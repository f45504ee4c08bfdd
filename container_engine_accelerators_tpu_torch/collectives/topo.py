"""Annotated comm graph: what the collective synthesizer plans against.

The port's copy of ``container_engine_accelerators_tpu/collectives/
topo.py`` (host code: no torch).  The tier tables keep their ``ici``
entries so costs equal the JAX package's; the port's fleet never
classifies a link as ``ici``.  :meth:`CommGraph.scheduler_link_penalty`
and :class:`LinkHealthPenalty` feed the port's ``scheduler.daemon``
``link_penalty`` hook.

TACCL's core observation (PAPERS.md) is that the right collective
algorithm is a function of the topology *sketch* — which links exist,
how fast each tier is, and what shape the hierarchy has.  The fleet
rig already holds every input: :class:`FleetTopology` classifies each
pair by the production scheduler distance (``ici`` / ``intra-rack`` /
``cross-rack``), the :class:`LinkTable` knows which links are
partitioned, latency-injected, or shedding frames, and the windowed
``goodput.link.*`` series carry live measured rates.  This module
folds the three into one :class:`CommGraph` snapshot:

- every directed pair gets a :class:`CommEdge` with its tier, fault
  state, and (when the rig has moved bytes) measured goodput;
- :meth:`CommGraph.leg_cost_s` is the alpha-beta cost model the
  synthesizer's algorithm choice minimizes — injected latency lands in
  the alpha term, loss injection discounts the beta term, a partition
  costs infinity;
- :meth:`CommGraph.signature` is the re-synthesis trigger: it hashes
  only the *planning-relevant* state (up/degraded per edge), so a
  fault or a heal changes it and steady-state noise does not;
- :meth:`CommGraph.scheduler_link_penalty` renders the same evidence
  for the placement side: a distance-penalty callable
  ``calculate_pods_assignment`` adds on top of the production
  topology distance, so the packer steers pods away from nodes behind
  partitioned or lossy links (and degrades to the best available
  placement when no healthy one exists — a penalty, never a veto).

The graph is a snapshot by design: build one per planning pass.  It
never mutates live link state and imports nothing heavier than the
fleet topology model (no torch — the engine must load on a coordinator
that never touches an accelerator).
"""

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.fleet.topology import (
    TIER_CROSS_RACK,
    TIER_ICI,
    TIER_INTRA_RACK,
    FleetTopology,
)
from container_engine_accelerators_tpu_torch.scheduler import topology as sched_topo

# Tier base parameters for the cost model — RELATIVE envelopes, not
# hardware claims: ICI is effectively free next to any DCN tier,
# intra-rack DCN is a few times faster than the cross-rack spine.
# Measured goodput overrides the beta term once the rig has evidence.
TIER_BW_BPS = {
    TIER_ICI: 100e9,
    TIER_INTRA_RACK: 25e9,
    TIER_CROSS_RACK: 5e9,
}
TIER_ALPHA_S = {
    TIER_ICI: 1e-6,
    TIER_INTRA_RACK: 20e-6,
    TIER_CROSS_RACK: 100e-6,
}

# A link with a pending loss budget re-sends a share of everything it
# carries; discount its effective bandwidth rather than guessing a
# retransmit schedule.
DROP_BW_DISCOUNT = 4.0
# A link the goodput evidence flags as slow (see below) gets the same
# treatment: still usable, priced to be avoided.
SLOW_BW_DISCOUNT = 4.0

# Goodput evidence is RELATIVE, never absolute: a windowed
# ``goodput.link.*`` rate measures what a link carried, not what it
# could carry, so an idle or lightly-used link must never read as
# slow.  An edge is flagged ``slow`` only when it was demonstrably
# active (rate above the trust floor) AND delivered under
# SLOW_RATE_RATIO of the best rate any same-tier edge achieved in the
# same window — the shape a lossy link makes next to its healthy
# peers under symmetric collective traffic.
MIN_TRUSTED_RATE_BPS = 1024.0
SLOW_RATE_RATIO = 0.25

# Placement penalties the scheduler-side annotation source hands out,
# sized against scheduler.topology's distance envelope: a normal
# cross-rack hop costs ~DCN_MIN + DCN_FAR (~1e6), so DEGRADED must
# dominate any healthy alternative and PARTITIONED must dominate
# DEGRADED — while both stay finite, so an all-bad fleet still yields
# the least-bad assignment instead of none.
DEGRADED_LINK_PENALTY = 10 * sched_topo.DCN_FAR
PARTITIONED_LINK_PENALTY = 1000 * sched_topo.DCN_FAR


@dataclasses.dataclass
class CommEdge:
    """One directed link, annotated with everything planning needs."""

    src: str
    dst: str
    tier: str
    up: bool = True
    latency_s: float = 0.0
    drop_pending: int = 0
    #: windowed goodput evidence, observability + the `slow` verdict's
    #: input — never a capacity claim (utilization is not capacity)
    goodput_bps: float = 0.0
    #: flagged by the relative same-tier rate comparison at build time
    slow: bool = False

    @property
    def degraded(self) -> bool:
        """Injected evidence: lossy or latency-injected but still
        passing frames.  Feeds the planning signature (deterministic —
        faults and heals move it, measurement noise cannot)."""
        return self.up and (self.latency_s > 0.0 or self.drop_pending > 0)

    @property
    def suspect(self) -> bool:
        """Any avoid-if-you-can verdict, measured slowness included —
        what the scheduler's placement penalty and the node-health
        rollup read (a lossy real link shows up HERE even when no one
        told the coordinator's link table about it)."""
        return self.up and (self.degraded or self.slow)

    def cost_s(self, nbytes: int) -> float:
        """Alpha-beta transfer-time estimate for ``nbytes`` over this
        edge.  Partitioned edges cost infinity (no schedule through a
        null route can complete); injected latency is honest alpha;
        loss injection and measured slowness discount the tier's
        bandwidth envelope."""
        if not self.up:
            return math.inf
        alpha = TIER_ALPHA_S[self.tier] + self.latency_s
        bw = TIER_BW_BPS[self.tier]
        if self.drop_pending > 0:
            bw /= DROP_BW_DISCOUNT
        if self.slow:
            bw /= SLOW_BW_DISCOUNT
        return alpha + nbytes / bw


class CommGraph:
    """A planning snapshot of the fleet's communication structure."""

    def __init__(self, topology: FleetTopology,
                 edges: Dict[Tuple[str, str], CommEdge]):
        self.topology = topology
        self._edges = edges

    @classmethod
    def build(cls, topology: FleetTopology, links=None,
              rates: Optional[Callable[[str, str], float]] = None,
              ) -> "CommGraph":
        """Snapshot the fleet: tiers from the production distance
        function, fault state from the link table (when given), and
        live per-link goodput from the windowed series (or an injected
        ``rates(src, dst)`` source for tests).  Absent evidence reads
        as healthy at tier defaults — the same "no entry means no
        fault" contract the link table itself keeps."""
        if rates is None:
            from container_engine_accelerators_tpu_torch.obs import timeseries

            def rates(src: str, dst: str) -> float:
                return timeseries.rate(f"goodput.link.{src}->{dst}")

        state = links.snapshot_state() if links is not None else {}
        names = topology.names()
        edges: Dict[Tuple[str, str], CommEdge] = {}
        for a in names:
            for b in names:
                if a == b:
                    continue
                st = state.get((a, b), {})
                edges[(a, b)] = CommEdge(
                    src=a, dst=b, tier=topology.tier(a, b),
                    up=bool(st.get("up", True)),
                    latency_s=float(st.get("latency_s", 0.0)),
                    drop_pending=int(st.get("drop_next", 0)),
                    goodput_bps=float(rates(a, b) or 0.0),
                )
        # The relative slowness pass: within each tier, an ACTIVE edge
        # delivering well under the tier's best observed rate is
        # flagged `slow` — goodput as evidence of trouble, never as a
        # capacity estimate (an idle edge's decayed window is not
        # evidence of anything).
        peak_by_tier: Dict[str, float] = {}
        for e in edges.values():
            if e.goodput_bps >= MIN_TRUSTED_RATE_BPS:
                peak_by_tier[e.tier] = max(
                    peak_by_tier.get(e.tier, 0.0), e.goodput_bps)
        for e in edges.values():
            peak = peak_by_tier.get(e.tier, 0.0)
            if (e.up and peak > 0.0
                    and e.goodput_bps >= MIN_TRUSTED_RATE_BPS
                    and e.goodput_bps < SLOW_RATE_RATIO * peak):
                e.slow = True
        return cls(topology, edges)

    # -- queries -------------------------------------------------------------

    def nodes(self) -> List[str]:
        return self.topology.names()

    def edge(self, src: str, dst: str) -> CommEdge:
        return self._edges[(src, dst)]

    def up(self, src: str, dst: str) -> bool:
        return self._edges[(src, dst)].up

    def leg_cost_s(self, src: str, dst: str, nbytes: int) -> float:
        return self._edges[(src, dst)].cost_s(nbytes)

    def racks(self) -> Dict[str, List[str]]:
        """Rack -> member node names, both in deterministic order —
        the hierarchy the two-level schedule is synthesized over."""
        out: Dict[str, List[str]] = {}
        for name in sorted(self.topology.specs):
            out.setdefault(self.topology.specs[name].rack, []).append(name)
        return dict(sorted(out.items()))

    def order(self) -> List[str]:
        """Ring order: rack-major, so a ring crosses each rack
        boundary the minimum number of times the cycle allows."""
        return [n for members in self.racks().values() for n in members]

    def signature(self) -> tuple:
        """Hash of the planning-relevant state.  A schedule synthesized
        against one signature stays valid until the signature changes —
        a partition, a heal, injected latency appearing or clearing, a
        loss budget arming or spending out.  Measured goodput is
        deliberately NOT in the signature (it wobbles every round);
        it still shapes costs whenever a re-synthesis does happen."""
        return tuple(
            (src, dst, e.up, round(e.latency_s, 4), e.drop_pending > 0)
            for (src, dst), e in sorted(self._edges.items())
            if not e.up or e.degraded
        )

    # -- the placement-side annotation source --------------------------------

    def node_health(self) -> Dict[str, dict]:
        """Per-node link-health rollup: how many of the node's directed
        links are partitioned or degraded — the human-readable half of
        the annotation source (reports, CLI tables)."""
        out: Dict[str, dict] = {
            n: {"partitioned_links": 0, "degraded_links": 0}
            for n in self.nodes()
        }
        for (src, dst), e in self._edges.items():
            for end in (src, dst):
                if not e.up:
                    out[end]["partitioned_links"] += 1
                elif e.suspect:
                    out[end]["degraded_links"] += 1
        return out

    def scheduler_link_penalty(self) -> Callable[[dict, dict], float]:
        """A distance-penalty callable for the assignment search
        (``scheduler.daemon.calculate_pods_assignment(link_penalty=)``).

        Maps candidate nodes back to fleet nodes by the HOST label the
        simulator stamps (fleet/topology.NodeSpec.labels) and charges
        :data:`PARTITIONED_LINK_PENALTY` when either direction between
        the pair is down, :data:`DEGRADED_LINK_PENALTY` when either is
        lossy/latency-injected, 0 otherwise.  Hosts the fleet does not
        know cost nothing — the annotation source only ever *adds*
        evidence, it never vetoes a placement outright, so a job that
        fits nowhere healthy still lands on the least-bad nodes.

        This closure reads THIS graph — a frozen snapshot.  A
        long-lived SchedulerDaemon should wire
        :class:`LinkHealthPenalty` instead, which re-snapshots the
        link table on a bounded cadence so faults armed between
        scheduling passes steer the next placement."""
        known = set(self.topology.names())

        def penalty(node_a: dict, node_b: dict) -> float:
            a = (node_a.get("node_labels") or {}).get(
                sched_topo.HOST_LABEL)
            b = (node_b.get("node_labels") or {}).get(
                sched_topo.HOST_LABEL)
            if a not in known or b not in known or a == b:
                return 0.0
            fwd, rev = self._edges[(a, b)], self._edges[(b, a)]
            if not (fwd.up and rev.up):
                return PARTITIONED_LINK_PENALTY
            if fwd.suspect or rev.suspect:
                return DEGRADED_LINK_PENALTY
            return 0.0

        return penalty


class LinkHealthPenalty:
    """The LIVE link-health annotation source for a long-lived
    scheduler: a penalty callable (drop-in for
    ``calculate_pods_assignment(link_penalty=)`` /
    ``SchedulerDaemon(link_penalty=)``) that re-snapshots the fleet's
    link table on a bounded cadence instead of freezing one CommGraph
    forever.

    The assignment search evaluates the penalty in its inner loop —
    thousands of calls per pass — so rebuilding per call would be
    absurd and rebuilding never (a bare
    ``CommGraph.build(...).scheduler_link_penalty()`` closure) means a
    fault armed after construction never steers anything.  The middle
    road: each call checks a monotonic clock and rebuilds the snapshot
    at most once per ``refresh_s`` (default 1 s, the scheduler
    daemon's own pass interval), so within a pass the penalty is
    coherent and between passes it is fresh.  ``refresh_s=0`` rebuilds
    on every call — the deterministic setting tests use.
    """

    def __init__(self, topology: FleetTopology, links,
                 rates: Optional[Callable[[str, str], float]] = None,
                 refresh_s: float = 1.0):
        self.topology = topology
        self.links = links
        self.rates = rates
        self.refresh_s = float(refresh_s)
        self._built_at = -math.inf
        self._penalty: Optional[Callable[[dict, dict], float]] = None

    def refresh(self) -> None:
        """Force a rebuild on the next call (e.g. right after arming a
        fault, when waiting out the cadence would blur a test)."""
        self._built_at = -math.inf

    def __call__(self, node_a: dict, node_b: dict) -> float:
        now = time.monotonic()
        if self._penalty is None \
                or now - self._built_at >= self.refresh_s:
            self._penalty = CommGraph.build(
                self.topology, links=self.links,
                rates=self.rates).scheduler_link_penalty()
            self._built_at = now
        return self._penalty(node_a, node_b)
