"""Sketch-guided collective schedule search over the measured graph.

The port's copy of ``container_engine_accelerators_tpu/collectives/
search.py`` (host code: no torch): pure functions of the graph, so
sketches, ring orders and lowered steps equal the JAX package's.

The three hand-written families (ring / tree / hierarchical) each
freeze one communication shape; an asymmetric rig — unequal racks, one
degraded spine link — needs a shape none of them expresses.  TACCL
(PAPERS.md) shows the fix: synthesize the schedule against the
measured alpha-beta topology, guided by a small *communication sketch*
that bounds the search instead of exploring raw send/recv programs.

This module is that synthesis engine.  A :class:`Sketch` is a hint
bundle from a tiny grammar:

- ``ring:<order>`` — run the classic ring family over a *searched*
  node order (rack-major baseline, greedy nearest-neighbor
  construction from measured leg costs, bounded 2-opt descent), so a
  slow edge is routed to where the ring crosses it least;
- ``gateway:<g0,g1,...>`` — pick one *gateway* member per rack (the
  healthiest by measured cross-rack cost, so a degraded spine endpoint
  is steered around), reduce/gather inside each rack onto the
  gateway (``intra`` style ``star`` or ``ring``), exchange between
  gateways only (``xr`` style ``direct`` — a multi-root star over a
  ``chunks``-way granularity — or ``ring``), then fan back out.
  Gateways work on UNEQUAL racks, where the hierarchical family
  refuses to lower.

Every candidate is lowered to plain :class:`synth.TransferStep`
groups, scored with the existing :func:`synth.estimate_cost_s` cost
model over the measured :class:`CommGraph`, and the winner is executed
only after it reproduces :func:`synth.expected_outputs` under the
:func:`synth.simulate` oracle — a searched schedule that cannot prove
itself correct is rejected (``collective.search.rejected``) and the
next-best candidate takes its place.

Plugged into the Synthesizer as ``algorithm: searched`` (pin-only —
auto-selection stays with the free families), which buys the
signature-keyed cache and resynthesis-on-fault for free: a fault or a
heal changes the planning signature and the whole search re-runs
against the new measured costs.
"""

import dataclasses
import itertools
import logging
import math
from typing import Dict, List, Sequence, Tuple

from container_engine_accelerators_tpu_torch.collectives import synth
from container_engine_accelerators_tpu_torch.collectives.topo import CommGraph
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries, trace

log = logging.getLogger(__name__)

# Search bounds: the sketch grammar keeps the space tiny, these keep
# it tiny even on wide fleets.
GATEWAYS_PER_RACK = 2      # top-k healthiest members enumerated per rack
MAX_GATEWAY_COMBOS = 16    # cap on the per-rack gateway product
TWO_OPT_PASSES = 2         # bounded local descent on ring orders
VERIFY_SEED = 1            # oracle verification input seed


@dataclasses.dataclass(frozen=True)
class Sketch:
    """One point of the sketch grammar the search enumerates."""

    kind: str                        # "ring" | "gateway"
    order: Tuple[str, ...] = ()      # ring: explicit node order
    gateways: Tuple[str, ...] = ()   # gateway: one member per rack
    xr_style: str = "direct"         # gateway: "direct" | "ring"
    intra_style: str = "star"        # gateway: "star" | "ring"
    chunks: int = 0                  # gateway direct: exchange granularity

    def label(self) -> str:
        if self.kind == "ring":
            return "ring:" + ">".join(self.order)
        return (f"gateway:{','.join(self.gateways)}"
                f":xr={self.xr_style}:intra={self.intra_style}"
                f":chunks={self.chunks}")


# -- ring-order search -------------------------------------------------------


def _tour_cost(graph: CommGraph, order: Sequence[str],
               probe: int) -> float:
    total = 0.0
    n = len(order)
    for i in range(n):
        total += graph.leg_cost_s(order[i], order[(i + 1) % n], probe)
    return total


def _greedy_order(graph: CommGraph, start: str, names: Sequence[str],
                  probe: int) -> List[str]:
    """Nearest-neighbor construction: always extend the ring over the
    cheapest measured edge out of the current tail."""
    left = [n for n in names if n != start]
    out = [start]
    while left:
        nxt = min(left,
                  key=lambda n: (graph.leg_cost_s(out[-1], n, probe), n))
        out.append(nxt)
        left.remove(nxt)
    return out


def _two_opt(graph: CommGraph, order: List[str],
             probe: int) -> List[str]:
    """Bounded 2-opt descent: reverse any segment whose reversal
    lowers the directed tour cost, a few passes at most (the rigs are
    small; this is a polish, not an exhaustive TSP solve)."""
    best = list(order)
    cost = _tour_cost(graph, best, probe)
    n = len(best)
    for _ in range(TWO_OPT_PASSES):
        improved = False
        for i in range(1, n - 1):
            for j in range(i + 1, n):
                cand = best[:i] + best[i:j][::-1] + best[j:]
                c = _tour_cost(graph, cand, probe)
                if c < cost:
                    best, cost, improved = cand, c, True
        if not improved:
            break
    return best


def _ring_orders(graph: CommGraph,
                 nbytes: int) -> List[Tuple[str, ...]]:
    base = graph.order()
    probe = max(1, nbytes // len(base))
    cands = [list(base),
             _greedy_order(graph, base[0], base, probe)]
    cands += [_two_opt(graph, c, probe) for c in list(cands)]
    seen, out = set(), []
    for c in cands:
        key = tuple(c)
        if key not in seen:
            seen.add(key)
            out.append(key)
    return out


# -- gateway selection -------------------------------------------------------


def _gateway_choices(graph: CommGraph, racks: List[List[str]],
                     probe: int) -> List[Tuple[str, ...]]:
    """Per rack, the top GATEWAYS_PER_RACK members by summed measured
    cross-rack cost (both directions — a spine fault on either side
    makes that member a bad gateway), then the capped product."""
    per_rack: List[List[str]] = []
    for r, members in enumerate(racks):
        others = [n for r2, ms in enumerate(racks) if r2 != r
                  for n in ms]
        scored = sorted(
            members,
            key=lambda m: (sum(graph.leg_cost_s(m, o, probe)
                               + graph.leg_cost_s(o, m, probe)
                               for o in others), m))
        per_rack.append(scored[:GATEWAYS_PER_RACK])
    combos = []
    for combo in itertools.product(*per_rack):
        combos.append(tuple(combo))
        if len(combos) >= MAX_GATEWAY_COMBOS:
            break
    return combos


def sketches(graph: CommGraph, nbytes: int) -> List[Sketch]:
    """Enumerate the sketch grammar for this fleet shape."""
    out = [Sketch(kind="ring", order=o)
           for o in _ring_orders(graph, nbytes)]
    racks = list(graph.racks().values())
    if len(racks) >= 2:
        g = len(racks)
        probe = max(1, nbytes // max(1, sum(len(r) for r in racks)))
        for gws in _gateway_choices(graph, racks, probe):
            for intra in ("star", "ring"):
                out.append(Sketch(kind="gateway", gateways=gws,
                                  xr_style="ring", intra_style=intra))
                for c in sorted({g, min(2 * g, 8)}):
                    out.append(Sketch(kind="gateway", gateways=gws,
                                      xr_style="direct",
                                      intra_style=intra, chunks=c))
    return out


# -- sketch lowering ---------------------------------------------------------


def _rack_regions(racks: List[List[str]],
                  nbytes: int) -> Tuple[List[Tuple[int, int]],
                                        List[Tuple[int, int]],
                                        Dict[str, int]]:
    """Global n-way chunking (rack-major, matching ``graph.order()``),
    each rack's contiguous region, and each node's global chunk index."""
    n = sum(len(r) for r in racks)
    chunks = synth.partition(nbytes, n)
    regions, owner_chunk = [], {}
    idx = 0
    for members in racks:
        start = idx
        for m in members:
            owner_chunk[m] = idx
            idx += 1
        off = chunks[start][0]
        ln = sum(chunks[i][1] for i in range(start, idx))
        regions.append((off, ln))
    return chunks, regions, owner_chunk


def _intra_reduce(racks: List[List[str]], gws: Sequence[str],
                  style: str, nbytes: int) -> List[List[synth.TransferStep]]:
    """Reduce every rack's buffers onto its gateway.  ``star``: one
    full-buffer fan-in group.  ``ring``: rack-local ring
    reduce-scatter (lockstep across racks) then a chunk gather — more
    groups, but no single endpoint is charged the whole fan-in."""
    steps: List[List[synth.TransferStep]] = []
    if style == "star":
        group = [synth.TransferStep(src=m, dst=gw, offset=0,
                                    nbytes=nbytes, reduce=True,
                                    phase="intra")
                 for members, gw in zip(racks, gws)
                 for m in members if m != gw]
        if group:
            steps.append(group)
        return steps
    local = [synth.partition(nbytes, len(members)) for members in racks]
    max_k = max(len(members) for members in racks)
    for s in range(max_k - 1):
        group = []
        for members, chunks in zip(racks, local):
            k = len(members)
            if s >= k - 1:
                continue
            for i in range(k):
                off, ln = chunks[(i - s - 1) % k]
                if ln == 0:
                    continue
                group.append(synth.TransferStep(
                    src=members[i], dst=members[(i + 1) % k],
                    offset=off, nbytes=ln, reduce=True, phase="intra"))
        if group:
            steps.append(group)
    gather = []
    for members, chunks, gw in zip(racks, local, gws):
        for i, m in enumerate(members):
            off, ln = chunks[i]
            if m == gw or ln == 0:
                continue
            gather.append(synth.TransferStep(
                src=m, dst=gw, offset=off, nbytes=ln, reduce=False,
                phase="intra"))
    if gather:
        steps.append(gather)
    return steps


def _xr_all_reduce(gws: Sequence[str], sk: Sketch,
                   nbytes: int) -> List[List[synth.TransferStep]]:
    if sk.xr_style == "ring":
        return [[dataclasses.replace(t, phase="xr") for t in g]
                for g in synth._ring(list(gws), "all_reduce", nbytes)]
    g = len(gws)
    chunks = synth.partition(nbytes, max(sk.chunks, g))
    up, down = [], []
    for i, (off, ln) in enumerate(chunks):
        if ln == 0:
            continue
        owner = gws[i % g]
        for gw in gws:
            if gw == owner:
                continue
            up.append(synth.TransferStep(src=gw, dst=owner, offset=off,
                                         nbytes=ln, reduce=True,
                                         phase="xr"))
            down.append(synth.TransferStep(src=owner, dst=gw,
                                           offset=off, nbytes=ln,
                                           reduce=False, phase="xr"))
    return [grp for grp in (up, down) if grp]


def _lower_gateway(racks: List[List[str]], sk: Sketch, collective: str,
                   nbytes: int) -> List[List[synth.TransferStep]]:
    gws = list(sk.gateways)
    chunks, regions, owner_chunk = _rack_regions(racks, nbytes)
    steps: List[List[synth.TransferStep]] = []
    if collective in ("all_reduce", "reduce_scatter"):
        steps += _intra_reduce(racks, gws, sk.intra_style, nbytes)
        if collective == "all_reduce":
            steps += _xr_all_reduce(gws, sk, nbytes)
            down = [synth.TransferStep(src=gw, dst=m, offset=0,
                                       nbytes=nbytes, reduce=False,
                                       phase="down")
                    for members, gw in zip(racks, gws)
                    for m in members if m != gw]
            if down:
                steps.append(down)
            return steps
        # reduce_scatter: cross-rack reduce of each rack's region onto
        # its own gateway, then scatter members their own chunks.
        if sk.xr_style == "ring":
            steps += synth._ring_phase(gws, regions, True, "xr")
        else:
            xr = [synth.TransferStep(src=gws[r], dst=gws[r2],
                                     offset=regions[r2][0],
                                     nbytes=regions[r2][1], reduce=True,
                                     phase="xr")
                  for r in range(len(gws))
                  for r2 in range(len(gws))
                  if r2 != r and regions[r2][1] > 0]
            if xr:
                steps.append(xr)
        down = []
        for members, gw in zip(racks, gws):
            for m in members:
                off, ln = chunks[owner_chunk[m]]
                if m == gw or ln == 0:
                    continue
                down.append(synth.TransferStep(
                    src=gw, dst=m, offset=off, nbytes=ln, reduce=False,
                    phase="down"))
        if down:
            steps.append(down)
        return steps
    # all_gather: members hand their own chunk up, gateways exchange
    # whole rack regions, every member gets the full buffer back.
    up = []
    for members, gw in zip(racks, gws):
        for m in members:
            off, ln = chunks[owner_chunk[m]]
            if m == gw or ln == 0:
                continue
            up.append(synth.TransferStep(src=m, dst=gw, offset=off,
                                         nbytes=ln, reduce=False,
                                         phase="intra"))
    if up:
        steps.append(up)
    if sk.xr_style == "ring":
        steps += synth._ring_phase(gws, regions, False, "xr")
    else:
        xr = [synth.TransferStep(src=gws[r], dst=gws[r2],
                                 offset=regions[r][0],
                                 nbytes=regions[r][1], reduce=False,
                                 phase="xr")
              for r in range(len(gws))
              for r2 in range(len(gws))
              if r2 != r and regions[r][1] > 0]
        if xr:
            steps.append(xr)
    down = [synth.TransferStep(src=gw, dst=m, offset=0, nbytes=nbytes,
                               reduce=False, phase="down")
            for members, gw in zip(racks, gws)
            for m in members if m != gw]
    if down:
        steps.append(down)
    return steps


def lower_sketch(graph: CommGraph, sk: Sketch, collective: str,
                 nbytes: int) -> List[List[synth.TransferStep]]:
    """Lower one sketch to barrier-grouped transfer steps.  Every
    lowering here is hazard-free by construction (no node's read
    region overlaps a write aimed at it within one group), which is
    what lets the routed execution plane fire a whole group of
    daemon→daemon forwards concurrently without snapshots."""
    if sk.kind == "ring":
        return synth._ring(list(sk.order), collective, nbytes)
    if sk.kind == "gateway":
        racks = list(graph.racks().values())
        if len(racks) < 2:
            raise synth.SynthesisError("gateway sketch needs >= 2 racks")
        return _lower_gateway(racks, sk, collective, nbytes)
    raise synth.SynthesisError(f"unknown sketch kind {sk.kind!r}")


# -- search + oracle verification --------------------------------------------


def _verified(steps: List[List[synth.TransferStep]], order: List[str],
              collective: str, nbytes: int) -> bool:
    """Run the candidate through the simulate() oracle and compare
    every node's contract region against expected_outputs — the gate
    between "scored well" and "allowed on the wire"."""
    inputs = synth.make_inputs(collective, order, nbytes,
                               seed=VERIFY_SEED)
    want = synth.expected_outputs(collective, order, inputs, nbytes)
    sched = synth.Schedule(collective=collective, algorithm="searched",
                           nbytes=nbytes, order=list(order),
                           steps=steps, est_cost_s=0.0, signature=())
    got = synth.simulate(sched, inputs)
    for node, (off, ln, data) in want.items():
        if bytes(got[node][off:off + ln]) != data:
            return False
    return True


def search_steps(graph: CommGraph, collective: str,
                 nbytes: int) -> List[List[synth.TransferStep]]:
    """The ``algorithm: searched`` entry point synth._lower dispatches
    to: enumerate the sketch grammar, score every lowerable candidate
    with the measured cost model, prune unroutable ones, and emit the
    cheapest candidate that passes oracle verification."""
    order = graph.order()
    with trace.span("collective.search", collective=collective,
                    bytes=nbytes, nodes=len(order)):
        scored = []
        for idx, sk in enumerate(sketches(graph, nbytes)):
            try:
                steps = lower_sketch(graph, sk, collective, nbytes)
            except synth.SynthesisError:
                continue
            counters.inc("collective.search.candidates")
            cost = synth.estimate_cost_s(graph, steps)
            scored.append((cost, idx, sk, steps))
        if not scored:
            raise synth.SynthesisError(
                f"no sketch lowers {collective} over this fleet")
        finite = [c for c in scored if math.isfinite(c[0])]
        if finite and len(finite) < len(scored):
            # Unroutable candidates (a leg through a partition) are
            # pruned — unless everything is partitioned, in which case
            # the least-bad schedule still ships and the heal's
            # re-synthesis fixes it (same contract as the families).
            counters.inc("collective.search.pruned",
                         len(scored) - len(finite))
            scored = finite
        # Primary: modeled cost.  Tie-break: FEWER barrier groups —
        # every group is a coordination round (a barrier wait, and in
        # routed mode a verdict round-trip) the alpha-beta model does
        # not charge, so between cost-equal candidates the shallower
        # schedule wins on the wire.  Enumeration index last keeps the
        # sort total.
        scored.sort(key=lambda c: (c[0], len(c[3]), c[1]))
        for cost, _idx, sk, steps in scored:
            if not _verified(steps, order, collective, nbytes):
                counters.inc("collective.search.rejected")
                log.error("searched candidate %s failed oracle "
                          "verification; trying next-best", sk.label())
                continue
            counters.inc("collective.search.verified")
            _record_margin(graph, collective, nbytes, cost)
            log.info("searched schedule: %s (est %.3f ms, "
                     "%d candidates)", sk.label(), cost * 1e3,
                     len(scored))
            trace.event("collective.search.chosen", sketch=sk.label(),
                        collective=collective,
                        est_cost_ms=round(cost * 1e3, 3))
            return steps
        raise synth.SynthesisError(
            f"every searched candidate for {collective} failed oracle "
            "verification")


def _record_margin(graph: CommGraph, collective: str, nbytes: int,
                   searched_cost: float) -> None:
    """Model-predicted margin over the best auto family, as a gauge —
    the CLI's measured margin is the gate; this is the planning-time
    leading indicator beside it."""
    try:
        family = synth.synthesize(graph, collective, nbytes)
    except synth.SynthesisError:
        return
    if (math.isfinite(family.est_cost_s) and searched_cost > 0
            and math.isfinite(searched_cost)):
        timeseries.gauge("collective.search.margin",
                         family.est_cost_s / searched_cost)
