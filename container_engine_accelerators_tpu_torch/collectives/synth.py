"""Collective schedule synthesis over the fleet's comm graph.

The port's copy of ``container_engine_accelerators_tpu/collectives/
synth.py`` (host code: no torch): the schedules, costs and byte
semantics are the JAX package's exactly.  ``combine`` is bit-equal to
the transfer daemon's ``fleet/xferd.py::_combine_into``.

Lowers ``all_reduce`` / ``all_gather`` / ``reduce_scatter`` into
explicit per-leg transfer steps for three algorithm families and picks
the cheapest under the graph's cost model (TACCL's shape, PAPERS.md —
the topology sketch chooses the algorithm, not a hardcoded ring):

- **ring** — the bandwidth-optimal classic: rack-major node order,
  ``n-1`` reduce-scatter steps and/or ``n-1`` all-gather steps, each
  moving one ``S/n`` chunk per node to its ring successor;
- **tree** — the flat two-phase star: everyone sends to the root, the
  root answers (latency-optimal for small payloads; the cost model's
  endpoint serialization charges the root its fan-in honestly);
- **hierarchical** — the two-level DCN shape for ``all_reduce``:
  intra-rack ring reduce-scatter, a cross-rack exchange per shard
  owner, intra-rack ring all-gather — the only family whose
  cross-rack traffic is ``S/k`` per node instead of riding every
  step, which is why it wins the moment the cross-rack tier degrades.

A :class:`Schedule` is plain data: an ordered list of *step groups*,
each a list of :class:`TransferStep` legs that may run concurrently
(every leg's payload is read from pre-step state, so groups have
barrier semantics and no intra-group data hazards).  ``simulate``
executes a schedule over in-memory buffers — the unit-testable oracle
the runner's wire execution is verified against.

:class:`Synthesizer` owns re-synthesis: it caches the schedule keyed
by the graph signature it was planned against, and a signature change
(fault armed, link healed) triggers a fresh synthesis, counted by
``collective.resynth`` and marked in the trace — the "fault → new
schedule, heal → recover" loop the scenario gates assert on.
"""

import dataclasses
import logging
import math
from typing import Dict, List, Optional, Tuple

try:  # vectorized reduction; the pure-python loop below is the spec
    import numpy as _np
except ImportError:  # pragma: no cover - numpy ships with the stack
    _np = None

from container_engine_accelerators_tpu_torch.collectives.topo import CommGraph
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import trace

log = logging.getLogger(__name__)

COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter")
# Preference order breaks exact cost ties deterministically.  The
# hand-written families participate in auto-selection; ``searched``
# (collectives/search.py's sketch-guided synthesis) is pin-only — it
# spends real synthesis CPU enumerating candidates, so a config must
# ask for it (``algorithm: searched``) rather than every auto pass
# paying the search.
AUTO_ALGORITHMS = ("ring", "tree", "hierarchical")
ALGORITHMS = AUTO_ALGORITHMS + ("searched",)


def bus_factor(op: str, n: int) -> float:
    """nccl-tests bus-bandwidth factor over ``n`` ranks: ``busbw = algbw *
    factor`` (``bench.py`` keeps the same accounting)."""
    if op == "all_reduce":
        return 2 * (n - 1) / n
    if op in ("all_gather", "reduce_scatter"):
        return (n - 1) / n
    return 1.0  # point-to-point shift


class SynthesisError(ValueError):
    """The requested (collective, algorithm, fleet shape) combination
    cannot be lowered — e.g. hierarchical over one rack."""


@dataclasses.dataclass(frozen=True)
class TransferStep:
    """One leg: move ``nbytes`` at ``offset`` of the collective buffer
    from ``src`` to ``dst``; the receiver reduces (elementwise
    combine) or places (overwrite) the region."""

    src: str
    dst: str
    offset: int
    nbytes: int
    reduce: bool
    phase: str


@dataclasses.dataclass
class Schedule:
    collective: str
    algorithm: str
    nbytes: int
    order: List[str]
    steps: List[List[TransferStep]]
    est_cost_s: float
    signature: tuple

    @property
    def transfers(self) -> int:
        return sum(len(g) for g in self.steps)

    def to_dict(self) -> dict:
        """JSON-clean summary for reports/CLI tables (the full step
        list stays in memory; reports carry the shape, not the data)."""
        return {
            "collective": self.collective,
            "algorithm": self.algorithm,
            "bytes": self.nbytes,
            "steps": len(self.steps),
            "transfers": self.transfers,
            "est_cost_ms": (round(self.est_cost_s * 1e3, 3)
                            if math.isfinite(self.est_cost_s) else None),
            "phases": sorted({t.phase for g in self.steps for t in g}),
        }


def partition(nbytes: int, parts: int) -> List[Tuple[int, int]]:
    """Even ``parts``-way split of ``[0, nbytes)`` as (offset, length);
    the remainder spreads one byte at a time over the leading chunks,
    so lengths differ by at most one (and may be zero for tiny
    payloads — zero-length legs are skipped at lowering time)."""
    base, rem = divmod(nbytes, parts)
    out = []
    off = 0
    for i in range(parts):
        ln = base + (1 if i < rem else 0)
        out.append((off, ln))
        off += ln
    return out


def _ring_phase(order: List[str], chunks: List[Tuple[int, int]],
                reduce: bool, phase: str,
                offset_base: int = 0) -> List[List[TransferStep]]:
    """The ``n-1`` steps of a ring reduce-scatter (``reduce=True``:
    step ``s`` moves chunk ``(i - s - 1) mod n`` so node ``i`` ends
    owning the fully reduced chunk ``i``) or ring all-gather
    (``reduce=False``: step ``s`` moves chunk ``(i - s) mod n``,
    starting from each node owning chunk ``i``)."""
    n = len(order)
    groups = []
    for s in range(n - 1):
        group = []
        for i in range(n):
            c = (i - s - 1) % n if reduce else (i - s) % n
            off, ln = chunks[c]
            if ln == 0:
                continue
            group.append(TransferStep(
                src=order[i], dst=order[(i + 1) % n],
                offset=offset_base + off, nbytes=ln,
                reduce=reduce, phase=phase))
        if group:
            groups.append(group)
    return groups


def _ring(order: List[str], collective: str,
          nbytes: int) -> List[List[TransferStep]]:
    chunks = partition(nbytes, len(order))
    if collective == "all_reduce":
        return (_ring_phase(order, chunks, True, "rs")
                + _ring_phase(order, chunks, False, "ag"))
    if collective == "reduce_scatter":
        return _ring_phase(order, chunks, True, "rs")
    return _ring_phase(order, chunks, False, "ag")


def _tree(order: List[str], collective: str,
          nbytes: int) -> List[List[TransferStep]]:
    root, rest = order[0], order[1:]
    chunks = partition(nbytes, len(order))
    up_reduce = collective in ("all_reduce", "reduce_scatter")
    up = [TransferStep(src=n, dst=root,
                       offset=0 if up_reduce else chunks[i + 1][0],
                       nbytes=nbytes if up_reduce else chunks[i + 1][1],
                       reduce=up_reduce,
                       phase="reduce" if up_reduce else "gather")
          for i, n in enumerate(rest)
          if (nbytes if up_reduce else chunks[i + 1][1]) > 0]
    if collective == "reduce_scatter":
        down = [TransferStep(src=root, dst=n, offset=chunks[i + 1][0],
                             nbytes=chunks[i + 1][1], reduce=False,
                             phase="scatter")
                for i, n in enumerate(rest) if chunks[i + 1][1] > 0]
    else:
        down = [TransferStep(src=root, dst=n, offset=0, nbytes=nbytes,
                             reduce=False, phase="bcast")
                for n in rest]
    return [g for g in (up, down) if g]


def _hierarchical(graph: CommGraph, collective: str,
                  nbytes: int) -> List[List[TransferStep]]:
    """Two-level lowerings.  Requires >= 2 equal-size racks (the
    counterpart pairing is positional) — callers treat
    :class:`SynthesisError` as "not a candidate".

    - **all_reduce**: intra-rack ring reduce-scatter over the
      rack-size chunking, one cross-rack star exchange per shard
      owner, intra-rack ring all-gather;
    - **all_gather**: one cross-rack counterpart exchange (each node
      ships its own global chunk to its position-mates in every other
      rack), then an intra-rack ring all-gather of the *coarse*
      chunks (position ``j``'s pieces across all racks) — cross-rack
      bytes per node are ``(R-1)·S/n`` instead of the flat ring's
      every-boundary crossings;
    - **reduce_scatter**: the mirror — intra-rack ring
      reduce-scatter over the coarse chunks, then one cross-rack
      counterpart exchange shipping each rack's partial of the
      destination's own chunk (``reduce=True``)."""
    racks = list(graph.racks().values())
    if len(racks) < 2:
        raise SynthesisError("hierarchical needs >= 2 racks")
    k = len(racks[0])
    if any(len(r) != k for r in racks):
        raise SynthesisError(
            "hierarchical needs equal-size racks, got "
            f"{[len(r) for r in racks]}")
    if collective == "all_gather":
        return _hier_all_gather(racks, nbytes)
    if collective == "reduce_scatter":
        return _hier_reduce_scatter(racks, nbytes)
    chunks = partition(nbytes, k)
    steps: List[List[TransferStep]] = []
    # Intra-rack reduce-scatter: every rack steps in lockstep, so the
    # per-s groups merge across racks into one concurrent group.
    for s in range(k - 1):
        group = []
        for members in racks:
            for i in range(k):
                c = (i - s - 1) % k
                off, ln = chunks[c]
                if ln == 0:
                    continue
                group.append(TransferStep(
                    src=members[i], dst=members[(i + 1) % k],
                    offset=off, nbytes=ln, reduce=True, phase="rs"))
        if group:
            steps.append(group)
    # Cross-rack exchange: shard i's owners (one per rack) star-reduce
    # into rack 0's owner, which answers with the full sum — 2 groups
    # total, each carrying S/k per participating node.
    up, down = [], []
    for i in range(k):
        off, ln = chunks[i]
        if ln == 0:
            continue
        anchor = racks[0][i]
        for members in racks[1:]:
            up.append(TransferStep(src=members[i], dst=anchor,
                                   offset=off, nbytes=ln, reduce=True,
                                   phase="xr"))
            down.append(TransferStep(src=anchor, dst=members[i],
                                     offset=off, nbytes=ln,
                                     reduce=False, phase="xr"))
    for g in (up, down):
        if g:
            steps.append(g)
    # Intra-rack all-gather, lockstep across racks again.
    for s in range(k - 1):
        group = []
        for members in racks:
            for i in range(k):
                c = (i - s) % k
                off, ln = chunks[c]
                if ln == 0:
                    continue
                group.append(TransferStep(
                    src=members[i], dst=members[(i + 1) % k],
                    offset=off, nbytes=ln, reduce=False, phase="ag"))
        if group:
            steps.append(group)
    return steps


def _hier_all_gather(racks: List[List[str]],
                     nbytes: int) -> List[List[TransferStep]]:
    """Two-level all_gather over the n-way global chunking (rack-major
    order, so rack ``r`` position ``j`` owns global chunk ``r·k+j``):
    one ``xr`` counterpart-exchange group, then ``k-1`` lockstep
    intra-rack ring steps gathering the coarse chunks (each coarse
    chunk is ``R`` non-contiguous pieces, one leg per piece)."""
    R, k = len(racks), len(racks[0])
    chunks = partition(nbytes, R * k)
    steps: List[List[TransferStep]] = []
    xr = []
    for r in range(R):
        for j in range(k):
            off, ln = chunks[r * k + j]
            if ln == 0:
                continue
            for r2 in range(R):
                if r2 == r:
                    continue
                xr.append(TransferStep(
                    src=racks[r][j], dst=racks[r2][j],
                    offset=off, nbytes=ln, reduce=False, phase="xr"))
    if xr:
        steps.append(xr)
    for s in range(k - 1):
        group = []
        for r in range(R):
            for i in range(k):
                c = (i - s) % k
                for r2 in range(R):
                    off, ln = chunks[r2 * k + c]
                    if ln == 0:
                        continue
                    group.append(TransferStep(
                        src=racks[r][i], dst=racks[r][(i + 1) % k],
                        offset=off, nbytes=ln, reduce=False,
                        phase="ag"))
        if group:
            steps.append(group)
    return steps


def _hier_reduce_scatter(racks: List[List[str]],
                         nbytes: int) -> List[List[TransferStep]]:
    """Two-level reduce_scatter, the all_gather mirror: ``k-1``
    lockstep intra-rack ring reduce-scatter steps over the coarse
    chunks (after which position ``j`` owns its rack's partial of
    every rack's ``j``-th global chunk), then one ``xr`` counterpart
    group where each node ships the partial of its position-mate's
    own chunk with ``reduce=True`` — every node ends owning its fully
    reduced global chunk ``r·k+j``."""
    R, k = len(racks), len(racks[0])
    chunks = partition(nbytes, R * k)
    steps: List[List[TransferStep]] = []
    for s in range(k - 1):
        group = []
        for r in range(R):
            for i in range(k):
                c = (i - s - 1) % k
                for r2 in range(R):
                    off, ln = chunks[r2 * k + c]
                    if ln == 0:
                        continue
                    group.append(TransferStep(
                        src=racks[r][i], dst=racks[r][(i + 1) % k],
                        offset=off, nbytes=ln, reduce=True,
                        phase="rs"))
        if group:
            steps.append(group)
    xr = []
    for r in range(R):
        for j in range(k):
            for r2 in range(R):
                if r2 == r:
                    continue
                off, ln = chunks[r2 * k + j]
                if ln == 0:
                    continue
                xr.append(TransferStep(
                    src=racks[r][j], dst=racks[r2][j],
                    offset=off, nbytes=ln, reduce=True, phase="xr"))
    if xr:
        steps.append(xr)
    return steps


def estimate_cost_s(graph: CommGraph,
                    steps: List[List[TransferStep]]) -> float:
    """Cost of a lowered schedule under the graph: per group, every
    endpoint serializes its own legs (a tree root's fan-in is charged
    as a sum, not hidden behind a max), the group costs its busiest
    endpoint, and groups are barriers so the total is the sum."""
    total = 0.0
    for group in steps:
        by_end: Dict[str, float] = {}
        for t in group:
            c = graph.leg_cost_s(t.src, t.dst, t.nbytes)
            by_end[t.src] = by_end.get(t.src, 0.0) + c
            by_end[t.dst] = by_end.get(t.dst, 0.0) + c
        total += max(by_end.values(), default=0.0)
    return total


def _lower(graph: CommGraph, algorithm: str, collective: str,
           nbytes: int) -> List[List[TransferStep]]:
    order = graph.order()
    if len(order) < 2:
        raise SynthesisError("a collective needs >= 2 nodes")
    if algorithm == "ring":
        return _ring(order, collective, nbytes)
    if algorithm == "tree":
        return _tree(order, collective, nbytes)
    if algorithm == "hierarchical":
        return _hierarchical(graph, collective, nbytes)
    if algorithm == "searched":
        # Lazy import: search.py scores candidates with THIS module's
        # cost model and verifies them against THIS module's oracle.
        from container_engine_accelerators_tpu_torch.collectives import search
        return search.search_steps(graph, collective, nbytes)
    raise SynthesisError(f"unknown algorithm {algorithm!r}")


def synthesize(graph: CommGraph, collective: str, nbytes: int,
               algorithm: Optional[str] = None) -> Schedule:
    """Lower ``collective`` over ``graph``; with ``algorithm=None``
    every auto family that can lower this shape is costed and the
    cheapest wins (ties break by the AUTO_ALGORITHMS preference
    order; ``searched`` is pin-only).  A fleet mid-partition prices
    every candidate at infinity — the cheapest is still returned
    (legs will fail, the caller retries, and the heal's signature
    change re-synthesizes)."""
    if collective not in COLLECTIVES:
        raise SynthesisError(f"unknown collective {collective!r}")
    if nbytes <= 0:
        raise SynthesisError("collective payload must be > 0 bytes")
    candidates = [algorithm] if algorithm else list(AUTO_ALGORITHMS)
    best: Optional[Schedule] = None
    for rank, algo in enumerate(candidates):
        try:
            steps = _lower(graph, algo, collective, nbytes)
        except SynthesisError:
            if algorithm:
                raise
            continue
        cost = estimate_cost_s(graph, steps)
        sched = Schedule(collective=collective, algorithm=algo,
                         nbytes=nbytes, order=graph.order(),
                         steps=steps, est_cost_s=cost,
                         signature=graph.signature())
        if best is None or (cost, rank) < (best.est_cost_s,
                                           candidates.index(
                                               best.algorithm)):
            best = sched
    if best is None:
        raise SynthesisError(
            f"no algorithm lowers {collective} over this fleet")
    return best


class Synthesizer:
    """Schedule cache + re-synthesis trigger for one collective shape.

    ``schedule_for(graph)`` returns the cached schedule while the
    graph signature it was planned against holds; a signature change
    (fault or heal) synthesizes fresh, bumps ``collective.resynth``
    and drops a ``collective.resynth`` trace marker carrying the
    old/new algorithm — the evidence the scenario gate reads."""

    def __init__(self, collective: str, nbytes: int,
                 algorithm: Optional[str] = None):
        self.collective = collective
        self.nbytes = int(nbytes)
        self.algorithm = algorithm
        self.resynth_count = 0
        self._schedule: Optional[Schedule] = None

    def current(self) -> Optional[Schedule]:
        """The schedule the last planning pass produced (None before
        the first ``schedule_for``)."""
        return self._schedule

    def schedule_for(self, graph: CommGraph) -> Schedule:
        sig = graph.signature()
        if self._schedule is not None \
                and sig == self._schedule.signature:
            return self._schedule
        prev = self._schedule
        self._schedule = synthesize(graph, self.collective,
                                    self.nbytes, self.algorithm)
        if prev is not None:
            self.resynth_count += 1
            counters.inc("collective.resynth")
            trace.event("collective.resynth",
                        collective=self.collective,
                        prev_algorithm=prev.algorithm,
                        algorithm=self._schedule.algorithm,
                        degraded_edges=len(sig))
            log.warning(
                "collective schedule re-synthesized: %s -> %s "
                "(%d degraded/partitioned edge(s))",
                prev.algorithm, self._schedule.algorithm, len(sig))
        return self._schedule


# -- in-memory execution oracle ----------------------------------------------


def combine(dst: bytearray, offset: int, payload: bytes) -> None:
    """Elementwise byte-add mod 256 — the rig's reduction operator:
    cheap, commutative, associative, and a dropped or duplicated leg
    changes the result (the verification actually verifies).  uint8
    addition wraps mod 256 natively, so the vectorized path is
    bit-identical to the loop — it exists because oracle verification
    of searched schedules runs at real payload sizes, and the routed
    plane reduces inside daemon landing threads."""
    n = len(payload)
    if _np is not None and n >= 64:
        view = _np.frombuffer(dst, dtype=_np.uint8, count=n,
                              offset=offset)
        view += _np.frombuffer(payload, dtype=_np.uint8, count=n)
        return
    for i, b in enumerate(payload):
        j = offset + i
        dst[j] = (dst[j] + b) & 0xFF


def make_inputs(collective: str, order: List[str], nbytes: int,
                seed: int = 0) -> Dict[str, bytes]:
    """Deterministic per-node input buffers.  all_reduce and
    reduce_scatter start from full distinct buffers; all_gather starts
    from each node's own shard at its chunk offset (zeros elsewhere —
    the gather must move the shard, not rely on it being there)."""
    inputs = {}
    chunks = partition(nbytes, len(order))
    for i, name in enumerate(order):
        pattern = bytes(((seed * 131 + i * 31 + j * 7) % 251)
                        for j in range(nbytes))
        if collective == "all_gather":
            buf = bytearray(nbytes)
            off, ln = chunks[i]
            buf[off:off + ln] = pattern[off:off + ln]
            inputs[name] = bytes(buf)
        else:
            inputs[name] = pattern
    return inputs


def expected_outputs(collective: str, order: List[str],
                     inputs: Dict[str, bytes],
                     nbytes: int) -> Dict[str, Tuple[int, int, bytes]]:
    """Per node: the (offset, length, bytes) region that must match
    after the collective — full reduced buffer for all_reduce, the
    concatenation for all_gather, each node's own reduced chunk for
    reduce_scatter (the rest of its buffer is scratch by contract)."""
    chunks = partition(nbytes, len(order))
    if collective == "all_gather":
        full = bytearray(nbytes)
        for i, name in enumerate(order):
            off, ln = chunks[i]
            full[off:off + ln] = inputs[name][off:off + ln]
        return {n: (0, nbytes, bytes(full)) for n in order}
    total = bytearray(nbytes)
    for name in order:
        combine(total, 0, inputs[name])
    if collective == "all_reduce":
        return {n: (0, nbytes, bytes(total)) for n in order}
    return {
        name: (chunks[i][0], chunks[i][1],
               bytes(total[chunks[i][0]:chunks[i][0] + chunks[i][1]]))
        for i, name in enumerate(order)
    }


def simulate(schedule: Schedule,
             inputs: Dict[str, bytes]) -> Dict[str, bytearray]:
    """Apply a schedule to in-memory buffers with the runner's exact
    barrier semantics: each group's payloads snapshot pre-step state,
    then every leg lands.  The pure-python twin of the wire execution
    — what schedule-correctness tests (and debugging) run against."""
    bufs = {n: bytearray(b) for n, b in inputs.items()}
    for group in schedule.steps:
        staged = [(t, bytes(bufs[t.src][t.offset:t.offset + t.nbytes]))
                  for t in group]
        for t, payload in staged:
            if t.reduce:
                combine(bufs[t.dst], t.offset, payload)
            else:
                bufs[t.dst][t.offset:t.offset + t.nbytes] = payload
    return bufs
