"""Critical-path engine: where did the wall-clock actually go?

The stack emits spans (obs/trace.py), exemplars (obs/histo.py), and
per-second rates (obs/timeseries.py) — evidence of WHAT happened.  This
module answers the next operational question: of one slow transfer or
serving request, which phase *dominated*?  It reconstructs span trees
from the flat JSONL / ring-buffer span dicts (trace → parent/child via
the existing trace/span ids), computes per-phase **self time** (a
span's duration minus the union of its children's intervals), walks the
**critical path** (the chain of dominant children from a root to a
leaf), and derives **exposed-communication time** — DCN time NOT
overlapped with staging/compute, the signal the fine-grained-overlap
direction (T3, PAPERS.md) and the self-tuning data plane both need:
you cannot hide or tune the DCN leg until you can attribute it.

Inputs are plain span dicts (the JSONL schema in obs/trace.py):
``{"trace", "span", "parent", "name", "ts", "dur_us", ...}``.  ``ts``
is a wall-clock start and ``dur_us`` a monotonic duration, so a span's
interval is ``[ts, ts + dur_us/1e6)``; intervals from different
processes on one host compare well enough for attribution (and every
child is clipped to its parent, so clock skew degrades percentages,
never produces negative time).

Two layers:

- **interval algebra** (``merge`` / ``covered_s`` / ``subtract`` /
  ``exposed_s``) — shared with the LIVE accounting in
  ``parallel/dcn_pipeline.py``, which feeds the ``dcn.exposed`` /
  ``dcn.comm`` histograms and the ``dcn.exposed_ratio`` gauge from the
  same math this module applies offline;
- **tree analysis** (``build_trees`` / ``critical_path`` /
  ``phase_rollup`` / ``analyze``) — what ``cmd/agent_trace.py
  --critical-path``, the fleet report's ``critical_path`` section, and
  the tests consume.

Known request shapes (``analyze``): a pipelined transfer
(``dcn.pipeline`` → stage vs send vs wait vs read, per chunk/stripe), a
serving batch (``serving.batch`` → queue wait vs batch wait vs attempt
vs hedge), a fleet leg (``fleet.leg``), a serial exchange
(``dcn.exchange``), and a bench transfer (``bench.xfer``).  Unknown
trees still work through ``critical_path`` — the shapes are starting
points, not a schema.

Stdlib-only, like the rest of obs/.
"""

from collections import defaultdict
from typing import Any, Dict, Iterable, List, Optional, Tuple

Interval = Tuple[float, float]

# Root span names analyze() rolls up.  HEADLINE_PRIORITY orders the
# overall dominant-phase pick: the specific request shapes (a
# pipelined transfer, a serving batch) answer "where did the time go"
# better than the enclosing fleet.leg, whose own rollup they dominate
# anyway — fleet.leg is the fallback, not the headline.
SHAPE_ROOTS = (
    "fleet.leg",
    "serving.batch",
    "collective.run",
    "dcn.pipeline",
    "dcn.exchange",
    "bench.xfer",
)
HEADLINE_PRIORITY = (
    "collective.run",
    "dcn.pipeline",
    "serving.batch",
    "dcn.exchange",
    "bench.xfer",
    "fleet.leg",
)

# serving.attempt spans split by their hedge role so the breakdown
# answers "attempt vs hedge", not just "attempt".
_ATTEMPT = "serving.attempt"


# ---------------------------------------------------------------------------
# interval algebra (shared with the live exposed-comm accounting)
# ---------------------------------------------------------------------------


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """Sorted, overlap-free union of ``(t0, t1)`` pairs; empty and
    inverted inputs are dropped."""
    ivs = sorted((t0, t1) for t0, t1 in intervals if t1 > t0)
    out: List[Interval] = []
    for t0, t1 in ivs:
        if out and t0 <= out[-1][1]:
            if t1 > out[-1][1]:
                out[-1] = (out[-1][0], t1)
        else:
            out.append((t0, t1))
    return out


def covered_s(intervals: Iterable[Interval]) -> float:
    """Total time covered by the union of ``intervals``, seconds."""
    return sum(t1 - t0 for t0, t1 in merge(intervals))


def subtract(intervals: Iterable[Interval],
             cover: Iterable[Interval]) -> List[Interval]:
    """The parts of ``intervals`` NOT covered by ``cover`` (both merged
    first)."""
    out: List[Interval] = []
    cov = merge(cover)
    for t0, t1 in merge(intervals):
        cur = t0
        for c0, c1 in cov:
            if c1 <= cur:
                continue
            if c0 >= t1:
                break
            if c0 > cur:
                out.append((cur, c0))
            cur = max(cur, c1)
            if cur >= t1:
                break
        if cur < t1:
            out.append((cur, t1))
    return out


def exposed_s(comm: Iterable[Interval],
              overlap: Iterable[Interval]) -> float:
    """Exposed-communication time: seconds of ``comm`` not hidden
    behind ``overlap`` (staging/compute).  The T3 measure — a serial
    leg exposes everything (ratio 1.0); a perfectly pipelined one
    exposes only the protrusion past its staging."""
    return covered_s(subtract(comm, overlap))


def clip(iv: Interval, bound: Interval) -> Optional[Interval]:
    t0, t1 = max(iv[0], bound[0]), min(iv[1], bound[1])
    return (t0, t1) if t1 > t0 else None


# ---------------------------------------------------------------------------
# span trees
# ---------------------------------------------------------------------------


def interval_of(span: Dict[str, Any]) -> Interval:
    t0 = float(span.get("ts") or 0.0)
    return (t0, t0 + float(span.get("dur_us") or 0.0) / 1e6)


def build_trees(spans: Iterable[Dict[str, Any]],
                trace_id: Optional[str] = None):
    """``(roots, children)`` for one trace (or every trace when
    ``trace_id`` is None): ``children`` maps span id → child spans,
    start-ordered; a span whose parent is absent (evicted from the
    ring, lost to sampling, or remote) is treated as a root — partial
    evidence degrades to a forest, never an error."""
    mine = [s for s in spans
            if (trace_id is None or s.get("trace") == trace_id)
            and s.get("span") is not None]
    mine.sort(key=lambda s: float(s.get("ts") or 0.0))
    ids = {s["span"] for s in mine}
    children: Dict[str, List[dict]] = defaultdict(list)
    roots: List[dict] = []
    for s in mine:
        parent = s.get("parent")
        if parent in ids and parent != s["span"]:
            children[parent].append(s)
        else:
            roots.append(s)
    return roots, children


def self_time_s(span: Dict[str, Any], children: List[dict]) -> float:
    """A span's duration minus the union of its children's intervals
    (clipped to the span): the time the phase itself held, with every
    attributed sub-phase carved out.  Thread-parallel children (the
    pipeline's stage/stripe workers) union, so overlapped work is
    never double-subtracted."""
    iv = interval_of(span)
    kids = [c for c in (clip(interval_of(ch), iv) for ch in children)
            if c is not None]
    return max(0.0, (iv[1] - iv[0]) - covered_s(kids))


def coverage_of(span: Dict[str, Any], children: List[dict]) -> float:
    """Fraction of the span's wall-clock covered by its (clipped,
    unioned) direct children — the "attributed to named child phases"
    number the critical-path acceptance gates on.  1.0 for a leaf
    (everything is its own phase)."""
    iv = interval_of(span)
    dur = iv[1] - iv[0]
    if dur <= 0:
        return 1.0
    if not children:
        return 1.0
    kids = [c for c in (clip(interval_of(ch), iv) for ch in children)
            if c is not None]
    return min(1.0, covered_s(kids) / dur)


def phase_key(span: Dict[str, Any]) -> str:
    """The phase a span contributes to: its name, except hedge
    attempts split out so the serving breakdown separates "attempt"
    from "hedge"."""
    name = span.get("name", "?")
    if name == _ATTEMPT and (span.get("attrs") or {}).get("role") == \
            "hedge":
        return _ATTEMPT + ".hedge"
    return name


def _descend(span: dict, children: Dict[str, List[dict]], out: list,
             depth: int = 0) -> None:
    if depth > 64:  # defensive: ids are random, but evidence is input
        return
    out.append(span)
    for ch in children.get(span["span"], ()):
        _descend(ch, children, out, depth + 1)


def phase_rollup(root: dict,
                 children: Dict[str, List[dict]]) -> Dict[str, float]:
    """Per-phase SELF time (seconds) over the whole subtree of
    ``root``, keyed by :func:`phase_key`; the root's own uncovered time
    lands under ``<root-name> (self)``.  Within one thread the self
    times are disjoint; across threads they are WORK time (a stage
    worker and two stripe senders running concurrently sum past the
    wall-clock, exactly like cumulative CPU time in a profile) — which
    is what a share-of-work breakdown should weigh."""
    nodes: List[dict] = []
    _descend(root, children, nodes)
    out: Dict[str, float] = defaultdict(float)
    for s in nodes:
        self_s = self_time_s(s, children.get(s["span"], []))
        key = phase_key(s)
        if s is root:
            key = f"{key} (self)"
        out[key] += self_s
    return dict(out)


def critical_path(root: dict,
                  children: Dict[str, List[dict]]) -> List[dict]:
    """The dominant chain root → leaf: at every level, descend into
    the child covering the most of its parent (clipped).  Each hop
    reports its duration, share of the ROOT's wall-clock, self time,
    and how much of it the next level attributes (``coverage``)."""
    root_iv = interval_of(root)
    root_dur = max(root_iv[1] - root_iv[0], 1e-12)
    chain: List[dict] = []
    node = root
    seen: set = set()
    while True:
        # Corrupt evidence is expected input: a parent-id cycle (torn
        # writes, 4-byte span-id collisions across merged files) must
        # terminate the walk, not hang it — same guard as _descend.
        if node["span"] in seen or len(chain) > 64:
            return chain
        seen.add(node["span"])
        kids = children.get(node["span"], [])
        iv = interval_of(node)
        chain.append({
            "name": node.get("name", "?"),
            "span": node.get("span"),
            "dur_us": round((iv[1] - iv[0]) * 1e6, 1),
            "pct_of_root": round(
                min(1.0, (iv[1] - iv[0]) / root_dur) * 100, 1),
            "self_us": round(
                self_time_s(node, kids) * 1e6, 1),
            "coverage": round(coverage_of(node, kids), 4),
        })
        if not kids:
            return chain
        node = max(
            kids,
            key=lambda ch: (lambda c: c[1] - c[0] if c else 0.0)(
                clip(interval_of(ch), iv)),
        )


# ---------------------------------------------------------------------------
# the report-level analyzer
# ---------------------------------------------------------------------------


def _worst_root(roots: List[dict]) -> dict:
    return max(roots, key=lambda s: float(s.get("dur_us") or 0.0))


def analyze(spans: Iterable[Dict[str, Any]],
            shape_roots: Iterable[str] = SHAPE_ROOTS) -> Dict[str, Any]:
    """The fleet report's ``critical_path`` section: for every known
    request shape present in ``spans``, the per-phase self-time
    breakdown across ALL instances, the dominant phase, and the worst
    instance's critical path.  ``dominant_phase`` at the top level is
    the dominant phase of the largest shape (by aggregate wall-clock)
    — "where did this run's time go" in one key."""
    spans = [s for s in spans
             if isinstance(s, dict) and "span" in s and "name" in s]
    roots, children = build_trees(spans)
    by_name: Dict[str, List[dict]] = defaultdict(list)
    # A shape root need not be a TRACE root (dcn.pipeline hangs off
    # fleet.leg): index every span by name, not just the forest roots.
    for s in spans:
        by_name[s.get("name", "?")].append(s)
    shapes: Dict[str, Any] = {}
    for shape in shape_roots:
        instances = by_name.get(shape)
        if not instances:
            continue
        rollup: Dict[str, float] = defaultdict(float)
        total_s = 0.0
        cov_sum = 0.0
        for inst in instances:
            total_s += float(inst.get("dur_us") or 0.0) / 1e6
            cov_sum += coverage_of(inst,
                                   children.get(inst["span"], []))
            for key, sec in phase_rollup(inst, children).items():
                rollup[key] += sec
        attributed = sum(rollup.values()) or 1e-12
        phases = {
            key: {"self_ms": round(sec * 1e3, 3),
                  "pct": round(sec / attributed * 100, 1)}
            for key, sec in sorted(rollup.items(),
                                   key=lambda kv: -kv[1])
        }
        dominant = max(rollup, key=rollup.get)
        worst = _worst_root(instances)
        shapes[shape] = {
            "count": len(instances),
            "total_ms": round(total_s * 1e3, 3),
            "coverage": round(cov_sum / len(instances), 4),
            "phases": phases,
            "dominant_phase": dominant,
            "worst": {"trace": worst.get("trace"),
                      "dur_us": worst.get("dur_us")},
            "path": critical_path(worst, children),
        }
    dominant_phase = None
    if shapes:
        headline = next((s for s in HEADLINE_PRIORITY if s in shapes),
                        None)
        if headline is not None:
            dominant_phase = shapes[headline]["dominant_phase"]
        else:  # only unknown shapes: fall back to the largest
            biggest = max(shapes.values(),
                          key=lambda s: s["total_ms"])
            dominant_phase = biggest["dominant_phase"]
    return {
        "spans": len(spans),
        "traces": len({s.get("trace") for s in spans}),
        "shapes": shapes,
        "dominant_phase": dominant_phase,
    }
