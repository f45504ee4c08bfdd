"""Lock-protected log2-bucket latency histograms.

Flat counters (metrics/counters.py) say *how often* the self-healing
paths fire; these say *how long* they take — the difference between "40
reconnects" and "40 reconnects, p99 3.1s" is the difference between a
blip and a flapping link.  Durations are bucketed by the power of two
of their microsecond value (``2^k us`` upper bounds), so the whole
histogram is a handful of integers per op: cheap enough for the DCN
hot path, exact enough for order-of-magnitude percentiles.

The MetricServer exports the registry as the
``agent_latency{op=...,bucket=...}`` gauge family (cumulative
Prometheus-style ``le`` buckets in microseconds, plus ``+Inf`` = total
count) next to ``agent_events``; ``snapshot()``/``percentile()`` serve
in-process consumers (the flight recorder, bench p50/p99 reporting).

**Trace exemplars**: each bucket additionally remembers the trace id
of its worst (longest) sample, so a histogram is never a dead end —
the scrape's ``agent_exemplar{op,bucket,trace}`` row names the exact
trace whose JSONL tree explains the tail
(``cmd/agent_trace.py --exemplar <op>``).  ``obs.trace.span(...,
histogram=op)`` wires the id through automatically; direct
``observe()`` callers may pass ``trace_id`` themselves or leave the
bucket exemplar-less.

Stdlib-only, like the rest of obs/: importable from utils/ and
parallel/ without prometheus_client.
"""

import threading
from typing import Dict, Iterable, List, Optional, Tuple

_lock = threading.Lock()


class _Histo:
    __slots__ = ("buckets", "count", "sum_s", "exemplars")

    def __init__(self):
        self.buckets: Dict[int, int] = {}  # exponent k -> count (le 2^k us)
        self.count = 0
        self.sum_s = 0.0
        # exponent k -> (trace_id, worst duration s) for that bucket
        self.exemplars: Dict[int, Tuple[str, float]] = {}


_registry: Dict[str, _Histo] = {}


def bucket_le_us(seconds: float) -> int:
    """The log2 bucket a duration falls into: the smallest ``2^k``
    microseconds >= the duration (sub-microsecond clamps to 1us)."""
    us = int(seconds * 1e6)
    if us <= 1:
        return 1
    return 1 << (us - 1).bit_length()


def observe(op: str, seconds: float,
            trace_id: Optional[str] = None) -> None:
    """Record one duration for ``op`` (created on first observation).
    With ``trace_id`` set, the sample competes for its bucket's
    exemplar slot: the bucket keeps the id of its WORST sample."""
    le = bucket_le_us(seconds)
    exp = le.bit_length() - 1
    with _lock:
        h = _registry.get(op)
        if h is None:
            h = _registry[op] = _Histo()
        h.buckets[exp] = h.buckets.get(exp, 0) + 1
        h.count += 1
        h.sum_s += seconds
        if trace_id is not None:
            worst = h.exemplars.get(exp)
            if worst is None or seconds > worst[1]:
                h.exemplars[exp] = (trace_id, seconds)


def snapshot() -> Dict[str, dict]:
    """Point-in-time copy: ``{op: {count, sum_us, buckets{le_us: n},
    exemplars{le_us: {trace, dur_us}}}}`` with non-cumulative
    per-bucket counts (the exporter accumulates)."""
    with _lock:
        return {
            op: {
                "count": h.count,
                "sum_us": round(h.sum_s * 1e6, 1),
                "buckets": {
                    str(1 << exp): n
                    for exp, n in sorted(h.buckets.items())
                },
                "exemplars": {
                    str(1 << exp): {"trace": t,
                                    "dur_us": round(d * 1e6, 1)}
                    for exp, (t, d) in sorted(h.exemplars.items())
                },
            }
            for op, h in _registry.items()
        }


def exemplar(op: str) -> Optional[Tuple[str, float]]:
    """The op's overall worst sample as ``(trace_id, seconds)`` — the
    one-hop answer to "which trace blew the p99?".  None for an
    unknown op or one whose observations carried no trace id."""
    with _lock:
        h = _registry.get(op)
        if h is None or not h.exemplars:
            return None
        return max(h.exemplars.values(), key=lambda td: td[1])


def percentile(op: str, q: float) -> Optional[float]:
    """Upper-bound estimate of the ``q``-quantile (0 < q <= 1) in
    seconds: the bucket boundary at which the cumulative count reaches
    ``q * count``.  None for an unknown/empty op."""
    with _lock:
        h = _registry.get(op)
        if h is None or h.count == 0:
            return None
        target = q * h.count
        seen = 0
        for exp in sorted(h.buckets):
            seen += h.buckets[exp]
            if seen >= target:
                return (1 << exp) / 1e6
        return (1 << max(h.buckets)) / 1e6  # pragma: no cover — q <= 1


def percentiles(op: str, qs: Iterable[float]) -> List[Optional[float]]:
    return [percentile(op, q) for q in qs]


def delta_percentile_us(op: str, baseline: Dict[str, int],
                        q: float) -> Optional[float]:
    """Upper-bound ``q``-quantile in µs of the observations made
    SINCE ``baseline`` (a ``snapshot()[op]['buckets']`` mapping taken
    earlier).  The registry is process-global and cumulative, so
    anything judging one run/lifetime — fleet SLOs, the serving
    frontend's adaptive hedge deadline — must quantile the delta, not
    the whole process history.  None when nothing was observed since
    the baseline."""
    now = snapshot().get(op, {}).get("buckets", {})
    delta = {int(le): n - baseline.get(le, 0)
             for le, n in now.items()
             if n - baseline.get(le, 0) > 0}
    total = sum(delta.values())
    if not total:
        return None
    target = q * total
    seen = 0
    for le in sorted(delta):
        seen += delta[le]
        if seen >= target:
            return float(le)
    return float(max(delta))  # pragma: no cover — q <= 1


def reset() -> None:
    """Drop every histogram — test isolation only; production
    histograms are cumulative for the agent's life, like counters."""
    with _lock:
        _registry.clear()
