"""Windowed time-series: ring-bucket rates and explicit gauges.

Counters (metrics/counters.py) and histograms (obs/histo.py) are
cumulative for the life of the process — the right contract for
Prometheus, useless for the question an operator actually asks when a
transfer stalls: what is this node doing NOW?  Forty million bytes
transferred since boot says nothing about whether the link moved a
byte in the last second.

This module closes that gap with two primitives, both stdlib-only like
the rest of obs/:

- **Series**: a ring of time buckets (``BUCKET_S`` seconds each,
  ``NUM_BUCKETS`` deep).  ``record(name, value)`` adds into the bucket
  the current moment falls in; ``rate(name, window_s)`` sums the
  buckets inside the window and divides — a per-second rate that
  decays to zero by construction when traffic stops (old buckets fall
  out of the window; nothing ever needs a background thread).  Every
  ``counters.inc`` feeds its series automatically, so every counter
  has a windowed rate for free (exported as ``agent_rate{event=...}``),
  and byte-valued series (``*.bytes``, ``goodput.*``) give bandwidth.

- **Gauges**: instantaneous values — in-flight chunks, active stripes,
  retransmit ratios, SLO verdicts — set or nudged directly
  (``gauge``/``gauge_add``), exported as ``agent_gauge{name=...}``.

Naming convention for series: counter names stay themselves
(``dcn.frames.deduped``); throughput series end in ``.bytes``
(``xferd.rx.bytes``); goodput series are
``goodput.<scope>.<name>`` with scope ``flow``/``link``/``node`` —
the MetricServer splits that prefix into the
``agent_goodput{scope=...,name=...}`` family.  Goodput means bytes
that LANDED usefully: dedup-dropped replays and link-eaten frames
never count.

Every function takes an optional ``now`` (monotonic seconds) so tests
drive the clock instead of sleeping through real windows.
"""

import os
import threading
import time
from typing import Dict, List, Optional, Tuple

BUCKET_S = 1.0
NUM_BUCKETS = 64  # ~64s of history; windows beyond that clamp
RATE_WINDOW_ENV = "TPU_RATE_WINDOW_S"
DEFAULT_WINDOW_S = 10.0

# Series names are unbounded in principle (per-flow goodput names are
# unique per transfer), so the registry self-prunes: once it holds more
# than MAX_SERIES entries, creating a series evicts every series whose
# last traffic fell out of the ring entirely (at most once per bucket
# epoch, so a creation storm cannot turn every insert into a rescan).
# A stopped flow therefore exports an explicit 0.0 for a full ring
# span (~NUM_BUCKETS seconds — long enough for any scraper to see it
# die), then vanishes instead of leaking memory and label cardinality.
# HARD_MAX_SERIES is the true bound for a storm of still-live names:
# past it, the oldest quarter is evicted outright — losing tail series
# under pathological churn beats unbounded exporter cardinality.
MAX_SERIES = 512
HARD_MAX_SERIES = 4 * MAX_SERIES

GOODPUT_PREFIX = "goodput."

_lock = threading.Lock()


class _Series:
    __slots__ = ("sums", "epochs")

    def __init__(self):
        self.sums: List[float] = [0.0] * NUM_BUCKETS
        # Which absolute bucket epoch each slot currently holds; a slot
        # whose epoch is stale is logically empty (lazily recycled).
        self.epochs: List[int] = [-1] * NUM_BUCKETS


_series: Dict[str, _Series] = {}
_gauges: Dict[str, float] = {}
_last_prune_epoch = -1


def default_window_s() -> float:
    """Export window, env-tunable; malformed values degrade to the
    default (the TPU_FAULT_SPEC rule)."""
    raw = os.environ.get(RATE_WINDOW_ENV)
    if raw is None:
        return DEFAULT_WINDOW_S
    try:
        w = float(raw)
        if not w > 0:
            raise ValueError("window must be > 0")
        return min(w, NUM_BUCKETS * BUCKET_S)
    except ValueError:
        return DEFAULT_WINDOW_S


def _prune_locked(epoch: int) -> None:
    """Evict stale (then, under a storm, oldest) series; caller holds
    the lock.  Stale pruning runs at most once per bucket epoch; the
    hard-cap eviction amortizes by dropping a whole quarter at once."""
    global _last_prune_epoch
    if epoch != _last_prune_epoch:
        _last_prune_epoch = epoch
        floor = epoch - NUM_BUCKETS
        for name in [n for n, s in _series.items()
                     if max(s.epochs) < floor]:
            del _series[name]
    if len(_series) >= HARD_MAX_SERIES:
        by_age = sorted(_series, key=lambda n: max(_series[n].epochs))
        for name in by_age[:HARD_MAX_SERIES // 4]:
            del _series[name]


def record(name: str, value: float = 1.0,
           now: Optional[float] = None) -> None:
    """Add ``value`` into ``name``'s current time bucket (series
    created on first record)."""
    now = time.monotonic() if now is None else now
    epoch = int(now / BUCKET_S)
    idx = epoch % NUM_BUCKETS
    with _lock:
        s = _series.get(name)
        if s is None:
            if len(_series) >= MAX_SERIES:
                _prune_locked(epoch)
            s = _series[name] = _Series()
        if s.epochs[idx] != epoch:
            s.sums[idx] = 0.0
            s.epochs[idx] = epoch
        s.sums[idx] += value


def _rate_locked(s: _Series, floor: int, epoch: int,
                 window_s: float) -> float:
    return sum(s.sums[i] for i in range(NUM_BUCKETS)
               if floor <= s.epochs[i] <= epoch) / window_s


def _window_bounds(window_s: Optional[float],
                   now: Optional[float]):
    window_s = default_window_s() if window_s is None else window_s
    window_s = max(BUCKET_S, min(window_s, NUM_BUCKETS * BUCKET_S))
    now = time.monotonic() if now is None else now
    epoch = int(now / BUCKET_S)
    floor = epoch - int(window_s / BUCKET_S) + 1
    return window_s, epoch, floor


def rate(name: str, window_s: Optional[float] = None,
         now: Optional[float] = None) -> float:
    """Per-second rate of ``name`` over the trailing window (0.0 for an
    unknown series — an absent series and an idle one look the same,
    which is exactly what a dashboard wants)."""
    window_s, epoch, floor = _window_bounds(window_s, now)
    with _lock:
        s = _series.get(name)
        if s is None:
            return 0.0
        return _rate_locked(s, floor, epoch, window_s)


def rates(window_s: Optional[float] = None,
          now: Optional[float] = None) -> Dict[str, float]:
    """Every known series' windowed rate (idle series report 0.0 —
    a stopped flow must scrape as zero, not vanish).  One clock
    reading and one lock hold for the whole snapshot, so every series
    on a scrape is judged against the SAME window."""
    window_s, epoch, floor = _window_bounds(window_s, now)
    with _lock:
        return {name: _rate_locked(s, floor, epoch, window_s)
                for name, s in _series.items()}


def gauge(name: str, value: float) -> None:
    """Set an explicit instantaneous gauge."""
    with _lock:
        _gauges[name] = float(value)


def gauge_add(name: str, delta: float) -> float:
    """Nudge a gauge (created at 0); returns the new value.  The
    in-flight-count idiom: +1 on dispatch, -1 on settle."""
    with _lock:
        value = _gauges.get(name, 0.0) + delta
        _gauges[name] = value
        return value


def gauges() -> Dict[str, float]:
    with _lock:
        return dict(_gauges)


def split_goodput(name: str) -> Optional[Tuple[str, str]]:
    """``goodput.<scope>.<rest>`` -> (scope, rest), None for anything
    else — the exporter's one parsing rule."""
    if not name.startswith(GOODPUT_PREFIX):
        return None
    rest = name[len(GOODPUT_PREFIX):]
    scope, _, ident = rest.partition(".")
    if not scope or not ident:
        return None
    return scope, ident


def snapshot(window_s: Optional[float] = None,
             now: Optional[float] = None) -> Dict[str, dict]:
    """One blob for the flight recorder / fleet aggregator:
    ``{"window_s": w, "rates": {name: per_s}, "gauges": {name: v}}``."""
    window_s = default_window_s() if window_s is None else window_s
    return {
        "window_s": window_s,
        "rates": rates(window_s, now),
        "gauges": gauges(),
    }


def least_squares_slope(points) -> float:
    """Ordinary-least-squares slope of ``(x, y)`` pairs — the windowed
    trend gate behind the soak world's leak sentinel (fleet/soak.py):
    a resource series whose fitted slope exceeds its per-window budget
    is a leak, whatever its instantaneous wobble.  Fewer than two
    points, or zero x-variance, judge nothing and return 0.0."""
    pts = [(float(x), float(y)) for x, y in points]
    n = len(pts)
    if n < 2:
        return 0.0
    mean_x = sum(x for x, _ in pts) / n
    mean_y = sum(y for _, y in pts) / n
    var_x = sum((x - mean_x) ** 2 for x, _ in pts)
    if var_x <= 0.0:
        return 0.0
    cov = sum((x - mean_x) * (y - mean_y) for x, y in pts)
    return cov / var_x


def reset() -> None:
    """Drop every series and gauge — test isolation only, same contract
    as counters.reset()."""
    global _last_prune_epoch
    with _lock:
        _series.clear()
        _gauges.clear()
        _last_prune_epoch = -1
