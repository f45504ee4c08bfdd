"""Continuous stack-sampling profiler: where does the CPU go?

The critical-path engine (obs/critpath.py) answers "where did the wall
time go" per phase, and the exposed-communication accounting says how
much DCN time hides behind staging — but neither can attribute a
single CPU-second to a line of code.  This module does: it names the
code where a node agent's threads spend their samples.

A timer thread wakes at ``TPU_PROF_HZ`` (default ~67 Hz — off the
100 Hz harmonic most periodic work sits on), walks
``sys._current_frames()``, folds each thread's stack into one
semicolon-joined line (root first — the flamegraph collapsed format),
and classifies it by a **subsystem map**:

- ``shm-staging``  — any first-party frame in ``parallel/dcn_shm.py``
  or whose function name contains ``shm`` (the staging memcpy, the
  read-out copy, ring post/poll, segment land/commit);
- ``dcn_pipeline`` — the chunked/striped client data plane
  (``parallel/dcn_pipeline.py`` / ``dcn.py`` / ``dcn_client.py`` /
  ``dcn_tune.py``);
- ``xferd``        — the PyXferd daemon (``fleet/xferd.py``);
- ``serving``      — the serving frontend/breakers (``serving/``);
- ``idle``         — the idle-vs-GIL heuristic: a leaf frame parked in
  a *stdlib* waiter (``threading.wait``, ``queue.get``,
  ``selectors.select``, socket ``accept``/``readinto``, …) is a thread
  burning nothing.  A wall-clock sampler cannot see the GIL, so a
  thread blocked inside a first-party function (e.g. ``netio`` socket
  IO mid-chunk) stays attributed to its subsystem — that IS the
  socket-IO share;
- ``other``        — everything else (bench drivers, coordinator glue).

Aggregation is **bounded**: at most ``MAX_STACKS`` distinct folded
stacks are held; admitting a new stack past the cap evicts the
coldest quarter (smallest count, oldest last-seen) and their samples
are counted in ``prof.dropped`` — never silently lost.  Snapshot /
reset semantics mirror ``obs/timeseries.py``; every aggregated sample
bumps a process-wide cursor, so ``scrape(since=<cursor>)`` returns
only the stacks that changed — what the MetricServer's ``/profile``
endpoint serves and the fleet aggregator pages.

Overhead is accounted, not assumed: the sampler times its own passes
and publishes the cumulative ``prof.overhead_ratio`` gauge (sampling
seconds / wall seconds since the sampler started).

Kill switch ``TPU_PROF=0`` disables ``start()`` entirely; a malformed
``TPU_PROF_HZ`` degrades to the default (the TPU_FAULT_SPEC rule).
The sampler takes NO first-party lock while walking frames: the walk
and fold run lock-free, and only the finished fold list is folded
into the registry under the module lock.

Stdlib-only, like the rest of obs/.
"""

import json
import logging
import os
import sys
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries

log = logging.getLogger(__name__)

PROF_ENV = "TPU_PROF"          # "0" = kill switch (default: enabled)
HZ_ENV = "TPU_PROF_HZ"         # sampling rate; malformed -> default
DEFAULT_HZ = 67.0
MIN_HZ, MAX_HZ = 1.0, 1000.0

# Bounded aggregation: distinct folded stacks held at once, frames
# folded per stack, and the /profile response bounds.
MAX_STACKS = 256
MAX_DEPTH = 48
SCRAPE_DEFAULT_LIMIT = 64
SCRAPE_MAX_LIMIT = 512

SUBSYSTEMS = ("shm-staging", "dcn_pipeline", "xferd", "serving",
              "idle", "other")

# The idle-vs-GIL heuristic's stdlib waiter leaves: a thread whose
# innermost frame is one of these, in a NON-first-party file, is
# parked, not computing.
IDLE_FUNCS = frozenset((
    "wait", "_wait_for_tstate_lock", "get", "select", "poll",
    "accept", "acquire", "readinto", "readline", "_try_wait",
    "_recv_msg", "read",
))

_PKG_PREFIX = os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))).replace(os.sep, "/") + "/"

_DCN_PIPELINE_FILES = frozenset((
    "parallel/dcn_pipeline.py", "parallel/dcn.py",
    "parallel/dcn_client.py", "parallel/dcn_tune.py",
))


class _Stack:
    __slots__ = ("count", "subsystem", "seq")

    def __init__(self, subsystem: str):
        self.count = 0
        self.subsystem = subsystem
        self.seq = 0


_lock = threading.Lock()
_stacks: Dict[str, _Stack] = {}
_subsystems: Dict[str, int] = {}
_samples = 0          # total thread-stacks aggregated (the cursor)
_dropped = 0          # samples lost to LRU eviction
_sample_time_s = 0.0  # cumulative time spent inside sampling passes
_started_mono: Optional[float] = None
_thread: Optional[threading.Thread] = None
_stop_event: Optional[threading.Event] = None


# -- knobs -------------------------------------------------------------------


def enabled(env=None) -> bool:
    """The ``TPU_PROF`` kill switch (default on — the profiler is a
    low-rate always-on surface, like the span ring)."""
    env = os.environ if env is None else env
    raw = str(env.get(PROF_ENV, "1")).strip().lower()
    return raw not in ("0", "false", "off", "no")


def resolve_hz(env=None) -> float:
    """``TPU_PROF_HZ``, clamped to [1, 1000]; malformed or
    non-positive values degrade to the default (the TPU_FAULT_SPEC
    rule: a config typo must never blind — or stampede — an agent)."""
    env = os.environ if env is None else env
    raw = env.get(HZ_ENV)
    if raw is None:
        return DEFAULT_HZ
    try:
        hz = float(raw)
        if not hz > 0:
            raise ValueError("rate must be > 0")
    except ValueError:
        log.error("ignoring malformed %s=%r; using %g", HZ_ENV, raw,
                  DEFAULT_HZ)
        return DEFAULT_HZ
    return min(max(hz, MIN_HZ), MAX_HZ)


# -- fold + classify (lock-free: runs while walking frames) ------------------


def classify(frames: List[Tuple[Optional[str], str]]) -> str:
    """Subsystem for one stack, ``frames`` leaf-first as
    ``(package-relative path or None, function name)``.  The leaf
    decides idle (stdlib waiter = parked thread).  Otherwise a stack
    passing through the shm machinery ANYWHERE is ``shm-staging`` —
    the shm code lives inside the pipeline and daemon modules, and
    its leaf-side helpers (control ops, span plumbing) would
    otherwise steal its samples; among the rest, the innermost
    matching first-party frame wins."""
    if frames:
        rel, func = frames[0]
        if rel is None and func in IDLE_FUNCS:
            return "idle"
    first = None
    for rel, func in frames:
        if rel is None:
            continue
        if rel == "parallel/dcn_shm.py" or "shm" in func:
            return "shm-staging"
        if first is None:
            if rel in _DCN_PIPELINE_FILES:
                first = "dcn_pipeline"
            elif rel == "fleet/xferd.py":
                first = "xferd"
            elif rel.startswith("serving/"):
                first = "serving"
    return first or "other"


def fold(frame) -> Tuple[str, str]:
    """One thread's stack as ``(folded, subsystem)``: the folded form
    is root-first, semicolon-joined ``module.function`` labels — the
    flamegraph collapsed format, ready for ``flamegraph.pl`` via
    ``agent_prof --folded``."""
    frames: List[Tuple[Optional[str], str]] = []
    labels: List[str] = []
    f = frame
    while f is not None and len(frames) < MAX_DEPTH:
        code = f.f_code
        fn = code.co_filename.replace(os.sep, "/")
        func = code.co_name
        rel: Optional[str] = None
        if fn.startswith(_PKG_PREFIX):
            rel = fn[len(_PKG_PREFIX):]
            mod = rel[:-3] if rel.endswith(".py") else rel
            labels.append(mod.replace("/", ".") + "." + func)
        else:
            base = fn.rsplit("/", 1)[-1]
            if base.endswith(".py"):
                base = base[:-3]
            labels.append(base + "." + func)
        frames.append((rel, func))
        f = f.f_back
    labels.reverse()
    return ";".join(labels), classify(frames)


# Fold cache: most threads are parked on the same stack tick after
# tick, so folding is memoized by the stack's code-object tuple (the
# stack's identity at function granularity — strong refs keep ids
# stable).  Plain dict, GIL-atomic get/set, cleared wholesale past the
# cap; read/written only from the sampling pass, never under _lock.
_fold_cache: Dict[tuple, Tuple[str, str]] = {}
_FOLD_CACHE_MAX = 2048


def _fold_cached(frame) -> Tuple[str, str]:
    codes = []
    f = frame
    while f is not None and len(codes) < MAX_DEPTH:
        codes.append(f.f_code)
        f = f.f_back
    key = tuple(codes)
    hit = _fold_cache.get(key)
    if hit is not None:
        return hit
    result = fold(frame)
    if len(_fold_cache) >= _FOLD_CACHE_MAX:
        _fold_cache.clear()
    _fold_cache[key] = result
    return result


# -- aggregation -------------------------------------------------------------


def _evict_locked() -> int:
    """Make room for a new stack: drop the coldest quarter (smallest
    count, ties oldest last-seen) and return how many samples they
    held — the caller counts them dropped, never silently gone."""
    victims = sorted(_stacks.items(),
                     key=lambda kv: (kv[1].count, kv[1].seq))
    victims = victims[:max(1, MAX_STACKS // 4)]
    gone = 0
    for name, entry in victims:
        gone += entry.count
        del _stacks[name]
    return gone


def _ingest_locked(folded: str, subsystem: str, n: int) -> int:
    """Fold ``n`` samples of one stack into the registry; caller
    holds the lock.  Returns samples evicted to make room."""
    global _samples
    dropped = 0
    _samples += n
    _subsystems[subsystem] = _subsystems.get(subsystem, 0) + n
    entry = _stacks.get(folded)
    if entry is None:
        if len(_stacks) >= MAX_STACKS:
            dropped = _evict_locked()
        entry = _stacks[folded] = _Stack(subsystem)
    entry.count += n
    entry.seq = _samples
    return dropped


def sample_once() -> int:
    """One sampling pass over every OTHER thread's current stack;
    returns how many thread-stacks were aggregated.  The frame walk
    and fold run with NO lock held (first-party or otherwise); only
    the finished fold list touches the registry."""
    global _dropped, _sample_time_s, _started_mono
    # The wall clock starts when the FIRST pass starts, before its fold:
    # the pass's own time then counts in the elapsed time too, and the
    # ratio cannot pass 1 (the JAX module starts it after the fold).
    start_mono = time.monotonic()
    t0 = time.perf_counter()
    me = threading.get_ident()
    folds = [_fold_cached(frame)
             for ident, frame in sys._current_frames().items()
             if ident != me]
    dropped_now = 0
    with _lock:
        if _started_mono is None:
            _started_mono = start_mono
        for folded, subsystem in folds:
            dropped_now += _ingest_locked(folded, subsystem, 1)
        _dropped += dropped_now
        _sample_time_s += time.perf_counter() - t0
        ratio = _overhead_ratio_locked()
    if folds:
        counters.inc("prof.samples", len(folds))
    if dropped_now:
        counters.inc("prof.dropped", dropped_now)
    if ratio is not None:
        timeseries.gauge("prof.overhead_ratio", ratio)
    return len(folds)


def ingest(folded: str, subsystem: str, n: int = 1) -> None:
    """Seed the registry with pre-folded samples — demo tours and
    merge tooling; does NOT claim real sampling happened (the
    ``prof.*`` counters are untouched)."""
    global _dropped
    sub = subsystem if subsystem in SUBSYSTEMS else "other"
    with _lock:
        _dropped += _ingest_locked(folded, sub, max(1, int(n)))


def _overhead_ratio_locked() -> Optional[float]:
    if _started_mono is None:
        return None
    elapsed = time.monotonic() - _started_mono
    if elapsed <= 0:
        return None
    return _sample_time_s / elapsed


# -- read side ---------------------------------------------------------------


def _payload_locked(rows: List[Tuple[str, str, int]],
                    cursor: int) -> dict:
    ratio = _overhead_ratio_locked()
    return {
        "cursor": cursor,
        "samples": _samples,
        "dropped": _dropped,
        "hz": resolve_hz(),
        "running": _thread is not None and _thread.is_alive(),
        "overhead_ratio": (round(ratio, 6)
                           if ratio is not None else None),
        "subsystems": dict(_subsystems),
        "stacks": [{"stack": n, "subsystem": s, "count": c}
                   for n, s, c in rows],
    }


def scrape(since: int = 0, limit: Optional[int] = None) -> dict:
    """The ``/profile`` response body: cumulative totals plus every
    stack whose count changed after the ``since`` cursor,
    oldest-change first.  When ``limit`` truncates the page, the
    returned ``cursor`` advances only past what was actually returned
    (the ``/spans`` contract: nothing is silently skipped — the next
    page picks up the rest); an unchanged registry scrapes as an
    empty ``stacks`` list."""
    since = max(0, int(since))
    with _lock:
        changed = sorted((e.seq, name, e.subsystem, e.count)
                         for name, e in _stacks.items()
                         if e.seq > since)
        cursor = _samples
        if limit is not None and len(changed) > max(0, int(limit)):
            changed = changed[:max(0, int(limit))]
            cursor = changed[-1][0] if changed else since
        return _payload_locked(
            [(n, s, c) for _seq, n, s, c in changed], cursor)


def snapshot(top: Optional[int] = None) -> dict:
    """Point-in-time copy of the whole registry, count-descending
    (``top`` caps the stack rows) — same contract as
    ``timeseries.snapshot``; the display-ordered sibling of the
    cursor-paged :func:`scrape`."""
    with _lock:
        rows = sorted(((name, e.subsystem, e.count)
                       for name, e in _stacks.items()),
                      key=lambda r: (-r[2], r[0]))
        if top is not None:
            rows = rows[:max(0, int(top))]
        return _payload_locked(rows, _samples)


def fetch(url: str, timeout_s: float = 10.0) -> dict:
    """One GET of a ``/profile`` endpoint -> the parsed body dict —
    the ONE wire fetcher every consumer (agent_top's hotspot panel,
    agent_prof, fleet telemetry) shares.  Raises OSError/ValueError
    on transport or parse trouble; callers own their degradation."""
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        obj = json.loads(resp.read().decode("utf-8", "replace"))
    if not isinstance(obj, dict):
        raise ValueError("profile body is not a JSON object")
    return obj


def summary(top: int = 10) -> dict:
    """The flight recorder's compact slice: totals, the subsystem
    rollup, and the top-N stacks — where every thread was stuck."""
    snap = snapshot(top=top)
    return {
        "samples": snap["samples"],
        "dropped": snap["dropped"],
        "overhead_ratio": snap["overhead_ratio"],
        "subsystems": snap["subsystems"],
        "top": snap["stacks"],
    }


def subsystem_shares(baseline: Optional[Dict[str, int]] = None,
                     include_idle: bool = False) -> Dict[str, float]:
    """Per-subsystem sample shares, optionally as a delta against an
    earlier ``snapshot()['subsystems']`` (the per-cell attribution
    ``dcn_bench`` records).  Idle samples are excluded by default —
    a parked thread pool would otherwise drown every busy share."""
    with _lock:
        subs = dict(_subsystems)
    if baseline:
        subs = {k: v - baseline.get(k, 0) for k, v in subs.items()}
    subs = {k: v for k, v in subs.items()
            if v > 0 and (include_idle or k != "idle")}
    total = sum(subs.values())
    if not total:
        return {}
    return {k: v / total for k, v in subs.items()}


# -- lifecycle ---------------------------------------------------------------


def _loop(stop: threading.Event, interval: float) -> None:
    while not stop.wait(interval):
        try:
            sample_once()
        except Exception as e:  # noqa: BLE001 — sampler never kills host
            log.error("profiler sampling pass failed: %s", e)


def running() -> bool:
    return _thread is not None and _thread.is_alive()


def start(hz: Optional[float] = None) -> bool:
    """Arm the sampling thread (idempotent); returns whether the
    sampler is running afterwards.  ``TPU_PROF=0`` makes this a
    documented no-op — the one-knob kill switch."""
    global _thread, _stop_event, _started_mono
    if not enabled():
        return False
    rate = resolve_hz() if hz is None else min(max(float(hz), MIN_HZ),
                                               MAX_HZ)
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        if _started_mono is None:
            _started_mono = time.monotonic()
        stop_event = threading.Event()
        t = threading.Thread(target=_loop,
                             args=(stop_event, 1.0 / rate),
                             name="tpu-prof", daemon=True)
        _stop_event, _thread = stop_event, t
        # Started under the lock: a concurrent start() must observe
        # this thread as alive, or it would overwrite the globals and
        # leak an unstoppable duplicate sampler.
        t.start()
    return True


def stop() -> None:
    """Park the sampler; the aggregate registry stays readable."""
    global _thread, _stop_event
    with _lock:
        t, ev = _thread, _stop_event
        _thread = _stop_event = None
    if ev is not None:
        ev.set()
    if t is not None and t.is_alive():
        t.join(timeout=2.0)


def reset() -> None:
    """Stop the sampler and drop every aggregate — test isolation
    only, same contract as ``timeseries.reset()``."""
    global _samples, _dropped, _sample_time_s, _started_mono
    stop()
    _fold_cache.clear()
    with _lock:
        _stacks.clear()
        _subsystems.clear()
        _samples = 0
        _dropped = 0
        _sample_time_s = 0.0
        _started_mono = None
