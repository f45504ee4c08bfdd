"""Dependency-free span tracing for the node agents.

The self-healing layer made recovery *countable* (metrics/counters.py);
this makes it *traceable*: where does a slow or flapping transfer spend
its time?  A span records a named, monotonic-clocked interval with
attributes, a trace/span id pair, and a parent link taken from
thread-local context, so the DCN client's reconnect, the flow replay it
triggers, and the retried op that rode it all hang off one trace.

Spans land in two places:

- an in-memory **ring buffer** (always on, bounded) — the flight
  recorder (obs/flight.py) dumps its tail on SIGUSR1 or terminal
  failure;
- a **JSONL sink** when ``TPU_TRACE_FILE`` names a path — one JSON
  object per completed span, summarized offline by
  ``cmd/agent_trace.py`` the way ``cmd/trace_summary.py`` digests a
  trainer's profiler traces.

JSONL schema (one line per span)::

    {"trace": "9f2c…", "span": "a1b2…", "parent": "c3d4…"|null,
     "name": "dcn.send", "ts": 1722650000.123, "dur_us": 152.4,
     "status": "ok"|"error", "thread": "MainThread", "attrs": {...}}

``ts`` is wall-clock (correlation with logs/Prometheus scrapes);
``dur_us`` comes from the monotonic clock (immune to NTP steps).

Cross-process context: a trace is not bounded by one process.  A parent
process (the fleet coordinator, a test rig) exports
``TPU_TRACE_CONTEXT="<trace>:<span>"``; children call
:func:`attach_from_env` so their root spans join the parent's trace.
The DCN control protocol and the fleet data-plane frames carry the same
pair, so one cross-node transfer reads as ONE trace across every
process it touched (merge the JSONLs with ``cmd/agent_trace.py a.jsonl
b.jsonl --trace ID``).

Head sampling: ``TPU_TRACE_SAMPLE=<rate>`` (0.0–1.0) samples whole
traces into the JSONL sink by a deterministic hash of the trace id, so
every span of one trace — in every process, because the id travels —
shares a fate.  The in-memory ring is NOT sampled (the flight recorder
must always have the tail).  A malformed rate degrades to
sample-everything: a config typo must never blind a node agent.

Sink bounding: ``TPU_TRACE_MAX_BYTES`` caps the JSONL sink with a
size-triggered rotation — when the file passes the cap it is renamed
to ``<path>.1`` (ONE kept generation, the previous ``.1`` replaced)
and a fresh file is opened, so a long fleet/serving run can hold at
most ~2x the cap on disk.  Unset/0 means unbounded (the historical
behavior); a malformed value degrades to unbounded, and a failed
rotation disables rotation but never the sink.

Ring cursor: every recorded span gets a process-wide sequence number;
:func:`tail_since` returns the spans recorded after a cursor (bounded
by the ring) plus the new cursor and how many were evicted unseen —
what the MetricServer's ``/spans?since=`` endpoint and the fleet
telemetry span collector page through.

Kept stdlib-only, like metrics/counters.py, so utils/ and parallel/
import it without dragging in prometheus_client or grpc.  A sink write
failure is logged once and disables the sink — tracing must never take
down a node agent.
"""

import contextlib
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

TRACE_FILE_ENV = "TPU_TRACE_FILE"
RING_CAPACITY_ENV = "TPU_TRACE_RING"
TRACE_SAMPLE_ENV = "TPU_TRACE_SAMPLE"
TRACE_CONTEXT_ENV = "TPU_TRACE_CONTEXT"
TRACE_MAX_BYTES_ENV = "TPU_TRACE_MAX_BYTES"
DEFAULT_RING_CAPACITY = 512


class Span:
    """One named interval.  Mutable while active (annotate()); frozen
    into a dict when it finishes."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "attrs",
        "status", "ts", "_t0", "duration_s", "thread",
    )

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self.status = "ok"
        self.ts = time.time()
        self._t0 = time.monotonic()
        self.duration_s: float = 0.0
        self.thread = threading.current_thread().name

    def annotate(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace": self.trace_id,
            "span": self.span_id,
            "parent": self.parent_id,
            "name": self.name,
            "ts": round(self.ts, 6),
            "dur_us": round(self.duration_s * 1e6, 1),
            "status": self.status,
            "thread": self.thread,
            "attrs": self.attrs,
        }


def _env_int(name: str, default: int) -> int:
    """A malformed tuning knob degrades to the default — config typos
    must never take a node agent down (the TPU_FAULT_SPEC rule)."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        log.error("ignoring malformed %s=%r; using %d", name, raw, default)
        return default


_local = threading.local()  # .stack: List[Span] per thread
_lock = threading.Lock()  # ring + sink
_ring: "deque[Dict[str, Any]]" = deque(
    maxlen=_env_int(RING_CAPACITY_ENV, DEFAULT_RING_CAPACITY)
)
# Sink states: None = unresolved (consult env on next span), False =
# resolved-off, file object = resolved-on.
_sink = None
_sink_path: Optional[str] = None
# Sample rate: None = unresolved (consult env on next span).
_sample_rate: Optional[float] = None
# Sink rotation cap: None = unresolved, 0 = unbounded.
_max_bytes: Optional[int] = None
# Process-wide cursor: sequence number of the most recently recorded
# span (ring and sink share it; tail_since pages by it).
_seq = 0


def _new_id(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


def _resolve_sample_rate() -> float:
    """Parse TPU_TRACE_SAMPLE once.  Anything that is not a float in
    [0, 1] degrades to 1.0 (sample everything) — the TPU_FAULT_SPEC
    rule: a config typo must never blind a node agent."""
    global _sample_rate
    if _sample_rate is None:
        raw = os.environ.get(TRACE_SAMPLE_ENV)
        if raw is None:
            _sample_rate = 1.0
        else:
            try:
                rate = float(raw)
                if not 0.0 <= rate <= 1.0:
                    raise ValueError("rate outside [0, 1]")
                _sample_rate = rate
            except ValueError as e:
                log.error("ignoring malformed %s=%r (%s); sampling "
                          "everything", TRACE_SAMPLE_ENV, raw, e)
                _sample_rate = 1.0
    return _sample_rate


# Hash denominator for the head-sampling decision: the first 8 hex chars
# of the trace id interpreted as an integer, uniform over 32 bits.
_SAMPLE_MOD = 1 << 32


def sampled(trace_id: str) -> bool:
    """Head-sampling decision for a whole trace, deterministic by trace
    id — every span of the trace, in every process the id travels to,
    shares one fate.  Non-hex (foreign) ids sample in: losing evidence
    is worse than an oversized JSONL."""
    rate = _resolve_sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    try:
        return int(trace_id[:8], 16) < rate * _SAMPLE_MOD
    except (ValueError, TypeError):
        return True


def _stack() -> List[Span]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def current() -> Optional[Span]:
    """The active span on this thread, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def annotate(**attrs: Any) -> None:
    """Attach attributes to the active span; no-op without one (so
    instrumented leaf code never needs to know whether a caller
    traced it — faults.py uses this to stamp ``fault=<site>``)."""
    span = current()
    if span is not None:
        span.annotate(**attrs)


def _resolve_sink():
    """Open the JSONL sink from TPU_TRACE_FILE (lazily, once)."""
    global _sink, _sink_path
    if _sink is None:
        path = _sink_path or os.environ.get(TRACE_FILE_ENV)
        if not path:
            _sink = False
        else:
            try:
                _sink = open(path, "a", buffering=1)
                _sink_path = path
            except OSError as e:
                log.error("cannot open trace sink %s: %s; tracing to "
                          "ring buffer only", path, e)
                _sink = False
    return _sink


def _resolve_max_bytes() -> int:
    """Parse TPU_TRACE_MAX_BYTES once; <= 0 or malformed means
    unbounded (the TPU_FAULT_SPEC rule: a typo'd cap must not cost
    evidence)."""
    global _max_bytes
    if _max_bytes is None:
        _max_bytes = max(0, _env_int(TRACE_MAX_BYTES_ENV, 0))
    return _max_bytes


def _maybe_rotate(sink) -> None:
    """Size-capped sink rotation: past the cap, the live file becomes
    ``<path>.1`` (replacing any previous generation) and a fresh file
    opens.  Called under _lock.  A failed rotation disables rotation
    for this process — never the sink itself."""
    global _sink, _max_bytes
    cap = _resolve_max_bytes()
    if not cap or not _sink_path:
        return
    try:
        if sink.tell() < cap:
            return
        # Multi-writer guard: several processes may share one
        # TPU_TRACE_FILE path (fleet workers inherit the coordinator's
        # env).  Only the writer whose fd still IS the live path may
        # rename it — if another process rotated first, our fd now
        # points at the .1 generation, and renaming the path again
        # would clobber that process's fresh live file with it.  Skip
        # the rename and just reopen the live path instead.
        try:
            live = os.stat(_sink_path)
            fd = os.fstat(sink.fileno())
            owns_live = (fd.st_ino == live.st_ino
                         and fd.st_dev == live.st_dev)
        except OSError:
            owns_live = False  # path vanished: nothing to rename
        sink.close()
        if owns_live:
            os.replace(_sink_path, _sink_path + ".1")
        _sink = open(_sink_path, "a", buffering=1)
    except OSError as e:
        log.error("trace sink rotation of %s failed: %s; rotation "
                  "disabled (sink stays on)", _sink_path, e)
        _max_bytes = 0
        if _sink is None or _sink is False or _sink.closed:
            try:
                _sink = open(_sink_path, "a", buffering=1)
            except OSError as e2:
                log.error("trace sink reopen failed: %s; disabling "
                          "sink", e2)
                _sink = False


def _record(span: Span) -> None:
    d = span.to_dict()
    global _sink, _seq
    with _lock:
        # The ring is never sampled: the flight recorder's tail must
        # exist even at aggressive sink sampling rates.
        _ring.append(d)
        _seq += 1
        if not sampled(span.trace_id):
            return
        sink = _resolve_sink()
        if sink:
            try:
                sink.write(json.dumps(d) + "\n")
                _maybe_rotate(_sink)
            except (OSError, ValueError) as e:  # ValueError: closed file
                log.error("trace sink write failed: %s; disabling sink", e)
                _sink = False


@contextlib.contextmanager
def span(name: str, histogram: Optional[str] = None, **attrs: Any):
    """Open a span; it closes (and records) when the block exits.

    ``histogram=<op>`` additionally feeds the span's duration into
    ``obs.histo`` under that op — one call site, both surfaces.  An
    exception marks the span ``status="error"`` (with the repr in
    ``attrs.error``) and propagates untouched.
    """
    parent = current()
    s = Span(
        name,
        trace_id=parent.trace_id if parent else _new_id(8),
        span_id=_new_id(4),
        parent_id=parent.span_id if parent else None,
        attrs=dict(attrs),
    )
    stack = _stack()
    stack.append(s)
    try:
        yield s
    except BaseException as e:
        s.status = "error"
        s.attrs.setdefault("error", repr(e))
        raise
    finally:
        s.duration_s = time.monotonic() - s._t0
        stack.pop()
        _record(s)
        if histogram is not None:
            from container_engine_accelerators_tpu_torch.obs import histo

            # The span's own trace id rides along so the histogram
            # bucket can keep a trace exemplar for its worst sample.
            histo.observe(histogram, s.duration_s, trace_id=s.trace_id)


def event(name: str, **attrs: Any) -> None:
    """A zero-duration marker span (a point in the timeline — health
    transitions, announcements)."""
    with span(name, **attrs):
        pass


def record_span(name: str, duration_s: float,
                end_ts: Optional[float] = None,
                trace_id: Optional[str] = None,
                parent_id: Optional[str] = None,
                status: str = "ok", **attrs: Any) -> Span:
    """Record an already-measured interval as a completed span — for
    phases whose start and end were observed on DIFFERENT threads
    (serving queue wait: submitted on the caller's thread, cut on the
    batcher's), where no ``with span(...)`` block can bracket them.
    ``end_ts`` is the wall-clock end (now when None); trace/parent
    default to the calling thread's active span so recorded phases
    nest like live ones."""
    cur = current()
    s = Span(
        name,
        trace_id=trace_id or (cur.trace_id if cur else _new_id(8)),
        span_id=_new_id(4),
        parent_id=parent_id or (cur.span_id if cur else None),
        attrs=dict(attrs),
    )
    s.status = status
    s.duration_s = max(0.0, float(duration_s))
    s.ts = (end_ts if end_ts is not None else time.time()) \
        - s.duration_s
    _record(s)
    return s


@contextlib.contextmanager
def attach(trace_id: Optional[str], parent_span_id: Optional[str] = None):
    """Join a trace started elsewhere (another process, the far side of
    a DCN transfer): spans opened inside the block carry ``trace_id``
    and hang off ``parent_span_id``.  The placeholder itself is never
    recorded — the remote side already owns that span.  A falsy
    ``trace_id`` makes this a no-op, so protocol handlers can pass
    whatever the wire carried without checking."""
    if not trace_id:
        yield None
        return
    s = Span("remote", trace_id=str(trace_id),
             span_id=str(parent_span_id) if parent_span_id else _new_id(4),
             parent_id=None, attrs={})
    stack = _stack()
    stack.append(s)
    try:
        yield s
    finally:
        stack.pop()


def context() -> Optional[Dict[str, str]]:
    """The active (trace, span) pair as wire/env fields, or None.  What
    the DCN client stamps on control requests and the fleet daemon
    stamps on data-plane frames."""
    cur = current()
    if cur is None:
        return None
    return {"trace": cur.trace_id, "span": cur.span_id}


def context_env() -> Optional[str]:
    """The active context in TPU_TRACE_CONTEXT form ("<trace>:<span>"),
    for a coordinator exporting it to child processes."""
    cur = current()
    if cur is None:
        return None
    return f"{cur.trace_id}:{cur.span_id}"


def attach_from_env(env=None):
    """Context manager joining the trace named by TPU_TRACE_CONTEXT
    ("<trace>:<span>", set by the process that spawned us).  Unset or
    malformed values yield a no-op attach — a worker must boot with or
    without a coordinator."""
    env = env if env is not None else os.environ
    raw = env.get(TRACE_CONTEXT_ENV, "")
    trace_id, _, span_id = raw.partition(":")
    if raw and (not trace_id or not span_id or ":" in span_id):
        log.error("ignoring malformed %s=%r (want '<trace>:<span>')",
                  TRACE_CONTEXT_ENV, raw)
        trace_id = span_id = ""
    return attach(trace_id or None, span_id or None)


def tail(n: Optional[int] = None) -> List[Dict[str, Any]]:
    """The last ``n`` completed spans (all buffered ones when None),
    oldest first — what the flight recorder dumps."""
    with _lock:
        spans = list(_ring)
    return spans if n is None else spans[-n:]


def tail_since(cursor: int, limit: Optional[int] = None):
    """Cursor-paged ring read: ``(spans, next_cursor, dropped)`` where
    ``spans`` are the (oldest-first) spans recorded after ``cursor``
    that are still in the ring, ``next_cursor`` is what the caller
    passes next time, and ``dropped`` counts spans recorded after the
    cursor but already evicted (the ring outran the reader).  With
    ``limit``, at most that many are returned and the cursor advances
    only past them — nothing is silently skipped.  What the
    ``/spans?since=`` endpoint serves."""
    cursor = max(0, int(cursor))
    with _lock:
        last = _seq
        behind = max(0, last - cursor)
        avail = min(len(_ring), behind)
        dropped = behind - avail
        if limit is not None and avail > int(limit):
            take = max(0, int(limit))
            spans = list(_ring)[-avail:][:take]
            return spans, cursor + dropped + take, dropped
        spans = list(_ring)[-avail:] if avail else []
        return spans, last, dropped


def configure(path: Optional[str] = None,
              ring_capacity: Optional[int] = None) -> None:
    """Point the sink at ``path`` (None ⇒ re-resolve from env on next
    span) and optionally resize the ring.  Tests and long-lived agents
    rotating their trace file use this; plain processes just set
    ``TPU_TRACE_FILE`` before the first span."""
    global _sink, _sink_path, _ring, _sample_rate, _max_bytes
    with _lock:
        if _sink:
            try:
                _sink.close()
            except OSError:
                pass
        _sink = None
        _sink_path = path
        _sample_rate = None  # re-resolve TPU_TRACE_SAMPLE too
        _max_bytes = None  # re-resolve TPU_TRACE_MAX_BYTES too
        if ring_capacity is not None:
            _ring = deque(_ring, maxlen=ring_capacity)


def reset() -> None:
    """Drop buffered spans and forget the resolved sink, sample rate,
    and ring cursor (test isolation; the next span re-reads
    TPU_TRACE_FILE / TPU_TRACE_SAMPLE).  Production readers never see
    this — a live agent's cursor only moves forward."""
    global _sink, _sink_path, _sample_rate, _max_bytes, _seq
    with _lock:
        _ring.clear()
        _seq = 0
        if _sink:
            try:
                _sink.close()
            except OSError:
                pass
        _sink = None
        _sink_path = None
        _sample_rate = None
        _max_bytes = None
