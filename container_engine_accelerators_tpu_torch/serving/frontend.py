"""ServingFrontend: admission control, batching, hedged retries.

The port's copy of ``container_engine_accelerators_tpu/serving/frontend.py``
(host code: no torch): the same names, counters and spans byte for byte.

The fleet rig proves bytes survive chaos; this module is the layer
that makes *requests* survive it — the front end production puts
between millions of users and a fleet of accelerator nodes.  It is
robust by construction, not by retry-harder:

- **admission control**: a bounded queue.  A full queue REJECTS
  (``RequestShed``, ``serving.shed``) instead of buffering without
  bound — reject-over-collapse: the requests already admitted keep
  their latency budget, and the queue-depth gauge
  (``serving.queue.depth``) tells the operator load is being turned
  away *before* p99 melts.

- **batching**: a cutter thread groups admitted requests into batches
  of at most ``max_batch``, waiting at most ``max_wait_ms`` for the
  batch to fill — the continuous-batching trade (throughput from
  batching, bounded added latency from the cutter) applied to the
  dispatch path.

- **hedged retries**: each batch dispatches to one node; if no
  response lands by the hedge deadline (``hedge_after_ms``, or
  adaptively the ``hedge_percentile`` of observed attempt latency —
  the tail-at-scale recipe), a backup attempt launches on a SECOND
  node (``serving.hedge.fired``).  First response wins; the loser's
  in-flight work is cancelled cooperatively at its next phase
  boundary, and per-request-id dedup guarantees exactly one delivery
  even when both attempts land (``serving.hedge.won`` /
  ``serving.hedge.wasted``, duplicate results counted as
  ``serving.dedup.dropped``).

- **breakers + failover**: every attempt consults the per-node
  :class:`~container_engine_accelerators_tpu_torch.serving.breaker.
  NodeBreaker`; a node that keeps failing is ejected and probed back
  in.  Within one attempt sequence, failures fail over to the next
  allowed node under a bounded ``attempts`` budget.

The default execution path is a **cross-node shard read** on the DCN
data plane: the batch payload is staged on a shard-home node and
streamed to the serving node through its daemon — every hop rides a
pooled production ``ResilientDcnXferClient``, so daemon kills, rack
partitions, link loss, and slow links exercise this stack end to end.
Tests may inject a ``transfer=`` callable to model slow/failing
backends deterministically.

Every admitted request terminates in exactly one of: a result, an
error, or (at close) a shutdown error — never silently lost, never
delivered twice.  That invariant is what the chaos scenarios gate.
"""

import contextlib
import itertools
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Callable, Dict, List, Optional

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import histo, timeseries, trace
from container_engine_accelerators_tpu_torch.parallel import dcn
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferError,
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.serving.breaker import NodeBreaker
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

E2E_OP = "serving.e2e"
ATTEMPT_OP = "serving.attempt"


class RequestShed(RuntimeError):
    """Admission rejected the request: the bounded queue is full (or
    the frontend is closing).  The caller backs off or fails fast —
    the frontend never buffers without bound."""


class AttemptCancelled(Exception):
    """This attempt lost the hedge race (or the frontend is closing);
    its in-flight work stops at the next phase boundary."""


class ServingConfig:
    """Frontend knobs.  Scenario specs pass them as the ``serving:``
    mapping (:meth:`from_scenario` — unknown keys are dropped with a
    log line, the TPU_FAULT_SPEC rule)."""

    #: bounded admission queue depth; a full queue sheds
    admission_capacity: int = 64
    #: batch cutter: size and wait ceilings
    max_batch: int = 8
    max_wait_ms: float = 5.0
    #: hedge deadline: fixed ms, or None = adaptive from the observed
    #: ``serving.attempt`` latency percentile (floored)
    hedge_after_ms: Optional[float] = None
    hedge_percentile: float = 0.95
    hedge_floor_ms: float = 50.0
    #: per-batch end-to-end budget; past it every undelivered request
    #: gets a timeout error (terminates — nothing is ever lost)
    request_timeout_s: float = 10.0
    #: per-attempt-sequence failover budget (distinct nodes tried)
    attempts: int = 3
    hedge_attempts: int = 2
    #: breaker: consecutive failures to eject, cooldown before a probe
    breaker_failures: int = 3
    breaker_cooldown_s: float = 1.0
    #: per-node client retry deadline (snappier than the fleet default
    #: — a serving attempt must fail over, not ride a 15 s reconnect)
    client_deadline_s: float = 3.0
    #: concurrent batch dispatches (and 2x this many attempt workers)
    max_inflight_batches: int = 4
    #: land/read timeout for one DCN phase inside an attempt
    land_timeout_s: float = 2.0

    _FIELDS = ("admission_capacity", "max_batch", "max_wait_ms",
               "hedge_after_ms", "hedge_percentile", "hedge_floor_ms",
               "request_timeout_s", "attempts", "hedge_attempts",
               "breaker_failures", "breaker_cooldown_s",
               "client_deadline_s", "max_inflight_batches",
               "land_timeout_s")

    def __init__(self, **kw):
        for field in self._FIELDS:
            setattr(self, field, kw.pop(field, getattr(type(self),
                                                       field)))
        if kw:
            raise TypeError(f"unknown ServingConfig fields: "
                            f"{sorted(kw)}")

    @classmethod
    def from_scenario(cls, raw: Optional[dict]) -> "ServingConfig":
        import logging

        log = logging.getLogger(__name__)
        if raw is None:
            return cls()
        known = {}
        for key, value in dict(raw).items():
            if key in cls._FIELDS:
                known[key] = value
            elif key not in ("requests_per_round", "round_deadline_s"):
                # The two round-pacing keys belong to the controller;
                # anything else is a typo — degrade, don't crash.
                log.error("ignoring unknown serving knob %r", key)
        return cls(**known)


class Request:
    """One admitted request.  Exactly-once delivery by construction:
    the first ``_deliver`` wins, every later one reports False (the
    dedup the hedge race depends on)."""

    __slots__ = ("rid", "payload", "t_submit", "result", "error",
                 "winner", "_done", "_lock")

    def __init__(self, rid: int, payload: bytes, t_submit: float):
        self.rid = rid
        self.payload = payload
        self.t_submit = t_submit
        self.result: Optional[bytes] = None
        self.error: Optional[str] = None
        self.winner: Optional[str] = None
        self._done = threading.Event()
        self._lock = threading.Lock()

    def _deliver(self, result: Optional[bytes], error: Optional[str],
                 role: str) -> bool:
        with self._lock:
            if self._done.is_set():
                return False
            self.result = result
            self.error = error
            self.winner = role
            self._done.set()
        return True

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout_s: Optional[float] = None) -> bool:
        """Block until the request terminated (result OR error);
        returns whether it did within the timeout."""
        return self._done.wait(timeout_s)


class _Batch:
    """One cut batch: the dispatch unit.  Holds the concatenated
    payload, per-request slicing, and the hedge race state (winner,
    per-role cancel tokens).  ``ctx`` is the batch's trace context
    (set by the dispatcher's ``serving.batch`` span): every attempt —
    primary AND hedge — attaches to it, so one request's whole
    admit→cut→attempt→hedge story reads as ONE trace."""

    def __init__(self, bid: int, requests: List[Request]):
        self.bid = bid
        self.requests = requests
        self.payload = b"".join(r.payload for r in requests)
        self.t_cut = time.monotonic()
        self.ctx: Optional[dict] = None
        self.hedged = False
        self.winner: Optional[str] = None
        self.errors: Dict[str, str] = {}
        self._lock = threading.Lock()
        self._tokens: Dict[str, threading.Event] = {}

    def cancel_token(self, role: str) -> threading.Event:
        with self._lock:
            return self._tokens.setdefault(role, threading.Event())

    def done(self) -> bool:
        return all(r.done() for r in self.requests)

    def deliver(self, result: bytes, role: str) -> bool:
        """First-response-wins: the first role to deliver claims the
        batch, cancels the losers' tokens, and hands each request its
        slice.  A later delivery returns False (its results are the
        duplicates the request-id dedup exists to drop)."""
        with self._lock:
            if self.winner is not None:
                return False
            self.winner = role
            losers = [tok for r, tok in self._tokens.items()
                      if r != role]
        for tok in losers:
            tok.set()
        now = time.monotonic()
        cur = trace.current()
        tid = cur.trace_id if cur is not None else None
        off = 0
        delivered = 0
        for req in self.requests:
            chunk = result[off:off + len(req.payload)]
            off += len(req.payload)
            if req._deliver(chunk, None, role):
                delivered += 1
                histo.observe(E2E_OP, now - req.t_submit,
                              trace_id=tid)
        if delivered:
            counters.inc("serving.ok", delivered)
        return True

    def record_failure(self, role: str, error: str) -> None:
        with self._lock:
            self.errors[role] = error

    def terminate(self, error: str) -> None:
        """Every attempt is spent (or the budget is): hand every
        still-undelivered request a terminal error — a request may
        fail, it may never be LOST."""
        failed = 0
        for req in self.requests:
            if req._deliver(None, error, "error"):
                failed += 1
        if failed:
            counters.inc("serving.errors", failed)


class ServingFrontend:
    """The fleet-facing request frontend (module docstring has the
    architecture).  ``nodes`` is the fleet's name → node mapping —
    anything EmulatedNode/ProcNode-shaped (``.name``/``.root``/
    ``.down``/``.daemon.data_port``) serves."""

    def __init__(self, nodes: Dict[str, object],
                 config: Optional[ServingConfig] = None,
                 transfer: Optional[Callable] = None):
        self.nodes = nodes
        self.cfg = config or ServingConfig()
        self.breaker = NodeBreaker(
            failures=self.cfg.breaker_failures,
            cooldown_s=self.cfg.breaker_cooldown_s)
        self._transfer = transfer or self._dcn_transfer
        self._admit: "queue.Queue" = queue.Queue(
            maxsize=max(1, int(self.cfg.admission_capacity)))
        self._stop = threading.Event()
        self._rid = itertools.count(1)
        self._bid = itertools.count(1)
        self._fid = itertools.count(1)  # unique flow names per attempt
        self._rr = itertools.count()
        self.node_stats = {name: {"ok": 0, "failed": 0}
                           for name in nodes}
        self._stats_lock = threading.Lock()
        self._client_pool: Dict[str, List] = {}
        self._clients_lock = threading.Lock()
        self._batcher: Optional[threading.Thread] = None
        self._batch_pool: Optional[ThreadPoolExecutor] = None
        self._attempt_pool: Optional[ThreadPoolExecutor] = None
        # Dispatch slots: the cutter takes one BEFORE draining the
        # admission queue and _dispatch gives it back when the batch
        # resolves.  Without this the cutter would drain the bounded
        # queue straight into the executor's unbounded work queue —
        # admission control in name only: submit() would never see
        # Full, nothing would shed, and requests would buffer without
        # bound exactly where the depth gauge can't see them.
        self._slots = threading.BoundedSemaphore(
            max(1, int(self.cfg.max_inflight_batches)))
        # Baseline for the adaptive hedge deadline's percentile
        # (_attempt_percentile_s): this frontend's observations only.
        self._attempt0: Dict[str, int] = dict(
            histo.snapshot().get(ATTEMPT_OP, {}).get("buckets", {}))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ServingFrontend":
        if self._batcher is not None:
            return self
        workers = max(1, int(self.cfg.max_inflight_batches))
        self._batch_pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="serving-batch")
        # Attempts get their own pool: a dispatch thread waiting on
        # its attempt futures must never be the thing those futures
        # are queued behind (the classic same-pool deadlock).
        self._attempt_pool = ThreadPoolExecutor(
            max_workers=2 * workers,
            thread_name_prefix="serving-attempt")
        self._batcher = threading.Thread(
            target=self._batch_loop, name="serving-batcher", daemon=True)
        self._batcher.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._batcher is not None:
            self._batcher.join(timeout=5.0)
        if self._batch_pool is not None:
            self._batch_pool.shutdown(wait=True)
        if self._attempt_pool is not None:
            self._attempt_pool.shutdown(wait=True)
        # Nothing admitted may be lost, even at shutdown: whatever is
        # still queued terminates with a shutdown error.
        self._drain_admit()
        timeseries.gauge("serving.queue.depth", 0.0)
        with self._clients_lock:
            clients = [c for pool in self._client_pool.values()
                       for c in pool]
            self._client_pool.clear()
        for c in clients:
            try:
                c.close()
            except OSError:
                pass

    # -- admission -----------------------------------------------------------

    def _drain_admit(self) -> None:
        """Terminate everything still in the admission queue with a
        shutdown error — errored, never lost."""
        while True:
            try:
                req = self._admit.get_nowait()
            except queue.Empty:
                break
            if req._deliver(None, "frontend closed", "shutdown"):
                counters.inc("serving.errors")

    def submit(self, payload: bytes) -> Request:
        """Admit one request, or shed it.  Sheds raise
        :class:`RequestShed` — the caller hears "not now" immediately
        instead of queueing into a latency cliff."""
        if self._stop.is_set():
            counters.inc("serving.shed")
            raise RequestShed("frontend is closing")
        req = Request(next(self._rid), payload, time.monotonic())
        try:
            self._admit.put_nowait(req)
        except queue.Full:
            counters.inc("serving.shed")
            timeseries.gauge("serving.queue.depth",
                             float(self._admit.qsize()))
            raise RequestShed(
                f"admission queue full "
                f"({self.cfg.admission_capacity})") from None
        counters.inc("serving.requests")
        timeseries.gauge("serving.queue.depth",
                         float(self._admit.qsize()))
        if self._stop.is_set():
            # submit raced close(): the stop check above passed before
            # close() set the flag, and close()'s drain may already
            # have run — a request put after it would sit in a queue
            # nobody reads, silently lost.  Re-drain here (the batcher
            # is stopped, _deliver is first-wins) so it terminates.
            self._drain_admit()
        return req

    # -- batching ------------------------------------------------------------

    def _batch_loop(self) -> None:
        max_wait_s = max(0.0, float(self.cfg.max_wait_ms)) / 1e3
        while not self._stop.is_set():
            # A dispatch slot first, a batch second: with every slot
            # in flight the cutter stalls HERE, admitted requests
            # accumulate in the bounded queue, and the overflow sheds
            # at submit() — backpressure reaches the caller instead of
            # the executor's unbounded queue.
            if not self._slots.acquire(timeout=0.05):
                continue
            try:
                first = self._admit.get(timeout=0.05)
            except queue.Empty:
                self._slots.release()
                continue
            members = [first]
            cut_at = time.monotonic() + max_wait_s
            while len(members) < self.cfg.max_batch:
                remaining = cut_at - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    members.append(self._admit.get(timeout=remaining))
                except queue.Empty:
                    break
            timeseries.gauge("serving.queue.depth",
                             float(self._admit.qsize()))
            counters.inc("serving.batches")
            batch = _Batch(next(self._bid), members)
            try:
                self._batch_pool.submit(self._dispatch, batch)
            except RuntimeError:
                # Pool already shut down (a close racing the cutter's
                # last batch): the slot comes back and every member
                # terminates — errored, never lost.
                self._slots.release()
                batch.terminate("frontend closed")

    # -- dispatch: hedge race ------------------------------------------------

    def _hedge_deadline_s(self) -> float:
        if self.cfg.hedge_after_ms is not None:
            return max(float(self.cfg.hedge_after_ms), 1.0) / 1e3
        floor = max(self.cfg.hedge_floor_ms, 1.0) / 1e3
        # THIS frontend's attempt latencies only: the histogram
        # registry is process-global and cumulative, and a stale slow
        # tail from an earlier run would pin the adaptive deadline at
        # its cap — hedging silently disabled.
        p_us = histo.delta_percentile_us(
            ATTEMPT_OP, self._attempt0, self.cfg.hedge_percentile)
        if p_us is None:
            return floor
        return min(max(p_us / 1e6, floor),
                   self.cfg.request_timeout_s / 2)

    def _record_wait_spans(self, batch: _Batch, bspan) -> None:
        """The admit→cut phases, recorded as completed child spans of
        the batch: per-request ``serving.queue.wait`` (submit → cut,
        measured across threads — no ``with`` block can bracket it)
        and one ``serving.batch.wait`` (cut → dispatch start).  This
        is what lets the critical-path engine answer "was it the
        queue, the cutter, or the attempt?" per request shape."""
        now_mono = time.monotonic()
        now_wall = time.time()
        cut_wall = now_wall - (now_mono - batch.t_cut)
        for req in batch.requests:
            trace.record_span(
                "serving.queue.wait",
                duration_s=batch.t_cut - req.t_submit,
                end_ts=cut_wall,
                trace_id=bspan.trace_id, parent_id=bspan.span_id,
                rid=req.rid)
        trace.record_span(
            "serving.batch.wait",
            duration_s=now_mono - batch.t_cut,
            end_ts=now_wall,
            trace_id=bspan.trace_id, parent_id=bspan.span_id,
            batch=batch.bid)

    def _dispatch(self, batch: _Batch) -> None:
        timeseries.gauge_add("serving.inflight", 1)
        deadline = time.monotonic() + self.cfg.request_timeout_s
        try:
            with trace.span("serving.batch", batch=batch.bid,
                            requests=len(batch.requests),
                            bytes=len(batch.payload)) as bspan:
                batch.ctx = trace.context()
                self._record_wait_spans(batch, bspan)
                primary = self._attempt_pool.submit(
                    self._attempt_seq, batch, "primary", deadline)
                futures = [primary]
                hedge_s = self._hedge_deadline_s()
                try:
                    primary.result(
                        timeout=min(hedge_s,
                                    max(0.0,
                                        deadline - time.monotonic())))
                except _FutureTimeout:
                    if not batch.done():
                        batch.hedged = True
                        counters.inc("serving.hedge.fired")
                        futures.append(self._attempt_pool.submit(
                            self._attempt_seq, batch, "hedge",
                            deadline))
                # Wait the race out: done the moment anything
                # delivers, or every attempt sequence has given up, or
                # the budget is up.
                while (not batch.done()
                       and any(not f.done() for f in futures)
                       and time.monotonic() < deadline):
                    time.sleep(0.002)
                if batch.hedged:
                    if batch.winner == "hedge":
                        counters.inc("serving.hedge.won")
                    elif batch.winner == "primary":
                        counters.inc("serving.hedge.wasted")
                if not batch.done():
                    why = "; ".join(f"{r}: {e}" for r, e
                                    in sorted(batch.errors.items())) \
                        or "request timeout"
                    batch.terminate(f"all attempts failed ({why})")
                bspan.annotate(hedged=batch.hedged,
                               winner=batch.winner)
        except Exception as e:
            # An exception type _attempt_seq doesn't anticipate
            # re-raises out of primary.result() and would skip the
            # terminate fallback above — every request in the batch
            # silently lost, the one outcome the frontend may never
            # produce.  Errored, never lost, whatever the exception.
            batch.terminate(f"internal dispatch error: {e!r}")
        finally:
            timeseries.gauge_add("serving.inflight", -1)
            self._slots.release()

    def _attempt_seq(self, batch: _Batch, role: str,
                     deadline: float) -> bool:
        """One role's bounded failover sequence: try up to
        ``attempts`` (breaker-allowed, preferably distinct) nodes
        until one delivers.  Returns whether this role won.  Attempts
        run on pool threads, so they JOIN the batch's trace
        explicitly (``batch.ctx``): hedge winner and loser share the
        request's trace id, and a cancelled loser's span still closes
        (status ``error``) into the ring — the race leaves no open
        spans behind."""
        ctx = batch.ctx or {}
        with trace.attach(ctx.get("trace"), ctx.get("span")):
            return self._attempt_seq_traced(batch, role, deadline)

    def _attempt_seq_traced(self, batch: _Batch, role: str,
                            deadline: float) -> bool:
        cancel = batch.cancel_token(role)
        budget = (self.cfg.attempts if role == "primary"
                  else self.cfg.hedge_attempts)
        tried: set = set()
        last: Optional[BaseException] = None
        for _ in range(max(1, int(budget))):
            if cancel.is_set() or batch.done() or self._stop.is_set():
                return False
            if time.monotonic() >= deadline:
                break
            node = self._pick_node(exclude=tried)
            if node is None:
                node = self._pick_node(exclude=set())
            if node is None:
                last = DcnXferError("no serving node available "
                                    "(all down or breaker-open)")
                time.sleep(0.05)
                continue
            tried.add(node.name)
            try:
                with trace.span(ATTEMPT_OP, histogram=ATTEMPT_OP,
                                batch=batch.bid, role=role,
                                node=node.name,
                                bytes=len(batch.payload)):
                    result = self._transfer(batch, node, cancel)
                self.breaker.record_success(node.name)
                with self._stats_lock:
                    self.node_stats[node.name]["ok"] += 1
                if not batch.deliver(result, role):
                    # Both attempts landed: the loser's results are
                    # dropped HERE, by the request-id dedup.
                    counters.inc("serving.dedup.dropped")
                return batch.winner == role
            except AttemptCancelled:
                self.breaker.release_probe(node.name)
                return False
            except (DcnXferError, OSError, TimeoutError) as e:
                last = e
                self.breaker.record_failure(node.name)
                with self._stats_lock:
                    self.node_stats[node.name]["failed"] += 1
            except Exception as e:
                # An exception type we didn't anticipate is still a
                # verdict on this attempt: record the failure so a
                # half-open probe slot is never leaked (a leaked slot
                # wedges the node out of dispatch forever — allow()
                # re-grants only on probing=False) and failover
                # continues under the same bounded budget.
                last = e
                self.breaker.record_failure(node.name)
                with self._stats_lock:
                    self.node_stats[node.name]["failed"] += 1
        batch.record_failure(role, str(last) if last else "no attempt")
        return False

    # -- node selection ------------------------------------------------------

    def _pick_node(self, exclude: set):
        """Round-robin over live, breaker-allowed nodes."""
        names = list(self.nodes)
        if not names:
            return None
        start = next(self._rr)
        for k in range(len(names)):
            name = names[(start + k) % len(names)]
            node = self.nodes[name]
            if name in exclude:
                continue
            if getattr(node, "down", False) \
                    or getattr(node, "permanently_down", False):
                continue
            if not self.breaker.allow(name):
                continue
            return node
        return None

    def _shard_home(self, serving_node):
        """The node the serving node reads its shard from: the next
        live node after it in fleet order, so every request crosses a
        node→node link (the DCN fault surface).  A one-node fleet
        reads from itself."""
        names = list(self.nodes)
        idx = names.index(serving_node.name)
        for k in range(1, len(names)):
            cand = self.nodes[names[(idx + k) % len(names)]]
            if not getattr(cand, "down", False) \
                    and not getattr(cand, "permanently_down", False):
                return cand
        return serving_node

    # -- the default execution path: cross-node shard read -------------------

    @contextlib.contextmanager
    def _client(self, node):
        """A pooled per-node ResilientDcnXferClient.  Concurrent
        attempts never share a control socket; a client that saw an
        error is closed instead of re-pooled (its flow table may be
        mid-replay)."""
        c = None
        with self._clients_lock:
            pool = self._client_pool.setdefault(node.name, [])
            if pool:
                c = pool.pop()
        if c is None:
            c = ResilientDcnXferClient(
                os.path.join(node.root, "tpu-dcn"),
                retry=RetryPolicy(
                    max_attempts=4, initial_backoff_s=0.02,
                    max_backoff_s=0.2,
                    deadline_s=self.cfg.client_deadline_s),
            )
        clean = False
        try:
            yield c
            clean = True
        finally:
            if clean:
                with self._clients_lock:
                    self._client_pool.setdefault(node.name,
                                                 []).append(c)
            else:
                try:
                    c.close()
                except OSError:
                    pass

    @staticmethod
    def _check(cancel: threading.Event) -> None:
        if cancel.is_set():
            raise AttemptCancelled()

    def _dcn_transfer(self, batch: _Batch, node,
                      cancel: threading.Event) -> bytes:
        """Execute one batch as a cross-node shard read: stage the
        payload on the shard-home node, stream it to the serving
        node's daemon (through the link table / the proc link shim),
        read it back — the whole resilient client stack under the
        batch.  Cancellation is checked between phases."""
        home = self._shard_home(node)
        flow = f"srv.{batch.bid}.{next(self._fid)}"
        payload = batch.payload
        nbytes = len(payload)
        land_s = self.cfg.land_timeout_s
        if home.name == node.name:
            # One-node fleet (or every other node dark): a local
            # staging round trip — no cross-node leg exists to take.
            with self._client(node) as c:
                c.register_flow(flow, bytes=nbytes)
                try:
                    self._check(cancel)
                    c.put(flow, payload)
                    dcn.wait_flow_rx(c, flow, nbytes,
                                     timeout_s=land_s)
                    got = c.read(flow, nbytes)
                    if got != payload:
                        raise DcnXferError(
                            f"shard read corrupt on {flow}")
                    return got
                finally:
                    try:
                        c.release_flow(flow)
                    except (DcnXferError, OSError):
                        pass
        with self._client(home) as src, self._client(node) as dst:
            dst.register_flow(flow, peer=home.name, bytes=nbytes)
            src.register_flow(flow, peer=node.name, bytes=nbytes)
            try:
                self._check(cancel)
                src.put(flow, payload)
                dcn.wait_flow_rx(src, flow, nbytes, timeout_s=land_s)
                self._check(cancel)
                src.send(flow, "127.0.0.1", node.daemon.data_port,
                         nbytes)
                self._check(cancel)
                dcn.wait_flow_rx(dst, flow, nbytes, timeout_s=land_s)
                got = dst.read(flow, nbytes)
                if got != payload:
                    raise DcnXferError(
                        f"shard read corrupt on {flow}")
                return got
            finally:
                for client in (src, dst):
                    try:
                        client.release_flow(flow)
                    except (DcnXferError, OSError):
                        pass
