"""Execute synthesized collective schedules over the fleet rig.

The port's copy of ``container_engine_accelerators_tpu/collectives/
runner.py`` (host code: no torch): the same rounds, counters, spans and
report keys.  One addition: after a verified coordinator-path round,
``CollectiveEngine.last_outputs`` holds each node's buffer, so a caller
that holds the inputs elsewhere (on a GPU) can check the reduction
against its own.

The runner is the wire half of the engine: it takes the schedule
synth.py planned (ring / tree / hierarchical, chosen from the comm
graph) and drives every :class:`TransferStep` through the SAME data
plane the rest of the stack uses — pooled production
``ResilientDcnXferClient``s per node, serial staging legs or the
chunked/striped pipelined plane, every cross-node byte through the
link table (in-process fleets) or each worker daemon's real TCP stack
(process mode).  Link chaos therefore hits a collective exactly where
it would hit a training job's exchange.

Semantics: step groups are barriers.  Every leg's payload snapshots
pre-group state (so concurrent legs in one group can never observe
each other's landings — the same contract synth.simulate verifies),
legs run concurrently on a bounded pool, and the group's reductions
apply on the coordinator after every leg returns.  A leg retries
under a bounded budget; a leg that spends it fails the whole run for
this round (the controller's round loop is the outer retry, and a
graph-signature change from the fault re-synthesizes the schedule —
``collective.resynth``).

Accounting follows collectives/bench.py's nccl-tests conventions:
``algbw = S / t`` with S the per-rank payload and t the whole
schedule's wall time, ``busbw = algbw * bus_factor(op, n)`` — so a
number measured here compares against the NCCL sweep's.  The run
emits ``collective.*`` counters/gauges and a span tree
(``collective.run`` > ``collective.phase`` > ``collective.leg`` with
src/dst/phase attrs) so the critical-path report names the hop that
dominated, not just the slower total.

CLI (the acceptance comparison)::

    python -m container_engine_accelerators_tpu_torch.collectives.runner \
        --compare --nodes 4 --racks 2 --xrack-latency-ms 25 \
        --bytes 262144 --margin 1.3

boots an in-process 2-rack fleet, degrades the cross-rack tier, runs
ring and hierarchical pinned, and exits non-zero unless hierarchical
beats the flat ring's bus bandwidth by the margin.
"""

import argparse
import contextlib
import itertools
import json
import logging
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.collectives import synth
from container_engine_accelerators_tpu_torch.collectives.topo import CommGraph
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries, trace
from container_engine_accelerators_tpu_torch.parallel import dcn, dcn_pipeline
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferError,
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)


class CollectiveConfig:
    """Engine knobs.  Scenario specs pass them as the ``collective:``
    mapping (:meth:`from_scenario` — unknown keys are dropped with a
    log line, the TPU_FAULT_SPEC rule)."""

    #: which collective and how many payload bytes per rank (S)
    op: str = "all_reduce"
    bytes: int = 262144
    #: pin one algorithm, or None = the cost model chooses per graph
    algorithm: Optional[str] = None
    #: verify every node's result region against the in-memory oracle
    verify: bool = True
    #: per-leg retry budget (the controller round loop retries above)
    leg_attempts: int = 3
    leg_backoff_ms: float = 30.0
    leg_deadline_s: float = 8.0
    #: land/read timeout for one DCN phase inside a leg
    land_timeout_s: float = 2.0
    #: concurrent legs per step group (and the client-pool high water)
    max_workers: int = 8
    #: per-node client retry deadline
    client_deadline_s: float = 4.0
    #: daemon-routed execution: every leg is ONE daemon->daemon
    #: forward hop; the coordinator posts programs and collects
    #: verdicts, payload bytes never cross its clients
    routed: bool = False

    _FIELDS = ("op", "bytes", "algorithm", "verify", "leg_attempts",
               "leg_backoff_ms", "leg_deadline_s", "land_timeout_s",
               "max_workers", "client_deadline_s", "routed")

    def __init__(self, **kw):
        for field in self._FIELDS:
            setattr(self, field, kw.pop(field, getattr(type(self),
                                                       field)))
        if kw:
            raise TypeError(f"unknown CollectiveConfig fields: "
                            f"{sorted(kw)}")

    @classmethod
    def from_scenario(cls, raw: Optional[dict]) -> "CollectiveConfig":
        if raw is None:
            return cls()
        known = {}
        for key, value in dict(raw).items():
            if key in cls._FIELDS:
                known[key] = value
            else:
                log.error("ignoring unknown collective knob %r", key)
        return cls(**known)


class CollectiveEngine:
    """Synthesize-and-execute loop over one fleet's nodes.

    ``nodes`` is the controller's node map (EmulatedNode or ProcNode —
    both expose ``root``/``client``/``daemon.data_port``/``down``);
    ``links`` is the coordinator's LinkTable (fault evidence for the
    graph; process-mode fleets mirror their worker-shim faults into
    it).  ``pipe_cfg`` non-None routes legs over the pipelined plane.
    """

    def __init__(self, nodes: dict, topology, links=None,
                 cfg: Optional[CollectiveConfig] = None,
                 pipe_cfg=None):
        self.nodes = nodes
        self.topology = topology
        self.links = links
        self.cfg = cfg or CollectiveConfig()
        self.pipe_cfg = pipe_cfg
        # Each node's buffer after a verified coordinator round; None
        # after a routed or failed one.
        self.last_outputs: Optional[Dict[str, bytearray]] = None
        self.synth = synth.Synthesizer(self.cfg.op, self.cfg.bytes,
                                       self.cfg.algorithm)
        self._retry = RetryPolicy(
            max_attempts=int(self.cfg.leg_attempts),
            initial_backoff_s=float(self.cfg.leg_backoff_ms) / 1e3,
            max_backoff_s=0.2,
            deadline_s=float(self.cfg.leg_deadline_s),
        )
        workers = int(self.cfg.max_workers)
        if self.cfg.routed:
            # Routed legs are verdict round-trips, not payload moves;
            # a fixed pool would put the coordinator back on the
            # critical path the forwarding plane exists to leave
            # (group wall time = latency x ceil(legs/workers) instead
            # of one latency).  Scale the pool with the fleet.
            workers = max(workers, 4 * max(len(nodes), 1))
        self._pool = ThreadPoolExecutor(
            max_workers=workers,
            thread_name_prefix="collective")
        self._client_pool: Dict[str, List] = {}
        self._clients_lock = threading.Lock()
        self._fid = itertools.count()
        # Routed-mode accounting is mutated from pool threads.
        self._acct_lock = threading.Lock()

    # -- pooled clients (the serving frontend's discipline) ------------------

    def _checkout(self, node):
        """Take a client for ``node`` out of the pool (or dial a new
        one).  The caller owns it until :meth:`_checkin` — while held
        it can never be handed to another leg, and nothing closes it
        behind the caller's back.  The routed round leans on this: a
        daemon-side flow lives exactly as long as the CONNECTION that
        registered it, so the round checks out one owner client per
        node and holds it across every leg failure."""
        with self._clients_lock:
            pool = self._client_pool.setdefault(node.name, [])
            if pool:
                return pool.pop()
        return ResilientDcnXferClient(
            os.path.join(node.root, "tpu-dcn"),
            retry=RetryPolicy(
                max_attempts=4, initial_backoff_s=0.02,
                max_backoff_s=0.2,
                deadline_s=float(self.cfg.client_deadline_s)),
        )

    def _checkin(self, node, c, clean=True) -> None:
        if clean:
            with self._clients_lock:
                self._client_pool.setdefault(node.name, []).append(c)
            return
        try:
            c.close()
        except OSError:
            pass

    @contextlib.contextmanager
    def _client(self, node):
        c = self._checkout(node)
        clean = False
        try:
            yield c
            clean = True
        finally:
            self._checkin(node, c, clean=clean)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
        with self._clients_lock:
            clients = [c for pool in self._client_pool.values()
                       for c in pool]
            self._client_pool.clear()
        for c in clients:
            try:
                c.close()
            except OSError:
                pass

    # -- graph + schedule ----------------------------------------------------

    def graph(self) -> CommGraph:
        return CommGraph.build(self.topology, links=self.links)

    # -- one leg -------------------------------------------------------------

    def _leg(self, rnd: int, gi: int, t: synth.TransferStep,
             payload: bytes, ctx: Optional[dict]) -> bytes:
        with contextlib.ExitStack() as stack:
            if ctx:
                # Legs run on pool threads; join the round's trace so
                # the critical-path report sees one tree per run.
                stack.enter_context(trace.attach(ctx["trace"],
                                                 ctx["span"]))
            with trace.span("collective.leg",
                            histogram="collective.leg",
                            src=t.src, dst=t.dst, phase=t.phase,
                            bytes=t.nbytes, reduce=t.reduce) as span:
                src, dst = self.nodes[t.src], self.nodes[t.dst]
                if getattr(src, "down", False) \
                        or getattr(dst, "down", False):
                    counters.inc("collective.failures")
                    raise DcnXferError(
                        f"leg {t.src}->{t.dst}: node down")
                flow = (f"coll.r{rnd}.g{gi}.{t.src}.{t.dst}."
                        f"{next(self._fid)}")
                with self._client(src) as sc, self._client(dst) as dc:
                    # Registration sits INSIDE the try: if the second
                    # register raises (its worker just died), the
                    # finally still releases whatever the first one
                    # registered — faulted rounds must not accumulate
                    # leaked assembly buffers on surviving daemons.
                    try:
                        dc.register_flow(flow, peer=t.src,
                                         bytes=t.nbytes)
                        sc.register_flow(flow, peer=t.dst,
                                         bytes=t.nbytes)
                        if self.pipe_cfg is None:
                            # Serial leg: whole-payload staging up
                            # front, ONCE (the controller's _leg
                            # discipline) — retries below re-send
                            # only, and a daemon restart that lost
                            # the staging is healed by the resilient
                            # client's transparent restage.  The
                            # pipelined leg stages chunk-by-chunk
                            # inside each attempt instead.
                            sc.put(flow, payload)
                            dcn.wait_flow_rx(
                                sc, flow, t.nbytes,
                                timeout_s=float(
                                    self.cfg.land_timeout_s))
                        last: Optional[BaseException] = None
                        attempts = 0
                        for _attempt in self._retry.attempts():
                            attempts += 1
                            try:
                                got = self._transfer(sc, dc, dst, flow,
                                                     payload, t)
                                if got != payload:
                                    raise DcnXferError(
                                        f"payload mismatch on {flow}")
                                counters.inc("collective.transfers")
                                span.annotate(attempts=attempts)
                                return got
                            except (DcnXferError, OSError,
                                    TimeoutError) as e:
                                last = e
                                counters.inc("collective.leg.retried")
                        span.annotate(attempts=attempts)
                        raise DcnXferError(
                            f"leg {t.src}->{t.dst} spent its retry "
                            f"budget: {last}")
                    except (DcnXferError, OSError, TimeoutError):
                        # One failure count per failed leg, whatever
                        # phase broke — registration, staging, or a
                        # spent retry budget.
                        counters.inc("collective.failures")
                        raise
                    finally:
                        for c in (sc, dc):
                            try:
                                c.release_flow(flow)
                            except (DcnXferError, OSError):
                                pass

    def _transfer(self, sc, dc, dst_node, flow: str, payload: bytes,
                  t: synth.TransferStep) -> bytes:
        """One attempt of a leg's data movement.  The serial path
        assumes ``_leg`` staged the payload once up front: an attempt
        re-sends only, and a daemon restart that lost the staging is
        healed by the resilient client (``dcn.send.restaged``)."""
        nbytes = len(payload)
        land_s = float(self.cfg.land_timeout_s)
        port = dst_node.daemon.data_port
        if self.pipe_cfg is not None:
            dcn_pipeline.send_pipelined(sc, flow, payload, "127.0.0.1",
                                        port, self.pipe_cfg,
                                        timeout_s=land_s)
            return dcn_pipeline.read_pipelined(dc, flow, nbytes,
                                               self.pipe_cfg,
                                               timeout_s=land_s)
        sc.send(flow, "127.0.0.1", port, nbytes)
        dcn.wait_flow_rx(dc, flow, nbytes, timeout_s=land_s)
        return dc.read(flow, nbytes)

    # -- one collective ------------------------------------------------------

    def run_round(self, rnd: int) -> dict:
        """Synthesize (or reuse) the schedule for the current graph and
        run it once.  Returns the round-log entry: algorithm, timing,
        nccl-convention bandwidths, failure and re-synthesis counts —
        ``ok`` keeps the controller's convergence contract."""
        cfg = self.cfg
        self.last_outputs = None
        graph = self.graph()
        before = self.synth.resynth_count
        schedule = self.synth.schedule_for(graph)
        resynth = self.synth.resynth_count - before
        order = schedule.order
        n = len(order)
        inputs = synth.make_inputs(cfg.op, order, cfg.bytes, seed=rnd)
        bufs = {name: bytearray(b) for name, b in inputs.items()}
        counters.inc("collective.runs")
        entry = {
            "workload": "collective",
            "collective": cfg.op,
            "algorithm": schedule.algorithm,
            "bytes": cfg.bytes,
            "steps": len(schedule.steps),
            "transfers": schedule.transfers,
            "resynth": resynth,
            "est_cost_ms": schedule.to_dict()["est_cost_ms"],
        }
        per_node_ok: Dict[str, int] = {name: 0 for name in order}
        per_node_failed: Dict[str, int] = {name: 0 for name in order}
        if cfg.routed:
            if self._hazard_free(schedule):
                return self._routed_round(rnd, schedule, inputs, entry,
                                          per_node_ok, per_node_failed)
            # Safety net, not a normal path: every family and searched
            # lowering is hazard-free by construction, but a hazarded
            # schedule must run with pre-group snapshots — which only
            # the coordinator path provides.
            counters.inc("collective.routed.fallback")
            log.warning("schedule %s is not hazard-free; routed mode "
                        "falling back to coordinator execution",
                        schedule.algorithm)
        error: Optional[str] = None
        t0 = time.monotonic()
        with trace.span("collective.run", histogram="collective.run",
                        collective=cfg.op,
                        algorithm=schedule.algorithm, bytes=cfg.bytes,
                        nodes=n, round=rnd) as span:
            gi = 0
            for phase, groups in itertools.groupby(
                    schedule.steps,
                    key=lambda g: g[0].phase if g else ""):
                with trace.span("collective.phase", phase=phase):
                    for group in groups:
                        errs = self._run_group(rnd, gi, group, bufs,
                                               per_node_ok,
                                               per_node_failed)
                        gi += 1
                        if errs:
                            error = str(errs[0][1])
                            break
                if error:
                    # Later groups consume this one's reductions; a
                    # broken barrier makes them meaningless.  The
                    # round fails, the controller loops, and the
                    # fault's signature change re-plans.
                    break
            span.annotate(ok=error is None, error=error)
        elapsed = max(time.monotonic() - t0, 1e-9)
        ok = error is None
        if ok and cfg.verify:
            expected = synth.expected_outputs(cfg.op, order, inputs,
                                              cfg.bytes)
            for name, (off, ln, want) in expected.items():
                if bytes(bufs[name][off:off + ln]) != want:
                    counters.inc("collective.verify.failed")
                    ok = False
                    error = f"verification failed on {name}"
                    break
        algbw = cfg.bytes / elapsed
        busbw = algbw * synth.bus_factor(cfg.op, n)
        self.last_outputs = bufs if ok else None
        if ok:
            # Gauges carry the LAST completed collective — a failed
            # round keeps the previous evidence instead of publishing
            # a bandwidth no data actually achieved.
            timeseries.gauge("collective.busbw_bps", busbw)
            timeseries.gauge("collective.algbw_bps", algbw)
        entry.update(
            ok=ok,
            error=error,
            time_ms=round(elapsed * 1e3, 3),
            algbw_bps=round(algbw, 1) if ok else 0.0,
            busbw_bps=round(busbw, 1) if ok else 0.0,
            per_node_ok=per_node_ok,
            per_node_failed=per_node_failed,
        )
        return entry

    # -- routed execution (daemon-routed forwarding plane) -------------------

    @staticmethod
    def _hazard_free(schedule) -> bool:
        """True when every barrier group can run WITHOUT pre-group
        snapshots: no leg reads a region another leg in the same group
        writes on the same node, and same-region concurrent writes
        only overlap when both reduce (byte-add commutes, and the
        destination daemon serializes combines under its flow lock).
        Ring steps shift read and write chunks apart, tree phases
        split sources from destinations, and the searched emitter
        inherits the family structure — so real schedules pass; the
        check is the routed mode's safety net, not a planner."""
        for group in schedule.steps:
            for a in group:
                for b in group:
                    if a is b:
                        continue
                    if not (a.offset < b.offset + b.nbytes
                            and b.offset < a.offset + a.nbytes):
                        continue
                    if b.dst == a.src:
                        return False       # a reads what b writes
                    if b.dst == a.dst and not (a.reduce and b.reduce):
                        return False       # racing plain writes
        return True

    def _routed_round(self, rnd: int, schedule, inputs: dict,
                      entry: dict, per_node_ok: Dict[str, int],
                      per_node_failed: Dict[str, int]) -> dict:
        """Daemon-routed execution: ONE shared flow per round on every
        daemon, inputs staged once up front (setup, unmeasured), then
        each schedule leg becomes a single ``forward`` op — the source
        daemon ships its staged region straight to the destination
        daemon over the persistent peer stream, and the coordinator
        only posts programs and collects verdicts.

        Correctness contract: the coordinator assigns every leg's
        frame seq (a destination's dedup window is shared by ALL
        source daemons, so only the schedule's author can hand out
        non-colliding numbers), a replayed leg reuses the seq it
        burned (landed-or-dup is exactly-once either way), and a group
        barrier is each touched destination's CUMULATIVE flow rx —
        baseline put plus every forwarded byte through this group.

        Accounting contract: forwarded legs land in
        ``dcn.lane.forward.*`` / ``xferd.forward.*`` on the daemons
        and move ZERO payload bytes through coordinator clients —
        ``routed.coordinator_payload_bytes`` stays 0 unless a
        forward-less daemon downgrades a leg (read + put_range through
        the coordinator, counted, same seq)."""
        cfg = self.cfg
        order = schedule.order
        n = len(order)
        S = cfg.bytes
        land_s = float(cfg.land_timeout_s)
        flow = f"collr.r{rnd}.{next(self._fid)}"
        routed = {
            "forward_legs": 0,
            "forward_bytes": 0,
            "forward_retries": 0,
            "downgraded_legs": 0,
            "coordinator_payload_bytes": 0,
            "setup_bytes": 0,
            "verify_bytes": 0,
        }
        ports = {name: self.nodes[name].daemon.data_port
                 for name in order}
        # Nodes discovered forward-less THIS round (fresh each round:
        # a restarted daemon may have regained the capability).
        fwd_less: set = set()
        seq_next = {name: 0 for name in order}
        expect_rx = {name: S for name in order}
        registered: List[str] = []
        owners: Dict[str, ResilientDcnXferClient] = {}
        error: Optional[str] = None
        elapsed = 1e-9
        try:
            for name in order:
                node = self.nodes[name]
                if getattr(node, "down", False):
                    raise DcnXferError(f"node {name} down")
                # One OWNER client per node, held for the whole
                # round: a daemon releases a flow when the connection
                # that registered it dies, and a failing leg closes
                # its pooled client on the way out — so the round's
                # shared flow must be anchored to a connection no leg
                # can ever be handed.
                c = owners[name] = self._checkout(node)
                c.register_flow(flow, peer="routed", bytes=S)
                registered.append(name)
                c.put(flow, inputs[name])
                dcn.wait_flow_rx(c, flow, S, timeout_s=land_s)
                routed["setup_bytes"] += S
            t0 = time.monotonic()
            with trace.span("collective.run",
                            histogram="collective.run",
                            collective=cfg.op,
                            algorithm=schedule.algorithm,
                            bytes=cfg.bytes, nodes=n, round=rnd,
                            routed=True) as span:
                gi = 0
                for phase, groups in itertools.groupby(
                        schedule.steps,
                        key=lambda g: g[0].phase if g else ""):
                    with trace.span("collective.phase", phase=phase,
                                    routed=True):
                        for group in groups:
                            self._routed_group(
                                flow, group, ports, seq_next,
                                expect_rx, fwd_less, routed,
                                per_node_ok, per_node_failed)
                            gi += 1
                span.annotate(ok=True)
            elapsed = max(time.monotonic() - t0, 1e-9)
        except (DcnXferError, OSError, TimeoutError) as e:
            counters.inc("collective.failures")
            error = str(e)
        ok = error is None
        if ok and cfg.verify:
            expected = synth.expected_outputs(cfg.op, order, inputs,
                                              cfg.bytes)
            try:
                for name, (off, ln, want) in expected.items():
                    got = owners[name].read(flow, ln, offset=off)
                    routed["verify_bytes"] += len(got)
                    if got != want:
                        counters.inc("collective.verify.failed")
                        ok = False
                        error = f"verification failed on {name}"
                        break
            except (DcnXferError, OSError, TimeoutError) as e:
                counters.inc("collective.verify.failed")
                ok = False
                error = f"verification read failed: {e}"
        for name in registered:
            try:
                owners[name].release_flow(flow)
            except (DcnXferError, OSError):
                pass
        for name, c in owners.items():
            # A clean round returns its owners to the pool; a faulted
            # one closes them (a dead daemon's conn must not be
            # re-dealt to the next round's setup).
            self._checkin(self.nodes[name], c, clean=error is None)
        algbw = cfg.bytes / elapsed
        busbw = algbw * synth.bus_factor(cfg.op, n)
        if ok:
            timeseries.gauge("collective.busbw_bps", busbw)
            timeseries.gauge("collective.algbw_bps", algbw)
            timeseries.gauge("collective.routed.busbw_bps", busbw)
        entry.update(
            ok=ok,
            error=error,
            time_ms=round(elapsed * 1e3, 3),
            algbw_bps=round(algbw, 1) if ok else 0.0,
            busbw_bps=round(busbw, 1) if ok else 0.0,
            per_node_ok=per_node_ok,
            per_node_failed=per_node_failed,
            routed=routed,
        )
        return entry

    def _routed_group(self, flow: str, group: List[synth.TransferStep],
                      ports: Dict[str, int], seq_next: Dict[str, int],
                      expect_rx: Dict[str, int], fwd_less: set,
                      routed: dict, per_node_ok: Dict[str, int],
                      per_node_failed: Dict[str, int]) -> None:
        """One barrier group, routed: post every leg as a forward
        program, join verdicts, then wait for each destination's
        cumulative rx to cover the group's landings.  A barrier
        timeout gets ONE engine-level re-post of that destination's
        legs under the seqs they burned (dedup keeps replays
        exactly-once) before it fails the round."""
        counters.inc("collective.steps")
        ctx = trace.context()
        legs: List[Tuple[synth.TransferStep, int]] = []
        for t in group:
            seq_next[t.dst] += 1
            legs.append((t, seq_next[t.dst]))
            expect_rx[t.dst] += t.nbytes
        futures = [(t, self._pool.submit(self._forward_leg, t, flow,
                                         ports[t.dst], seq, fwd_less,
                                         routed, ctx))
                   for t, seq in legs]
        errors: List[Tuple[synth.TransferStep, BaseException]] = []
        for t, fut in futures:
            try:
                fut.result()
                per_node_ok[t.src] += 1
            except (DcnXferError, OSError, TimeoutError) as e:
                errors.append((t, e))
                per_node_failed[t.src] += 1
        if errors:
            t, e = errors[0]
            raise DcnXferError(
                f"routed leg {t.src}->{t.dst} failed: {e}")
        land_s = float(self.cfg.land_timeout_s)
        for name in sorted({t.dst for t, _ in legs}):
            with self._client(self.nodes[name]) as c:
                try:
                    dcn.wait_flow_rx(c, flow, expect_rx[name],
                                     timeout_s=land_s)
                    continue
                except TimeoutError:
                    counters.inc("collective.forward.reposted")
            for t, seq in legs:
                if t.dst == name:
                    self._forward_leg(t, flow, ports[name], seq,
                                      fwd_less, routed, ctx)
            with self._client(self.nodes[name]) as c:
                dcn.wait_flow_rx(c, flow, expect_rx[name],
                                 timeout_s=land_s)

    def _forward_leg(self, t: synth.TransferStep, flow: str,
                     dst_port: int, seq: int, fwd_less: set,
                     routed: dict, ctx: Optional[dict]) -> None:
        """One routed leg: a single control-plane call to the SOURCE
        daemon (``forward``) that moves the payload daemon->daemon.
        A source that answers "unknown op" is downgraded mid-schedule
        to a coordinator-routed leg — same seq, same landing
        semantics, but the payload crosses the coordinator and the
        accounting says so."""
        with contextlib.ExitStack() as stack:
            if ctx:
                stack.enter_context(trace.attach(ctx["trace"],
                                                 ctx["span"]))
            with trace.span("collective.leg",
                            histogram="collective.leg",
                            src=t.src, dst=t.dst, phase=t.phase,
                            bytes=t.nbytes, reduce=t.reduce,
                            routed=True) as span:
                src = self.nodes[t.src]
                dst = self.nodes[t.dst]
                if getattr(src, "down", False) \
                        or getattr(dst, "down", False):
                    counters.inc("collective.failures")
                    raise DcnXferError(
                        f"leg {t.src}->{t.dst}: node down")
                last: Optional[BaseException] = None
                attempts = 0
                for _attempt in self._retry.attempts():
                    attempts += 1
                    try:
                        with self._client(src) as sc:
                            if t.src in fwd_less:
                                self._downgraded_leg(sc, flow, t,
                                                     dst_port, seq,
                                                     routed)
                            else:
                                try:
                                    resp = sc.forward(
                                        flow, "127.0.0.1", dst_port,
                                        t.nbytes, offset=t.offset,
                                        seq=seq, total=self.cfg.bytes,
                                        reduce=t.reduce,
                                        stage_wait_ms=int(
                                            self.cfg.land_timeout_s
                                            * 1e3))
                                except DcnXferError as e:
                                    if "unknown op" not in str(e):
                                        raise
                                    # Capability-less daemon: every
                                    # later leg from this source goes
                                    # coordinator-routed without
                                    # re-asking.
                                    fwd_less.add(t.src)
                                    counters.inc(
                                        "collective.forward."
                                        "downgraded")
                                    self._downgraded_leg(
                                        sc, flow, t, dst_port, seq,
                                        routed)
                                else:
                                    with self._acct_lock:
                                        routed["forward_legs"] += 1
                                        routed["forward_bytes"] += int(
                                            resp.get("bytes",
                                                     t.nbytes))
                                        routed["forward_retries"] += \
                                            max(int(resp.get(
                                                "attempts", 1)) - 1, 0)
                        counters.inc("collective.transfers")
                        counters.inc("collective.forward.legs")
                        span.annotate(attempts=attempts)
                        return
                    except (DcnXferError, OSError, TimeoutError) as e:
                        last = e
                        counters.inc("collective.leg.retried")
                        counters.inc("collective.forward.retried")
                span.annotate(attempts=attempts)
                counters.inc("collective.failures")
                raise DcnXferError(
                    f"routed leg {t.src}->{t.dst} spent its retry "
                    f"budget: {last}")

    def _downgraded_leg(self, sc, flow: str, t: synth.TransferStep,
                        dst_port: int, seq: int, routed: dict) -> None:
        """Coordinator-routed fallback for ONE leg: read the source
        region through the client, write it to the destination
        daemon's data port as the SAME forward frame (same seq, same
        reduce semantics, indistinguishable landing) — the payload
        crosses the coordinator twice, and the lane accounting records
        exactly that."""
        data = sc.read(flow, t.nbytes, offset=t.offset)
        if len(data) != t.nbytes:
            raise DcnXferError(
                f"downgraded leg {t.src}->{t.dst}: short read "
                f"({len(data)}/{t.nbytes})")
        sc.put_range(flow, data, t.offset, seq, "127.0.0.1", dst_port,
                     reduce=t.reduce, total=self.cfg.bytes)
        with self._acct_lock:
            routed["downgraded_legs"] += 1
            # In once (read), out once (put_range).
            routed["coordinator_payload_bytes"] += 2 * t.nbytes

    def _run_group(self, rnd: int, gi: int,
                   group: List[synth.TransferStep], bufs: dict,
                   per_node_ok: Dict[str, int],
                   per_node_failed: Dict[str, int],
                   ) -> List[Tuple[synth.TransferStep, BaseException]]:
        """One barrier group: snapshot payloads, run every leg on the
        pool, apply reductions coordinator-side after the join (so
        overlapping reduce targets — a tree root's fan-in — never
        race)."""
        counters.inc("collective.steps")
        ctx = trace.context()
        staged = [(t, bytes(bufs[t.src][t.offset:t.offset + t.nbytes]))
                  for t in group]
        futures = [(t, payload,
                    self._pool.submit(self._leg, rnd, gi, t, payload,
                                      ctx))
                   for t, payload in staged]
        landed: List[Tuple[synth.TransferStep, bytes]] = []
        errors: List[Tuple[synth.TransferStep, BaseException]] = []
        for t, payload, fut in futures:
            try:
                landed.append((t, fut.result()))
                per_node_ok[t.src] += 1
            except (DcnXferError, OSError, TimeoutError) as e:
                errors.append((t, e))
                per_node_failed[t.src] += 1
        for t, got in landed:
            if t.reduce:
                synth.combine(bufs[t.dst], t.offset, got)
            else:
                bufs[t.dst][t.offset:t.offset + t.nbytes] = got
        return errors


# -- CLI: the acceptance comparisons -----------------------------------------


class CompareError(Exception):
    """A comparison leg failed outright (not a margin miss)."""


def _boot_fleet(name: str, nodes: int, racks: int):
    from container_engine_accelerators_tpu_torch.fleet.controller import (
        FleetController,
    )

    ctl = FleetController({
        "name": name,
        "nodes": int(nodes),
        "racks": int(racks),
        "chips": 2,
        "topology": "1x2x1",
        "rounds": 0,
        "metrics": False,
    })
    ctl.boot()
    return ctl


def _best_round(ctl, args, algorithm: str,
                routed: bool = False) -> Optional[dict]:
    """``--rounds`` rounds of one pinned algorithm on a booted fleet;
    keeps the best-busbw entry.  A family the rig cannot lower
    (hierarchical on unequal racks) is *not a candidate* — returns
    None; a round that FAILS raises :class:`CompareError`."""
    engine = CollectiveEngine(
        ctl.nodes, ctl.topology, links=ctl.links,
        cfg=CollectiveConfig(op=args.op, bytes=args.bytes,
                             algorithm=algorithm, routed=routed))
    try:
        best = None
        for rnd in range(int(args.rounds)):
            try:
                entry = engine.run_round(rnd)
            except synth.SynthesisError as e:
                print(f"# {algorithm}: not a candidate ({e})",
                      file=sys.stderr)
                return None
            if not entry["ok"]:
                raise CompareError(
                    f"{algorithm} round {rnd} failed: "
                    f"{entry['error']}")
            if best is None \
                    or entry["busbw_bps"] > best["busbw_bps"]:
                best = entry
        return best
    finally:
        engine.close()


# The pinned asymmetric rig (5 nodes round-robined into 2 UNEQUAL
# racks: r0={n0,n2,n4}, r1={n1,n3}) with one degraded spine: both
# cross-rack edges the topology-blind families are forced through —
# the rack-major ring's wrap edges, which are also the star tree's
# root legs.  Ring and tree take ``order`` only, so they cannot route
# around these; the searched engine plans on the measured graph and
# can.
DEFAULT_SPINE_FAULTS = (
    "node:n4<->node:n1:latency:25",
    "node:n3<->node:n0:latency:25",
)

#: families the searched schedule must beat (best of)
FAMILIES = ("ring", "tree", "hierarchical")


def _compare_searched(args) -> int:
    """The searched-schedule acceptance gate: on the pinned asymmetric
    rig (unequal racks + degraded spine pairs), ``searched`` must beat
    the best hand-written family's bus bandwidth by ``--margin``; with
    ``--routed`` the searched run must ALSO prove its forwarded legs
    moved zero payload bytes through coordinator clients."""
    ctl = _boot_fleet("collective-searched", args.nodes, args.racks)
    spine = list(args.spine_fault or DEFAULT_SPINE_FAULTS)
    try:
        for spec in spine:
            ctl.links.apply(spec)
        families = {}
        for algo in FAMILIES:
            families[algo] = _best_round(ctl, args, algo)
        searched = _best_round(ctl, args, "searched",
                               routed=bool(args.routed))
    except CompareError as e:
        print(str(e), file=sys.stderr)
        return 2
    finally:
        ctl.close()
    candidates = {a: e for a, e in families.items() if e is not None}
    if not candidates or searched is None:
        print("no comparable family result", file=sys.stderr)
        return 2
    best_family = max(candidates, key=lambda a:
                      candidates[a]["busbw_bps"])
    family_bw = candidates[best_family]["busbw_bps"]
    searched_bw = searched["busbw_bps"]
    margin = searched_bw / max(family_bw, 1e-9)
    ok = margin >= float(args.margin)
    routed_acct = searched.get("routed") or {}
    if args.routed:
        # The lane-accounting proof: forwarded legs land on the
        # daemons (dcn.lane.forward.*), never on coordinator clients.
        if routed_acct.get("coordinator_payload_bytes", -1) != 0:
            print(f"# routed proof FAILED: "
                  f"{routed_acct.get('coordinator_payload_bytes')} "
                  f"payload bytes crossed coordinator clients",
                  file=sys.stderr)
            ok = False
        if not routed_acct.get("forward_bytes"):
            print("# routed proof FAILED: no forwarded bytes",
                  file=sys.stderr)
            ok = False
    report = {
        "mode": "searched",
        "nodes": int(args.nodes), "racks": int(args.racks),
        "op": args.op, "bytes": int(args.bytes),
        "routed": bool(args.routed),
        "spine_faults": spine,
        "families": families,
        "best_family": best_family,
        "searched": searched,
        "margin_x": round(margin, 3),
        "margin": float(args.margin),
        "pass": ok,
    }
    trend_rc = _compare_ledger(report, args)
    print(json.dumps(report))
    print(f"# searched {searched_bw:.0f} B/s vs best family "
          f"({best_family}) {family_bw:.0f} B/s = {margin:.2f}x "
          f"(need >= {args.margin:g}x) -> "
          f"{'PASS' if ok else 'FAIL'}", file=sys.stderr)
    if not ok:
        return 1
    return trend_rc


def _compare_ledger(report: dict, args) -> int:
    """Searched-vs-family evidence into the history ledger, judged
    against PRIOR runs of this config key first (a regressed run
    cannot poison its own baseline — fleet_sim's discipline).
    Returns 1 on a regression under ``--trend-gate``, else 0; ledger
    trouble costs the trend layer, never the comparison verdict."""
    if not (args.ledger or args.trend_gate):
        return 0
    from container_engine_accelerators_tpu_torch.obs import history

    ledger = history.RunLedger()
    if not ledger.enabled:
        return 0
    cfg_key = history.config_key(
        "collective_compare", report["op"], f"b{report['bytes']}",
        f"n{report['nodes']}", f"r{report['racks']}",
        "routed" if report["routed"] else "coord")
    metrics = {
        "searched_busbw_bps": report["searched"]["busbw_bps"],
        "best_family_busbw_bps":
            report["families"][report["best_family"]]["busbw_bps"],
        "margin_x": report["margin_x"],
    }
    if report["routed"]:
        metrics["routed_busbw_bps"] = report["searched"]["busbw_bps"]
    try:
        prior = ledger.records(kind="collective_compare",
                               cfg_key=cfg_key)
    except history.LedgerError as e:
        print(f"history ledger unreadable ({e}); trend gate skipped",
              file=sys.stderr)
        return 0
    verdicts = [history.trend_verdict(prior, m, v)
                for m, v in sorted(metrics.items())]
    ledger.record("collective_compare", cfg_key, metrics,
                  run_id=history.new_run_id())
    regressed = [v for v in verdicts if v["status"] == "regressed"]
    for v in verdicts:
        if v["status"] != "no_baseline":
            print("trend: " + history.format_verdict(v),
                  file=sys.stderr)
    report["trend"] = {"config_key": cfg_key, "verdicts": verdicts,
                       "ok": not regressed}
    return 1 if (args.trend_gate and regressed) else 0


def _scale_check(args) -> int:
    """The 2→4 rack scaling gate: routed searched busbw must GROW
    with fleet size on equal-rack rigs with a uniform cross-rack
    latency tier (per-rank bytes fixed, so more ranks = more data in
    flight — busbw is exactly the metric that must rise)."""
    points = []
    for racks in (2, 4):
        nodes = racks * int(args.rack_size)
        ctl = _boot_fleet(f"collective-scale-{racks}", nodes, racks)
        try:
            if args.xrack_latency_ms > 0:
                for a in range(racks):
                    for b in range(a + 1, racks):
                        ctl.links.apply(
                            f"rack:r{a}<->rack:r{b}:latency:"
                            f"{args.xrack_latency_ms:g}")
            best = _best_round(ctl, args, "searched", routed=True)
        except CompareError as e:
            print(str(e), file=sys.stderr)
            return 2
        finally:
            ctl.close()
        if best is None:
            print(f"searched failed on {racks} racks",
                  file=sys.stderr)
            return 2
        points.append({"racks": racks, "nodes": nodes,
                       "busbw_bps": best["busbw_bps"],
                       "time_ms": best["time_ms"],
                       "routed": best.get("routed")})
    grew = points[1]["busbw_bps"] > points[0]["busbw_bps"]
    print(json.dumps({"mode": "scale", "op": args.op,
                      "bytes": int(args.bytes),
                      "rack_size": int(args.rack_size),
                      "xrack_latency_ms": float(args.xrack_latency_ms),
                      "points": points, "pass": grew}))
    print(f"# routed searched busbw {points[0]['busbw_bps']:.0f} B/s "
          f"@2 racks -> {points[1]['busbw_bps']:.0f} B/s @4 racks -> "
          f"{'PASS' if grew else 'FAIL'}", file=sys.stderr)
    return 0 if grew else 1


def _compare(args) -> int:
    """Boot an in-process 2-rack fleet, degrade the cross-rack tier,
    run ring and hierarchical pinned over the SAME rig, and gate
    hierarchical's bus bandwidth at ``margin`` x the flat ring's."""
    ctl = _boot_fleet("collective-compare", args.nodes, args.racks)
    results = {}
    try:
        if args.xrack_latency_ms > 0:
            ctl.links.apply(
                f"rack:r0<->rack:r1:latency:{args.xrack_latency_ms:g}")
        for algo in ("ring", "hierarchical"):
            try:
                results[algo] = _best_round(ctl, args, algo)
            except CompareError as e:
                print(str(e), file=sys.stderr)
                return 2
            if results[algo] is None:
                print(f"{algo}: not a candidate on this rig",
                      file=sys.stderr)
                return 2
    finally:
        ctl.close()
    ring_bw = results["ring"]["busbw_bps"]
    hier_bw = results["hierarchical"]["busbw_bps"]
    ratio = hier_bw / max(ring_bw, 1e-9)
    ok = ratio >= float(args.margin)
    print(json.dumps({
        "nodes": int(args.nodes), "racks": int(args.racks),
        "op": args.op, "bytes": int(args.bytes),
        "xrack_latency_ms": float(args.xrack_latency_ms),
        "ring": results["ring"], "hierarchical": results["hierarchical"],
        "ratio": round(ratio, 3), "margin": float(args.margin),
        "pass": ok,
    }))
    print(f"# hierarchical {hier_bw:.0f} B/s vs ring {ring_bw:.0f} B/s "
          f"= {ratio:.2f}x (need >= {args.margin:g}x) -> "
          f"{'PASS' if ok else 'FAIL'}", file=sys.stderr)
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="topology-aware collective engine CLI")
    p.add_argument("--compare", action="store_true",
                   help="run the ring-vs-hierarchical acceptance "
                        "comparison on an in-process fleet")
    p.add_argument("--searched", action="store_true",
                   help="with --compare: searched vs the best "
                        "hand-written family on the pinned asymmetric "
                        "rig (unequal racks + degraded spine pairs)")
    p.add_argument("--routed", action="store_true",
                   help="run the searched schedule in daemon-routed "
                        "mode and gate the zero-coordinator-payload "
                        "lane-accounting proof")
    p.add_argument("--scale-check", action="store_true",
                   help="routed searched busbw must grow on a 2->4 "
                        "rack scaling check")
    p.add_argument("--spine-fault", action="append", default=None,
                   metavar="SPEC",
                   help="link-fault spec(s) for the degraded spine "
                        "(repeatable; default: the pinned 5-node "
                        "rig's ring wrap / tree root edges)")
    p.add_argument("--ledger", action="store_true",
                   help="record compare evidence to the history "
                        "ledger (kind collective_compare)")
    p.add_argument("--trend-gate", action="store_true",
                   help="exit non-zero when a recorded metric "
                        "regresses vs this config key's baseline")
    p.add_argument("--nodes", type=int, default=4)
    p.add_argument("--racks", type=int, default=2)
    p.add_argument("--rack-size", type=int, default=2,
                   help="nodes per rack for --scale-check rigs")
    p.add_argument("--bytes", type=int, default=262144)
    p.add_argument("--op", default="all_reduce",
                   choices=list(synth.COLLECTIVES))
    p.add_argument("--rounds", type=int, default=3,
                   help="rounds per algorithm; best busbw is compared")
    p.add_argument("--xrack-latency-ms", type=float, default=25.0,
                   help="injected cross-rack one-way latency (the "
                        "slow-spine rig the comparison runs on)")
    p.add_argument("--margin", type=float, default=1.3,
                   help="the challenger must beat the incumbent by "
                        "this factor (ring-vs-hierarchical default "
                        "1.3; the searched gate passes 1.15)")
    args = p.parse_args(argv)
    if args.scale_check:
        return _scale_check(args)
    if not args.compare:
        p.error("nothing to do: pass --compare or --scale-check")
    if args.searched:
        return _compare_searched(args)
    return _compare(args)


if __name__ == "__main__":
    sys.exit(main())
