"""FleetController: declarative chaos scenarios over N emulated nodes.

The port's copy of ``container_engine_accelerators_tpu/fleet/
controller.py`` (host code: no torch): the same scenario schema,
built-in scenarios and report keys, over the port's GPU nodes.  A chip
is named ``nvidia<i>`` where the JAX package names it ``accel<i>``.

A scenario is a plain dict (or JSON/YAML file — ``load_scenario``)::

    name: rack-partition
    nodes: 4            # or an explicit list of node dicts:
    racks: 2            #   {name, rack, chips, topology, partition_size}
    chips: 4
    topology: 2x2x1
    rounds: 6           # workload rounds; the fault schedule is keyed
    payload_bytes: 2048 # to rounds, so runs are reproducible
    metrics: false      # per-node MetricServer on an ephemeral port
    faults:
      - {round: 2, link: "rack:r0<->rack:r1:partition", for: 2}
      - {round: 1, action: chip_fault, node: n1, chip: nvidia0}
      - {round: 3, action: chip_recover, node: n1}
      - {round: 2, action: kill, node: n3, for: 1}

Workload: each round runs a ring of one-way DCN transfers (node i
stages a payload, streams it to node i+1's daemon through the link
table, node i+1 lands + reads it back) — every leg retried under a
bounded budget, so a leg that dies mid-partition re-converges after the
heal the way a real collective caller would.  ``for: K`` on a fault
schedules its inverse K rounds later (partition→heal, kill→restart).

The run returns one report: per-node (device health, daemon
generation, legs ok/failed), per-link (frames/bytes/drops/dups/blocked,
tier-annotated by the production scheduler distance), the round log,
the fleet-wide ``agent_events`` / ``agent_latency`` deltas, a
``telemetry`` section (per-round windowed goodput per ``{node, link}``
from fleet/telemetry.py), and an ``slo`` section evaluating the
scenario's declarative SLOs (``slo:`` mapping — p99 leg-latency
ceiling, goodput floor, retransmit/dedup ratio caps).  A scenario can
therefore *converge* and still FAIL: ``cmd/fleet_sim.py`` exits
non-zero on SLO breach, not just on non-convergence.

**Process mode** (``proc: true``): every node boots as its own OS
process (fleet/proc.py) — the scenario ``kill`` action delivers a real
``SIGKILL``, ``restart`` respawns under a supervisor with RetryPolicy
backoff and a bounded per-scenario budget (``restart_budget``, default
3; exhaustion marks the node permanently down and the scenario
non-converged), and telemetry aggregates by scraping each worker's
MetricServer over HTTP (``stale`` verdicts instead of hangs).  The
report schema is the same in both modes.  Link-table faults need the
in-process delivery fabric and are logged-and-skipped in proc mode;
endpoint chaos (kill / chip faults) is the point there.
"""

import json
import logging
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

from container_engine_accelerators_tpu_torch.fleet.links import (
    FleetNet,
    LinkFault,
    LinkTable,
    parse_link_fault,
)
from container_engine_accelerators_tpu_torch.fleet.node import EmulatedNode
from container_engine_accelerators_tpu_torch.fleet.proc import ProcNode
from container_engine_accelerators_tpu_torch.fleet.telemetry import FleetTelemetry
from container_engine_accelerators_tpu_torch.fleet.topology import (
    DEFAULT_CHIP,
    FleetTopology,
    NodeSpec,
    build_specs,
)
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import (
    critpath,
    histo,
    profiler,
    trace,
)
from container_engine_accelerators_tpu_torch.parallel import (
    dcn,
    dcn_pipeline,
    dcn_tune,
)
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferError,
)
from container_engine_accelerators_tpu_torch.serving.frontend import (
    RequestShed,
    ServingConfig,
    ServingFrontend,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

DEFAULT_SCENARIO = {
    "name": "rack-partition",
    "nodes": 4,
    "racks": 2,
    "chips": 4,
    "topology": "2x2x1",
    "rounds": 6,
    "payload_bytes": 2048,
    "metrics": False,
    "faults": [
        {"round": 1, "action": "chip_fault", "node": "n1",
         "chip": DEFAULT_CHIP},
        {"round": 2, "link": "rack:r0<->rack:r1:partition", "for": 2},
        {"round": 3, "action": "chip_recover", "node": "n1"},
    ],
}

# The `--proc` headline: real OS-process nodes, a real SIGKILL
# mid-scenario, supervised respawn two rounds later, pipelined
# multi-chunk legs so the kill lands against in-flight transfer state,
# and a chip fault recovering through a worker's own health checker.
DEFAULT_PROC_SCENARIO = {
    "name": "proc-sigkill",
    "proc": True,
    "nodes": 3,
    "racks": 1,
    "chips": 2,
    "topology": "1x2x1",
    "rounds": 5,
    "payload_bytes": 16384,
    "pipelined": True,
    "chunk_bytes": 4096,
    "stripes": 2,
    "faults": [
        {"round": 1, "action": "kill", "node": "n1", "for": 2},
        {"round": 2, "action": "chip_fault", "node": "n2",
         "chip": DEFAULT_CHIP},
        {"round": 3, "action": "chip_recover", "node": "n2"},
    ],
}


# The serving headline (`--workload serving`): a ServingFrontend
# spraying batched requests across the fleet while a node is SIGKILLed
# mid-load — hedged retries + the per-node breaker steer traffic away
# from the corpse, the supervisor (in-process: the `for:` inverse)
# brings it back, and the serving SLOs gate the exit code.
DEFAULT_SERVING_SCENARIO = {
    "name": "serving-node-kill",
    "workload": "serving",
    "nodes": 3,
    "racks": 1,
    "chips": 2,
    "topology": "1x2x1",
    "rounds": 5,
    "payload_bytes": 2048,
    "serving": {
        "requests_per_round": 16,
        "max_batch": 4,
        "max_wait_ms": 4.0,
        "hedge_after_ms": 500.0,
        "breaker_cooldown_s": 0.5,
    },
    "faults": [
        {"round": 1, "action": "kill", "node": "n1", "for": 2},
    ],
    "slo": {
        "min_qps": 1.0,
        "max_error_ratio": 0.5,
        "p99_e2e_ms": 30000,
    },
}


# The collective headline (`--workload collective`): the topology-aware
# engine synthesizes the schedule from the measured comm graph (2 racks
# -> hierarchical reduce-scatter / exchange / all-gather), the
# cross-rack tier degrades mid-run and heals (`for:`), the engine
# re-synthesizes on both edges of the fault (`collective.resynth`), and
# the recovery floor SLO gates that post-heal bus bandwidth is back.
DEFAULT_COLLECTIVE_SCENARIO = {
    "name": "collective-xrack-latency",
    "workload": "collective",
    "nodes": 4,
    "racks": 2,
    "chips": 2,
    "topology": "1x2x1",
    "rounds": 6,
    "payload_bytes": 65536,
    "collective": {
        "op": "all_reduce",
        "bytes": 65536,
    },
    "faults": [
        {"round": 2, "link": "rack:r0<->rack:r1:latency:30", "for": 2},
    ],
    "slo": {
        "min_final_busbw_bps": 50000,
    },
}


def load_scenario(path: str) -> dict:
    """Read a scenario file: YAML when the extension says so (and
    PyYAML is importable), JSON otherwise."""
    with open(path) as f:
        raw = f.read()
    if path.endswith((".yaml", ".yml")):
        import yaml

        return yaml.safe_load(raw)
    return json.loads(raw)


def _scenario_specs(scenario: dict) -> List[NodeSpec]:
    nodes = scenario.get("nodes", 4)
    if isinstance(nodes, int):
        return build_specs(
            nodes,
            racks=int(scenario.get("racks", 1)),
            chips=int(scenario.get("chips", 4)),
            topology=scenario.get("topology", "2x2x1"),
            partition_size=scenario.get("partition_size", ""),
        )
    return [
        NodeSpec(
            name=n["name"],
            rack=n.get("rack", "r0"),
            chips=int(n.get("chips", scenario.get("chips", 4))),
            topology=n.get("topology", scenario.get("topology", "2x2x1")),
            partition_size=n.get("partition_size", ""),
            # A shared slice id and mesh coords are carried as given;
            # the port's distance has no ICI tier, so they move no tier
            # or ring decision.
            slice_id=n.get("slice"),
            coords=n.get("coords", "0,0,0"),
        )
        for n in nodes
    ]


class FleetController:
    def __init__(self, scenario: Optional[dict] = None,
                 workdir: Optional[str] = None):
        self.scenario = dict(DEFAULT_SCENARIO if scenario is None
                             else scenario)
        self.workdir = workdir or tempfile.mkdtemp(prefix="fleet-sim-")
        self.topology = FleetTopology(_scenario_specs(self.scenario))
        self.links = LinkTable(self.topology)
        self.net = FleetNet(self.links)
        self.nodes: Dict[str, EmulatedNode] = {}
        self.rounds = int(self.scenario.get("rounds", 6))
        self.payload_bytes = int(self.scenario.get("payload_bytes", 2048))
        # Process mode: one OS process per node, real SIGKILL chaos,
        # HTTP-scraped telemetry (fleet/proc.py).
        self.proc_mode = bool(self.scenario.get("proc", False))
        # Pipelined ring legs: chunked/striped transfers through the
        # same link-table fault surface.  Chunk/stripe/shm knobs come
        # from the scenario first, the TPU_DCN_* env second.  Emulated
        # nodes are same-host by construction, so `shm: false` is how
        # a scenario pins the socket lane (fault-parity runs).
        self.pipelined = bool(self.scenario.get("pipelined", False))
        # `tuned: true` closes the loop: the chunk/stripe grid above
        # becomes only the BASE — parallel/dcn_tune.py adapts it per
        # destination from the legs' own telemetry (the no-operator-
        # knobs scenarios).  Learned state is dropped at boot so every
        # run starts from the declared grid, reproducibly.
        self.pipe_cfg = dcn_pipeline.PipelineConfig(
            chunk_bytes=self.scenario.get("chunk_bytes"),
            stripes=self.scenario.get("stripes"),
            shm=self.scenario.get("shm"),
            tuned=self.scenario.get("tuned"),
            # `shm_direct: false` pins every daemon→peer leg to TCP —
            # the lane-parity handle for proc scenarios, where real
            # co-hosted worker daemons would otherwise take the
            # daemon↔daemon segment lane (in-process fleets route
            # through the fabric and never take it).
            shm_direct=self.scenario.get("shm_direct"),
            ring=self.scenario.get("shm_ring"),
        )
        self.leg_retry = RetryPolicy(
            max_attempts=int(self.scenario.get("leg_attempts", 3)),
            initial_backoff_s=float(
                self.scenario.get("leg_backoff_ms", 30)) / 1e3,
            max_backoff_s=0.2,
            deadline_s=float(self.scenario.get("leg_deadline_s", 8.0)),
        )
        self.land_timeout_s = float(self.scenario.get("land_timeout_s", 2.0))
        # Workload: "ring" (the classic transfer legs), "serving" (a
        # ServingFrontend spraying batched/hedged requests across the
        # fleet — serving/frontend.py), or "collective" (the
        # topology-aware engine synthesizing and executing collective
        # schedules from the fleet's comm graph — collectives/).
        self.workload = str(self.scenario.get("workload", "ring"))
        self.frontend: Optional[ServingFrontend] = None
        # A collectives.runner.CollectiveEngine when workload is
        # "collective" (imported at boot — the engine plans against
        # fleet.topology, so a module-level import would be circular).
        self.collective = None
        # round -> list of deferred inverse faults ("for: K" entries)
        self._deferred: Dict[int, List[dict]] = {}
        self._booted = False
        self._counters0: Dict[str, int] = {}
        self.telemetry: Optional[FleetTelemetry] = None
        self._prof_started = False

    # -- lifecycle -----------------------------------------------------------

    def boot(self) -> "FleetController":
        if self._booted:
            return self
        if self.pipe_cfg.tuned:
            # Fresh controller state per scenario run: tuners learned
            # against a previous fleet's ports must not steer this one.
            dcn_tune.reset()
        try:
            if self.proc_mode:
                self._boot_procs()
            else:
                for spec in self.topology.specs.values():
                    self.nodes[spec.name] = EmulatedNode(
                        spec, os.path.join(self.workdir, spec.name),
                        net=self.net,
                        metrics=bool(self.scenario.get("metrics",
                                                       False)),
                    )
        except Exception:
            self.close()  # no orphan workers on a half-booted fleet
            raise
        # CPU attribution for the run: workers sample themselves
        # (fleet/proc.py starts the profiler in every worker); the
        # coordinator — where the transfer clients and the serving
        # frontend live in BOTH modes — samples here.  Only stop at
        # close() what this controller itself started: a bench or
        # test that armed the profiler first keeps it.
        if not profiler.running():
            self._prof_started = profiler.start()
        self._counters0 = counters.snapshot()
        self.telemetry = FleetTelemetry(
            self.nodes, self.links, self.scenario.get("slo"),
            scrape=self.proc_mode,
        )
        if self.workload == "serving":
            self.frontend = ServingFrontend(
                self.nodes,
                ServingConfig.from_scenario(self.scenario.get("serving")),
            ).start()
        elif self.workload == "collective":
            from container_engine_accelerators_tpu_torch.collectives.runner \
                import CollectiveConfig, CollectiveEngine

            # The engine plans against the coordinator's link table in
            # BOTH modes: in-process fleets fault it directly, process
            # fleets mirror their worker-shim faults into it
            # (_apply_proc_link_fault), so the comm graph sees the
            # same evidence either way.
            self.collective = CollectiveEngine(
                self.nodes, self.topology, links=self.links,
                cfg=CollectiveConfig.from_scenario(
                    self.scenario.get("collective")),
                pipe_cfg=self.pipe_cfg if self.pipelined else None,
            )
        self._booted = True
        log.info("fleet booted: %d node(s) in %d rack(s)%s",
                 len(self.nodes),
                 len({s.rack for s in self.topology.specs.values()}),
                 " [one process each]" if self.proc_mode else "")
        return self

    def _boot_procs(self) -> None:
        """One OS process per node, spawned together (a worker's
        interpreter start and handshake take most of a second); the
        MetricServer is always on (it is the aggregation transport).
        A worker that never handshakes raises ProcHandshakeError once
        every spawn has ended; the siblings that did come up stay in
        ``self.nodes`` for the caller's close() to reap."""
        specs = list(self.topology.specs.values())
        env = self.child_env()
        ctx = trace.context() or {}

        def spawn(spec):
            with trace.attach(ctx.get("trace"), ctx.get("span")):
                return ProcNode(
                    spec, os.path.join(self.workdir, spec.name), env=env,
                    handshake_timeout_s=float(
                        self.scenario.get("handshake_timeout_s", 60.0)),
                    restart_budget=int(
                        self.scenario.get("restart_budget", 3)),
                )

        error: Optional[BaseException] = None
        with ThreadPoolExecutor(max_workers=min(len(specs), 8) or 1,
                                thread_name_prefix="fleet-spawn") as pool:
            futures = [(spec.name, pool.submit(spawn, spec))
                       for spec in specs]
            for name, fut in futures:
                try:
                    self.nodes[name] = fut.result()
                except Exception as e:
                    error = error or e
        if error is not None:
            raise error

    def close(self) -> None:
        if self.frontend is not None:
            self.frontend.close()
            self.frontend = None
        if self.collective is not None:
            self.collective.close()
            self.collective = None
        for node in self.nodes.values():
            node.close()
        if self._prof_started:
            profiler.stop()
            self._prof_started = False

    # -- fault schedule ------------------------------------------------------

    def _apply_fault(self, rnd: int, entry: dict) -> dict:
        """Apply one schedule entry; returns a loggable record."""
        record = dict(entry)
        record["round"] = rnd
        if "link" in entry:
            fault = (entry["link"] if isinstance(entry["link"], LinkFault)
                     else parse_link_fault(entry["link"]))
            if fault is None:
                record["link"] = str(entry["link"])  # JSON-clean log
                record["applied"] = 0
                return record
            record["link"] = fault.spec()  # JSON-clean round log
            if self.proc_mode:
                # The delivery fabric cannot interpose on another
                # process's TCP stack — instead the fault is armed in
                # each source WORKER's daemon over the RPC pipe
                # (PyXferd's netem-like link shim): same selectors,
                # same actions, applied in the send path.
                record["applied"] = self._apply_proc_link_fault(
                    fault, record)
                # Mirror the fault into the coordinator's link table
                # as ANNOTATION state (no frame routes through it in
                # proc mode): the collective engine's comm graph and
                # the scheduler's link-health penalty read the same
                # evidence in both fleet modes.  One honest asymmetry:
                # a mirrored drop BUDGET never decrements here (the
                # frames that spend it cross worker TCP, not this
                # table), so the edge reads degraded until a heal —
                # conservative planning, never the reverse.
                self.links.apply(fault)
            else:
                record["applied"] = len(self.links.apply(fault))
            lifetime = int(entry.get("for", 0))
            inverse = fault.inverse()
            if lifetime > 0 and inverse is not None:
                self._deferred.setdefault(rnd + lifetime, []).append(
                    {"link": inverse}
                )
            return record
        action = entry.get("action", "")
        node = self.nodes.get(entry.get("node", ""))
        if node is None:
            log.error("fault entry names unknown node: %r", entry)
            record["applied"] = 0
            return record
        try:
            if action == "chip_fault":
                node.inject_chip_fault(entry.get("chip", DEFAULT_CHIP),
                                       int(entry.get("code", 48)))
            elif action == "chip_recover":
                record["recovered"] = node.force_recover()
            elif action == "kill":
                node.kill_daemon()
                lifetime = int(entry.get("for", 0))
                if lifetime > 0:
                    self._deferred.setdefault(rnd + lifetime, []).append(
                        {"action": "restart", "node": node.name}
                    )
            elif action == "restart":
                if node.restart_daemon() is False:
                    # Refused (permanently down / budget spent): the
                    # round log must not claim a respawn that never
                    # happened — that's the scenario's whole verdict.
                    record["applied"] = 0
                    record["skipped"] = "restart refused (node " \
                        "permanently down or budget exhausted)"
                    return record
            else:
                log.error("unknown fault action %r", action)
        except OSError as e:
            # A fault aimed at a node whose worker is dark (SIGKILLed
            # earlier in the schedule, or mid-crash): in proc mode the
            # RPC has no one to talk to.  Degrade, don't crash — same
            # rule as link faults above; the round log says why.
            log.error("fault %r on node %s not applied: %s",
                      action, node.name, e)
            record["applied"] = 0
            record["skipped"] = str(e)
            return record
        record["applied"] = 1
        return record

    def _apply_proc_link_fault(self, fault: LinkFault,
                               record: dict) -> int:
        """Arm one parsed link fault across a process-mode fleet: the
        selectors resolve to directed node pairs (the link table's own
        resolution), and each pair becomes a shim entry in the SOURCE
        worker's daemon keyed by the destination's current data port.
        A dark source worker degrades that pair (recorded), never the
        schedule; a destination respawn resets its inbound shim state
        (fresh port — the same reset its flows get)."""
        applied = 0
        skipped = []
        for src, dst in self.links.pairs_for(fault):
            sn, dn = self.nodes.get(src), self.nodes.get(dst)
            if sn is None or dn is None:
                continue
            try:
                applied += sn.apply_link_fault(
                    dn.daemon.data_port, fault.action, fault.param)
            except OSError as e:
                skipped.append(f"{src}->{dst}: {e}")
        if skipped:
            record["skipped"] = "; ".join(skipped)
        return applied

    # -- workload ------------------------------------------------------------

    def _leg(self, rnd: int, src: EmulatedNode, dst: EmulatedNode) -> dict:
        """One one-way transfer src → dst, retried under the leg
        budget.  Flow names are unique per (round, pair) so retries
        never collide with the daemons' duplicate-flow rejection."""
        payload = bytes([(rnd * 31 + len(src.name)) % 256]) \
            * self.payload_bytes
        # ONE name, registered on both daemons: frames land into the
        # flow of the same name on the receiver (the exchange_shard
        # convention); unique per (round, pair) so retries never hit
        # duplicate-flow rejection.
        flow = f"r{rnd}.{src.name}.{dst.name}"
        tx = rx = flow
        result = {"src": src.name, "dst": dst.name, "ok": False,
                  "attempts": 0}
        with trace.span("fleet.leg", histogram="fleet.leg", round=rnd,
                        src=src.name, dst=dst.name,
                        bytes=self.payload_bytes,
                        pipelined=self.pipelined) as span:
            try:
                dst.client.register_flow(rx, peer=src.name,
                                         bytes=self.payload_bytes)
                src.client.register_flow(tx, peer=dst.name,
                                         bytes=self.payload_bytes)
                if not self.pipelined:
                    # Serial leg: whole-payload staging up front.  The
                    # pipelined leg stages chunk-by-chunk inside each
                    # send attempt instead (a retry after a daemon kill
                    # must restage anyway).
                    src.client.put(tx, payload)
                    dcn.wait_flow_rx(src.client, tx, len(payload),
                                     timeout_s=self.land_timeout_s)
                last: Optional[BaseException] = None
                for _attempt in self.leg_retry.attempts():
                    result["attempts"] += 1
                    try:
                        if self.pipelined:
                            dcn_pipeline.send_pipelined(
                                src.client, tx, payload, "127.0.0.1",
                                dst.daemon.data_port, self.pipe_cfg,
                                timeout_s=self.land_timeout_s)
                            got = dcn_pipeline.read_pipelined(
                                dst.client, rx, len(payload),
                                self.pipe_cfg,
                                timeout_s=self.land_timeout_s)
                        else:
                            src.client.send(tx, "127.0.0.1",
                                            dst.daemon.data_port,
                                            len(payload))
                            dcn.wait_flow_rx(dst.client, rx,
                                             len(payload),
                                             timeout_s=self.land_timeout_s)
                            got = dst.client.read(rx, len(payload))
                        if got != payload:
                            raise DcnXferError(
                                f"payload mismatch on {flow}"
                            )
                        result["ok"] = True
                        return result
                    except (DcnXferError, OSError, TimeoutError) as e:
                        last = e
                result["error"] = str(last)
                span.annotate(error=str(last))
                return result
            except (DcnXferError, OSError, TimeoutError) as e:
                result["error"] = str(e)
                span.annotate(error=str(e))
                return result
            finally:
                span.annotate(ok=result["ok"],
                              attempts=result["attempts"])
                for node, flow in ((src, tx), (dst, rx)):
                    try:
                        node.client.release_flow(flow)
                    except (DcnXferError, OSError):
                        pass

    def _serving_round(self, rnd: int, per_node_ok: Dict[str, int],
                       per_node_failed: Dict[str, int]) -> dict:
        """One serving round: spray ``requests_per_round`` requests at
        the frontend, wait for every one to TERMINATE (result, error,
        or shed — a request silently lost fails the round outright),
        and fold the frontend's per-node dispatch deltas into the
        report's per-node accounting.  The round-log entry keeps the
        same ``ok``-bool convergence contract as a ring leg."""
        serving = self.scenario.get("serving") or {}
        n = int(serving.get("requests_per_round", 16))
        wait_s = float(serving.get("round_deadline_s", 20.0))
        stats0 = {name: dict(st)
                  for name, st in self.frontend.node_stats.items()}
        reqs = []
        shed = 0
        entry = {"workload": "serving", "requests": n}
        with trace.span("fleet.serving_round", round=rnd, requests=n):
            for i in range(n):
                payload = bytes([(rnd * 31 + i) % 256]) \
                    * self.payload_bytes
                try:
                    reqs.append((self.frontend.submit(payload),
                                 payload))
                except RequestShed:
                    shed += 1
            ok = errors = lost = 0
            deadline = time.monotonic() + wait_s
            for req, payload in reqs:
                if not req.wait(max(0.0,
                                    deadline - time.monotonic())):
                    lost += 1  # never terminated: the worst verdict
                    continue
                if req.error is None and req.result == payload:
                    ok += 1
                else:
                    errors += 1
        for name, st in self.frontend.node_stats.items():
            per_node_ok[name] += st["ok"] - stats0[name]["ok"]
            per_node_failed[name] += (st["failed"]
                                      - stats0[name]["failed"])
        entry.update(
            accepted=len(reqs), shed=shed, ok_requests=ok,
            errors=errors, lost=lost,
            ok=bool(reqs) and lost == 0 and errors == 0
            and ok == len(reqs),
        )
        return entry

    def _collective_round(self, rnd: int, per_node_ok: Dict[str, int],
                          per_node_failed: Dict[str, int]) -> dict:
        """One collective round: re-plan against the current comm
        graph if the fault state moved (the engine's synthesizer owns
        that), execute the schedule over the rig, and fold the
        per-node leg accounting into the report.  The entry keeps the
        ``ok``-bool convergence contract, and the telemetry layer
        collects the busbw history the `min_busbw_bps` /
        `min_final_busbw_bps` SLOs judge."""
        entry = self.collective.run_round(rnd)
        for name, n in entry.pop("per_node_ok").items():
            per_node_ok[name] += n
        for name, n in entry.pop("per_node_failed").items():
            per_node_failed[name] += n
        tele = {k: entry[k] for k in ("ok", "algorithm", "busbw_bps",
                                      "resynth")}
        if "routed" in entry:
            # Routed-mode lane accounting rides along so the
            # min_forward_bytes / max_coordinator_leg_bytes SLOs can
            # judge the pure-control-plane claim per run.
            tele["routed"] = entry["routed"]
        self.telemetry.collective_rounds.append(tele)
        return entry

    def _ring(self) -> List[tuple]:
        names = list(self.nodes)
        n = len(names)
        return [(self.nodes[names[i]], self.nodes[names[(i + 1) % n]])
                for i in range(n)] if n > 1 else []

    # -- the run -------------------------------------------------------------

    def run(self) -> dict:
        self.boot()
        per_node_ok: Dict[str, int] = {n: 0 for n in self.nodes}
        per_node_failed: Dict[str, int] = {n: 0 for n in self.nodes}
        round_log = []
        with trace.span("fleet.scenario",
                        scenario=self.scenario.get("name", "fleet"),
                        nodes=len(self.nodes), rounds=self.rounds):
            scheduled = list(self.scenario.get("faults", []))
            for rnd in range(self.rounds):
                fired = []
                for entry in self._deferred.pop(rnd, []):
                    fired.append(self._apply_fault(rnd, entry))
                for entry in scheduled:
                    if int(entry.get("round", 0)) == rnd:
                        fired.append(self._apply_fault(rnd, entry))
                legs = []
                with trace.span("fleet.round", round=rnd):
                    if self.frontend is not None:
                        legs.append(self._serving_round(
                            rnd, per_node_ok, per_node_failed))
                    elif self.collective is not None:
                        legs.append(self._collective_round(
                            rnd, per_node_ok, per_node_failed))
                    else:
                        for src, dst in self._ring():
                            if src.down or dst.down:
                                legs.append({"src": src.name,
                                             "dst": dst.name,
                                             "skipped": "node down"})
                                continue
                            leg = self._leg(rnd, src, dst)
                            legs.append(leg)
                            if leg["ok"]:
                                per_node_ok[src.name] += 1
                            else:
                                per_node_failed[src.name] += 1
                    for node in self.nodes.values():
                        node.recover()
                # Scrape every node's registry while the round's
                # traffic is still inside the rate window.
                self.telemetry.sample_round(rnd)
                round_log.append(
                    {"round": rnd, "faults": fired, "legs": legs}
                )
        return self._report(round_log, per_node_ok, per_node_failed)

    def _report(self, round_log, per_node_ok, per_node_failed) -> dict:
        final_legs = round_log[-1]["legs"] if round_log else []
        survivors_converged = all(
            leg.get("ok", False) for leg in final_legs
            if "skipped" not in leg
        ) and bool(final_legs)
        # The serving zero-lost invariant gates the WHOLE run, not
        # just the final round: mid-chaos rounds may ERROR requests
        # (bounded budgets spent — the contract allows it), but a
        # request that never terminated is a correctness failure no
        # amount of later convergence buys back.
        serving_lost = sum(
            leg.get("lost", 0)
            for entry in round_log for leg in entry["legs"]
            if leg.get("workload") == "serving")
        nodes_report = {}
        all_up_healthy = True
        for name, node in self.nodes.items():
            snap = node.snapshot()
            snap["legs_ok"] = per_node_ok[name]
            snap["legs_failed"] = per_node_failed[name]
            nodes_report[name] = snap
            # Judge healthiness from the snapshot in hand: in proc
            # mode all_healthy() would issue a SECOND snapshot RPC per
            # node, and the two could disagree mid-recovery.
            if not snap.get("down") and not (
                    snap.get("total", 0) > 0
                    and snap.get("healthy") == snap.get("total")):
                all_up_healthy = False
        # A node whose restart budget exhausted is permanently down:
        # its legs being "skipped" must not let the scenario converge —
        # capacity is gone and nothing will bring it back.
        none_permanently_down = not any(
            getattr(node, "permanently_down", False)
            for node in self.nodes.values()
        )
        # Observability snapshot: THIS process's counters and latency
        # histograms.  In the one-process rig the process registries
        # ARE the fleet's; in proc mode this is the coordinator side
        # only (client/pipeline healing) — the workers' registries
        # arrive via the telemetry section's HTTP scrapes instead.
        delta = {}
        now = counters.snapshot()
        for k, v in now.items():
            d = v - self._counters0.get(k, 0)
            if d:
                delta[k] = d
        latency = {
            op: {"count": h["count"],
                 "p50_us": (histo.percentile(op, 0.5) or 0) * 1e6,
                 "p99_us": (histo.percentile(op, 0.99) or 0) * 1e6}
            for op, h in histo.snapshot().items()
            if op.startswith(("fleet.", "xferd.", "dcn."))
        }
        links_report = self.links.report()
        # Where did the run's wall-clock go: span trees from the
        # coordinator ring (+ scraped workers in proc mode) rolled up
        # per request shape, with the dominant phase named
        # (obs/critpath.py).  A latency-faulted link shows up HERE as
        # "dcn.chunk.send dominated", not just as a slower p99.
        critical_path = critpath.analyze(self.telemetry.spans())
        critical_path["dropped_spans"] = self.telemetry.spans_dropped
        report_extra = {}
        if self.collective is not None:
            graph = self.collective.graph()
            report_extra["collective"] = {
                "resynth": self.collective.synth.resynth_count,
                "schedule": (
                    self.collective.synth.current().to_dict()
                    if self.collective.synth.current() else None),
                # The placement side of the same evidence: per-node
                # partitioned/degraded link rollup — what the
                # scheduler's link-health penalty steers on.
                "node_health": graph.node_health(),
            }
        if self.frontend is not None:
            report_extra["serving"] = {
                "breakers": self.frontend.breaker.snapshot(),
                "node_stats": {
                    name: dict(st) for name, st
                    in self.frontend.node_stats.items()
                },
                "lost_requests": serving_lost,
            }
        return {
            "scenario": self.scenario.get("name", "fleet"),
            "proc": self.proc_mode,
            "workload": self.workload,
            **report_extra,
            "nodes": nodes_report,
            "links": links_report,
            "rounds": round_log,
            "agent_events_delta": delta,
            "agent_latency": latency,
            "critical_path": critical_path,
            # Where did the CPU go: merged continuous-profiler stacks
            # (per worker via /profile scrapes in proc mode, plus the
            # coordinator's own sampler) — the companion question to
            # critical_path's "where did the wall time go".
            "profile": self.telemetry.profile_report(),
            # Grey-failure verdicts (obs/anomaly.py): live peer-
            # relative suspicion per node, plus the closed-loop
            # precision/recall judgment when the soak world fed its
            # seeded schedule as ground truth.
            "anomaly": self.telemetry.anomaly_report(),
            "telemetry": {"rounds": self.telemetry.history},
            "slo": self.telemetry.evaluate(links_report),
            "converged": (survivors_converged and all_up_healthy
                          and none_permanently_down
                          and serving_lost == 0),
        }

    # -- coordinator env -----------------------------------------------------

    def child_env(self, base: Optional[dict] = None) -> dict:
        """Env for a worker process this coordinator spawns: the active
        trace context rides TPU_TRACE_CONTEXT so the child's spans join
        the coordinator's trace (obs/trace.attach_from_env)."""
        env = dict(os.environ if base is None else base)
        ctx = trace.context_env()
        if ctx:
            env[trace.TRACE_CONTEXT_ENV] = ctx
        return env


def run_scenario(scenario: Optional[dict] = None,
                 workdir: Optional[str] = None) -> dict:
    """One-shot convenience: boot, run, close, return the report."""
    ctl = FleetController(scenario, workdir=workdir)
    try:
        return ctl.run()
    finally:
        ctl.close()
