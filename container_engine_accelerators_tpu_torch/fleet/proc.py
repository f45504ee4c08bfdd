"""Process-mode fleet: every emulated node is its own OS process.

The port's copy of ``container_engine_accelerators_tpu/fleet/proc.py``
(host code: a worker loads no torch).  The worker is spawned as this
package's ``worker_main``, from the repo root, so it runs the port's
node stack and never the JAX package's.

The one-process rig (fleet/node.py + fleet/controller.py) proved the
*logic* of chaos recovery, but a scenario ``kill`` there is a method
call: ``PyXferd.stop(crash=True)`` still runs Python teardown inside a
process that keeps living.  Production daemons do not get that
courtesy — SIGKILL runs zero lines of their code, their sockets die
with the task_struct, their mmap segment files linger on disk, and the
supervisor that respawns them is a different process with its own
bounded patience.  This module supplies that substrate:

- **worker half** (``python -m container_engine_accelerators_tpu_torch.
  fleet.proc``): one :class:`~…fleet.node.EmulatedNode` — real
  GpuManager + health checker + PyXferd + per-node MetricServer — in
  its own process.  It reports its daemon/metrics ports to the
  coordinator over a handshake line on stdout, then serves a tiny
  newline-JSON RPC (chip faults, recovery pumps, snapshots) on
  stdin/stdout.  stdin EOF is a clean shutdown; SIGTERM dumps the
  flight recorder first (the evidence must outlive the pod); SIGKILL
  is the chaos the rest of the stack exists to survive.

- **coordinator half** (:class:`ProcNode`): the EmulatedNode-shaped
  handle the controller drives.  ``kill_daemon`` delivers a real
  ``SIGKILL`` and reaps the corpse (waitpid — no zombies);
  ``restart_daemon`` respawns under a small supervisor — RetryPolicy
  backoff on spawn attempts, a bounded per-scenario restart budget
  (``fleet.node.restarts`` counts successes; exhaustion marks the node
  permanently down instead of looping forever).  The coordinator keeps
  the production :class:`ResilientDcnXferClient` pointed at the
  worker's UDS path, so every leg of the ring workload crosses a real
  process boundary and heals through the same reconnect/replay/restage
  machinery a production caller would.

A worker that never completes its handshake is killed, reaped, and
surfaced as :class:`ProcHandshakeError` — ``cmd/fleet_sim.py`` exits
nonzero instead of hanging on it.

Link-table faults (partition/loss/latency) are a one-process feature:
the delivery fabric cannot interpose on another process's TCP stack,
so ``proc: true`` scenarios get endpoint chaos (SIGKILL, chip faults)
and direct daemon→daemon TCP; link-level chaos stays with the
in-process rig.  Telemetry aggregation flips the other way: with no
shared registry, ``fleet/telemetry.py`` scrapes each worker's
MetricServer over HTTP (per-node timeout, one retry, ``stale``
verdicts) — the aggregation path production would use.
"""

import json
import logging
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

from container_engine_accelerators_tpu_torch.fleet.topology import DEFAULT_CHIP
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

SPEC_ENV = "FLEET_PROC_SPEC"
# Test hook: a worker that parks before its handshake — the
# never-completes-handshake failure cmd/fleet_sim.py must exit 2 on.
HANG_ENV = "FLEET_PROC_HANG"

DEFAULT_HANDSHAKE_TIMEOUT_S = 60.0
DEFAULT_RPC_TIMEOUT_S = 15.0
DEFAULT_RESTART_BUDGET = 3
# Teardown escalation grace per stage: stdin EOF -> SIGTERM -> SIGKILL.
CLOSE_GRACE_S = 5.0

# Supervisor respawn attempts for ONE restart_daemon call; a spec that
# cannot come up inside this budget marks the node permanently down.
RESPAWN_RETRY = RetryPolicy(
    max_attempts=3, initial_backoff_s=0.2, max_backoff_s=1.0,
    deadline_s=30.0,
)

_PKG_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


class ProcHandshakeError(RuntimeError):
    """A node worker never reported ready (spawn failed, import crash,
    or a hang) — the coordinator killed and reaped it."""


# ---------------------------------------------------------------------------
# coordinator half
# ---------------------------------------------------------------------------


class _DaemonHandle:
    """What the controller needs of a remote daemon: where to send
    (the handshake-reported data port) and which incarnation is
    serving (cumulative across respawns, like the in-process
    ``PyXferd.generation``)."""

    def __init__(self):
        self.data_port = 0
        self.generation = 0


class ProcNode:
    """Coordinator-side handle for one node worker process.

    Interface-compatible with :class:`~…fleet.node.EmulatedNode` where
    the controller touches it: ``client`` / ``daemon.data_port`` for
    the workload legs, ``down`` / ``snapshot`` / ``all_healthy`` for
    the report, ``inject_chip_fault`` / ``force_recover`` / ``recover``
    for the fault schedule — except that here each of those crosses a
    real process boundary.
    """

    def __init__(self, spec, root: str,
                 env: Optional[dict] = None,
                 handshake_timeout_s: float = DEFAULT_HANDSHAKE_TIMEOUT_S,
                 restart_budget: int = DEFAULT_RESTART_BUDGET,
                 respawn_retry: Optional[RetryPolicy] = None,
                 metrics_interval_s: float = 0.25,
                 client_retry: Optional[RetryPolicy] = None,
                 stderr=None):
        self.spec = spec
        self.name = spec.name
        self.root = root
        self.down = True  # until the first handshake lands
        self.permanently_down = False
        self.restarts = 0
        self.restart_budget = int(restart_budget)
        self.handshake_timeout_s = float(handshake_timeout_s)
        self.metrics_interval_s = float(metrics_interval_s)
        self.respawn_retry = respawn_retry or RESPAWN_RETRY
        self.metrics_port = 0
        self.shm_dir = os.path.join(root, "tpu-dcn", "shm")
        self.pid: Optional[int] = None
        self.daemon = _DaemonHandle()
        self.proc: Optional[subprocess.Popen] = None
        self._base_env = dict(os.environ if env is None else env)
        self._stderr = stderr
        self._q: "queue.Queue" = queue.Queue()
        self._rpc_lock = threading.Lock()
        self._rpc_id = 0
        self._spawns = 0
        self._last_snapshot: Dict[str, object] = {
            "rack": spec.rack, "devices": {}, "healthy": 0, "total": 0,
        }
        self._spawn()
        # The production client, pointed across the process boundary:
        # the worker's daemon binds the same UDS path on every respawn,
        # so reconnect + flow-table replay heal a SIGKILL transparently.
        from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
            ResilientDcnXferClient,
        )
        from container_engine_accelerators_tpu_torch.fleet.node import (
            FLEET_CLIENT_RETRY,
        )

        self.client = ResilientDcnXferClient(
            os.path.join(root, "tpu-dcn"),
            retry=client_retry or FLEET_CLIENT_RETRY,
        )

    # -- spawn / handshake ---------------------------------------------------

    def _spawn(self, extra_env: Optional[dict] = None) -> None:
        blob = {
            "name": self.spec.name,
            "rack": self.spec.rack,
            "chips": self.spec.chips,
            "topology": self.spec.topology,
            "partition_size": self.spec.partition_size,
            "slice_id": self.spec.slice_id,
            "root": self.root,
            "metrics_interval_s": self.metrics_interval_s,
        }
        env = dict(self._base_env)
        # Respawns inherit the coordinator's CURRENT trace context so a
        # mid-scenario restart joins the scenario's trace.
        ctx = trace.context_env()
        if ctx:
            env[trace.TRACE_CONTEXT_ENV] = ctx
        env[SPEC_ENV] = json.dumps(blob)
        env["PYTHONUNBUFFERED"] = "1"
        env["PYTHONPATH"] = _PKG_ROOT + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        if extra_env:
            env.update(extra_env)
        # -c instead of -m: the package __init__ imports this module,
        # and runpy warns when the -m target is already in sys.modules.
        proc = subprocess.Popen(
            [sys.executable, "-c",
             "from container_engine_accelerators_tpu_torch.fleet.proc "
             "import worker_main; raise SystemExit(worker_main())"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr, env=env, cwd=_PKG_ROOT, text=True,
        )
        q: "queue.Queue" = queue.Queue()
        threading.Thread(target=self._pump_stdout, args=(proc, q),
                         name=f"fleet-proc-read-{self.name}",
                         daemon=True).start()
        deadline = time.monotonic() + self.handshake_timeout_s
        ready = None
        while ready is None:
            try:
                line = q.get(timeout=max(0.0,
                                         deadline - time.monotonic()))
            except queue.Empty:
                line = False
            if line in (None, False):  # EOF (died) or timeout (hung)
                self._reap(proc, force=True)
                why = ("worker died before its handshake"
                       if line is None else
                       f"no handshake within {self.handshake_timeout_s:g}s")
                raise ProcHandshakeError(
                    f"node {self.name}: {why} "
                    f"(pid {proc.pid}, rc {proc.returncode})"
                )
            try:
                msg = json.loads(line)
            except ValueError:
                continue  # stray output on stdout; keep waiting
            if not isinstance(msg, dict):
                continue  # a bare JSON scalar is stray output too
            if msg.get("event") == "ready":
                ready = msg
        self.proc = proc
        self._q = q
        self.pid = int(ready["pid"])
        self._spawns += 1
        self.daemon.data_port = int(ready["daemon_port"])
        self.daemon.generation = self._spawns
        self.metrics_port = int(ready["metrics_port"])
        self.down = False
        log.info("node %s up: pid %d, daemon :%d, metrics :%d (spawn %d)",
                 self.name, self.pid, self.daemon.data_port,
                 self.metrics_port, self._spawns)
        # Prime the cached snapshot: a node SIGKILLed before any
        # report query must still show its last known devices.
        self.snapshot()

    @staticmethod
    def _pump_stdout(proc: subprocess.Popen, q: "queue.Queue") -> None:
        try:
            for line in proc.stdout:
                q.put(line)
        except (OSError, ValueError):
            pass
        finally:
            q.put(None)  # EOF sentinel: the worker is gone

    def _reap(self, proc: Optional[subprocess.Popen],
              force: bool = False) -> None:
        """waitpid the child — every exit path runs through here, so a
        scenario can never leave a zombie (or worse, a live orphan
        still bound to the node's ports)."""
        if proc is None:
            return
        if proc.poll() is None and force:
            try:
                proc.kill()
            except OSError:
                pass
        try:
            proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover — SIGKILL'd
            log.error("node %s pid %d did not exit after SIGKILL",
                      self.name, proc.pid)
        for f in (proc.stdin, proc.stdout):
            if f is not None:
                try:
                    f.close()
                except OSError:
                    pass

    # -- RPC -----------------------------------------------------------------

    def _rpc(self, op: str, timeout_s: float = DEFAULT_RPC_TIMEOUT_S,
             **kw) -> dict:
        with self._rpc_lock:
            proc = self.proc
            if self.down or proc is None or proc.poll() is not None:
                raise OSError(f"node {self.name} worker is down")
            self._rpc_id += 1
            req = dict(kw, op=op, id=self._rpc_id)
            try:
                proc.stdin.write(json.dumps(req) + "\n")
                proc.stdin.flush()
            except (OSError, ValueError) as e:
                raise OSError(
                    f"node {self.name} RPC write failed: {e}") from e
            deadline = time.monotonic() + timeout_s
            while True:
                try:
                    line = self._q.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    raise OSError(
                        f"node {self.name} RPC {op!r} timed out "
                        f"after {timeout_s:g}s")
                if line is None:
                    raise OSError(
                        f"node {self.name} worker died mid-RPC {op!r}")
                try:
                    resp = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(resp, dict):
                    continue  # stray stdout that happens to be JSON
                if resp.get("id") != self._rpc_id:
                    continue  # a previous timed-out op's late answer
                if not resp.get("ok"):
                    raise OSError(
                        f"node {self.name} RPC {op!r} failed: "
                        f"{resp.get('error')}")
                return resp

    # -- health / fault surface (RPC-backed) ---------------------------------

    def inject_chip_fault(self, chip: str, code: int = 48) -> None:
        trace.event("fleet.chip_fault", node=self.name, chip=chip,
                    code=code)
        self._rpc("chip_fault", chip=chip, code=code)

    def force_recover(self) -> int:
        return int(self._rpc("chip_recover").get("recovered", 0))

    def recover(self, now: Optional[float] = None) -> int:
        if self.down:
            return 0
        try:
            return int(self._rpc("recover").get("recovered", 0))
        except OSError:
            return 0

    def pump_health(self) -> int:
        return int(self._rpc("pump_health").get("pumped", 0))

    def drop_response_once(self, op: str, times: int = 1) -> None:
        """Arm the worker daemon's lost-response hook (chaos tests)."""
        self._rpc("drop_response", dop=op, times=times)

    def apply_link_fault(self, port: int, action: str,
                         param: float = 0.0,
                         host: str = "127.0.0.1") -> int:
        """Arm the worker daemon's outbound link shim toward a peer's
        data port — the proc-mode stand-in for the in-process link
        table (netem-like partition/latency/drop in PyXferd's send
        path, driven over this RPC)."""
        return int(self._rpc("link_fault", port=int(port),
                             action=action, param=float(param),
                             host=host).get("applied", 0))

    def ring_delay(self, seconds: float) -> float:
        """Arm the worker daemon's slow-ring-completer grey fault:
        every posted descriptor costs ``seconds`` before the completer
        drives it — slow, not dead (the cursor keeps crawling).  0
        disarms."""
        return float(self._rpc("ring_delay",
                               seconds=float(seconds)).get(
                                   "delay_s", 0.0))

    def shm_delay(self, seconds: float) -> float:
        """Arm the worker daemon's slow-shm-commit grey fault: every
        shm commit pays ``seconds`` before landing — a throttled
        staging memcpy, slow, not dead (commits still land and
        account).  0 disarms."""
        return float(self._rpc("shm_delay",
                               seconds=float(seconds)).get(
                                   "delay_s", 0.0))

    def resources(self) -> Dict[str, int]:
        """The worker's resource census (fds / threads / shm segments
        / rss) for the soak leak sentinel.  Raises OSError on a dark
        worker — unlike :meth:`snapshot` there is no cached fallback,
        because a stale census would fake a flat (leak-free) series
        for exactly as long as the worker is unobservable."""
        return dict(self._rpc("resources").get("resources", {}))

    def burn_cpu(self, seconds: float = 1.0) -> float:
        """Arm the grey-failure CPU burn: the worker spins a core for
        ``seconds`` (capped worker-side) — slow, not dead."""
        return float(self._rpc("burn",
                               seconds=float(seconds)).get(
                                   "burning_s", 0.0))

    def stop_burn(self) -> None:
        """Disarm any in-flight CPU burn (the grey fault's heal)."""
        self._rpc("burn_stop")

    def device_health(self) -> Dict[str, str]:
        return dict(self.snapshot().get("devices", {}))

    def all_healthy(self) -> bool:
        snap = self.snapshot()
        return (snap.get("total", 0) > 0
                and snap.get("healthy") == snap.get("total"))

    # -- daemon churn (real signals) -----------------------------------------

    def kill_daemon(self) -> None:
        """SIGKILL the node worker: no teardown runs — sockets die
        with the process, shm segment files linger until the next
        incarnation wipes them.  The corpse is reaped immediately."""
        trace.event("fleet.node_kill", node=self.name, pid=self.pid,
                    signal="SIGKILL")
        self.down = True
        proc = self.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.kill()
            except OSError:
                pass
        self._reap(proc)
        self.proc = None

    def restart_daemon(self, extra_env: Optional[dict] = None) -> bool:
        """Supervised respawn: RetryPolicy backoff across spawn
        attempts, a bounded per-scenario restart budget.  Exhausting
        either marks the node permanently down — the scenario then
        reports non-converged instead of the supervisor spinning.
        Returns whether a respawn actually happened, so the round log
        can record a refused restart as skipped, not applied."""
        if self.permanently_down:
            log.error("node %s is permanently down; not restarting",
                      self.name)
            return False
        if self.restarts >= self.restart_budget:
            self.permanently_down = True
            counters.inc("fleet.node.budget_exhausted")
            log.error(
                "node %s restart budget (%d) exhausted; marking "
                "permanently down", self.name, self.restart_budget)
            return False
        # A restart on a LIVE node (rolling-restart schedules) must
        # not leak the old worker: kill and reap it before spawning
        # its replacement — the respawn rebinding the same UDS path
        # and node root depends on the old incarnation being gone.
        old = self.proc
        if old is not None and old.poll() is None:
            self.down = True
            self._reap(old, force=True)
            self.proc = None
        trace.event("fleet.node_restart", node=self.name)
        last: Optional[BaseException] = None
        for _attempt in self.respawn_retry.attempts():
            try:
                self._spawn(extra_env=extra_env)
                break
            except ProcHandshakeError as e:
                last = e
        else:
            self.permanently_down = True
            counters.inc("fleet.node.budget_exhausted")
            log.error("node %s could not be respawned (%s); marking "
                      "permanently down", self.name, last)
            return False
        self.restarts += 1
        counters.inc("fleet.node.restarts")
        return True

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> dict:
        if not self.down:
            try:
                fresh = self._rpc("snapshot")["snapshot"]
                self._last_snapshot = {
                    k: fresh[k]
                    for k in ("rack", "devices", "healthy", "total")
                    if k in fresh
                }
            except OSError as e:
                log.warning("node %s snapshot RPC failed: %s",
                            self.name, e)
        snap = dict(self._last_snapshot)
        snap.update(
            daemon_generation=self._spawns,
            down=self.down,
            restarts=self.restarts,
            permanently_down=self.permanently_down,
            proc=True,
            pid=self.pid,
            metrics_port=self.metrics_port,
        )
        return snap

    def close(self) -> None:
        """Teardown escalation: stdin EOF (clean exit) → SIGTERM
        (flight-recorder dump, then exit) → SIGKILL.  Always reaps."""
        try:
            self.client.close()
        except OSError:
            pass
        proc = self.proc
        self.proc = None
        self.down = True
        if proc is None:
            return
        if proc.poll() is None:
            try:
                proc.stdin.close()
            except OSError:
                pass
            try:
                proc.wait(timeout=CLOSE_GRACE_S)
            except subprocess.TimeoutExpired:
                try:
                    proc.terminate()  # SIGTERM: dump flight, then die
                except OSError:
                    pass
                try:
                    proc.wait(timeout=CLOSE_GRACE_S)
                except subprocess.TimeoutExpired:
                    log.error("node %s pid %d survived SIGTERM; "
                              "killing", self.name, proc.pid)
        self._reap(proc, force=True)


# ---------------------------------------------------------------------------
# worker half
# ---------------------------------------------------------------------------


def _emit(out, obj: dict) -> None:
    out.write(json.dumps(obj) + "\n")
    out.flush()


def _resource_snapshot(shm_dir: Optional[str] = None) -> dict:
    """Process-local resource census for the soak leak sentinel: open
    fds (``/proc/self/fd``), OS thread count, shm segment files under
    the daemon's segment dir, and resident set size.  Every probe
    degrades to 0 instead of raising — a worker mid-teardown must
    still answer its supervisor."""
    snap = {"fds": 0, "threads": 0, "shm_segments": 0, "rss_bytes": 0}
    try:
        snap["fds"] = len(os.listdir("/proc/self/fd"))
    except OSError:
        pass
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    snap["threads"] = int(line.split()[1])
                    break
    except (OSError, ValueError, IndexError):
        snap["threads"] = threading.active_count()
    if not snap["threads"]:
        snap["threads"] = threading.active_count()
    if shm_dir:
        try:
            snap["shm_segments"] = len(os.listdir(shm_dir))
        except OSError:
            pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        snap["rss_bytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return snap


# Grey-failure CPU burn: a daemon thread spinning until its deadline
# or until ``_stop_burn`` bumps the epoch — the "slow, not dead" half
# of the soak world's grey fault (the other half is outbound link
# latency via the PyXferd shim).  Bounded so a lost ``burn_stop`` can
# never wedge a worker past the fault window it was armed for.
MAX_BURN_S = 30.0
_burn_lock = threading.Lock()
_burn_epoch = 0


def _start_burn(seconds: float) -> float:
    seconds = max(0.0, min(float(seconds), MAX_BURN_S))
    with _burn_lock:
        epoch = _burn_epoch

    def _spin():
        deadline = time.monotonic() + seconds
        x = 1
        while time.monotonic() < deadline:
            with _burn_lock:
                if _burn_epoch != epoch:
                    return
            for _ in range(20000):
                x = (x * 1103515245 + 12345) & 0x7FFFFFFF

    threading.Thread(target=_spin, name="grey-burn",
                     daemon=True).start()
    return seconds


def _stop_burn() -> int:
    global _burn_epoch
    with _burn_lock:
        _burn_epoch += 1
        return _burn_epoch


def _serve(node, out) -> None:
    """The worker's RPC loop: newline-JSON requests on stdin, one
    response line each on stdout.  EOF means the coordinator is gone
    (or closing us cleanly) — either way, stop serving."""
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except ValueError:
            continue
        if not isinstance(req, dict):
            continue  # a scalar line is noise, not a request
        op = req.get("op")
        resp = {"id": req.get("id"), "ok": True}
        try:
            if op == "ping":
                pass
            elif op == "snapshot":
                resp["snapshot"] = node.snapshot()
            elif op == "chip_fault":
                node.inject_chip_fault(req.get("chip", DEFAULT_CHIP),
                                       int(req.get("code", 48)))
            elif op == "chip_recover":
                resp["recovered"] = node.force_recover()
            elif op == "recover":
                resp["recovered"] = node.recover()
            elif op == "pump_health":
                resp["pumped"] = node.pump_health()
            elif op == "drop_response":
                node.daemon.drop_response_once(
                    req["dop"], int(req.get("times", 1)))
            elif op == "link_fault":
                resp["applied"] = node.daemon.set_link_fault(
                    req.get("host", "127.0.0.1"), int(req["port"]),
                    req.get("action", ""),
                    float(req.get("param", 0.0)))
            elif op == "ring_delay":
                resp["delay_s"] = node.daemon.set_ring_delay(
                    float(req.get("seconds", 0.0)))
            elif op == "shm_delay":
                resp["delay_s"] = node.daemon.set_shm_delay(
                    float(req.get("seconds", 0.0)))
            elif op == "resources":
                resp["resources"] = _resource_snapshot(
                    getattr(node.daemon, "shm_dir", None))
            elif op == "burn":
                resp["burning_s"] = _start_burn(
                    float(req.get("seconds", 1.0)))
            elif op == "burn_stop":
                resp["epoch"] = _stop_burn()
            elif op == "shutdown":
                _emit(out, resp)
                return
            else:
                resp = {"id": req.get("id"), "ok": False,
                        "error": f"unknown op: {op!r}"}
        except Exception as e:  # noqa: BLE001 — RPC errors must answer
            resp = {"id": req.get("id"), "ok": False, "error": str(e)}
        _emit(out, resp)


def worker_main() -> int:
    """Entry point for one node worker process."""
    from container_engine_accelerators_tpu_torch.fleet.node import EmulatedNode
    from container_engine_accelerators_tpu_torch.fleet.topology import NodeSpec
    from container_engine_accelerators_tpu_torch.obs import flight, profiler

    if os.environ.get(HANG_ENV):
        time.sleep(3600)  # test hook: a worker that never handshakes
    blob = json.loads(os.environ[SPEC_ENV])
    # The pod-resources socket does not exist in the sim; at the fast
    # proc-mode collection interval its absence would be a warning
    # flood, so absorb it below warning level.
    logging.getLogger(
        "container_engine_accelerators_tpu_torch.metrics.metrics"
    ).setLevel(logging.ERROR)

    def _sigterm(signum, frame):
        # The supervisor's pre-kill courtesy signal: dump what this
        # node was DOING before the evidence dies with the process.
        flight.dump("signal 15 (SIGTERM): fleet supervisor teardown")
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, _sigterm)
    flight.install()  # SIGUSR1 on-demand dumps, as on a real agent
    # Always-on continuous profiler at the low default rate: the
    # worker's /profile endpoint (scraped by the fleet aggregator) and
    # the flight dumps above both read it.  TPU_PROF=0 disables.
    profiler.start()
    with trace.attach_from_env():
        spec = NodeSpec(
            name=blob["name"], rack=blob.get("rack", "r0"),
            chips=int(blob.get("chips", 4)),
            topology=blob.get("topology", "2x2x1"),
            partition_size=blob.get("partition_size", ""),
            slice_id=blob.get("slice_id"),
        )
        node = EmulatedNode(
            spec, blob["root"], net=None, metrics=True,
            metrics_interval_s=float(blob.get("metrics_interval_s",
                                              0.25)),
        )
        try:
            with trace.span("fleet.proc_node", node=spec.name,
                            pid=os.getpid()):
                _emit(sys.stdout, {
                    "event": "ready",
                    "pid": os.getpid(),
                    "node": spec.name,
                    "daemon_port": node.daemon.data_port,
                    "metrics_port": node.metrics.port,
                    "generation": node.daemon.generation,
                })
                _serve(node, sys.stdout)
        finally:
            node.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(worker_main())
