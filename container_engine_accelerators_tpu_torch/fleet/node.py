"""EmulatedNode: one simulated GPU host, full node-agent stack included.

The port's copy of ``container_engine_accelerators_tpu/fleet/node.py``
on the port's node stack (host code: no torch).  Each node the fleet
boots is the real single-node machinery, not a mock: a
:class:`GpuManager` discovering a fabricated NVML table and ``/dev``
tree of H100s (``gpulib/fake.py``), a :class:`GpuHealthChecker` with
the production quiescence/flap-backoff state machine, a :class:`PyXferd` transfer daemon with a live data
plane, a :class:`ResilientDcnXferClient` with the production
reconnect/replay/restage behavior, and (opt-in) a per-node
:class:`MetricServer` on an ephemeral port.  Chaos at the fleet level
therefore exercises exactly the code paths a real node would run —
the same reason the chaos suite injects faults into production call
sites instead of monkeypatching sockets.

Health is pumped deterministically (the controller drains the manager's
health queue between rounds, like ListAndWatch would) so scenarios are
reproducible: no background thread races the fault schedule.
"""

import logging
import os
from typing import Dict, Optional

from container_engine_accelerators_tpu_torch.deviceplugin.manager import GpuManager
from container_engine_accelerators_tpu_torch.fleet.topology import NodeSpec
from container_engine_accelerators_tpu_torch.fleet.xferd import PyXferd
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    FakeGpuLib,
    write_fixture,
    write_mig_fixture,
)
from container_engine_accelerators_tpu_torch.gpulib.types import XidEvent
from container_engine_accelerators_tpu_torch.health import GpuHealthChecker
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.partition.mig import (
    PARTITION_MAX_COUNT,
)
from container_engine_accelerators_tpu_torch.utils.config import GPUConfig
from container_engine_accelerators_tpu_torch.utils.device import HEALTHY
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

# Node-agent retry budget at simulation timescale: same shape as
# production DEFAULT_DCN_RETRY, milliseconds instead of seconds.
FLEET_CLIENT_RETRY = RetryPolicy(
    max_attempts=8, initial_backoff_s=0.01, max_backoff_s=0.1,
    deadline_s=15.0,
)

DEFAULT_RECOVERY_WINDOW_S = 0.05
# The JAX package's external chip-fault injector variable.  A fleet node
# polls the file it names (the port's own daemon reads GPU_FAULT_FILE),
# so one scenario's fault file reaches the nodes of both packages.
CHIP_FAULT_FILE_ENV = "TPU_CHIP_FAULT_FILE"


class EmulatedNode:
    def __init__(
        self,
        spec: NodeSpec,
        root: str,
        net=None,
        recovery_window_s: float = DEFAULT_RECOVERY_WINDOW_S,
        metrics: bool = False,
        client_retry: Optional[RetryPolicy] = None,
        metrics_interval_s: float = 30.0,
    ):
        self.spec = spec
        self.name = spec.name
        self.root = root
        self.net = net
        self.down = False  # daemon intentionally killed by the scenario
        # Parity fields with fleet/proc.ProcNode, so reports carry one
        # schema whichever mode booted the node: an in-process node is
        # never budget-limited, but its restarts are still counted.
        self.permanently_down = False
        self.restarts = 0

        write_fixture(root, spec.chips)
        if spec.partition_size:
            # Unknown profiles fall through to the manager's own error.
            write_mig_fixture(
                root, PARTITION_MAX_COUNT.get(spec.partition_size, 1))
        cfg = GPUConfig(partition_size=spec.partition_size)
        cfg.add_defaults_and_validate()
        self.lib = FakeGpuLib(root)
        self.manager = GpuManager(
            os.path.join(root, "dev"), [], cfg, lib=self.lib,
            proc_root=os.path.join(root, "proc"),
        )
        self.manager.start()
        self.health = GpuHealthChecker(
            self.manager, self.lib, recovery_window_s=recovery_window_s,
            fault_file=os.environ.get(CHIP_FAULT_FILE_ENV) or None,
        )
        self.daemon = PyXferd(
            os.path.join(root, "tpu-dcn"), node=spec.name, net=net
        ).start()
        if net is not None:
            net.register(spec.name, self.daemon)
        self.client = ResilientDcnXferClient(
            os.path.join(root, "tpu-dcn"),
            retry=client_retry or FLEET_CLIENT_RETRY,
        )
        self.metrics = None
        if metrics:
            # Per-node exporter on an ephemeral port; the pod-resources
            # socket does not exist in the sim and its absence is
            # absorbed (the production contract).
            from container_engine_accelerators_tpu_torch.metrics.metrics import (
                GpuMetricsCollector,
                MetricServer,
            )

            self.metrics = MetricServer(
                collector=GpuMetricsCollector(self.lib),
                port=0,
                collection_interval_s=metrics_interval_s,
                pod_resources_socket=os.path.join(root, "noresources.sock"),
            )
            self.metrics.start()

    # -- health --------------------------------------------------------------

    def pump_health(self) -> int:
        """Drain queued health transitions into device state, as the
        kubelet-facing ListAndWatch announcement loop would."""
        n = 0
        while True:
            try:
                d = self.manager.health_events.get_nowait()
            except Exception:  # queue.Empty
                return n
            self.manager.set_device_health(d.id, d.health)
            n += 1

    def inject_chip_fault(self, chip: str, code: int = 48) -> None:
        trace.event("fleet.chip_fault", node=self.name, chip=chip,
                    code=code)
        self.health.catch_error(XidEvent(code=code, device=chip))
        self.pump_health()

    def recover(self, now: Optional[float] = None) -> int:
        # The external injector file is polled on the same deterministic
        # cadence as recovery: scenarios pump between rounds, so a
        # fault line written from OUTSIDE the coordinator RPC lands
        # with the next round's health sweep (TPU_CHIP_FAULT_FILE, else
        # GPU_FAULT_FILE — proc workers inherit the env path from their
        # coordinator).
        self.health.poll_fault_file()
        n = self.health.maybe_recover(now=now)
        self.pump_health()
        return n

    def force_recover(self) -> int:
        """Drive every pending quiescence window closed (a scenario's
        explicit ``chip_recover`` action — deterministic, no sleeps)."""
        import time as _time

        return self.recover(now=_time.monotonic() + 1e6)

    def device_health(self) -> Dict[str, str]:
        return {d.id: d.health
                for d in self.manager.list_devices().values()}

    def all_healthy(self) -> bool:
        health = self.device_health()
        return bool(health) and all(h == HEALTHY for h in health.values())

    # -- daemon churn --------------------------------------------------------

    def kill_daemon(self) -> None:
        trace.event("fleet.node_kill", node=self.name)
        self.down = True
        if self.net is not None:
            self.net.unregister(self.name)
        self.daemon.stop(crash=True)

    def restart_daemon(self) -> bool:
        trace.event("fleet.node_restart", node=self.name)
        self.daemon.start()
        if self.net is not None:
            self.net.register(self.name, self.daemon)
        self.down = False
        self.restarts += 1
        counters.inc("fleet.node.restarts")
        return True

    # -- reporting -----------------------------------------------------------

    def snapshot(self) -> dict:
        health = self.device_health()
        snap = {
            "rack": self.spec.rack,
            "devices": health,
            "healthy": sum(1 for h in health.values() if h == HEALTHY),
            "total": len(health),
            "daemon_generation": self.daemon.generation,
            "down": self.down,
            "restarts": self.restarts,
            "permanently_down": self.permanently_down,
        }
        if self.metrics is not None:
            snap["metrics_port"] = self.metrics.port
        return snap

    def close(self) -> None:
        for action in (
            lambda: self.client.close(),
            lambda: self.daemon.stop(),
            lambda: self.metrics.stop() if self.metrics else None,
        ):
            try:
                action()
            except OSError:
                pass
