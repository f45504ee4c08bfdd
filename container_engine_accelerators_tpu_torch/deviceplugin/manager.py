"""GPU device manager: discovery, device specs, the MPS env contract and
the serve state machine (ref: pkg/gpu/nvidia/manager.go:136-499; the JAX
package's ``deviceplugin/manager.py`` with NVIDIA semantics):

- discovery reads ``devDirectory`` for ``nvidia[0-9]+`` (manager.go:231-247)
  and keeps the nodes NVML also reports: a ``/dev`` node that NVML does not
  see is logged and not advertised, since it could not be health checked
  or sampled;
- every container gets the control nodes ``nvidiactl`` and ``nvidia-uvm``,
  and ``nvidia-uvm-tools`` and ``nvidia-modeset`` where the node has them
  (manager.go:357-365), and the driver's libraries mounted read-only;
- ``GPUPartitionSize`` advertises the MIG partitions ``nvidiaN/giM``
  that ``partition/mig.py`` finds under ``/proc`` (three device nodes
  each); a GPU's Xid takes all its partitions down, and its recovery
  brings them back;
- sharing expands each GPU (or partition) into ``.../vgpuM`` virtual
  devices; under ``mps`` the start proves the MPS control daemon answers
  (``sharing/gate.py``), mounts its pipe directory into containers, and
  each Allocate asks the daemon again and sets the client's thread and
  memory limits (manager.go:312-325, :376-386);
- ``serve`` runs the availability state machine: listen on a timestamped
  socket in the kubelet's plugin directory, register, then poll -- every
  1 s for the socket's deletion (a kubelet restart: re-register) and every
  10 s for new GPUs (hotplug: rediscover and restart) (manager.go:410-499).
"""

import concurrent.futures
import logging
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Set

import grpc

from container_engine_accelerators_tpu_torch.deviceplugin import api, preferred
from container_engine_accelerators_tpu_torch.gpulib.types import GpuLib
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.partition.mig import (
    MigDeviceManager,
)
from container_engine_accelerators_tpu_torch.sharing import (
    SharingStrategy,
    virtual_device_ids,
    virtual_to_physical_device_id,
)
from container_engine_accelerators_tpu_torch.sharing.gate import (
    DEFAULT_PIPE_DIRECTORY,
    PIPE_DIRECTORY_ENV,
    MpsGate,
)
from container_engine_accelerators_tpu_torch.utils import faults
from container_engine_accelerators_tpu_torch.utils.config import GPUConfig
from container_engine_accelerators_tpu_torch.utils.device import (
    HEALTHY,
    Device,
    DeviceSpec,
    Mount,
)
from container_engine_accelerators_tpu_torch.utils.devname import DEVICE_RE
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

CONTROL_DEVICES = ("nvidiactl", "nvidia-uvm")
OPTIONAL_DEVICES = ("nvidia-uvm-tools", "nvidia-modeset")
DRIVER_HOST_PATH = "/home/kubernetes/bin/nvidia"
DRIVER_CONTAINER_PATH = "/usr/local/nvidia"

DEVICE_CHECK_INTERVAL_S = 10.0  # hotplug poll (gpuCheckInterval)
SOCKET_CHECK_INTERVAL_S = 1.0  # kubelet-restart poll (pluginSocketCheckInterval)

MPS_THREAD_PERCENTAGE_ENV = "CUDA_MPS_ACTIVE_THREAD_PERCENTAGE"
MPS_PINNED_MEMORY_ENV = "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT"

# A kubelet mid-restart refuses Register for a few seconds; ride it out
# instead of crashing the DaemonSet pod.
REGISTER_RETRY = RetryPolicy(
    max_attempts=6, initial_backoff_s=0.5, max_backoff_s=5.0, deadline_s=30.0
)


class GpuManager:
    def __init__(
        self,
        dev_directory: str,
        mount_paths: List[Mount],
        config: GPUConfig,
        lib: Optional[GpuLib] = None,
        device_check_interval_s: float = DEVICE_CHECK_INTERVAL_S,
        socket_check_interval_s: float = SOCKET_CHECK_INTERVAL_S,
        proc_root: str = "/proc",
        mps_pipe_directory: str = DEFAULT_PIPE_DIRECTORY,
    ):
        self.dev_directory = dev_directory
        self.driver_mounts = list(mount_paths)
        # What Allocate mounts: the driver, and under mps the pipe
        # directory (set by start).
        self.mount_paths = list(mount_paths)
        self.config = config
        self.lib = lib
        self.mig = MigDeviceManager(dev_directory, proc_root)
        self.mps_pipe_directory = mps_pipe_directory
        self.mps_gate: Optional[MpsGate] = None
        self.total_memory_per_gpu = 0
        self.devices: Dict[str, Device] = {}
        self.devices_mutex = threading.Lock()
        self.default_devices: List[str] = []
        self.health_events: "queue.Queue[Device]" = queue.Queue()
        self.grpc_server: Optional[grpc.Server] = None
        self.socket: str = ""
        self.device_check_interval_s = device_check_interval_s
        self.socket_check_interval_s = socket_check_interval_s
        self._stop = threading.Event()

    # ---- discovery ---------------------------------------------------------

    def check_device_paths(self) -> bool:
        """Installer handshake: the driver's control nodes exist
        (nvidia_gpu.go:99-109)."""
        return all(os.path.exists(os.path.join(self.dev_directory, d))
                   for d in CONTROL_DEVICES)

    def _dev_gpus(self) -> Set[str]:
        try:
            entries = os.listdir(self.dev_directory)
        except OSError as e:
            log.error("cannot read %s: %s", self.dev_directory, e)
            return set()
        return {f for f in entries if DEVICE_RE.match(f)}

    def _discoverable(self, log_mismatch: bool = False) -> Set[str]:
        """``/dev`` nodes that NVML also reports (all of them without a
        library)."""
        on_dev = self._dev_gpus()
        if self.lib is None:
            return on_dev
        seen = {info.name for info in self.lib.devices()}
        if log_mismatch:
            for name in sorted(on_dev - seen):
                log.warning("%s is in %s but NVML does not report it; not "
                            "advertised", name, self.dev_directory)
            for name in sorted(seen - on_dev):
                log.warning("NVML reports %s but %s has no node for it; not "
                            "advertised", name, self.dev_directory)
        return on_dev & seen

    def discover_gpus(self) -> None:
        for name in sorted(self._discoverable(log_mismatch=True),
                           key=preferred.natural_key):
            log.debug("Found GPU %r", name)
            self.set_device_health(name, HEALTHY)

    def has_additional_gpus_installed(self) -> bool:
        with self.devices_mutex:
            original = len(self.devices)
        return len(self._discoverable()) > original

    def start(self) -> None:
        """Discover devices and the default device nodes, the MIG
        partitions and the MPS daemon (ref: manager.go:354-388).  Raises
        when the configured partitions or the MPS daemon are not there."""
        self.default_devices = [
            os.path.join(self.dev_directory, d) for d in CONTROL_DEVICES]
        for d in OPTIONAL_DEVICES:
            path = os.path.join(self.dev_directory, d)
            if os.path.exists(path):
                self.default_devices.append(path)
        self.discover_gpus()
        with self.devices_mutex:
            gpus = sorted(self.devices, key=preferred.natural_key)
            if self.config.partition_size:
                self.mig.start(self.config.partition_size, gpus)
        mounts = list(self.driver_mounts)
        if self.config.sharing.strategy == SharingStrategy.MPS:
            if self.lib is None or not gpus:
                raise RuntimeError("mps needs a GPU that NVML reports, for "
                                   "the per-client memory limit")
            total = self.lib.memory_info(gpus[0]).total_bytes
            if total <= 0:
                raise RuntimeError(f"mps: NVML reports {total} bytes of "
                                   f"memory on {gpus[0]}")
            gate = MpsGate(self.driver_mounts, self.mps_pipe_directory)
            gate.verify()
            mounts.append(Mount(host_path=self.mps_pipe_directory,
                                container_path=self.mps_pipe_directory))
            self.total_memory_per_gpu = total
            self.mps_gate = gate
        self.mount_paths = mounts

    # ---- device views ------------------------------------------------------

    def list_physical_devices(self) -> Dict[str, Device]:
        """What is shared or advertised: the GPUs, or under
        GPUPartitionSize their MIG partitions.  A snapshot (a copy: gRPC
        worker threads iterate it while hotplug rediscovers on the serve
        thread)."""
        with self.devices_mutex:
            if self.config.partition_size:
                return dict(self.mig.devices)
            return dict(self.devices)

    def list_devices(self) -> Dict[str, Device]:
        physical = self.list_physical_devices()
        max_clients = self.config.sharing.max_shared_clients_per_gpu
        if max_clients <= 0:
            return physical
        # Virtual devices inherit their GPU's health.
        return {vid: Device(id=vid, health=dev.health)
                for dev in physical.values()
                for vid in virtual_device_ids(dev.id, max_clients)}

    def set_device_health(self, name: str, health: str) -> None:
        """A GPU's health, and under GPUPartitionSize its partitions'; or
        one partition's."""
        with self.devices_mutex:
            if DEVICE_RE.match(name):
                self.devices[name] = Device(id=name, health=health)
                if self.config.partition_size:
                    self.mig.set_gpu_health(name, health)
            elif self.config.partition_size:
                self.mig.set_device_health(name, health)

    # ---- allocate path -----------------------------------------------------

    def verify_allocatable(self) -> None:
        """Before an Allocate: under mps, the MPS daemon must still answer
        (ValueError rejects the request)."""
        if self.mps_gate is not None:
            self.mps_gate.check_allocatable()

    def envs(self, request_device_ids: List[str]) -> Dict[str, str]:
        """The MPS client's limits for a request of n virtual devices
        (ref: manager.go:312-325; the arithmetic of the JAX manager's
        core-sharing envs): n/max of the threads and of the GPU's memory.
        The memory limit names CUDA device 0: an MPS request holds one GPU
        (several vGPUs only on single-GPU nodes), which the container sees
        as device 0.  The pipe directory is named too, so a client finds
        a daemon whose directory is not the default."""
        if (self.config.sharing.strategy != SharingStrategy.MPS
                or self.total_memory_per_gpu <= 0 or not request_device_ids):
            return {}
        n = len(request_device_ids)
        max_clients = self.config.sharing.max_shared_clients_per_gpu
        limit_mib = n * self.total_memory_per_gpu // max_clients // 2**20
        return {MPS_THREAD_PERCENTAGE_ENV: str(n * 100 // max_clients),
                MPS_PINNED_MEMORY_ENV: f"0={limit_mib}M",
                PIPE_DIRECTORY_ENV: self.mps_pipe_directory}

    def device_spec(self, device_id: str) -> List[DeviceSpec]:
        """Map one requested device ID to its device nodes
        (ref: manager.go:201-228; a MIG partition: mig.go:73-80)."""
        if self.config.sharing.max_shared_clients_per_gpu > 0:
            device_id = virtual_to_physical_device_id(device_id)
        with self.devices_mutex:
            if self.config.partition_size:
                return self.mig.device_spec(device_id)
            dev = self.devices.get(device_id)
        if dev is None:
            raise ValueError(
                f"invalid allocation request with non-existing device {device_id}")
        if dev.health != HEALTHY:
            raise ValueError(
                f"invalid allocation request with unhealthy device {device_id}")
        node = os.path.join(self.dev_directory, device_id)
        return [DeviceSpec(host_path=node, container_path=node, permissions="mrw")]

    # ---- serve state machine ----------------------------------------------

    def serve(
        self,
        plugin_mount_path: str,
        kubelet_endpoint: str = api.KUBELET_SOCKET,
        plugin_endpoint: Optional[str] = None,
    ) -> None:
        """Availability state machine (ref: manager.go:410-499): (re)create
        the plugin socket, serve gRPC, register with the kubelet, then watch
        for socket deletion (1 s) and GPU hotplug (10 s); either tears the
        server down and restarts the loop."""
        from container_engine_accelerators_tpu_torch.deviceplugin.service import (
            DevicePluginService,
        )

        kubelet_socket = os.path.join(plugin_mount_path, kubelet_endpoint)
        register_with_kubelet = os.path.exists(kubelet_socket)
        log.info("kubelet socket %s; registration %s", kubelet_socket,
                 "enabled" if register_with_kubelet else "disabled")

        while not self._stop.is_set():
            endpoint = plugin_endpoint or f"nvidiaGPU-{int(time.time())}.sock"
            endpoint_path = os.path.join(plugin_mount_path, endpoint)
            if os.path.exists(endpoint_path):
                os.unlink(endpoint_path)
            log.info("starting device-plugin server at: %s", endpoint_path)

            server = grpc.server(
                concurrent.futures.ThreadPoolExecutor(max_workers=4))
            api.add_device_plugin_servicer(server, DevicePluginService(self))
            server.add_insecure_port(f"unix:{endpoint_path}")
            server.start()
            self.grpc_server = server
            self.socket = endpoint_path

            try:
                if register_with_kubelet:
                    if not self._register_with_retry(kubelet_socket, endpoint):
                        # Budget spent: restart the loop on a fresh socket
                        # rather than crash; the kubelet may still be
                        # coming up.
                        continue
                    log.info("device-plugin registered with the kubelet")
                self._status_check(endpoint_path)
            finally:
                server.stop(grace=1).wait()
                self.grpc_server = None

    def _register_with_retry(self, kubelet_socket: str, endpoint: str) -> bool:
        """Register under REGISTER_RETRY; False when the budget is spent.
        Fault site ``kubelet.register`` fires before each attempt."""
        last = None
        for attempt in REGISTER_RETRY.attempts(sleep=self._stop.wait):
            if self._stop.is_set():
                return False
            try:
                with trace.span("kubelet.register",
                                histogram="kubelet.register",
                                attempt=attempt, endpoint=endpoint):
                    faults.check("kubelet.register")
                    api.register_with_v1beta1_kubelet(kubelet_socket,
                                                      endpoint)
                if attempt > 0:
                    counters.inc("kubelet.register.retried")
                return True
            except (grpc.RpcError, grpc.FutureTimeoutError, OSError) as e:
                # FutureTimeoutError: the kubelet socket exists but nothing
                # answers yet (mid-restart).
                last = e
                counters.inc("kubelet.register.failed")
                log.error("kubelet registration attempt %d failed: %s",
                          attempt + 1, e)
        log.error("kubelet registration budget exhausted: %s", last)
        return False

    def _status_check(self, endpoint_path: str) -> None:
        last_device_check = time.monotonic()
        while not self._stop.wait(self.socket_check_interval_s):
            # Socket gone: the kubelet restarted and wiped the plugin
            # directory; tear down and re-register (manager.go:475-481).
            if not os.path.lexists(endpoint_path):
                log.info("plugin socket %s deleted; restarting", endpoint_path)
                counters.inc("kubelet.reregister")
                return
            if time.monotonic() - last_device_check >= self.device_check_interval_s:
                last_device_check = time.monotonic()
                if self.has_additional_gpus_installed():
                    log.info("new GPUs found; rediscovering and restarting")
                    try:
                        self.start()
                    except Exception as e:
                        log.error("rediscovery failed: %s; will retry", e)
                    return

    def stop(self) -> None:
        if self.socket and os.path.exists(self.socket):
            os.unlink(self.socket)
        self._stop.set()
        if self.grpc_server is not None:
            self.grpc_server.stop(grace=1)
