"""MIG partitions as devices (ref: pkg/gpu/nvidia/mig/mig.go:33-212,
SURVEY §2.1 row 5 and §3.3; the counterpart of the JAX package's
``partition/subslice.py::SubsliceDeviceManager``).

The design has two sides, as the reference's: ``cmd/partition_gpu.py``
programs a node's GPUs into partitions of the configured size before the
device plugin starts, and this manager discovers what was programmed and
answers the plugin's queries.

The driver publishes each MIG partition under ``/proc``:

    <proc>/driver/nvidia/capabilities/gpu<minor>/mig/gi<G>/access
    <proc>/driver/nvidia/capabilities/gpu<minor>/mig/gi<G>/ci0/access

each file holding ``DeviceFileMinor: <m>``, the minor of the capability
node ``/dev/nvidia-caps/nvidia-cap<m>`` that grants access to that GPU
instance (``gi<G>``) or compute instance (``ci0``).  A partition is one
device, ``nvidia<minor>/gi<G>``, and a container that gets it gets three
nodes: ``/dev/nvidia<minor>`` and the two capability nodes (mig.go:73-80).

A GPU with no partition means MIG is off on it or nothing was
programmed: ``start`` raises, naming the GPU and the path, and the
daemon's start loop retries.  A count of partitions other than the size's
maximum on an H100 80GB (or A100) is logged, not refused: the
partitioner creates the maximum, but an operator may have made fewer.

An Xid is reported for the whole GPU, so it marks every partition of
that GPU Unhealthy, and the GPU's recovery heals them all (the inverse
of the JAX manager's chip-to-slice routing, ``slice_for_chip``).
"""

import logging
import os
import re
from typing import Dict, Iterable, List

from container_engine_accelerators_tpu_torch.deviceplugin.preferred import (
    natural_key,
)
from container_engine_accelerators_tpu_torch.utils.config import (
    VALID_PARTITION_SIZES,
)
from container_engine_accelerators_tpu_torch.utils.device import (
    HEALTHY,
    Device,
    DeviceSpec,
)
from container_engine_accelerators_tpu_torch.utils.devname import device_minor

log = logging.getLogger(__name__)

CAPABILITIES = "driver/nvidia/capabilities"
CAPS_DIRECTORY = "nvidia-caps"

# The most partitions of each size one GPU holds (mig.go:33-46,
# partition_gpu.go:35-50): A100 40GB sizes first, then the A100 80GB's
# and the H100 80GB's.
PARTITION_MAX_COUNT = {
    "1g.5gb": 7, "2g.10gb": 3, "3g.20gb": 2, "4g.20gb": 1, "7g.40gb": 1,
    "1g.10gb": 7, "1g.20gb": 4, "2g.20gb": 3, "3g.40gb": 2, "4g.40gb": 1,
    "7g.80gb": 1,
}

_GI_RE = re.compile(r"^gi([0-9]+)$")
_MINOR_RE = re.compile(r"DeviceFileMinor:\s*([0-9]+)")


def read_minor(path: str) -> int:
    """The ``DeviceFileMinor`` of a capability ``access`` file."""
    with open(path) as f:
        m = _MINOR_RE.search(f.read())
    if m is None:
        raise ValueError(f"{path} holds no 'DeviceFileMinor: <n>'")
    return int(m.group(1))


class MigDeviceManager:
    def __init__(self, dev_directory: str, proc_root: str = "/proc"):
        self.dev_directory = dev_directory
        self.proc_root = proc_root
        self.partition_size = ""
        self.devices: Dict[str, Device] = {}
        self._specs: Dict[str, List[DeviceSpec]] = {}
        self._by_gpu: Dict[str, List[str]] = {}

    def mig_directory(self, gpu: str) -> str:
        return os.path.join(self.proc_root, CAPABILITIES,
                            f"gpu{device_minor(gpu)}", "mig")

    def start(self, partition_size: str, gpus: Iterable[str]) -> None:
        """Discover the partitions of ``gpus`` (``nvidia<minor>`` names);
        the tables are swapped in whole, so a reader never sees half of
        them."""
        if partition_size not in PARTITION_MAX_COUNT:
            raise ValueError(f"invalid GPUPartitionSize {partition_size!r}, "
                             f"should be one of {VALID_PARTITION_SIZES}")
        expected = PARTITION_MAX_COUNT[partition_size]
        devices: Dict[str, Device] = {}
        specs: Dict[str, List[DeviceSpec]] = {}
        by_gpu: Dict[str, List[str]] = {}
        for gpu in sorted(gpus, key=natural_key):
            mig_dir = self.mig_directory(gpu)
            try:
                entries = os.listdir(mig_dir)
            except FileNotFoundError:
                entries = []
            instances = sorted(int(m.group(1)) for m in map(_GI_RE.match,
                                                             entries) if m)
            if not instances:
                raise FileNotFoundError(
                    f"{gpu}: no MIG partition under {mig_dir}; MIG mode is "
                    f"off or no {partition_size} partitions were created "
                    f"(cmd/partition_gpu.py)")
            if len(instances) != expected:
                log.warning("%s has %d partitions of %s; the size's maximum "
                            "is %d", gpu, len(instances), partition_size,
                            expected)
            for gi in instances:
                device_id = f"{gpu}/gi{gi}"
                gi_dir = os.path.join(mig_dir, f"gi{gi}")
                caps = [read_minor(os.path.join(gi_dir, "access")),
                        read_minor(os.path.join(gi_dir, "ci0", "access"))]
                nodes = [os.path.join(self.dev_directory, gpu)] + [
                    os.path.join(self.dev_directory, CAPS_DIRECTORY,
                                 f"nvidia-cap{m}") for m in caps]
                for node in nodes:
                    if not os.path.exists(node):
                        raise FileNotFoundError(
                            f"partition {device_id}: device node {node} "
                            f"missing")
                specs[device_id] = [DeviceSpec(host_path=n, container_path=n,
                                               permissions="mrw")
                                    for n in nodes]
                devices[device_id] = Device(id=device_id, health=HEALTHY)
                by_gpu.setdefault(gpu, []).append(device_id)
        self.partition_size = partition_size
        self.devices = devices
        self._specs = specs
        self._by_gpu = by_gpu

    def set_gpu_health(self, gpu: str, health: str) -> None:
        """A GPU's health is every one of its partitions' health."""
        for device_id in self._by_gpu.get(gpu, []):
            self.devices[device_id] = Device(id=device_id, health=health)

    def set_device_health(self, device_id: str, health: str) -> None:
        if device_id in self.devices:
            self.devices[device_id] = Device(id=device_id, health=health)

    def device_spec(self, device_id: str) -> List[DeviceSpec]:
        dev = self.devices.get(device_id)
        if dev is None:
            raise ValueError(f"invalid allocation request with non-existing "
                             f"device {device_id}")
        if dev.health != HEALTHY:
            raise ValueError(f"invalid allocation request with unhealthy "
                             f"device {device_id}")
        return list(self._specs[device_id])
