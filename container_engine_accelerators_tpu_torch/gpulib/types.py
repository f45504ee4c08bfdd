"""gpulib data types and the backend interface."""

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class GpuInfo:
    name: str  # "nvidia<minor>": the /dev node, never the NVML index
    index: int  # NVML index
    minor: int
    uuid: str
    pci_bus_id: Optional[str]  # None where the driver does not report it
    model: str  # e.g. "NVIDIA H100 80GB HBM3"


@dataclasses.dataclass(frozen=True)
class MemoryInfo:
    total_bytes: int
    used_bytes: int


@dataclasses.dataclass(frozen=True)
class XidEvent:
    """A critical Xid error (ref: health_checker.go:179-226)."""

    code: int
    device: Optional[str]  # "nvidia<minor>", or None: the whole node
    message: str = ""


class GpuLib:
    """Backend interface, the seam for fakes (the reference's
    ``callDevice`` interface, health_checker.go:170-177)."""

    def device_count(self) -> int:
        return len(self.devices())

    def devices(self) -> List[GpuInfo]:
        raise NotImplementedError

    def device_info(self, name: str) -> GpuInfo:
        for info in self.devices():
            if info.name == name:
                return info
        raise ValueError(f"no GPU named {name!r}")

    def memory_info(self, name: str) -> MemoryInfo:
        raise NotImplementedError

    def duty_cycle(self, name: str) -> int:
        """0-100: percent of time the GPU was busy since the last call."""
        raise NotImplementedError

    def register_xid_events(self) -> List[str]:
        """Subscribe to critical Xid events on every device; returns the
        names subscribed.  A device that does not support it is logged and
        left out (it stays Healthy: health_checker.go:116-118).  The list
        is the backend's own: a GPU that appears later is subscribed when
        the backend maps it, and appended."""
        raise NotImplementedError

    def wait_for_event(self, timeout_s: float) -> Optional[XidEvent]:
        """Block up to timeout_s for the next Xid event; None on timeout
        (nvml.WaitForEvent(5000), health_checker.go:238-243)."""
        raise NotImplementedError

    def close(self) -> None:
        pass
