"""Device selection for the port's model entry points, and the device
plugin's data types (kubelet DevicePlugin v1beta1 shapes).

The node layer imports this module without torch: ``resolve_device``
imports it when it is called.
"""

import dataclasses

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"


@dataclasses.dataclass
class Device:
    id: str
    health: str = HEALTHY


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    host_path: str
    container_path: str
    permissions: str = "mrw"


@dataclasses.dataclass(frozen=True)
class Mount:
    host_path: str
    container_path: str
    read_only: bool = False


def resolve_device(device=None) -> "torch.device":  # noqa: F821
    """``None`` means ``"cuda"``.  A CUDA device without CUDA raises: a
    run that asked for the card never drops to the CPU silently.  Pass
    ``device="cpu"`` to run on the CPU (the tests do)."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass "
            f"device='cpu' (--device cpu) to run on the CPU")
    return dev


def synchronize(device) -> None:
    """Wait for the work queued on a CUDA ``device``; a no-op on the CPU,
    whose ops return when done."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
