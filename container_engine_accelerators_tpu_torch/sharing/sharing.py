"""GPU sharing: the virtual-device ID scheme and request validation
(ref: pkg/gpu/nvidia/gpusharing/gpusharing.go:23-84; the JAX package's
``sharing/sharing.py`` with NVIDIA names).

Two strategies:

- ``time-sharing``: N virtual devices time-multiplexed onto one GPU; a
  container may claim at most one of them (there is no isolation, so
  claiming several buys nothing).
- ``mps``: co-tenant processes share a GPU through the CUDA Multi-Process
  Service; several virtual devices per request only on single-GPU nodes
  (gpusharing.go:40-50).  The manager gates it on the MPS daemon
  (``gate.py``).

Virtual IDs: ``nvidia0/vgpu1`` -> physical ``nvidia0``; on a MIG
partition ``nvidia0/gi3/vgpu1`` -> ``nvidia0/gi3``.
"""

import enum
import re
from typing import List, Optional


class SharingStrategy(str, enum.Enum):
    UNDEFINED = ""
    TIME_SHARING = "time-sharing"
    MPS = "mps"

    @classmethod
    def parse(cls, value: str) -> "SharingStrategy":
        try:
            return cls(value)
        except ValueError:
            raise ValueError(
                f"invalid GPU sharing strategy: {value!r}, should be one of "
                f"time-sharing or mps"
            ) from None


_VIRTUAL_RE = re.compile(r"^nvidia([0-9]+)(/gi[0-9]+)?/vgpu([0-9]+)$")
_VGPU_SUFFIX_RE = re.compile(r"/vgpu([0-9]+)$")


def is_virtual_device_id(device_id: str) -> bool:
    return bool(_VIRTUAL_RE.match(device_id))


def virtual_to_physical_device_id(virtual_device_id: str) -> str:
    """``nvidia0/vgpu1`` -> ``nvidia0``, ``nvidia0/gi3/vgpu1`` ->
    ``nvidia0/gi3``."""
    if not is_virtual_device_id(virtual_device_id):
        raise ValueError(f"virtual device ID ({virtual_device_id}) is not valid")
    return _VGPU_SUFFIX_RE.split(virtual_device_id)[0]


def virtual_device_ids(physical_device_id: str, max_clients: int) -> List[str]:
    """Expand one physical device into its virtual device IDs."""
    return [f"{physical_device_id}/vgpu{i}" for i in range(max_clients)]


def validate_request(
    request_device_ids: List[str],
    device_count: int,
    strategy: Optional[SharingStrategy],
) -> None:
    """Reject invalid sharing requests (ref: gpusharing.go:40-50).

    time-sharing: at most one virtual device per request.
    mps: several virtual devices only on single-GPU nodes.
    """
    if len(request_device_ids) > 1 and is_virtual_device_id(request_device_ids[0]):
        if strategy == SharingStrategy.TIME_SHARING:
            raise ValueError(
                "invalid request for sharing GPU (time-sharing), at most 1 "
                "nvidia.com/gpu can be requested on GPU-sharing nodes"
            )
        if strategy == SharingStrategy.MPS and device_count > 1:
            raise ValueError(
                "invalid request for sharing GPU (mps), at most 1 "
                "nvidia.com/gpu can be requested on multi-GPU nodes"
            )
