"""Public re-exports for the sharing package."""
from container_engine_accelerators_tpu_torch.sharing.sharing import (
    SharingStrategy,
    is_virtual_device_id,
    validate_request,
    virtual_device_ids,
    virtual_to_physical_device_id,
)

__all__ = [
    "SharingStrategy",
    "is_virtual_device_id",
    "validate_request",
    "virtual_to_physical_device_id",
    "virtual_device_ids",
]
