"""Public re-exports for the health package."""
from container_engine_accelerators_tpu_torch.health.health_checker import (
    DEFAULT_CRITICAL_XID,
    DEFAULT_RECOVERY_WINDOW_S,
    GpuHealthChecker,
)

__all__ = [
    "GpuHealthChecker",
    "DEFAULT_CRITICAL_XID",
    "DEFAULT_RECOVERY_WINDOW_S",
]
