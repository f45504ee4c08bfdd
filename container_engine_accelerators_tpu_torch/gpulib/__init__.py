"""gpulib: the node's GPUs as the node layer sees them.

Two backends implement :class:`GpuLib`:

- :class:`~container_engine_accelerators_tpu_torch.gpulib.nvml.NvmlLib`,
  ctypes over the driver's NVML: what every node runs;
- :class:`~container_engine_accelerators_tpu_torch.gpulib.fake.FakeGpuLib`,
  a node written as files under a directory, for tests.

``open_lib`` returns the fake only when it is given a fixture.  It never
falls back from NVML to anything: a node whose NVML cannot load has no
GPU to advertise, and the caller sees the error.
"""

from typing import Optional

from container_engine_accelerators_tpu_torch.gpulib.types import GpuLib


def open_lib(fixture: Optional[str] = None) -> GpuLib:
    """NVML, or the fake node under ``fixture``.  Raises OSError when
    ``libnvidia-ml.so.1`` cannot load and NvmlError when NVML fails to
    initialise."""
    if fixture:
        from container_engine_accelerators_tpu_torch.gpulib.fake import (
            FakeGpuLib,
        )

        return FakeGpuLib(fixture)
    from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlLib

    return NvmlLib()
