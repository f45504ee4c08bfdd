"""Device names of NVIDIA GPU nodes.

The driver exposes one char device per GPU as ``/dev/nvidia<minor>``
(plus the control nodes ``nvidiactl`` and ``nvidia-uvm``), where
``<minor>`` is the device's minor number, not its NVML index
(ref: pkg/gpu/nvidia/util/util.go:22-29, manager.go:231-247).
"""

import re

DEVICE_RE = re.compile(r"^nvidia([0-9]+)$")
DEVICE_PATH_RE = re.compile(r"^/dev/(nvidia[0-9]+)$")


def device_name_from_path(path: str) -> str:
    """Map ``/dev/nvidiaN`` to the device name ``nvidiaN``."""
    m = DEVICE_PATH_RE.match(path)
    if not m:
        raise ValueError(f"{path!r} is not a GPU device path (/dev/nvidiaN)")
    return m.group(1)


def device_path_from_name(name: str) -> str:
    """Map the device name ``nvidiaN`` to its ``/dev`` path."""
    if not DEVICE_RE.match(name):
        raise ValueError(f"{name!r} is not a GPU device name (nvidiaN)")
    return f"/dev/{name}"


def device_minor(name: str) -> int:
    """Return N (the minor number) for device name ``nvidiaN``."""
    m = DEVICE_RE.match(name)
    if not m:
        raise ValueError(f"{name!r} is not a GPU device name (nvidiaN)")
    return int(m.group(1))
