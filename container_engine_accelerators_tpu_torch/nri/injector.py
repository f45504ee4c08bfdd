"""Device injection: a pod annotation -> NRI LinuxDevice adjustments (a
copy of the JAX package's ``nri/injector.py``).

As the reference injector (nri_device_injector.go:126-199): the
annotation ``devices.gke.io/container.<name>`` holds a YAML or JSON list
of ``{path, type, major, minor, file_mode, uid, gid}``; of entries with
one path the first is kept; the device's type, major and minor come from
an lstat of the path on the node (the annotated values are only
informational), and the annotation's file_mode, uid and gid apply when
non-zero.  On a GPU node the paths are the GPU's nodes, as the device
plugin's Allocate gives them: ``/dev/nvidia<minor>``, ``/dev/nvidiactl``,
``/dev/nvidia-uvm`` (whose major the driver picks at load time) and,
for a MIG partition, ``/dev/nvidia-caps/nvidia-cap<m>``.
"""

import os
import stat as stat_module
from typing import Dict, List

import yaml

from container_engine_accelerators_tpu_torch.nri import nri_v1alpha1_pb2 as pb

DEVICE_KEY_PREFIX = "devices.gke.io"
CTR_DEVICE_KEY_PREFIX = DEVICE_KEY_PREFIX + "/container."

BLOCK_DEVICE = "b"
CHAR_DEVICE = "c"
FIFO_DEVICE = "p"


class _NoAliasSafeLoader(yaml.SafeLoader):
    """A SafeLoader that refuses anchors and aliases: annotations are
    untrusted pod input, PyYAML expands aliases without limit (the
    billion laughs), and a device list never needs them."""

    def compose_node(self, parent, index):
        if self.check_event(yaml.events.AliasEvent):
            raise yaml.YAMLError("YAML aliases are not allowed")
        return super().compose_node(parent, index)


def get_devices(ctr_name: str, pod_annotations: Dict[str, str]) -> List[dict]:
    """The container's device annotation, parsed; [] when absent."""
    raw = (pod_annotations or {}).get(CTR_DEVICE_KEY_PREFIX + ctr_name)
    if raw is None:
        return []
    try:
        parsed = yaml.load(raw, Loader=_NoAliasSafeLoader)
    except yaml.YAMLError as e:
        raise ValueError(f"invalid device annotation for {ctr_name!r}: {e}")
    if parsed is None:
        return []
    if not isinstance(parsed, list):
        raise ValueError(
            f"invalid device annotation for {ctr_name!r}: expected a list"
        )
    devices, seen = [], set()
    for entry in parsed:
        if not isinstance(entry, dict) or "path" not in entry:
            raise ValueError(
                f"invalid device annotation for {ctr_name!r}: "
                f"each entry needs a 'path'"
            )
        if entry["path"] in seen:
            continue
        seen.add(entry["path"])
        devices.append(entry)
    return devices


def to_linux_device(entry: dict, lstat=os.lstat) -> pb.LinuxDevice:
    """lstat the device path and build the NRI device (go:158-199)."""
    path = entry["path"]
    try:
        st = lstat(path)
    except OSError as e:
        raise ValueError(f"failed to get info from device path {path}: {e}")
    mode = st.st_mode
    if stat_module.S_ISBLK(mode):
        dev_type = BLOCK_DEVICE
    elif stat_module.S_ISCHR(mode):
        dev_type = CHAR_DEVICE
    elif stat_module.S_ISFIFO(mode):
        dev_type = FIFO_DEVICE
    else:
        raise ValueError(f"invalid device type {mode:o} from device path {path}")
    device = pb.LinuxDevice(
        path=path,
        type=dev_type,
        major=os.major(st.st_rdev),
        minor=os.minor(st.st_rdev),
    )
    if entry.get("file_mode"):
        device.file_mode.value = _parse_mode(entry["file_mode"])
    if entry.get("uid"):
        device.uid.value = int(entry["uid"])
    if entry.get("gid"):
        device.gid.value = int(entry["gid"])
    return device


def _parse_mode(value) -> int:
    """A file mode arrives as an int or a string: YAML 1.1 reads ``0660``
    as an octal int, but PyYAML leaves ``0o660`` a string; both are
    taken (Go's yaml.v3, which the reference uses, reads 0o as an int)."""
    if isinstance(value, int):
        return value
    s = str(value).strip()
    if s.startswith(("0o", "0O", "0x", "0X", "0b", "0B")):
        return int(s, 0)
    if s.startswith("0") and s != "0":
        return int(s, 8)
    return int(s)


def create_container_adjustment(
    ctr_name: str, pod_annotations: Dict[str, str], lstat=os.lstat
) -> pb.ContainerAdjustment:
    """The CreateContainer hook's body (go:86-123).  Raises on a bad
    annotation or a missing device, so that the runtime fails the
    container rather than start it without its devices."""
    adjust = pb.ContainerAdjustment()
    for entry in get_devices(ctr_name, pod_annotations):
        adjust.linux.devices.append(to_linux_device(entry, lstat=lstat))
    return adjust
