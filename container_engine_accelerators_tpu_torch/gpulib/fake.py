"""A fixture-backed GPU node for tests: the part of NVML and ``/dev`` the
node layer reads, as files under a root directory.

    <root>/dev/nvidia<minor>, nvidiactl, nvidia-uvm (+ nvidia-uvm-tools,
        nvidia-modeset)                      device nodes (empty files)
    <root>/var/run/nvidia/gpus.json          the device table, one entry a
        GPU: index, minor, uuid, pci_bus_id, model, memory_total,
        memory_used, duty_cycle, xid_supported
    <root>/var/run/nvidia/events/<seq>.json  the Xid queue:
        {"code": int, "device": "nvidia<minor>" | null, "message": str}
    <root>/proc/driver/nvidia/capabilities/gpu<minor>/mig/gi<G>/access
        (+ ci0/access) and <root>/dev/nvidia-caps/nvidia-cap<m>
                                             MIG partitions
                                             (``write_mig_fixture``)

``gpulib.open_lib`` returns it only when a flag names a fixture.
"""

import json
import logging
import os
import time
from typing import List, Optional, Sequence

from container_engine_accelerators_tpu_torch.gpulib.types import (
    GpuInfo,
    GpuLib,
    MemoryInfo,
    XidEvent,
)

log = logging.getLogger(__name__)

EVENT_POLL_INTERVAL_S = 0.05
TABLE = "var/run/nvidia/gpus.json"
EVENTS = "var/run/nvidia/events"
CONTROL_NODES = ("nvidiactl", "nvidia-uvm")
EXTRA_NODES = ("nvidia-uvm-tools", "nvidia-modeset")
H100_MODEL = "NVIDIA H100 80GB HBM3"
H100_MEMORY = 81559 * 2**20


def _entry(index: int, minor: int, memory_total: int, model: str) -> dict:
    return {
        "index": index,
        "minor": minor,
        "uuid": f"GPU-{minor:08x}-0000-4000-8000-{index:012x}",
        "pci_bus_id": f"00000000:{0x18 + index:02X}:00.0",
        "model": model,
        "memory_total": memory_total,
        "memory_used": 0,
        "duty_cycle": 0,
        "xid_supported": True,
    }


def _read_table(root: str) -> List[dict]:
    try:
        with open(os.path.join(root, TABLE)) as f:
            return json.load(f)
    except FileNotFoundError:
        return []


def _write_table(root: str, table: List[dict]) -> None:
    path = os.path.join(root, TABLE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(table, f)
    os.replace(tmp, path)


def write_fixture(
    root: str,
    num_gpus: int,
    minors: Optional[Sequence[int]] = None,
    memory_total: int = H100_MEMORY,
    model: str = H100_MODEL,
    extra_nodes: Sequence[str] = EXTRA_NODES,
) -> None:
    """Fabricate a node of ``num_gpus`` GPUs under ``root``.  ``minors``
    gives each NVML index its minor number (default: the index)."""
    minors = list(range(num_gpus)) if minors is None else list(minors)
    if len(minors) != num_gpus:
        raise ValueError("one minor number per GPU")
    os.makedirs(os.path.join(root, EVENTS), exist_ok=True)
    dev = os.path.join(root, "dev")
    os.makedirs(dev, exist_ok=True)
    for node in CONTROL_NODES + tuple(extra_nodes):
        open(os.path.join(dev, node), "w").close()
    for minor in minors:
        open(os.path.join(dev, f"nvidia{minor}"), "w").close()
    _write_table(root, [_entry(i, m, memory_total, model)
                        for i, m in enumerate(minors)])


# The driver's capability minors (/proc/driver/nvidia-caps/mig-minors):
# 1 and 2 for config and monitor, then per GPU 15 GPU instances of 9
# minors each, the instance's access and its compute instances' ci0-ci7.
_CAPS_PER_GI = 9
_CAPS_PER_GPU = 15 * _CAPS_PER_GI
# The GPU-instance ids an H100 gives the first partition of a layout of
# n partitions (nvidia-smi mig -lgi after -cgi of the size's maximum).
_FIRST_GI = {7: 7, 4: 3, 3: 3, 2: 1, 1: 0}


def cap_minor(minor: int, gi: int, ci: Optional[int] = None) -> int:
    """The capability minor of ``gpu<minor>/gi<gi>/access`` (or of its
    ``ci<ci>/access``)."""
    base = 3 + minor * _CAPS_PER_GPU + gi * _CAPS_PER_GI
    return base if ci is None else base + 1 + ci


def write_mig_fixture(root: str, count: int,
                      minors: Optional[Sequence[int]] = None,
                      caps_nodes: bool = True) -> List[str]:
    """Program ``count`` MIG partitions on each GPU of the fixture (all of
    them, or ``minors``): the driver's /proc capability tree and the
    /dev/nvidia-caps nodes.  Returns the partition ids, ``nvidia<m>/gi<G>``."""
    from container_engine_accelerators_tpu_torch.partition.mig import (
        CAPABILITIES,
        CAPS_DIRECTORY,
    )

    if minors is None:
        minors = [e["minor"] for e in _read_table(root)]
    caps = os.path.join(root, "dev", CAPS_DIRECTORY)
    os.makedirs(caps, exist_ok=True)
    ids = []
    for minor in minors:
        for gi in range(_FIRST_GI.get(count, 1), _FIRST_GI.get(count, 1)
                        + count):
            gi_dir = os.path.join(root, "proc", CAPABILITIES, f"gpu{minor}",
                                  "mig", f"gi{gi}")
            os.makedirs(os.path.join(gi_dir, "ci0"), exist_ok=True)
            for rel, cap in (("access", cap_minor(minor, gi)),
                             ("ci0/access", cap_minor(minor, gi, 0))):
                with open(os.path.join(gi_dir, rel), "w") as f:
                    f.write(f"DeviceFileMinor: {cap}\nDeviceFileMode: 292\n"
                            f"DeviceFileModify: 1\n")
                if caps_nodes:
                    open(os.path.join(caps, f"nvidia-cap{cap}"), "w").close()
            ids.append(f"nvidia{minor}/gi{gi}")
    return ids


def add_gpu(root: str, minor: int) -> None:
    """Hotplug: one more GPU in the table and its ``/dev`` node."""
    table = _read_table(root)
    first = table[0] if table else _entry(0, 0, H100_MEMORY, H100_MODEL)
    table.append(_entry(len(table), minor, first["memory_total"],
                        first["model"]))
    _write_table(root, table)
    open(os.path.join(root, "dev", f"nvidia{minor}"), "w").close()


def set_gpu(root: str, name: str, **fields) -> None:
    """Change a GPU's entry (``duty_cycle``, ``memory_used``,
    ``xid_supported``, ...)."""
    table = _read_table(root)
    for entry in table:
        if f"nvidia{entry['minor']}" == name:
            entry.update(fields)
            _write_table(root, table)
            return
    raise ValueError(f"no GPU named {name!r}")


def post_event(root: str, code: int, device: Optional[str],
               message: str = "") -> str:
    """Drop one Xid into the queue (atomic rename, ordered by name)."""
    events = os.path.join(root, EVENTS)
    os.makedirs(events, exist_ok=True)
    seq = time.monotonic_ns()
    tmp = os.path.join(events, f".{seq}.tmp")
    with open(tmp, "w") as f:
        json.dump({"code": code, "device": device, "message": message}, f)
    final = os.path.join(events, f"{seq}.json")
    os.rename(tmp, final)
    return final


class FakeGpuLib(GpuLib):
    def __init__(self, root: str):
        if not os.path.exists(os.path.join(root, TABLE)):
            raise FileNotFoundError(f"no GPU fixture under {root}")
        self.root = root
        self.events_dir = os.path.join(root, EVENTS)
        self._registered: Optional[List[str]] = None
        self._seen = set()  # GPUs the Xid subscription has looked at

    def _entries(self) -> List[dict]:
        return _read_table(self.root)

    def _entry(self, name: str) -> dict:
        for entry in self._entries():
            if f"nvidia{entry['minor']}" == name:
                return entry
        raise ValueError(f"no GPU named {name!r}")

    def devices(self) -> List[GpuInfo]:
        return [GpuInfo(name=f"nvidia{e['minor']}", index=e["index"],
                        minor=e["minor"], uuid=e["uuid"],
                        pci_bus_id=e["pci_bus_id"], model=e["model"])
                for e in self._entries()]

    def memory_info(self, name: str) -> MemoryInfo:
        e = self._entry(name)
        return MemoryInfo(total_bytes=e["memory_total"],
                          used_bytes=e["memory_used"])

    def duty_cycle(self, name: str) -> int:
        return int(self._entry(name)["duty_cycle"])

    def register_xid_events(self) -> List[str]:
        self._registered = []
        self._seen.clear()
        self._subscribe_new()
        return self._registered

    def _subscribe_new(self) -> None:
        """Subscribe the GPUs of the table not seen yet (all of them at
        registration, a hotplugged one later), as NvmlLib does."""
        for entry in self._entries():
            name = f"nvidia{entry['minor']}"
            if name in self._seen:
                continue
            self._seen.add(name)
            if not entry["xid_supported"]:
                log.warning("%s (%s) does not support Xid events; it is "
                            "not health checked", name, entry["model"])
                continue
            self._registered.append(name)

    def _next_event_file(self) -> Optional[str]:
        try:
            entries = sorted(e for e in os.listdir(self.events_dir)
                             if e.endswith(".json"))
        except FileNotFoundError:
            return None
        return os.path.join(self.events_dir, entries[0]) if entries else None

    def wait_for_event(self, timeout_s: float) -> Optional[XidEvent]:
        """Consume the queue's oldest event; like NVML, an event on a
        device that was not registered is not delivered."""
        if self._registered is None:
            raise RuntimeError("wait_for_event before register_xid_events")
        deadline = time.monotonic() + timeout_s
        while True:
            self._subscribe_new()
            path = self._next_event_file()
            if path is not None:
                obj = None
                try:
                    with open(path) as f:
                        obj = json.load(f)
                except (OSError, ValueError):
                    log.warning("discarding unreadable event file %s", path)
                try:
                    os.unlink(path)
                except FileNotFoundError:
                    pass
                if isinstance(obj, dict) and (
                        obj.get("device") is None
                        or obj["device"] in self._registered):
                    return XidEvent(code=int(obj.get("code", -1)),
                                    device=obj.get("device"),
                                    message=obj.get("message", ""))
                continue
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            time.sleep(min(EVENT_POLL_INTERVAL_S, remaining))
