"""ctypes binding over NVML (``libnvidia-ml.so.1``, shipped with the
NVIDIA driver): the calls the node layer makes, as the reference makes
them through its Go bindings and cgo helper (go.mod:6-7,
pkg/gpu/nvidia/metrics/util.go:37-94).

The struct layouts are those of the CUDA toolkit's ``nvml.h`` (API 12);
``chip_smoke.py`` holds ``sizeof`` and ``offsetof`` of each against a C
program built with that header.  Every NVML return code but success
raises :class:`NvmlError` with ``nvmlErrorString``'s text, except where
a method says otherwise.

Devices are named ``nvidia<minor>`` after their ``/dev`` node, never by
their NVML index: in a container NVML index 0 can be ``/dev/nvidia5``.
"""

import ctypes
import logging
import threading
from typing import Dict, List, Optional

from container_engine_accelerators_tpu_torch.gpulib.types import (
    GpuInfo,
    GpuLib,
    MemoryInfo,
    XidEvent,
)

log = logging.getLogger(__name__)

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_NOT_FOUND = 6
NVML_ERROR_TIMEOUT = 10
NVML_GPU_UTILIZATION_SAMPLES = 1
EVENT_TYPE_XID_CRITICAL_ERROR = 0x8
_NAME_LEN = 96  # NVML_DEVICE_NAME_V2_BUFFER_SIZE
_UUID_LEN = 96  # NVML_DEVICE_UUID_V2_BUFFER_SIZE
_EVENT_WAIT_MS_MAX = 2**31 - 1


class PciInfo(ctypes.Structure):  # nvmlPciInfo_t (GetPciInfo_v3)
    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


class Memory(ctypes.Structure):  # nvmlMemory_t
    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


class Value(ctypes.Union):  # nvmlValue_t
    _fields_ = [
        ("dVal", ctypes.c_double),
        ("siVal", ctypes.c_int),
        ("uiVal", ctypes.c_uint),
        ("ulVal", ctypes.c_ulong),
        ("ullVal", ctypes.c_ulonglong),
        ("sllVal", ctypes.c_longlong),
        ("usVal", ctypes.c_ushort),
    ]


class Sample(ctypes.Structure):  # nvmlSample_t
    _fields_ = [
        ("timeStamp", ctypes.c_ulonglong),  # CPU time, microseconds
        ("sampleValue", Value),
    ]


class EventData(ctypes.Structure):  # nvmlEventData_t
    _fields_ = [
        ("device", ctypes.c_void_p),
        ("eventType", ctypes.c_ulonglong),
        ("eventData", ctypes.c_ulonglong),  # the Xid
        ("gpuInstanceId", ctypes.c_uint),
        ("computeInstanceId", ctypes.c_uint),
    ]


class Utilization(ctypes.Structure):  # nvmlUtilization_t
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


# nvmlValueType_t -> the union member that holds the sample.
_VALUE_FIELDS = ("dVal", "uiVal", "ulVal", "ullVal", "sllVal", "siVal", "usVal")

_P = ctypes.POINTER
_H = ctypes.c_void_p  # nvmlDevice_t / nvmlEventSet_t
_U = ctypes.c_uint
_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [_P(_U)],
    "nvmlDeviceGetHandleByIndex_v2": [_U, _P(_H)],
    "nvmlDeviceGetName": [_H, ctypes.c_char_p, _U],
    "nvmlDeviceGetUUID": [_H, ctypes.c_char_p, _U],
    "nvmlDeviceGetMinorNumber": [_H, _P(_U)],
    "nvmlDeviceGetPciInfo_v3": [_H, _P(PciInfo)],
    "nvmlDeviceGetMemoryInfo": [_H, _P(Memory)],
    "nvmlDeviceGetSamples": [_H, ctypes.c_int, ctypes.c_ulonglong,
                             _P(ctypes.c_int), _P(_U), _P(Sample)],
    "nvmlDeviceGetUtilizationRates": [_H, _P(Utilization)],
    "nvmlDeviceGetMigMode": [_H, _P(_U), _P(_U)],
    "nvmlEventSetCreate": [_P(_H)],
    "nvmlDeviceRegisterEvents": [_H, ctypes.c_ulonglong, _H],
    "nvmlEventSetWait_v2": [_H, _P(EventData), _U],
    "nvmlEventSetFree": [_H],
}


class NvmlError(OSError):
    def __init__(self, code: int, call: str, text: str):
        super().__init__(code, f"{call}: {text} (NVML {code})")
        self.code = code
        self.call = call


def load_library() -> ctypes.CDLL:
    """Open ``LIBRARY`` and declare every call's types.  OSError if the
    driver's library cannot be loaded: there is no fallback."""
    lib = ctypes.CDLL(LIBRARY)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.nvmlErrorString.argtypes = [ctypes.c_int]
    lib.nvmlErrorString.restype = ctypes.c_char_p
    return lib


class NvmlLib(GpuLib):
    """The node's GPUs through NVML.  ``cdll`` replaces the library (the
    tests pass a fake); by default ``LIBRARY`` is loaded."""

    def __init__(self, cdll=None):
        self._lib = cdll if cdll is not None else load_library()
        self._call("nvmlInit_v2")
        self._open = True
        self._event_set: Optional[ctypes.c_void_p] = None
        self._xid_registered: List[str] = []
        self._last_sample_us: Dict[str, int] = {}
        self._last_duty: Dict[str, int] = {}
        # Devices whose driver refuses GetSamples read the instantaneous
        # utilization instead (see duty_cycle).
        self._sampling_refused = set()
        self._handles: Dict[str, ctypes.c_void_p] = {}
        self._names_by_handle: Dict[int, str] = {}
        self._devices: List[GpuInfo] = []
        self._enumerate_lock = threading.Lock()
        try:
            self._enumerate()
        except BaseException:
            self.close()
            raise

    def _call(self, name: str, *args) -> None:
        rc = getattr(self._lib, name)(*args)
        if rc != NVML_SUCCESS:
            raise self._error(rc, name)

    def _error(self, rc: int, name: str) -> NvmlError:
        text = self._lib.nvmlErrorString(rc)
        return NvmlError(rc, name, text.decode() if text else "unknown")

    def _enumerate(self) -> None:
        """Map the devices NVML counts beyond those already known: all of
        them at start-up, a hotplugged GPU later (see devices)."""
        with self._enumerate_lock:
            count = ctypes.c_uint()
            self._call("nvmlDeviceGetCount_v2", ctypes.byref(count))
            for index in range(len(self._devices), count.value):
                self._add_device(index)

    def _add_device(self, index: int) -> None:
        handle = ctypes.c_void_p()
        self._call("nvmlDeviceGetHandleByIndex_v2", index,
                   ctypes.byref(handle))
        name_buf = ctypes.create_string_buffer(_NAME_LEN)
        self._call("nvmlDeviceGetName", handle, name_buf, _NAME_LEN)
        uuid_buf = ctypes.create_string_buffer(_UUID_LEN)
        self._call("nvmlDeviceGetUUID", handle, uuid_buf, _UUID_LEN)
        minor = ctypes.c_uint()
        self._call("nvmlDeviceGetMinorNumber", handle, ctypes.byref(minor))
        info = GpuInfo(
            name=f"nvidia{minor.value}",
            index=index,
            minor=minor.value,
            uuid=uuid_buf.value.decode(),
            pci_bus_id=self._pci_bus_id(handle),
            model=name_buf.value.decode(),
        )
        self._devices.append(info)
        self._handles[info.name] = handle
        self._names_by_handle[handle.value] = info.name
        # A GPU mapped after the checker subscribed (hotplug) is
        # subscribed here, so its Xids reach the checker too.
        if self._event_set is not None:
            self._register(info)

    def _pci_bus_id(self, handle) -> Optional[str]:
        """The PCI bus id, or None where the driver answers NOT_SUPPORTED
        (a driver under gVisor may: nvidia-smi then prints ``[N/A]``)."""
        pci = PciInfo()
        rc = self._lib.nvmlDeviceGetPciInfo_v3(handle, ctypes.byref(pci))
        if rc == NVML_ERROR_NOT_SUPPORTED:
            return None
        if rc != NVML_SUCCESS:
            raise self._error(rc, "nvmlDeviceGetPciInfo_v3")
        return pci.busId.decode()

    def close(self) -> None:
        if not getattr(self, "_open", False):
            return
        self._open = False
        if self._event_set is not None:
            self._lib.nvmlEventSetFree(self._event_set)
            self._event_set = None
        self._call("nvmlShutdown")

    # -- enumeration ---------------------------------------------------------

    def devices(self) -> List[GpuInfo]:
        """The GPUs NVML counts now.  Each call asks NVML for the count
        again and maps any GPU beyond those known, so the manager's
        hotplug poll sees a GPU that appears after start-up."""
        self._enumerate()
        return list(self._devices)

    def _handle(self, name: str) -> ctypes.c_void_p:
        try:
            return self._handles[name]
        except KeyError:
            raise ValueError(f"no GPU named {name!r}") from None

    def mig_mode(self, name: str) -> Dict[str, int]:
        current, pending = ctypes.c_uint(), ctypes.c_uint()
        self._call("nvmlDeviceGetMigMode", self._handle(name),
                   ctypes.byref(current), ctypes.byref(pending))
        return {"current": current.value, "pending": pending.value}

    # -- sampling ------------------------------------------------------------

    def memory_info(self, name: str) -> MemoryInfo:
        mem = Memory()
        self._call("nvmlDeviceGetMemoryInfo", self._handle(name),
                   ctypes.byref(mem))
        return MemoryInfo(total_bytes=mem.total, used_bytes=mem.used)

    def duty_cycle(self, name: str) -> int:
        """Average GPU utilization of the samples NVML took since the last
        call for this device (the reference's cgo helper, util.go:37-94);
        the previous value when no new sample exists yet.

        A driver that answers GetSamples with NOT_SUPPORTED (one under
        gVisor may) gets ``nvmlDeviceGetUtilizationRates``: the share of the
        driver's last sample period the GPU was busy, the number
        ``nvidia-smi`` prints as ``utilization.gpu``.
        """
        handle = self._handle(name)
        if name not in self._sampling_refused:
            try:
                return self._sampled_duty(name, handle)
            except NvmlError as e:
                if e.code != NVML_ERROR_NOT_SUPPORTED:
                    raise
                log.warning("%s: nvmlDeviceGetSamples is not supported; "
                            "reading nvmlDeviceGetUtilizationRates", name)
                self._sampling_refused.add(name)
        util = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", handle, ctypes.byref(util))
        return util.gpu

    def duty_cycle_source(self, name: str) -> str:
        return ("nvmlDeviceGetUtilizationRates" if name in self._sampling_refused
                else "nvmlDeviceGetSamples")

    def _sampled_duty(self, name: str, handle) -> int:
        since = self._last_sample_us.get(name, 0)
        value_type, count = ctypes.c_int(), ctypes.c_uint()
        args = (handle, NVML_GPU_UTILIZATION_SAMPLES, since,
                ctypes.byref(value_type), ctypes.byref(count))
        rc = self._lib.nvmlDeviceGetSamples(*args, None)
        if rc == NVML_SUCCESS and count.value:
            samples = (Sample * count.value)()
            rc = self._lib.nvmlDeviceGetSamples(*args, samples)
        if rc == NVML_ERROR_NOT_FOUND or (rc == NVML_SUCCESS
                                          and not count.value):
            return self._last_duty.get(name, 0)
        if rc != NVML_SUCCESS:
            raise self._error(rc, "nvmlDeviceGetSamples")
        field = _VALUE_FIELDS[value_type.value]
        taken = samples[:count.value]
        values = [getattr(s.sampleValue, field) for s in taken]
        duty = int(sum(values) / len(values))
        self._last_sample_us[name] = max(s.timeStamp for s in taken)
        self._last_duty[name] = duty
        return duty

    # -- Xid events ----------------------------------------------------------

    def register_xid_events(self) -> List[str]:
        """Subscribe every GPU known now.  The list returned is the lib's
        own: a GPU mapped later (``devices`` after a hotplug) is subscribed
        as it is mapped and appended to it."""
        with self._enumerate_lock:
            if self._event_set is None:
                event_set = ctypes.c_void_p()
                self._call("nvmlEventSetCreate", ctypes.byref(event_set))
                self._event_set = event_set
            self._xid_registered.clear()
            for info in self._devices:
                self._register(info)
            return self._xid_registered

    def _register(self, info: GpuInfo) -> None:
        rc = self._lib.nvmlDeviceRegisterEvents(
            self._handles[info.name], EVENT_TYPE_XID_CRITICAL_ERROR,
            self._event_set)
        if rc == NVML_ERROR_NOT_SUPPORTED:
            log.warning("%s (%s) does not support Xid events; it is "
                        "not health checked", info.name, info.model)
            return
        if rc != NVML_SUCCESS:
            raise self._error(rc, "nvmlDeviceRegisterEvents")
        self._xid_registered.append(info.name)

    def wait_for_event(self, timeout_s: float) -> Optional[XidEvent]:
        if self._event_set is None:
            raise RuntimeError("wait_for_event before register_xid_events")
        data = EventData()
        timeout_ms = min(max(0, int(timeout_s * 1000)), _EVENT_WAIT_MS_MAX)
        rc = self._lib.nvmlEventSetWait_v2(self._event_set, ctypes.byref(data),
                                           timeout_ms)
        if rc == NVML_ERROR_TIMEOUT:
            return None
        if rc != NVML_SUCCESS:
            raise self._error(rc, "nvmlEventSetWait_v2")
        if data.eventType != EVENT_TYPE_XID_CRITICAL_ERROR:
            log.info("ignoring NVML event type %#x", data.eventType)
            return None
        # An event without a device (or with one NVML did not enumerate)
        # takes the whole node down in the checker.
        device = self._names_by_handle.get(data.device) if data.device else None
        return XidEvent(code=int(data.eventData), device=device,
                        message=f"Xid {data.eventData}")
