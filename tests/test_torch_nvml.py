"""The port's NVML binding (gpulib/nvml.py) against a fake CDLL: the
struct layouts of nvml.h, names by minor number, the return-code to
exception mapping, the duty-cycle average and its fallback, Xid
registration and events; open_lib's refusal to fall back; and, with the
``cuda`` marker, NvmlLib against the card.

The file imports no JAX, so on a GPU host the card checks run alone:

    python -m pytest --noconftest -m cuda tests/test_torch_nvml.py
"""

import ctypes
import threading
import time

import pytest

from container_engine_accelerators_tpu_torch import gpulib
from container_engine_accelerators_tpu_torch.gpulib import nvml
from container_engine_accelerators_tpu_torch.gpulib.nvml import NvmlError, NvmlLib

SUCCESS, NOT_SUPPORTED, NOT_FOUND, TIMEOUT = 0, 3, 6, 10
GPU_IS_LOST, OPERATING_SYSTEM = 15, 17
TEXT = {NOT_SUPPORTED: b"Not Supported", GPU_IS_LOST: b"GPU is lost",
        OPERATING_SYSTEM: b"GPU access blocked by the operating system",
        2: b"Invalid Argument"}

# sizeof and offsetof in the CUDA toolkit's nvml.h (API 12), as g++ prints
# them on the card's machine.
LAYOUT = {
    nvml.PciInfo: (68, {"busIdLegacy": 0, "domain": 16, "bus": 20,
                        "device": 24, "pciDeviceId": 28,
                        "pciSubSystemId": 32, "busId": 36}),
    nvml.Memory: (24, {"total": 0, "free": 8, "used": 16}),
    nvml.Sample: (16, {"timeStamp": 0, "sampleValue": 8}),
    nvml.Value: (8, {f: 0 for f in ("dVal", "siVal", "uiVal", "ulVal",
                                    "ullVal", "sllVal", "usVal")}),
    nvml.EventData: (32, {"device": 0, "eventType": 8, "eventData": 16,
                          "gpuInstanceId": 24, "computeInstanceId": 28}),
    nvml.Utilization: (8, {"gpu": 0, "memory": 4}),
}


@pytest.mark.parametrize("cls", list(LAYOUT), ids=lambda c: c.__name__)
def test_struct_layout_is_nvml_h(cls):
    size, offsets = LAYOUT[cls]
    assert ctypes.sizeof(cls) == size
    assert {f: getattr(cls, f).offset for f, _ in cls._fields_} == offsets


class FakeNvml:
    """The NVML calls NvmlLib makes, over a table of GPUs."""

    def __init__(self, minors=(5, 2), pci_rc=SUCCESS):
        self.gpus = [{"minor": m, "uuid": f"GPU-{i:04d}",
                      "name": b"NVIDIA H100 80GB HBM3", "total": 80 << 30,
                      "used": (i + 1) << 30} for i, m in enumerate(minors)]
        self.rc = {}  # call name -> forced return code
        self.pci_rc = pci_rc
        self.samples = {}  # index -> [(timeStamp, value)]
        self.samples_rc = SUCCESS
        self.util = 37
        self.register_rc = {}
        self.events = []  # (rc, handle, type, data)
        self.calls = []
        self.registered = []

    def __getattr__(self, name):
        raise AttributeError(name)

    def _handle(self, h):
        v = h.value if isinstance(h, ctypes.c_void_p) else h
        return v - 0x1000

    def _log(self, name):
        self.calls.append(name)
        return self.rc.get(name, SUCCESS)

    def nvmlErrorString(self, rc):
        return TEXT.get(rc, b"Unknown Error")

    def nvmlInit_v2(self):
        return self._log("nvmlInit_v2")

    def nvmlShutdown(self):
        return self._log("nvmlShutdown")

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = len(self.gpus)
        return self._log("nvmlDeviceGetCount_v2")

    def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
        handle._obj.value = 0x1000 + index
        return self._log("nvmlDeviceGetHandleByIndex_v2")

    def nvmlDeviceGetName(self, h, buf, n):
        buf.value = self.gpus[self._handle(h)]["name"]
        return self._log("nvmlDeviceGetName")

    def nvmlDeviceGetUUID(self, h, buf, n):
        buf.value = self.gpus[self._handle(h)]["uuid"].encode()
        return self._log("nvmlDeviceGetUUID")

    def nvmlDeviceGetMinorNumber(self, h, minor):
        minor._obj.value = self.gpus[self._handle(h)]["minor"]
        return self._log("nvmlDeviceGetMinorNumber")

    def nvmlDeviceGetPciInfo_v3(self, h, pci):
        pci._obj.busId = f"00000000:{0x18 + self._handle(h):02X}:00.0".encode()
        self._log("nvmlDeviceGetPciInfo_v3")
        return self.pci_rc

    def nvmlDeviceGetMemoryInfo(self, h, mem):
        g = self.gpus[self._handle(h)]
        mem._obj.total, mem._obj.used = g["total"], g["used"]
        mem._obj.free = g["total"] - g["used"]
        return self._log("nvmlDeviceGetMemoryInfo")

    def nvmlDeviceGetSamples(self, h, kind, since, vtype, count, buf):
        self._log("nvmlDeviceGetSamples")
        assert kind == nvml.NVML_GPU_UTILIZATION_SAMPLES
        if self.samples_rc != SUCCESS:
            return self.samples_rc
        taken = [s for s in self.samples.get(self._handle(h), [])
                 if s[0] > since]
        if not taken:
            return NOT_FOUND
        vtype._obj.value = 1  # NVML_VALUE_TYPE_UNSIGNED_INT
        if buf is None:
            count._obj.value = len(taken)
            return SUCCESS
        n = min(count._obj.value, len(taken))
        for i, (ts, v) in enumerate(taken[:n]):
            buf[i].timeStamp = ts
            buf[i].sampleValue.uiVal = v
        count._obj.value = n
        return SUCCESS

    def nvmlDeviceGetUtilizationRates(self, h, util):
        util._obj.gpu = self.util
        return self._log("nvmlDeviceGetUtilizationRates")

    def nvmlDeviceGetMigMode(self, h, current, pending):
        current._obj.value, pending._obj.value = 0, 1
        return self._log("nvmlDeviceGetMigMode")

    def nvmlEventSetCreate(self, event_set):
        event_set._obj.value = 0xE0
        return self._log("nvmlEventSetCreate")

    def nvmlEventSetFree(self, event_set):
        return self._log("nvmlEventSetFree")

    def nvmlDeviceRegisterEvents(self, h, types, event_set):
        assert types == nvml.EVENT_TYPE_XID_CRITICAL_ERROR
        self._log("nvmlDeviceRegisterEvents")
        rc = self.register_rc.get(self._handle(h), SUCCESS)
        if rc == SUCCESS:
            self.registered.append(self._handle(h))
        return rc

    def nvmlEventSetWait_v2(self, event_set, data, timeout_ms):
        self._log("nvmlEventSetWait_v2")
        if not self.events:
            return TIMEOUT
        rc, handle, kind, xid = self.events.pop(0)
        data._obj.device, data._obj.eventType = handle, kind
        data._obj.eventData = xid
        return rc


@pytest.fixture
def fake():
    return FakeNvml()


def test_devices_are_named_by_minor(fake):
    lib = NvmlLib(cdll=fake)
    assert [(d.name, d.index, d.minor, d.uuid, d.model) for d in
            lib.devices()] == [
        ("nvidia5", 0, 5, "GPU-0000", "NVIDIA H100 80GB HBM3"),
        ("nvidia2", 1, 2, "GPU-0001", "NVIDIA H100 80GB HBM3")]
    assert lib.devices()[1].pci_bus_id == "00000000:19:00.0"
    assert lib.device_count() == 2
    assert lib.device_info("nvidia2").index == 1
    with pytest.raises(ValueError):
        lib.memory_info("nvidia0")  # index 0 is not nvidia0
    lib.close()


def test_pci_not_supported_is_none(fake):
    fake.pci_rc = NOT_SUPPORTED
    lib = NvmlLib(cdll=fake)
    assert [d.pci_bus_id for d in lib.devices()] == [None, None]


def test_pci_other_errors_raise(fake):
    fake.pci_rc = GPU_IS_LOST
    with pytest.raises(NvmlError) as e:
        NvmlLib(cdll=fake)
    assert e.value.code == GPU_IS_LOST
    assert fake.calls[-1] == "nvmlShutdown"  # a failed open shuts NVML down


def test_memory_info_and_mig_mode(fake):
    lib = NvmlLib(cdll=fake)
    mem = lib.memory_info("nvidia2")
    assert (mem.total_bytes, mem.used_bytes) == (80 << 30, 2 << 30)
    assert lib.mig_mode("nvidia5") == {"current": 0, "pending": 1}


@pytest.mark.parametrize("call", ["nvmlDeviceGetMemoryInfo",
                                  "nvmlDeviceGetMigMode"])
@pytest.mark.parametrize("rc", [2, GPU_IS_LOST, NOT_SUPPORTED])
def test_return_codes_raise_with_the_error_string(fake, call, rc):
    lib = NvmlLib(cdll=fake)
    fake.rc[call] = rc
    with pytest.raises(NvmlError) as e:
        if call == "nvmlDeviceGetMemoryInfo":
            lib.memory_info("nvidia5")
        else:
            lib.mig_mode("nvidia5")
    assert e.value.code == rc
    assert e.value.call == call
    assert TEXT[rc].decode() in str(e.value)
    assert isinstance(e.value, OSError)


def test_init_failure_raises_without_shutdown(fake):
    fake.rc["nvmlInit_v2"] = 9  # NVML_ERROR_DRIVER_NOT_LOADED
    with pytest.raises(NvmlError) as e:
        NvmlLib(cdll=fake)
    assert e.value.code == 9
    assert "nvmlShutdown" not in fake.calls


def test_duty_cycle_averages_the_samples_since_the_last_read(fake):
    lib = NvmlLib(cdll=fake)
    fake.samples[0] = [(100, 90), (200, 70), (300, 81)]
    assert lib.duty_cycle("nvidia5") == 80  # int(241 / 3)
    assert lib.duty_cycle("nvidia5") == 80  # nothing new: the last value
    fake.samples[0].append((400, 10))
    assert lib.duty_cycle("nvidia5") == 10
    assert lib.duty_cycle("nvidia2") == 0  # no sample yet
    assert lib.duty_cycle_source("nvidia5") == "nvmlDeviceGetSamples"


def test_duty_cycle_falls_back_when_sampling_is_not_supported(fake):
    lib = NvmlLib(cdll=fake)
    fake.samples_rc = NOT_SUPPORTED
    assert lib.duty_cycle("nvidia5") == 37
    fake.util = 99
    assert lib.duty_cycle("nvidia5") == 99
    assert lib.duty_cycle_source("nvidia5") == "nvmlDeviceGetUtilizationRates"
    assert fake.calls.count("nvmlDeviceGetSamples") == 1  # decided once


def test_duty_cycle_other_sampling_errors_raise(fake):
    lib = NvmlLib(cdll=fake)
    fake.samples_rc = GPU_IS_LOST
    with pytest.raises(NvmlError):
        lib.duty_cycle("nvidia5")


def test_xid_registration_skips_not_supported(fake):
    fake.register_rc[0] = NOT_SUPPORTED
    lib = NvmlLib(cdll=fake)
    assert lib.register_xid_events() == ["nvidia2"]
    assert fake.registered == [1]


def test_xid_registration_other_errors_raise(fake):
    fake.register_rc[1] = GPU_IS_LOST
    lib = NvmlLib(cdll=fake)
    with pytest.raises(NvmlError):
        lib.register_xid_events()


def test_wait_before_registration_raises(fake):
    with pytest.raises(RuntimeError):
        NvmlLib(cdll=fake).wait_for_event(0.1)


def test_events_map_handle_to_minor_name(fake):
    lib = NvmlLib(cdll=fake)
    lib.register_xid_events()
    xid = nvml.EVENT_TYPE_XID_CRITICAL_ERROR
    fake.events = [(SUCCESS, 0x1001, xid, 79), (SUCCESS, 0x1000, xid, 48),
                   (SUCCESS, None, xid, 31), (SUCCESS, 0x2000, xid, 13),
                   (SUCCESS, 0x1000, 0x4, 0), (OPERATING_SYSTEM, None, 0, 0)]
    got = [lib.wait_for_event(5.0) for _ in range(5)]
    assert [(e.code, e.device) for e in got[:4]] == [
        (79, "nvidia2"), (48, "nvidia5"), (31, None), (13, None)]
    assert got[4] is None  # not an Xid
    with pytest.raises(NvmlError) as e:
        lib.wait_for_event(5.0)
    assert e.value.code == OPERATING_SYSTEM
    assert lib.wait_for_event(5.0) is None  # NVML_ERROR_TIMEOUT


H100 = b"NVIDIA H100 80GB HBM3"


def test_devices_maps_a_gpu_nvml_counts_after_start(fake):
    lib = NvmlLib(cdll=fake)
    lib.register_xid_events()
    fake.gpus.append({"minor": 7, "uuid": "GPU-0002", "name": H100,
                      "total": 80 << 30, "used": 0})
    assert [d.name for d in lib.devices()] == ["nvidia5", "nvidia2", "nvidia7"]
    assert lib.device_info("nvidia7").index == 2
    assert lib.memory_info("nvidia7").total_bytes == 80 << 30
    # Known GPUs are not mapped again.
    assert fake.calls.count("nvmlDeviceGetHandleByIndex_v2") == 3
    fake.events = [(SUCCESS, 0x1002, nvml.EVENT_TYPE_XID_CRITICAL_ERROR, 48)]
    assert lib.wait_for_event(5.0).device == "nvidia7"


def test_hot_added_gpu_gets_xid_registration(fake):
    """A GPU NVML counts after the checker started is subscribed as it is
    mapped, the checker's watch list grows, and an Xid 48 on it marks it
    Unhealthy."""
    import queue

    from container_engine_accelerators_tpu_torch.health import (
        GpuHealthChecker,
    )

    lib = NvmlLib(cdll=fake)

    class Manager:  # the manager's view: the GPUs NVML maps
        health_events = queue.Queue()

        @property
        def devices(self):
            return {d.name: None for d in lib.devices()}

    manager = Manager()
    checker = GpuHealthChecker(manager, lib, recovery_window_s=None,
                               event_wait_timeout_s=0.05)
    checker.start()
    try:
        assert checker.registered == ["nvidia5", "nvidia2"]
        fake.gpus.append({"minor": 7, "uuid": "GPU-0002", "name": H100,
                          "total": 80 << 30, "used": 0})
        assert "nvidia7" in manager.devices  # the hotplug poll maps it
        assert checker.registered == ["nvidia5", "nvidia2", "nvidia7"]
        assert fake.registered == [0, 1, 2]
        fake.events = [(SUCCESS, 0x1002,
                        nvml.EVENT_TYPE_XID_CRITICAL_ERROR, 48)]
        got = manager.health_events.get(timeout=10)
    finally:
        checker.stop()
    assert (got.id, got.health) == ("nvidia7", "Unhealthy")


def test_hot_added_gpu_without_xid_support_is_logged_and_skipped(fake):
    lib = NvmlLib(cdll=fake)
    registered = lib.register_xid_events()
    fake.register_rc[2] = NOT_SUPPORTED
    fake.gpus.append({"minor": 7, "uuid": "GPU-0002", "name": H100,
                      "total": 80 << 30, "used": 0})
    assert [d.name for d in lib.devices()][-1] == "nvidia7"
    assert registered == ["nvidia5", "nvidia2"]


def test_manager_hotplug_advertises_a_gpu_nvml_counts_later(fake, tmp_path):
    """The manager's hotplug poll over NvmlLib: a /dev node alone is not a
    new GPU; once NVML counts it too, serve rediscovers and advertises it."""
    from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
        GpuManager,
    )
    from container_engine_accelerators_tpu_torch.utils.config import GPUConfig

    dev = tmp_path / "dev"
    dev.mkdir()
    for node in ("nvidiactl", "nvidia-uvm", "nvidia5", "nvidia2"):
        (dev / node).touch()
    cfg = GPUConfig.from_json({})
    cfg.add_defaults_and_validate()
    manager = GpuManager(str(dev), [], cfg, lib=NvmlLib(cdll=fake),
                         device_check_interval_s=0.2,
                         socket_check_interval_s=0.05)
    manager.start()
    assert set(manager.list_devices()) == {"nvidia5", "nvidia2"}
    (dev / "nvidia7").touch()
    assert not manager.has_additional_gpus_installed()  # NVML: still 2
    plugins = tmp_path / "plugins"
    plugins.mkdir()
    server = threading.Thread(target=manager.serve, args=(str(plugins),),
                              kwargs={"plugin_endpoint": "gpu.sock"})
    server.start()
    try:
        fake.gpus.append({"minor": 7, "uuid": "GPU-0002", "name": H100,
                          "total": 80 << 30, "used": 0})
        deadline = time.monotonic() + 10
        while "nvidia7" not in manager.list_devices():
            assert time.monotonic() < deadline, "nvidia7 never advertised"
            time.sleep(0.05)
    finally:
        manager.stop()
        server.join(timeout=10)
    assert not server.is_alive()
    assert set(manager.list_devices()) == {"nvidia5", "nvidia2", "nvidia7"}


def test_close_frees_the_event_set_once(fake):
    lib = NvmlLib(cdll=fake)
    lib.register_xid_events()
    lib.close()
    lib.close()
    assert fake.calls.count("nvmlEventSetFree") == 1
    assert fake.calls.count("nvmlShutdown") == 1


def test_open_lib_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(nvml, "LIBRARY", "libnvidia-ml-absent.so.1")
    with pytest.raises(OSError):
        gpulib.open_lib()
    with pytest.raises(OSError):
        gpulib.open_lib(str(tmp_path / "no-fixture"))


# ---- on the card ---------------------------------------------------------------


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and its driver's NVML")
    lib = NvmlLib()
    yield torch, lib
    lib.close()


@pytest.mark.cuda
def test_nvml_matches_torch_on_the_card(card):
    torch, lib = card
    assert lib.device_count() == torch.cuda.device_count()
    for info in lib.devices():
        props = torch.cuda.get_device_properties(info.index)
        mem = lib.memory_info(info.name)
        assert info.model == props.name
        assert 0 <= mem.total_bytes - props.total_memory <= mem.total_bytes // 100
        assert 0 <= lib.duty_cycle(info.name) <= 100


@pytest.mark.cuda
def test_xid_registration_on_the_card(card):
    torch, lib = card
    assert lib.register_xid_events() == [d.name for d in lib.devices()]
