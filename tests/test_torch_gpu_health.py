"""The port's GpuHealthChecker against the JAX package's TpuHealthChecker:
one scripted sequence of events, fault-file lines and recovery sweeps on a
patched monotonic clock goes through both, each with a fake manager, and
they must give the same transitions (device, health, time), the same flap
doublings and the same counters.  Then the port's checker alone through
its event loop on the fake GPU node."""

import os
import queue
import threading
import time
import types

import pytest

from container_engine_accelerators_tpu.health import health_checker as tpu_hc
from container_engine_accelerators_tpu.metrics import counters as tpu_counters
from container_engine_accelerators_tpu.tpulib.types import TpuErrorEvent
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    FakeGpuLib,
    post_event,
    set_gpu,
    write_fixture,
)
from container_engine_accelerators_tpu_torch.gpulib.types import XidEvent
from container_engine_accelerators_tpu_torch.health import (
    health_checker as gpu_hc,
)
from container_engine_accelerators_tpu_torch.metrics import (
    counters as gpu_counters,
)
from container_engine_accelerators_tpu_torch.utils.device import (
    HEALTHY,
    UNHEALTHY,
)

COUNTERS = ("health.unhealthy", "health.recovered", "health.flap_backoff",
            "health.fault_file.events", "health.fault_file.malformed")


class FakeManager:
    def __init__(self, names):
        self.devices = {n: None for n in names}
        self.health_events = queue.Queue()


class Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


# (time, action, argument): events name TPU devices; the GPU side maps
# accelN -> nvidiaN.
SCRIPT = [
    (0, "event", (48, "accel1")),
    (1, "event", (13, "accel1")),
    (2, "event", (31, "accel2")),
    (5, "event", (48, "accel1")),
    (12, "recover", None),
    (15, "recover", None),
    (20, "event", (48, "accel1")),
    (35, "recover", None),
    (40, "recover", None),
    (45, "event", (48, None)),
    (46, "event", (48, "accel9")),
    (100, "recover", None),
    (300, "event", (48, "accel1")),
    (301, "line", "fault accel3"),
    (302, "line", "fault accel0 31"),
    (303, "line", "bogus accel0"),
    (304, "line", "fault accel0 x"),
    (305, "line", "clear accel3"),
    (306, "line", "clear accel2"),
    (320, "recover", None),
    (400, "event", (48, "accel1")),
    (405, "recover", None),
    (2000, "recover", None),
]


def to_gpu(name):
    return None if name is None else name.replace("accel", "nvidia")


def run_script(side, tmp_path, monkeypatch, **kw):
    clock = Clock()
    if side == "tpu":
        module, counters, names = tpu_hc, tpu_counters, "accel"
        event = TpuErrorEvent
        rename = lambda name: name  # noqa: E731
    else:
        module, counters, names = gpu_hc, gpu_counters, "nvidia"
        event = XidEvent
        rename = to_gpu
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        monotonic=clock.monotonic))
    counters.reset()
    manager = FakeManager([f"{names}{i}" for i in range(4)])
    fault_file = str(tmp_path / f"{side}.faults")
    open(fault_file, "w").close()
    cls = (tpu_hc.TpuHealthChecker if side == "tpu"
           else gpu_hc.GpuHealthChecker)
    checker = cls(manager, lib=None, fault_file=fault_file, **kw)
    transitions = []
    for t, action, arg in SCRIPT:
        clock.now = 1000.0 + t
        if action == "event":
            code, device = arg
            checker.catch_error(event(code=code, device=rename(device)))
        elif action == "recover":
            checker.maybe_recover()
        else:
            with open(fault_file, "a") as f:
                f.write(arg.replace("accel", names) + "\n")
            checker.poll_fault_file()
        while True:
            try:
                d = manager.health_events.get_nowait()
            except queue.Empty:
                break
            transitions.append((t, d.id.replace(names, "dev"), d.health))
    flaps = {k.replace(names, "dev"): v for k, v in checker._flaps.items()}
    return transitions, flaps, {c: counters.get(c) for c in COUNTERS}


@pytest.mark.parametrize("kw", [
    {"recovery_window_s": 10.0},
    {"recovery_window_s": 3.0},
    {"recovery_window_s": None},
    {"recovery_window_s": 10.0, "critical": [31, 13]},
], ids=["window10", "window3", "no_recovery", "critical_31_13"])
def test_same_transitions_flaps_and_counters_as_jax(tmp_path, monkeypatch, kw):
    kw = dict(kw)
    critical = kw.pop("critical", None)
    tpu = run_script("tpu", tmp_path, monkeypatch, critical_codes=critical,
                     **kw)
    gpu = run_script("gpu", tmp_path, monkeypatch, critical_xid=critical,
                     **kw)
    assert gpu == tpu
    transitions, flaps, counts = gpu
    assert transitions  # the script moved something
    if kw["recovery_window_s"]:
        assert counts["health.recovered"] > 0
    else:
        assert counts["health.recovered"] == 0
    assert counts["health.fault_file.malformed"] == 2


def test_window10_sequence_is_the_expected_one(tmp_path, monkeypatch):
    transitions, flaps, counts = run_script(
        "gpu", tmp_path, monkeypatch, recovery_window_s=10.0)
    assert transitions[:4] == [(0, "dev1", UNHEALTHY), (5, "dev1", UNHEALTHY),
                               (15, "dev1", HEALTHY), (20, "dev1", UNHEALTHY)]
    # A fault 5 s after a recovery is a flap: the next window is 20 s.
    assert (40, "dev1", HEALTHY) in transitions
    assert (35, "dev1", HEALTHY) not in transitions
    assert {d for t, d, h in transitions if t == 45} == {
        "dev0", "dev1", "dev2", "dev3"}
    assert counts["health.flap_backoff"] >= 2


def test_default_critical_set_is_48():
    assert gpu_hc.DEFAULT_CRITICAL_XID == frozenset({48})
    assert gpu_hc.DEFAULT_CRITICAL_XID == tpu_hc.DEFAULT_CRITICAL_CODES


# ---- the event loop on the fake GPU node -----------------------------------


@pytest.fixture
def node(tmp_path):
    root = str(tmp_path / "node")
    write_fixture(root, 4, minors=[3, 0, 1, 2])
    return root


def drain(q, n, timeout=10.0):
    out, deadline = [], time.monotonic() + timeout
    while len(out) < n and time.monotonic() < deadline:
        try:
            out.append(q.get(timeout=0.05))
        except queue.Empty:
            pass
    return out


def test_event_loop_marks_the_minor_named_device(node):
    lib = FakeGpuLib(node)
    manager = FakeManager([d.name for d in lib.devices()])
    checker = gpu_hc.GpuHealthChecker(manager, lib, recovery_window_s=None,
                                      event_wait_timeout_s=0.1)
    checker.start()
    try:
        assert sorted(checker.registered) == [f"nvidia{i}" for i in range(4)]
        post_event(node, 13, "nvidia3", "not critical")
        post_event(node, 48, "nvidia3", "double-bit ECC")
        got = drain(manager.health_events, 1)
    finally:
        checker.stop()
    assert not checker._thread.is_alive()
    assert [(d.id, d.health) for d in got] == [("nvidia3", UNHEALTHY)]


def test_device_without_xid_support_stays_healthy(node):
    set_gpu(node, "nvidia1", xid_supported=False)
    lib = FakeGpuLib(node)
    manager = FakeManager([d.name for d in lib.devices()])
    checker = gpu_hc.GpuHealthChecker(manager, lib, recovery_window_s=None,
                                      event_wait_timeout_s=0.1)
    checker.start()
    try:
        assert "nvidia1" not in checker.registered
        post_event(node, 48, "nvidia1")
        post_event(node, 48, "nvidia2")
        got = drain(manager.health_events, 2, timeout=2.0)
    finally:
        checker.stop()
    assert [(d.id, d.health) for d in got] == [("nvidia2", UNHEALTHY)]


class FailingLib:
    def __init__(self):
        self.calls = 0

    def register_xid_events(self):
        return ["nvidia0"]

    def wait_for_event(self, timeout_s):
        self.calls += 1
        raise OSError(17, "GPU access blocked by the operating system")


def test_stream_errors_back_off_and_the_fault_file_still_works(tmp_path):
    gpu_counters.reset()
    fault_file = tmp_path / "faults"
    manager = FakeManager(["nvidia0"])
    lib = FailingLib()
    checker = gpu_hc.GpuHealthChecker(manager, lib, recovery_window_s=0.2,
                                      event_wait_timeout_s=0.05,
                                      fault_file=str(fault_file))
    checker.start()
    try:
        fault_file.write_text("fault nvidia0 31\nfault nvidia0\n")
        got = drain(manager.health_events, 2, timeout=10)
    finally:
        checker.stop()
    # 31 is not critical by default; 48 is, and recovers after 0.2 s.
    assert [(d.id, d.health) for d in got] == [("nvidia0", UNHEALTHY),
                                               ("nvidia0", HEALTHY)]
    assert gpu_counters.get("health.stream.errors") >= 1
    assert lib.calls < 400  # backed off, did not spin


def test_fault_file_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("GPU_FAULT_FILE", str(tmp_path / "f"))
    checker = gpu_hc.GpuHealthChecker(FakeManager(["nvidia0"]), lib=None)
    assert checker.fault_file == str(tmp_path / "f")
    assert checker.poll_fault_file() == 0  # no file yet is no injector


def test_stop_joins_the_thread(node):
    lib = FakeGpuLib(node)
    checker = gpu_hc.GpuHealthChecker(FakeManager([]), lib,
                                      event_wait_timeout_s=0.1)
    before = threading.active_count()
    checker.start()
    checker.stop()
    assert not checker._thread.is_alive()
    assert threading.active_count() <= before
    assert not os.listdir(os.path.join(node, "var/run/nvidia/events"))
