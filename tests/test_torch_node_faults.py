"""The port's node fault sites against the JAX package's: the node cases of
tests/test_chaos.py (a kubelet registration that fails once, an event
stream that drops, a k8s.patch conflict and a hard failure, the counters
on /metrics), tests/test_metrics.py's rebind, and one fault spec run
through both ``faults`` modules.  Each case runs the same script on both
packages and compares what they did."""

import os
import threading
import time
import urllib.request

import pytest
from prometheus_client import CollectorRegistry

from container_engine_accelerators_tpu.deviceplugin.manager import TpuManager
from container_engine_accelerators_tpu.health import TpuHealthChecker
from container_engine_accelerators_tpu.health import maintenance as tpu_mw
from container_engine_accelerators_tpu.metrics import MetricServer as TpuServer
from container_engine_accelerators_tpu.metrics import counters as tpu_counters
from container_engine_accelerators_tpu.scheduler.k8s import (
    ApiException as TpuApiException,
)
from container_engine_accelerators_tpu.tpulib import SysfsTpuLib
from container_engine_accelerators_tpu.tpulib import (
    write_fixture as write_tpu_fixture,
)
from container_engine_accelerators_tpu.tpulib.sysfs import (
    post_event as tpu_post,
)
from container_engine_accelerators_tpu.utils import faults as tpu_faults
from container_engine_accelerators_tpu.utils.config import TPUConfig
from container_engine_accelerators_tpu.utils.retry import (
    RetryPolicy as TpuRetryPolicy,
)
from container_engine_accelerators_tpu_torch.deviceplugin import api
from container_engine_accelerators_tpu_torch.deviceplugin.manager import (
    GpuManager,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    FakeGpuLib,
    post_event,
    write_fixture,
)
from container_engine_accelerators_tpu_torch.health import GpuHealthChecker
from container_engine_accelerators_tpu_torch.health import maintenance as mw
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.metrics.metrics import (
    MetricServer,
)
from container_engine_accelerators_tpu_torch.scheduler.k8s import ApiException
from container_engine_accelerators_tpu_torch.utils import faults
from container_engine_accelerators_tpu_torch.utils.config import GPUConfig
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy
from tests.kubelet_stub import KubeletStub as TpuKubeletStub
from tests.test_torch_maintenance import FakeApi, fetcher, jax_taints
from tests.torch_node_helpers import KubeletStub

TERMINATE = "TERMINATE_ON_HOST_MAINTENANCE"


class Side:
    """One package's node pieces, under one interface."""

    def __init__(self, name):
        self.name = name
        gpu = name == "gpu"
        self.faults = faults if gpu else tpu_faults
        self.counters = counters if gpu else tpu_counters
        self.device = "nvidia0" if gpu else "accel0"

    def manager(self, root):
        if self.name == "gpu":
            write_fixture(root, 4)
            cfg = GPUConfig.from_json({})
            cfg.add_defaults_and_validate()
            return GpuManager(os.path.join(root, "dev"), [], cfg,
                              lib=FakeGpuLib(root))
        write_tpu_fixture(root, 4)
        cfg = TPUConfig.from_json({})
        cfg.add_defaults_and_validate()
        return TpuManager(os.path.join(root, "dev"), [], cfg,
                          lib=SysfsTpuLib(root))

    def kubelet(self, socket_path):
        stub = (KubeletStub if self.name == "gpu" else TpuKubeletStub)(
            socket_path)
        stub.start()
        return stub

    def checker(self, manager, **kw):
        cls = GpuHealthChecker if self.name == "gpu" else TpuHealthChecker
        return cls(manager, manager.lib, **kw)

    def post(self, root, code, device):
        (post_event if self.name == "gpu" else tpu_post)(root, code, device,
                                                         "HBM ECC")


SIDES = ("tpu", "gpu")


# ---- kubelet.register: fail once, register on the retry --------------------


def register_once_failed(tmp_path, side):
    side = Side(side)
    plugdir = str(tmp_path / "p")
    os.makedirs(plugdir)
    stub = side.kubelet(os.path.join(plugdir, api.KUBELET_SOCKET))
    manager = side.manager(str(tmp_path / "root"))
    manager.start()
    failed0 = side.counters.get("kubelet.register.failed")
    retried0 = side.counters.get("kubelet.register.retried")
    fired0 = side.counters.get("fault.fired.kubelet.register")
    with side.faults.armed("kubelet.register:fail@1") as inj:
        t = threading.Thread(target=manager.serve, args=(plugdir,),
                             daemon=True)
        t.start()
        try:
            reg = stub.requests.get(timeout=10)
            fired = inj.fired("kubelet.register")
        finally:
            manager.stop()
            t.join(timeout=10)
            stub.stop()
    assert not t.is_alive()
    return {"resource": reg.resource_name.split("/")[1], "fired": fired,
            "failed": side.counters.get("kubelet.register.failed") - failed0,
            "retried": (side.counters.get("kubelet.register.retried")
                        - retried0),
            "counted_fired": (side.counters.get("fault.fired.kubelet.register")
                              - fired0)}


def test_injected_register_failure_is_retried_as_in_jax(tmp_path):
    got = {s: register_once_failed(tmp_path / s, s) for s in SIDES}
    assert got["gpu"]["resource"] == "gpu" and got["tpu"]["resource"] == "tpu"
    for g in got.values():
        g.pop("resource")
    assert got["gpu"] == got["tpu"] == {"fired": 1, "failed": 1, "retried": 1,
                                        "counted_fired": 1}


# ---- health.stream: a dropped event wait does not stop the checker -----------


def stream_drop(tmp_path, side):
    side = Side(side)
    root = str(tmp_path / "root")
    manager = side.manager(root)
    manager.start()
    errors0 = side.counters.get("health.stream.errors")
    checker = side.checker(manager, recovery_window_s=None,
                           event_wait_timeout_s=0.1)
    with side.faults.armed("health.stream:drop@1") as inj:
        checker.start()
        try:
            deadline = time.monotonic() + 10
            while inj.fired("health.stream") == 0:
                assert time.monotonic() < deadline
                time.sleep(0.01)
            side.post(root, 48, side.device)
            event = manager.health_events.get(timeout=10)
        finally:
            checker.stop()
    return {"fired": inj.fired("health.stream"),
            "event": (event.id.replace("accel", "nvidia"), event.health),
            "errors": side.counters.get("health.stream.errors") - errors0}


def test_event_stream_fault_does_not_kill_monitoring_as_in_jax(tmp_path):
    got = {s: stream_drop(tmp_path / s, s) for s in SIDES}
    assert got["gpu"] == got["tpu"] == {
        "fired": 1, "event": ("nvidia0", "Unhealthy"), "errors": 1}


# ---- k8s.patch: a 409 rides the retry; a hard failure propagates -----------


def test_k8s_patch_conflict_rides_409_retry_as_in_jax(tmp_path):
    fired0 = counters.get("fault.fired.k8s.patch")
    gpu_api, tpu_api_ = FakeApi(ApiException), FakeApi(TpuApiException)
    with faults.armed("k8s.patch:conflict@1") as inj:
        got = mw.reconcile(gpu_api, "n0", fetcher(TERMINATE),
                           str(tmp_path / "faults"))
    with tpu_faults.armed("k8s.patch:conflict@1") as tpu_inj:
        tpu_got = tpu_mw.reconcile(tpu_api_, "n0", fetcher(TERMINATE),
                                   events_dir=str(tmp_path / "events"))
    assert got == tpu_got == TERMINATE
    assert inj.fired("k8s.patch") == tpu_inj.fired("k8s.patch") == 1
    (taints,) = gpu_api.patches  # the retry landed one patch
    assert jax_taints(gpu_api.patches) == tpu_api_.patches
    assert taints[0]["value"] == TERMINATE
    assert counters.get("fault.fired.k8s.patch") == fired0 + 1
    assert open(tmp_path / "faults").read().count("\n") == len(
        os.listdir(tmp_path / "events")) == 1


def test_k8s_patch_hard_failure_still_propagates_as_in_jax(tmp_path):
    gpu_api, tpu_api_ = FakeApi(ApiException), FakeApi(TpuApiException)
    with faults.armed("k8s.patch:fail@1"):
        with pytest.raises(faults.FaultInjectedError):
            mw.reconcile(gpu_api, "n0", fetcher(TERMINATE),
                         str(tmp_path / "faults"))
    with tpu_faults.armed("k8s.patch:fail@1"):
        with pytest.raises(tpu_faults.FaultInjectedError):
            tpu_mw.reconcile(tpu_api_, "n0", fetcher(TERMINATE),
                             events_dir=str(tmp_path / "events"))
    assert gpu_api.patches == tpu_api_.patches == []  # nothing half-applied
    assert not (tmp_path / "faults").exists()


# ---- the counters on /metrics ------------------------------------------------


class NoGpus:
    def devices(self):
        return []

    def collect_gpu_device(self, name):  # pragma: no cover
        raise AssertionError(name)

    def model(self, name):  # pragma: no cover
        return "gpu"


class NoChips(NoGpus):
    def collect_tpu_device(self, name):  # pragma: no cover
        raise AssertionError(name)


def test_agent_event_counters_exported_via_metrics(tmp_path):
    counters.inc("kubelet.reregister", 3)
    with faults.armed("health.stream:fail@1"):
        with pytest.raises(faults.FaultInjectedError):
            faults.check("health.stream")
    server = MetricServer(collector=NoGpus(), registry=CollectorRegistry(),
                          pod_resources_socket=str(tmp_path / "nope.sock"))
    server.collect_once()
    for event, least in (("kubelet.reregister", 3),
                         ("fault.fired.health.stream", 1)):
        value = server.registry.get_sample_value("agent_events",
                                                 {"event": event})
        assert value is not None and value >= least, event


# ---- MetricServer.rebind -------------------------------------------------------

FAST_BIND = RetryPolicy(max_attempts=8, initial_backoff_s=0.05,
                        max_backoff_s=0.2, deadline_s=10.0)


def scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


def rebind_script(tmp_path, side):
    gpu = side == "gpu"
    cnt = counters if gpu else tpu_counters
    cnt.inc("rebind.marker", 3 - cnt.get("rebind.marker"))
    server = (MetricServer if gpu else TpuServer)(
        collector=NoGpus() if gpu else NoChips(), registry=CollectorRegistry(),
        pod_resources_socket=str(tmp_path / f"{side}.sock"), port=0,
        collection_interval_s=3600)
    retry = FAST_BIND if gpu else TpuRetryPolicy(
        max_attempts=8, initial_backoff_s=0.05, max_backoff_s=0.2,
        deadline_s=10.0)
    marker = 'agent_events{event="rebind.marker"} 3.0'
    server.start(retry=retry)
    try:
        server.collect_once()
        old_port = server.port
        before = marker in scrape(old_port)
        rebinds = cnt.get("metrics.rebind")
        new_port = server.rebind(0, retry=retry)
        after = marker in scrape(new_port)
        with pytest.raises(OSError):
            scrape(old_port)
        return {"moved": new_port != old_port, "before": before,
                "after": after, "port": new_port == server.port,
                "rebinds": cnt.get("metrics.rebind") - rebinds}
    finally:
        server.stop()


def test_rebind_moves_listener_without_losing_state_as_in_jax(tmp_path):
    got = {s: rebind_script(tmp_path, s) for s in SIDES}
    assert got["gpu"] == got["tpu"] == {"moved": True, "before": True,
                                        "after": True, "port": True,
                                        "rebinds": 1}


def test_rebind_joins_the_old_listener(tmp_path):
    server = MetricServer(collector=NoGpus(), registry=CollectorRegistry(),
                          pod_resources_socket=str(tmp_path / "x.sock"),
                          port=0, collection_interval_s=3600)
    server.start(retry=FAST_BIND)
    try:
        first = server._http_thread
        server.rebind(0, retry=FAST_BIND)
        assert not first.is_alive()
        assert first not in server._threads
    finally:
        server.stop()
    assert server._threads == []


# ---- one spec, both fault injectors --------------------------------------------

SPECS = [
    "kubelet.register:fail@1",
    "health.stream:drop@2x3;k8s.patch:conflict@1",
    "k8s.patch:conflict@1x*",
    "kubelet.register:fail@3x2,health.stream:fail@1",
    "bogus;health.stream:nope@1;k8s.patch:fail@0;kubelet.register:drop@2",
]
SITES = ("kubelet.register", "health.stream", "k8s.patch", "checkpoint.save")


@pytest.mark.parametrize("spec", SPECS)
def test_same_spec_same_hits_and_fired_as_jax(spec):
    def run(mod, cnt):
        before = {s: cnt.get(f"fault.fired.{s}") for s in SITES}
        inj = mod.FaultInjector.from_spec(spec)
        prev = mod.set_injector(inj)
        outcomes = []
        try:
            for i in range(6):
                for site in SITES:
                    try:
                        mod.check(site)
                        outcomes.append(None)
                    except mod.FaultInjectedError as e:
                        outcomes.append((type(e).__name__,
                                         getattr(e, "status", None)))
        finally:
            mod.set_injector(prev)
        return (outcomes, {s: inj.fired(s) for s in SITES},
                {s: cnt.get(f"fault.fired.{s}") - before[s] for s in SITES})

    gpu, tpu = run(faults, counters), run(tpu_faults, tpu_counters)
    assert gpu == tpu
    assert gpu[1] == gpu[2]  # every fired fault counted
