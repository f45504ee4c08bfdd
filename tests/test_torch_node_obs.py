"""The port's node layer, instrumented, against the JAX package's.

The scripted fault sequences that ``tests/test_torch_gpu_health.py`` and
``tests/test_torch_node_faults.py`` already drive through both packages
run again with each package's span sink set (``trace.configure``), and
the spans must agree: the same multiset of (name, status, attribute
keys), the same histogram ops, ``fault=<site>`` on the span a fault
killed.  Then the port's MetricServer on a fake GPU node answers
``/spans`` and ``/profile`` with the JAX server's JSON, pages by cursor
as it does, and degrades a bad query to defaults, never to a 500.
"""

import collections
import json
import os
import urllib.request

import grpc
import pytest
from prometheus_client import CollectorRegistry

from container_engine_accelerators_tpu.health import maintenance as tpu_mw
from container_engine_accelerators_tpu.metrics import counters as jax_counters
from container_engine_accelerators_tpu.metrics.metrics import (
    MetricServer as TpuMetricServer,
)
from container_engine_accelerators_tpu.obs import histo as jax_histo
from container_engine_accelerators_tpu.obs import profiler as jax_profiler
from container_engine_accelerators_tpu.obs import timeseries as jax_timeseries
from container_engine_accelerators_tpu.obs import trace as jax_trace
from container_engine_accelerators_tpu.scheduler.k8s import (
    ApiException as TpuApiException,
)
from container_engine_accelerators_tpu.utils import faults as tpu_faults
from container_engine_accelerators_tpu.utils.device import (
    Device as TpuDevice,
)
from container_engine_accelerators_tpu.utils.retry import (
    RetryPolicy as TpuRetryPolicy,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    FakeGpuLib,
    write_fixture,
)
from container_engine_accelerators_tpu_torch.health import maintenance as mw
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.metrics import metrics
from container_engine_accelerators_tpu_torch.obs import (
    histo,
    profiler,
    timeseries,
    trace,
)
from container_engine_accelerators_tpu_torch.scheduler.k8s import ApiException
from container_engine_accelerators_tpu_torch.utils import faults
from container_engine_accelerators_tpu_torch.utils.device import (
    HEALTHY,
    UNHEALTHY,
    Device,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy
from tests import test_torch_gpu_health as health_cases
from tests import test_torch_node_faults as fault_cases
from tests.test_torch_gpu_device_plugin import PluginHarness, device_map
from tests.test_torch_maintenance import FakeApi, fetcher

SIDES = ("tpu", "gpu")
OBS = {"tpu": (jax_trace, jax_histo, jax_timeseries, jax_counters,
               jax_profiler),
       "gpu": (trace, histo, timeseries, counters, profiler)}
FAST_BIND = RetryPolicy(max_attempts=8, initial_backoff_s=0.05,
                        max_backoff_s=0.2, deadline_s=10.0)


def reset_both():
    for mods in OBS.values():
        for mod in mods:
            mod.reset()


@pytest.fixture(autouse=True)
def clean_obs():
    reset_both()
    yield
    reset_both()


class Sink:
    """One package's JSONL sink over a block: ``spans`` holds what it
    wrote."""

    def __init__(self, side, path):
        self.trace = OBS[side][0]
        self.path = str(path)
        self.spans = []

    def __enter__(self):
        self.trace.configure(self.path)
        return self

    def __exit__(self, *exc):
        self.trace.configure(None)
        if os.path.exists(self.path):
            self.spans = [json.loads(line) for line in open(self.path)]
        return False


def shape(spans, names=None):
    """The comparable part of a span set: a multiset of (name, status,
    attribute keys)."""
    return collections.Counter(
        (s["name"], s["status"], tuple(sorted(s["attrs"])))
        for s in spans if names is None or s["name"] in names)


def ops(side):
    return set(OBS[side][1].snapshot())


# ---- the health checker's scripted fault sequence -----------------------------


@pytest.mark.parametrize("kw", [
    {"recovery_window_s": 10.0},
    {"recovery_window_s": 3.0},
    {"recovery_window_s": None},
    {"recovery_window_s": 10.0, "critical": [31, 13]},
], ids=["window10", "window3", "no_recovery", "critical_31_13"])
def test_health_script_gives_the_same_spans_and_ops_as_jax(
        tmp_path, monkeypatch, kw):
    kw = dict(kw)
    critical = kw.pop("critical", None)
    got = {}
    for side in SIDES:
        key = "critical_codes" if side == "tpu" else "critical_xid"
        with Sink(side, tmp_path / f"{side}.jsonl") as sink:
            result = health_cases.run_script(side, tmp_path, monkeypatch,
                                             **{key: critical}, **kw)
        recovery = OBS[side][1].snapshot().get("health.recovery")
        got[side] = (result, shape(sink.spans), ops(side), recovery)
    assert got["gpu"][0] == got["tpu"][0]  # the transitions themselves
    assert got["gpu"][1] == got["tpu"][1]
    assert got["gpu"][2] == got["tpu"][2]
    # The outage histogram reads the patched clock: equal buckets.
    assert got["gpu"][3] == got["tpu"][3]
    spans = got["gpu"][1]
    assert spans[("health.event", "ok", ("code", "device"))] > 0
    assert spans[("health.fault_file", "ok", ("code", "device", "kind"))] == 2
    assert spans[("health.fault_file", "ok", ("device", "kind"))] == 2
    if kw["recovery_window_s"]:
        assert spans[("health.recover", "ok",
                      ("device", "outage_s", "window_s"))] > 0
        assert got["gpu"][2] == {"health.event", "health.recovery"}
        assert got["gpu"][3]["count"] == \
            got["gpu"][0][2]["health.recovered"]
    else:
        assert got["gpu"][2] == {"health.event"}


def test_recovery_histogram_measures_the_whole_outage(tmp_path,
                                                      monkeypatch):
    """First fault to announcement, not the last quiet window: the first
    episode of the window-10 script runs 0 s -> 15 s."""
    health_cases.run_script("gpu", tmp_path, monkeypatch,
                            recovery_window_s=10.0)
    recovered = [s for s in trace.tail() if s["name"] == "health.recover"]
    assert recovered[0]["attrs"] == {"device": "nvidia1", "outage_s": 15.0,
                                     "window_s": 10.0}
    assert histo.snapshot()["health.recovery"]["buckets"]["16777216"] >= 1


# ---- kubelet.register: fail once, then register ---------------------------


def test_register_retry_gives_the_same_spans_as_jax(tmp_path):
    got = {}
    for side in SIDES:
        with Sink(side, tmp_path / f"{side}.jsonl") as sink:
            result = fault_cases.register_once_failed(tmp_path / side, side)
        got[side] = (result, shape(sink.spans, {"kubelet.register"}),
                     ops(side), sink.spans)
    assert got["gpu"][1] == got["tpu"][1]
    assert got["gpu"][2] == got["tpu"][2] == {"kubelet.register"}
    attempts = [s for s in got["gpu"][3] if s["name"] == "kubelet.register"]
    assert [(s["status"], s["attrs"]["attempt"]) for s in attempts] == \
        [("error", 0), ("ok", 1)]
    assert attempts[0]["attrs"]["fault"] == "kubelet.register"
    assert attempts[0]["attrs"]["fault_mode"] == "fail"
    assert "fault" not in attempts[1]["attrs"]


# ---- health.stream: a dropped event wait -------------------------------------


def test_stream_drop_gives_the_same_spans_as_jax(tmp_path):
    got = {}
    for side in SIDES:
        with Sink(side, tmp_path / f"{side}.jsonl") as sink:
            result = fault_cases.stream_drop(tmp_path / side, side)
        got[side] = (result, shape(sink.spans), ops(side))
    assert got["gpu"] == got["tpu"]
    assert got["gpu"][1][("health.event", "ok", ("code", "device"))] == 1


# ---- k8s.patch: the 409 retry and a hard failure ------------------------------


def reconcile(side, tmp_path, spec):
    terminate = fault_cases.TERMINATE
    with Sink(side, tmp_path / f"{side}.jsonl") as sink:
        if side == "gpu":
            api = FakeApi(ApiException)
            with faults.armed(spec):
                try:
                    mw.reconcile(api, "n0", fetcher(terminate),
                                 str(tmp_path / "faults"))
                except faults.FaultInjectedError:
                    pass
        else:
            api = FakeApi(TpuApiException)
            with tpu_faults.armed(spec):
                try:
                    tpu_mw.reconcile(api, "n0", fetcher(terminate),
                                     events_dir=str(tmp_path / "events"))
                except tpu_faults.FaultInjectedError:
                    pass
    return sink.spans


@pytest.mark.parametrize("spec,statuses", [
    ("k8s.patch:conflict@1", [("error", 0, "conflict"), ("ok", 1, None)]),
    ("k8s.patch:fail@1", [("error", 0, "fail")]),
    ("", [("ok", 0, None)]),
], ids=["conflict", "fail", "clean"])
def test_k8s_patch_spans_as_in_jax(tmp_path, spec, statuses):
    got = {side: reconcile(side, tmp_path, spec) for side in SIDES}
    assert shape(got["gpu"]) == shape(got["tpu"])
    assert ops("gpu") == ops("tpu") == {"k8s.patch"}
    seen = [(s["status"], s["attrs"]["attempt"], s["attrs"].get("fault_mode"))
            for s in got["gpu"]]
    assert seen == statuses
    for s in got["gpu"]:
        assert s["attrs"].get("fault") == (
            "k8s.patch" if s["status"] == "error" else None)


# ---- one fault spec through both injectors, inside spans ------------------------


@pytest.mark.parametrize("spec", fault_cases.SPECS)
def test_fault_stamps_equal_jax(spec):
    def run(side):
        tr = OBS[side][0]
        mod = faults if side == "gpu" else tpu_faults
        prev = mod.set_injector(mod.FaultInjector.from_spec(spec))
        try:
            for _ in range(4):
                for site in fault_cases.SITES:
                    try:
                        with tr.span(site):
                            mod.check(site)
                    except OSError:
                        pass
        finally:
            mod.set_injector(prev)
        return [(s["name"], s["status"], s["attrs"].get("fault"),
                 s["attrs"].get("fault_mode")) for s in tr.tail()]

    gpu, tpu = run("gpu"), run("tpu")
    assert gpu == tpu
    for name, status, fault, _mode in gpu:
        assert (fault == name) == (status == "error")


# ---- retry.attempt spans and the terminal flight dump -------------------------


def test_retry_spans_and_terminal_dump_as_in_jax(tmp_path, monkeypatch,
                                                 capsys):
    got = {}
    for side in SIDES:
        path = str(tmp_path / f"{side}.flight")
        monkeypatch.setenv("TPU_FLIGHT_FILE", path)
        policy = (RetryPolicy if side == "gpu" else TpuRetryPolicy)(
            max_attempts=3, initial_backoff_s=0.0, jitter=0.0)
        calls = []

        def flaky():
            calls.append(1)
            raise OSError("down")

        with pytest.raises(OSError):
            policy.call(flaky, sleep=lambda s: None)
        (blob,) = [json.loads(line) for line in open(path)]
        spans = OBS[side][0].tail()
        got[side] = ([(s["name"], s["status"], s["attrs"]["fn"],
                       s["attrs"]["attempt"]) for s in spans],
                     blob["reason"], sorted(blob),
                     OBS[side][3].get("retry.exhausted"))
    assert got["gpu"] == got["tpu"]
    assert got["gpu"][0] == [("retry.attempt", "error", "flaky", i)
                             for i in range(3)]
    assert got["gpu"][1] == "terminal: retry budget exhausted: flaky"
    assert got["gpu"][3] == 1


# ---- the device plugin: Allocate and the health re-announcement ----------------


def plugin_script(h):
    name = "nvidia1" if h.side == "gpu" else "accel1"
    device = Device if h.side == "gpu" else TpuDevice
    stream = h.watch()
    device_map(stream)
    h.manager.health_events.put(device(id=name, health=UNHEALTHY))
    device_map(stream)
    with pytest.raises(grpc.RpcError):
        h.allocate([name])
    h.manager.health_events.put(device(id=name, health=HEALTHY))
    device_map(stream)
    for _ in range(3):
        h.allocate([name])


def test_plugin_spans_and_ops_as_in_jax(tmp_path):
    got = {}
    for side in SIDES:
        with Sink(side, tmp_path / f"{side}.jsonl") as sink:
            with PluginHarness(tmp_path / side, side=side) as h:
                plugin_script(h)
        names = {"plugin.allocate", "plugin.health_announce",
                 "kubelet.register"}
        got[side] = (shape(sink.spans, names), ops(side))
    assert got["gpu"] == got["tpu"]
    spans, histograms = got["gpu"]
    assert spans[("plugin.allocate", "ok", ("devices",))] == 3
    assert spans[("plugin.allocate", "error", ("devices", "error"))] == 1
    assert spans[("plugin.health_announce", "ok", ("device", "health"))] == 2
    assert {"plugin.allocate", "plugin.health_announce",
            "kubelet.register"} <= histograms
    assert histo.snapshot()["plugin.allocate"]["count"] == 4


# ---- /spans and /profile on the port's MetricServer ---------------------------


class _NoChips:
    def collect_tpu_device(self, name):  # pragma: no cover
        raise RuntimeError(name)

    def devices(self):
        return []

    def model(self, name):  # pragma: no cover
        return "none"


@pytest.fixture
def servers(tmp_path):
    """The port's server on a fake GPU node and the JAX one beside it."""
    root = str(tmp_path / "gpu")
    write_fixture(root, 4)
    gpu = metrics.MetricServer(
        lib=FakeGpuLib(root), port=0, collection_interval_s=3600,
        pod_resources_socket=str(tmp_path / "none.sock"))
    tpu = TpuMetricServer(
        collector=_NoChips(), registry=CollectorRegistry(), port=0,
        collection_interval_s=3600,
        pod_resources_socket=str(tmp_path / "none2.sock"))
    gpu.start(retry=FAST_BIND)
    tpu.start(retry=TpuRetryPolicy(max_attempts=8, initial_backoff_s=0.05,
                                   max_backoff_s=0.2, deadline_s=10.0))
    yield {"gpu": gpu, "tpu": tpu}
    gpu.stop()
    tpu.stop()


def get(server, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}{path}",
                                timeout=10) as resp:
        assert resp.status == 200
        return resp.headers.get("Content-Type"), resp.read()


def test_one_listener_serves_metrics_spans_and_profile(servers):
    server = servers["gpu"]
    server.collect_once()
    ctype, body = get(server, "/metrics")
    assert b"duty_cycle_gpu_node" in body
    for path in ("/spans", "/profile"):
        ctype, body = get(server, path)
        assert ctype == "application/json"
        json.loads(body)
    # Every other path is the exposition, as on the JAX server.
    ctype, body = get(server, "/spans/")
    assert b"duty_cycle_gpu_node" in body
    assert metrics.SPANS_DEFAULT_LIMIT == 512
    assert metrics.SPANS_MAX_LIMIT == 2048
    assert metrics.PROFILE_DEFAULT_LIMIT == profiler.SCRAPE_DEFAULT_LIMIT
    assert metrics.PROFILE_MAX_LIMIT == profiler.SCRAPE_MAX_LIMIT


def _strip_spans(payload):
    return dict(payload, spans=[
        {k: v for k, v in s.items()
         if k not in ("trace", "span", "parent", "ts", "dur_us")}
        for s in payload["spans"]])


SPAN_QUERIES = ["?since=0&limit=7", "?since=7&limit=7", "?since=14",
                "?since=0", "?since=bogus&limit=wat", "?limit=-5",
                "?limit=99999", "?since=-4&limit=3", "?since=10000",
                "?since=&limit=", "?since=1e3", ""]


def test_spans_pages_as_the_jax_server_does(servers):
    for side in SIDES:
        tr = OBS[side][0]
        for i in range(20):
            with tr.span(f"op{i % 4}", i=i):
                if i % 5 == 0:
                    tr.annotate(fault="site")
    for query in SPAN_QUERIES:
        pages = {side: json.loads(get(servers[side], "/spans" + query)[1])
                 for side in SIDES}
        assert list(pages["gpu"]) == list(pages["tpu"]) == \
            ["cursor", "dropped", "spans"]
        assert _strip_spans(pages["gpu"]) == _strip_spans(pages["tpu"]), \
            query
    # Paging by the returned cursor reads every span once.
    cursor, names = 0, []
    while True:
        page = json.loads(get(servers["gpu"],
                              f"/spans?since={cursor}&limit=6")[1])
        if not page["spans"]:
            break
        assert page["dropped"] == 0
        names += [s["attrs"].get("i", s["name"]) for s in page["spans"]]
        cursor = page["cursor"]
    # The server's own bind attempt comes first: it is a span too.
    assert names == ["retry.attempt"] + list(range(20))


def test_spans_count_what_the_ring_dropped(servers):
    trace.configure(ring_capacity=8)
    jax_trace.configure(ring_capacity=8)
    try:
        for side in SIDES:
            for i in range(30):
                OBS[side][0].event(f"e{i}")
        pages = {side: json.loads(get(servers[side], "/spans?since=2")[1])
                 for side in SIDES}
        assert _strip_spans(pages["gpu"]) == _strip_spans(pages["tpu"])
        # 31 spans (the bind's retry.attempt first), 8 kept, 2 read.
        assert pages["gpu"]["dropped"] == 21
    finally:
        trace.configure(ring_capacity=trace.DEFAULT_RING_CAPACITY)
        jax_trace.configure(ring_capacity=jax_trace.DEFAULT_RING_CAPACITY)


PROFILE_QUERIES = ["", "?since=0&limit=2", "?since=5&limit=1",
                   "?since=garbage&limit=wat", "?limit=0", "?limit=100000",
                   "?since=99999"]


def test_profile_pages_as_the_jax_server_does(servers):
    for side in SIDES:
        prof = OBS[side][4]
        prof.ingest("deviceplugin.service.Allocate;obs.trace.span",
                    "other", 3)
        prof.ingest("threading.run;threading.wait", "idle", 9)
        prof.ingest("serving.frontend._dispatch", "serving", 2)
        prof.ingest("health.health_checker._listen_to_events", "other", 1)
    for query in PROFILE_QUERIES:
        pages = {side: json.loads(get(servers[side], "/profile" + query)[1])
                 for side in SIDES}
        assert list(pages["gpu"]) == list(pages["tpu"])
        for page in pages.values():
            page.pop("overhead_ratio")
        assert pages["gpu"] == pages["tpu"], query
    cursor, seen = 0, []
    while True:
        page = json.loads(get(servers["gpu"],
                              f"/profile?since={cursor}&limit=1")[1])
        if not page["stacks"]:
            break
        seen += [e["stack"] for e in page["stacks"]]
        cursor = page["cursor"]
    assert len(seen) == 4 and page["samples"] == 15


def test_profile_of_a_running_sampler(servers):
    profiler.start(hz=200)
    try:
        deadline = 50
        while profiler.snapshot()["samples"] == 0 and deadline:
            import time

            time.sleep(0.02)
            deadline -= 1
        page = json.loads(get(servers["gpu"], "/profile")[1])
    finally:
        profiler.stop()
    assert page["running"] is True
    assert page["samples"] > 0 and page["stacks"]
    assert set(page["subsystems"]) <= set(profiler.SUBSYSTEMS)
    servers["gpu"].collect_once()
    text = get(servers["gpu"], "/metrics")[1].decode()
    assert 'agent_gauge{name="prof.overhead_ratio"}' in text
