"""The port's MetricServer against the JAX package's: fixed duty cycles
and memory from both fake nodes and one PodResources assignment (the same
containers, GPU names for TPU names) give the same values in both
servers' /metrics under the mapped names, and the same spans,
observations, series and gauges fed to both packages' ``obs/`` give the
same ``agent_*`` families; then the port's own cases (counters, the
periodic reset, a taken port, NVML's since-last duty cycle read once a
pass)."""

import os
import socket
import threading
import urllib.request

import pytest
from prometheus_client import CollectorRegistry

from container_engine_accelerators_tpu.metrics import counters as tpu_counters
from container_engine_accelerators_tpu.metrics.metrics import (
    MetricServer as TpuMetricServer,
)
from container_engine_accelerators_tpu.obs import histo as tpu_histo
from container_engine_accelerators_tpu.obs import profiler as tpu_profiler
from container_engine_accelerators_tpu.obs import timeseries as tpu_timeseries
from container_engine_accelerators_tpu.tpulib import SysfsTpuLib
from container_engine_accelerators_tpu.utils.retry import (
    RetryPolicy as TpuRetryPolicy,
)
from container_engine_accelerators_tpu.tpulib import (
    write_fixture as write_tpu_fixture,
)
from container_engine_accelerators_tpu_torch.gpulib.fake import (
    H100_MEMORY,
    H100_MODEL,
    FakeGpuLib,
    set_gpu,
    write_fixture,
)
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.metrics.devices import (
    ContainerID,
    PodResourcesClient,
)
from container_engine_accelerators_tpu_torch.metrics.metrics import (
    GpuMetricsCollector,
    MetricServer,
)
from container_engine_accelerators_tpu_torch.obs import (
    histo,
    profiler,
    timeseries,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy
from tests.test_metrics import PodResourcesStub as TpuPodResourcesStub
from tests.test_metrics import make_pod_resources as tpu_pod_resources
from tests.torch_node_helpers import PodResourcesStub, make_pod_resources

GIB = 2**30
FAST = RetryPolicy(max_attempts=20, initial_backoff_s=0.05,
                   max_backoff_s=0.1, deadline_s=5.0)
SAMPLES = {0: (78, 4 * GIB), 1: (12, 1 * GIB), 2: (0, 0), 3: (100, 79 * GIB)}
FAMILIES = {"duty_cycle": "duty_cycle", "memory_total": "memory_total",
            "memory_used": "memory_used", "request": "request",
            "duty_cycle_tpu_node": "duty_cycle_gpu_node",
            "memory_total_tpu_node": "memory_total_gpu_node",
            "memory_used_tpu_node": "memory_used_gpu_node",
            "agent_events": "agent_events",
            "agent_latency": "agent_latency", "agent_rate": "agent_rate",
            "agent_goodput": "agent_goodput", "agent_gauge": "agent_gauge",
            "agent_exemplar": "agent_exemplar"}


def scrape(port):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as resp:
        return resp.read().decode()


def parse(text, family):
    """{frozenset of label pairs: value} of one family."""
    out = {}
    for line in text.splitlines():
        if not line.startswith(family + "{"):
            continue
        labels, value = line[len(family) + 1:].rsplit("} ", 1)
        pairs = frozenset(tuple(kv.split("=", 1)) for kv in
                          labels.replace('"', "").split(","))
        out[pairs] = float(value)
    return out


def to_gpu_labels(pairs):
    mapped = {"google": "nvidia", "google.com/tpu": "nvidia.com/gpu"}
    return frozenset((k, mapped.get(v, v.replace("accel", "nvidia")))
                     for k, v in pairs)


@pytest.fixture
def tpu_server(tmp_path):
    root = str(tmp_path / "tpu")
    write_tpu_fixture(root, 4, hbm_total=H100_MEMORY)
    for i, (duty, used) in SAMPLES.items():
        d = os.path.join(root, "sys/class/accel", f"accel{i}", "device")
        for attr, v in (("duty_cycle_pct", duty), ("hbm_used_bytes", used),
                        ("model", H100_MODEL)):
            with open(os.path.join(d, attr), "w") as f:
                f.write(f"{v}\n")
    sock = str(tmp_path / "tpu-pr.sock")
    stub = TpuPodResourcesStub(sock, tpu_pod_resources())
    server = TpuMetricServer(lib=SysfsTpuLib(root), port=0,
                             collection_interval_s=3600,
                             pod_resources_socket=sock)
    server.start(retry=TpuRetryPolicy(max_attempts=20, initial_backoff_s=0.05,
                                      max_backoff_s=0.1, deadline_s=5.0))
    yield server
    server.stop()
    stub.server.stop(grace=0).wait()


@pytest.fixture
def gpu_node(tmp_path):
    root = str(tmp_path / "gpu")
    write_fixture(root, 4)
    for i, (duty, used) in SAMPLES.items():
        set_gpu(root, f"nvidia{i}", duty_cycle=duty, memory_used=used)
    return root


@pytest.fixture
def gpu_server(tmp_path, gpu_node):
    sock = str(tmp_path / "gpu-pr.sock")
    stub = PodResourcesStub(sock, make_pod_resources())
    server = MetricServer(lib=FakeGpuLib(gpu_node), port=0,
                          collection_interval_s=3600,
                          pod_resources_socket=sock)
    server.start(retry=FAST)
    yield server
    server.stop()
    stub.stop()


def feed_same_obs_state():
    """The same counters, observations, series and gauges in both
    packages' process state, from a clean start (no sampler left
    running, nor its aggregates, by an earlier test in this process)."""
    for side in ((tpu_counters, tpu_histo, tpu_timeseries, tpu_profiler),
                 (counters, histo, timeseries, profiler)):
        c, h, ts, prof = side
        prof.reset()
        c.reset()
        h.reset()
        ts.reset()
        c.inc("health.unhealthy", 3)
        c.inc("kubelet.register.failed")
        for i, us in enumerate((90, 120, 700, 5000, 5100, 70000)):
            h.observe("plugin.allocate", us / 1e6,
                      trace_id=f"{i:016x}" if i % 2 else None)
        h.observe("health.recovery", 12.5)
        ts.record("goodput.link.n0->n1", 4 << 20)
        ts.record("goodput.flow.demo.ring", 2 << 20)
        ts.record("xferd.rx.bytes", 6 << 20)
        ts.gauge("slo.min_qps.ok", 1)
        ts.gauge_add("dcn.chunks.inflight", 3)


@pytest.mark.parametrize("tpu_family,gpu_family", sorted(FAMILIES.items()))
def test_same_values_as_jax_under_mapped_names(tpu_server, gpu_server,
                                               tpu_family, gpu_family):
    feed_same_obs_state()
    tpu_server.collect_once()
    gpu_server.collect_once()
    tpu = {to_gpu_labels(k): v for k, v in
           parse(scrape(tpu_server.port), tpu_family).items()}
    gpu = parse(scrape(gpu_server.port), gpu_family)
    assert gpu == tpu
    assert gpu  # the family was exported


def test_container_gauges_and_skipped_ids(gpu_server):
    gpu_server.collect_once()
    text = scrape(gpu_server.port)
    duty = parse(text, "duty_cycle")
    assert duty == {
        frozenset({("namespace", "default"), ("pod", "train-job-0"),
                   ("container", "worker"), ("make", "nvidia"),
                   ("accelerator_id", f"nvidia{i}"),
                   ("model", H100_MODEL)}): float(SAMPLES[i][0])
        for i in (0, 1)}
    assert 'pod="shared-pod"' not in text  # virtual IDs are skipped
    assert 'pod="tpu-pod"' not in text  # another resource
    assert parse(text, "request") == {frozenset({
        ("namespace", "default"), ("pod", "train-job-0"),
        ("container", "worker"), ("resource_name", "nvidia.com/gpu")}): 2.0}


def test_pod_resources_client_filters_gpus(tmp_path):
    sock = str(tmp_path / "pr.sock")
    stub = PodResourcesStub(sock, make_pod_resources())
    try:
        got = PodResourcesClient(sock).get_devices_for_all_containers()
    finally:
        stub.stop()
    assert got == {ContainerID("default", "train-job-0", "worker"):
                   ["nvidia0", "nvidia1"]}


def test_agent_events_survive_the_reset(tmp_path, gpu_node):
    counters.reset()
    counters.inc("health.unhealthy", 3)
    server = MetricServer(lib=FakeGpuLib(gpu_node), port=0,
                          collection_interval_s=3600,
                          pod_resources_socket=str(tmp_path / "none.sock"))
    server.start(retry=FAST)
    try:
        server.collect_once()
        assert 'agent_events{event="health.unhealthy"} 3.0' in scrape(
            server.port)
        counters.inc("health.unhealthy")
        server._last_reset -= 120  # the periodic registry reset is due
        set_gpu(gpu_node, "nvidia3", duty_cycle=7)
        server.collect_once()
        text = scrape(server.port)
        assert 'agent_events{event="health.unhealthy"} 4.0' in text
        assert parse(text, "duty_cycle_gpu_node")[frozenset({
            ("make", "nvidia"), ("accelerator_id", "nvidia3"),
            ("model", H100_MODEL)})] == 7.0
        # The pod-resources socket is missing: no container series.
        assert not parse(text, "duty_cycle")
    finally:
        server.stop()
    assert all(not t.is_alive() for t in server._threads)


def test_reset_clears_series_of_gpus_that_left(tmp_path):
    registry = CollectorRegistry()

    class Collector:
        names = ["nvidia0", "nvidia1"]

        def devices(self):
            return list(self.names)

        def collect_gpu_device(self, name):
            from container_engine_accelerators_tpu_torch.gpulib.types import (
                MemoryInfo,
            )

            return 5, MemoryInfo(total_bytes=10, used_bytes=1)

        def model(self, name):
            return H100_MODEL

    collector = Collector()
    server = MetricServer(collector=collector, registry=registry,
                          pod_resources_socket=str(tmp_path / "none.sock"))
    server.collect_once()
    labels = {"make": "nvidia", "accelerator_id": "nvidia1",
              "model": H100_MODEL}
    assert registry.get_sample_value("duty_cycle_gpu_node", labels) == 5
    collector.names = ["nvidia0"]
    server._last_reset -= 120
    server.collect_once()
    assert registry.get_sample_value("duty_cycle_gpu_node", labels) is None


class CountingLib(FakeGpuLib):
    def __init__(self, root):
        super().__init__(root)
        self.duty_reads = 0

    def duty_cycle(self, name):
        self.duty_reads += 1
        return super().duty_cycle(name)


def test_each_gpu_is_sampled_once_a_pass(tmp_path, gpu_node):
    """NVML's duty cycle averages the samples since the previous read: the
    container and node gauges of one pass share one read."""
    sock = str(tmp_path / "pr.sock")
    stub = PodResourcesStub(sock, make_pod_resources())
    lib = CountingLib(gpu_node)
    try:
        MetricServer(collector=GpuMetricsCollector(lib),
                     registry=CollectorRegistry(),
                     pod_resources_socket=sock).collect_once()
    finally:
        stub.stop()
    assert lib.duty_reads == 4


def test_port_conflict_at_boot_is_retried(tmp_path, gpu_node):
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("0.0.0.0", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    before = counters.get("metrics.bind.retried")
    server = MetricServer(lib=FakeGpuLib(gpu_node), port=port,
                          collection_interval_s=3600,
                          pod_resources_socket=str(tmp_path / "none.sock"))
    release = threading.Timer(0.3, blocker.close)
    release.start()
    try:
        server.start(retry=FAST)
        assert server.port == port
        assert counters.get("metrics.bind.retried") > before
        server.collect_once()
        assert "duty_cycle_gpu_node" in scrape(port)
    finally:
        release.cancel()
        release.join()
        server.stop()


def test_port_conflict_past_the_budget_raises(tmp_path, gpu_node):
    blocker = socket.socket()
    blocker.bind(("0.0.0.0", 0))
    blocker.listen(1)
    try:
        server = MetricServer(lib=FakeGpuLib(gpu_node),
                              port=blocker.getsockname()[1],
                              pod_resources_socket=str(tmp_path / "x.sock"))
        with pytest.raises(OSError):
            server.start(retry=RetryPolicy(max_attempts=2,
                                           initial_backoff_s=0.01,
                                           max_backoff_s=0.02))
    finally:
        blocker.close()
