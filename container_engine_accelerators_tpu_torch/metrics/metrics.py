"""Prometheus metrics server for GPU nodes (ref: pkg/gpu/nvidia/metrics/
metrics.go; the JAX package's ``metrics/metrics.py``).  The serving demo's
HPA scales on ``duty_cycle``.

Gauges, labelled as the reference labels them (``make="nvidia"``):

- per container, joined to its GPUs through the kubelet's PodResources
  API: ``duty_cycle``, ``memory_total``, ``memory_used`` (namespace, pod,
  container, make, accelerator_id, model) and ``request`` (namespace,
  pod, container, resource_name);
- per GPU of the node: ``duty_cycle_gpu_node``, ``memory_total_gpu_node``,
  ``memory_used_gpu_node`` (make, accelerator_id, model);
- ``agent_events{event=...}``: the agent's counters (``counters.py``);
- ``agent_latency{op=...,bucket=...}``: the log2 latency histograms of
  ``obs/histo.py`` as cumulative ``le`` buckets in microseconds
  (``bucket="+Inf"`` is the total count);
- ``agent_rate{event=...}``: the per-second windowed rate of every
  counter and byte series (``obs/timeseries.py``);
- ``agent_goodput{scope=...,name=...}``: the ``goodput.<scope>.<name>``
  series' landed bytes a second;
- ``agent_gauge{name=...}``: explicit gauges (``timeseries.gauge``),
  the profiler's ``prof.overhead_ratio`` among them;
- ``agent_exemplar{op=...,bucket=...,trace=...}``: each latency
  bucket's worst sample's trace id, the value its duration in µs
  (``cmd/agent_trace.py --exemplar <op>`` resolves it).

``accelerator_id`` is ``nvidia<minor>``, the name the device plugin
advertises; ``model`` is NVML's device name.  The registry is cleared
every 60 s so that pods which are gone stop being reported
(metrics.go:241-253), and the agent families, which are cumulative
process state, are published again at once.  ``start`` retries a port
that is still taken under a bounded budget, and ``rebind`` moves the
listener to another port without stopping collection.

Beside ``/metrics`` the same listener answers ``GET /spans?since=N``
with the span ring (``obs/trace.py``) as bounded JSON ``{"cursor",
"dropped", "spans"}`` (page by passing ``cursor`` back; ``dropped``
counts spans the ring evicted before they were read), and ``GET
/profile?since=N`` with the stack sampler's folded stacks
(``obs/profiler.py``) under the same cursor discipline.  Both bodies
are the JAX package's, byte for byte in shape.  The server is
prometheus_client's WSGI surface, imported unconditionally: an install
without it fails at import, never serves a listener without ``/spans``.
"""

import json
import logging
import threading
import time
import urllib.parse
from typing import List, Optional, Tuple
from wsgiref.simple_server import make_server

from prometheus_client import CollectorRegistry, Gauge
from prometheus_client.exposition import (
    ThreadingWSGIServer,
    _SilentHandler,
    make_wsgi_app,
)

from container_engine_accelerators_tpu_torch.deviceplugin.api import RESOURCE_NAME
from container_engine_accelerators_tpu_torch.gpulib.types import GpuLib, MemoryInfo
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.metrics.devices import (
    POD_RESOURCES_SOCKET,
    PodResourcesClient,
)
from container_engine_accelerators_tpu_torch.obs import (
    histo,
    profiler,
    timeseries,
    trace,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

MAKE = "nvidia"
RESET_INTERVAL_S = 60.0  # metricsResetInterval
BIND_RETRY = RetryPolicy(
    max_attempts=6, initial_backoff_s=0.2, max_backoff_s=2.0, deadline_s=15.0
)

# /spans bounds: the default page and the hard cap of one GET, so a
# scraper that never passes `limit` still gets a bounded body.
# The listener's serve_forever poll: stop() waits up to one interval
# for the loop to see its shutdown (the library default is 0.5 s).
SHUTDOWN_POLL_S = 0.05
SPANS_DEFAULT_LIMIT = 512
SPANS_MAX_LIMIT = 2048
# /profile bounds: the folded stacks of one GET.
PROFILE_DEFAULT_LIMIT = profiler.SCRAPE_DEFAULT_LIMIT
PROFILE_MAX_LIMIT = profiler.SCRAPE_MAX_LIMIT

_CONTAINER_LABELS = ["namespace", "pod", "container", "make",
                     "accelerator_id", "model"]
_NODE_LABELS = ["make", "accelerator_id", "model"]


class GpuMetricsCollector:
    """The sampling seam (the reference's metricsCollector interface,
    metrics.go:29-35): tests substitute their own."""

    def __init__(self, lib: GpuLib):
        self.lib = lib

    def collect_gpu_device(self, name: str) -> Tuple[int, MemoryInfo]:
        return self.lib.duty_cycle(name), self.lib.memory_info(name)

    def devices(self) -> List[str]:
        return [info.name for info in self.lib.devices()]

    def model(self, name: str) -> str:
        return self.lib.device_info(name).model


class MetricServer:
    def __init__(
        self,
        lib: Optional[GpuLib] = None,
        port: int = 2112,
        collection_interval_s: float = 30.0,
        pod_resources_socket: str = POD_RESOURCES_SOCKET,
        collector: Optional[GpuMetricsCollector] = None,
        registry: Optional[CollectorRegistry] = None,
    ):
        self.collector = collector or GpuMetricsCollector(lib)
        self.port = port
        self.collection_interval_s = collection_interval_s
        self.pod_resources = PodResourcesClient(pod_resources_socket)
        self.registry = registry or CollectorRegistry()
        self._stop = threading.Event()
        self._last_reset = time.monotonic()
        self._httpd = None
        self._http_thread: Optional[threading.Thread] = None
        self._threads: List[threading.Thread] = []

        def gauge(name, doc, labels):
            return Gauge(name, doc, labels, registry=self.registry)

        self.duty_cycle = gauge(
            "duty_cycle", "Percent of time over the past sample period "
            "during which the accelerator was actively processing",
            _CONTAINER_LABELS)
        self.memory_total = gauge(
            "memory_total", "Total accelerator memory (bytes)",
            _CONTAINER_LABELS)
        self.memory_used = gauge(
            "memory_used", "Allocated accelerator memory (bytes)",
            _CONTAINER_LABELS)
        self.request = gauge(
            "request", "Number of accelerator devices requested by the "
            "container", ["namespace", "pod", "container", "resource_name"])
        self.duty_cycle_node = gauge(
            "duty_cycle_gpu_node", "Node-level GPU duty cycle", _NODE_LABELS)
        self.memory_total_node = gauge(
            "memory_total_gpu_node", "Node-level total GPU memory (bytes)",
            _NODE_LABELS)
        self.memory_used_node = gauge(
            "memory_used_gpu_node", "Node-level used GPU memory (bytes)",
            _NODE_LABELS)
        self.agent_events = gauge(
            "agent_events", "Cumulative recovery events of the node agent "
            "(health transitions, registration retries), by "
            "metrics/counters.py name", ["event"])
        self.agent_latency = gauge(
            "agent_latency", "Log2-bucket latency histograms of node-agent "
            "operations (obs/histo.py): bucket is a cumulative le upper "
            "bound in microseconds; bucket=\"+Inf\" is the total count",
            ["op", "bucket"])
        self.agent_rate = gauge(
            "agent_rate", "Per-second rate over the trailing window "
            "(TPU_RATE_WINDOW_S) of every counter and byte series; decays "
            "to zero when the activity stops", ["event"])
        self.agent_goodput = gauge(
            "agent_goodput", "Landed payload bytes per second over the "
            "trailing window, per flow / link / node", ["scope", "name"])
        self.agent_gauge = gauge(
            "agent_gauge", "Explicit instantaneous gauges "
            "(obs/timeseries.py)", ["name"])
        self.agent_exemplar = gauge(
            "agent_exemplar", "For each agent_latency bucket, the trace id "
            "of its worst sample (value: its duration in microseconds); "
            "resolve with cmd/agent_trace.py --exemplar",
            ["op", "bucket", "trace"])

    # -- lifecycle -----------------------------------------------------------

    def _wsgi_app(self):
        """One app for the one listener: ``/spans`` and ``/profile`` as
        bounded JSON, the Prometheus exposition at every other path."""
        metrics_app = make_wsgi_app(self.registry)

        def app(environ, start_response):
            path = environ.get("PATH_INFO", "")
            if path not in ("/spans", "/profile"):
                return metrics_app(environ, start_response)
            query = urllib.parse.parse_qs(environ.get("QUERY_STRING", ""))

            def qint(key, default):
                try:
                    return int(query.get(key, [default])[0])
                except (TypeError, ValueError):
                    return default  # a malformed query degrades, never 500s

            since = qint("since", 0)
            if path == "/spans":
                limit = min(max(1, qint("limit", SPANS_DEFAULT_LIMIT)),
                            SPANS_MAX_LIMIT)
                spans, cursor, dropped = trace.tail_since(since, limit)
                payload = {"cursor": cursor, "dropped": dropped,
                           "spans": spans}
            else:
                limit = min(max(1, qint("limit", PROFILE_DEFAULT_LIMIT)),
                            PROFILE_MAX_LIMIT)
                payload = profiler.scrape(since=since, limit=limit)
            body = json.dumps(payload).encode()
            start_response("200 OK", [
                ("Content-Type", "application/json"),
                ("Content-Length", str(len(body))),
            ])
            return [body]

        return app

    def _bind(self, retry: RetryPolicy) -> None:
        """Bind the HTTP listener; past the retry budget the OSError of a
        taken port propagates."""

        class Server(ThreadingWSGIServer):
            """A class a server, as prometheus_client makes them, so no
            attribute set on one leaks into another."""

        def attempt():
            return make_server("0.0.0.0", self.port, self._wsgi_app(),
                               Server, handler_class=_SilentHandler)

        def on_retry(attempt_index, error):
            counters.inc("metrics.bind.retried")
            log.warning("metrics port %d: %s; retrying", self.port, error)

        self._httpd = retry.call(attempt, retry_on=(OSError,),
                                 sleep=self._stop.wait, on_retry=on_retry)
        thread = threading.Thread(target=self._httpd.serve_forever,
                                  args=(SHUTDOWN_POLL_S,),
                                  name="gpu-metrics-http", daemon=True)
        thread.start()
        self._threads.append(thread)
        self._http_thread = thread
        # port 0 is any free port: report the one bound.
        self.port = self._httpd.server_port

    def start(self, retry: Optional[RetryPolicy] = None) -> None:
        self._bind(retry or BIND_RETRY)
        thread = threading.Thread(target=self._collect_loop,
                                  name="gpu-metrics", daemon=True)
        thread.start()
        self._threads.append(thread)

    def rebind(self, port: Optional[int] = None,
               retry: Optional[RetryPolicy] = None) -> int:
        """Move the listener to ``port`` (0: any free port; None: the same
        one) without restarting collection; returns the bound port.  The
        recovery path for a port lost after boot: scraping resumes on the
        new port, and gauges and counters carry over."""
        self._close_listener()
        if port is not None:
            self.port = port
        self._bind(retry or BIND_RETRY)
        counters.inc("metrics.rebind")
        log.warning("metrics server re-bound to port %d", self.port)
        return self.port

    def _close_listener(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        thread = self._http_thread
        self._http_thread = None
        thread.join(timeout=10)
        self._threads.remove(thread)

    def stop(self) -> None:
        self._stop.set()
        self._close_listener()
        for thread in self._threads:
            thread.join(timeout=10)
        self._threads = []

    def _collect_loop(self) -> None:
        while not self._stop.wait(self.collection_interval_s):
            try:
                self.collect_once()
            except Exception as e:
                log.error("metrics collection failed: %s", e)

    # -- collection ----------------------------------------------------------

    def _reset(self) -> None:
        for gauge in (self.duty_cycle, self.memory_total, self.memory_used,
                      self.request, self.duty_cycle_node,
                      self.memory_total_node, self.memory_used_node,
                      self.agent_events, self.agent_latency, self.agent_rate,
                      self.agent_goodput, self.agent_gauge,
                      self.agent_exemplar):
            gauge.clear()
        # The agent families are cumulative: publish them again at once,
        # so a scrape between the clear and the next pass does not read
        # them as gone.
        self._republish_cumulative()

    def _republish_cumulative(self) -> None:
        """Export every family backed by process state: counters,
        histograms with their exemplars, rates and gauges."""
        for name, value in counters.snapshot().items():
            self.agent_events.labels(event=name).set(value)
        # Prometheus-style buckets, cumulative over ascending bounds.
        for op, h in histo.snapshot().items():
            cumulative = 0
            for le, count in sorted(h["buckets"].items(),
                                    key=lambda kv: int(kv[0])):
                cumulative += count
                self.agent_latency.labels(op=op, bucket=le).set(cumulative)
            self.agent_latency.labels(op=op, bucket="+Inf").set(h["count"])
            for le, ex in h["exemplars"].items():
                self.agent_exemplar.labels(
                    op=op, bucket=le, trace=ex["trace"]).set(ex["dur_us"])
        # An idle series exports 0.0: a stopped activity scrapes as zero.
        for name, per_s in timeseries.rates().items():
            scoped = timeseries.split_goodput(name)
            if scoped is not None:
                self.agent_goodput.labels(scope=scoped[0],
                                          name=scoped[1]).set(per_s)
            else:
                self.agent_rate.labels(event=name).set(per_s)
        for name, value in timeseries.gauges().items():
            self.agent_gauge.labels(name=name).set(value)

    def collect_once(self) -> None:
        now = time.monotonic()
        if now - self._last_reset >= RESET_INTERVAL_S:
            self._reset()
            self._last_reset = now

        try:
            container_devices = self.pod_resources.get_devices_for_all_containers()
        except Exception as e:
            log.warning("pod-resources query failed: %s", e)
            container_devices = {}

        # One sample per GPU per pass: NVML's duty cycle averages the
        # samples since the previous read, so a second read in the same
        # pass would see almost none.
        samples = {}
        for name in self.collector.devices():
            try:
                samples[name] = self.collector.collect_gpu_device(name)
            except Exception as e:
                log.warning("sampling %s failed: %s", name, e)

        for cid, device_ids in container_devices.items():
            self.request.labels(
                namespace=cid.namespace, pod=cid.pod,
                container=cid.container, resource_name=RESOURCE_NAME,
            ).set(len(device_ids))
            for device_id in device_ids:
                if device_id not in samples:
                    continue
                duty, mem = samples[device_id]
                labels = dict(namespace=cid.namespace, pod=cid.pod,
                              container=cid.container, make=MAKE,
                              accelerator_id=device_id,
                              model=self.collector.model(device_id))
                self.duty_cycle.labels(**labels).set(duty)
                self.memory_total.labels(**labels).set(mem.total_bytes)
                self.memory_used.labels(**labels).set(mem.used_bytes)

        self._republish_cumulative()

        for name, (duty, mem) in samples.items():
            labels = dict(make=MAKE, accelerator_id=name,
                          model=self.collector.model(name))
            self.duty_cycle_node.labels(**labels).set(duty)
            self.memory_total_node.labels(**labels).set(mem.total_bytes)
            self.memory_used_node.labels(**labels).set(mem.used_bytes)
