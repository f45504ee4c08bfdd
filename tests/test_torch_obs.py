"""The port's ``obs/`` against the JAX package's.

First the cases of the JAX package's ``tests/test_obs.py`` (spans, trace
context, head sampling, histograms, exemplars, windowed rates, the
flight recorder), run unchanged against the port's modules.  Then parity:
the same inputs through both packages give equal results, exactly (these
are stdlib computations), with ids and wall-clock fields stripped or
injected.  Last, the import contract: the port's ``obs/`` imports no
torch, no prometheus_client, no grpc and nothing of the JAX package.

Both packages keep their rings, histograms, counters and rates per
process, so every test resets both sides.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

from container_engine_accelerators_tpu.metrics import counters as jax_counters
from container_engine_accelerators_tpu.obs import (
    flight as jax_flight,
    histo as jax_histo,
    promtext as jax_promtext,
    timeseries as jax_timeseries,
    trace as jax_trace,
)
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import (
    flight,
    histo,
    promtext,
    timeseries,
    trace,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reset_both():
    for mod in (trace, histo, timeseries, counters, jax_trace, jax_histo,
                jax_timeseries, jax_counters):
        mod.reset()


@pytest.fixture(autouse=True)
def clean_obs():
    """Spans, histograms, rates and counters are per process: isolate
    each test on both sides and leave no open sink behind."""
    reset_both()
    yield
    reset_both()


# ---------------------------------------------------------------------------
# The JAX package's cases, against the port's modules
# ---------------------------------------------------------------------------


class TestTrace:
    def test_nesting_links_and_ring_order(self):
        with trace.span("outer", a=1) as outer:
            with trace.span("inner") as inner:
                assert trace.current() is inner
            assert trace.current() is outer
        assert trace.current() is None

        inner_d, outer_d = trace.tail(2)
        assert (inner_d["name"], outer_d["name"]) == ("inner", "outer")
        assert inner_d["trace"] == outer_d["trace"]
        assert inner_d["parent"] == outer_d["span"]
        assert outer_d["parent"] is None
        assert outer_d["attrs"] == {"a": 1}

    def test_separate_roots_get_separate_traces(self):
        with trace.span("first"):
            pass
        with trace.span("second"):
            pass
        first, second = trace.tail(2)
        assert first["trace"] != second["trace"]

    def test_error_status_and_propagation(self):
        with pytest.raises(OSError, match="boom"):
            with trace.span("failing"):
                raise OSError("boom")
        (d,) = trace.tail(1)
        assert d["status"] == "error"
        assert "boom" in d["attrs"]["error"]

    def test_annotate_without_active_span_is_noop(self):
        trace.annotate(orphan=True)  # must not raise
        with trace.span("s"):
            trace.annotate(k="v")
        assert trace.tail(1)[0]["attrs"] == {"k": "v"}

    def test_histogram_option_feeds_histo(self):
        histo.reset()
        with trace.span("timed", histogram="timed.op"):
            pass
        assert histo.snapshot()["timed.op"]["count"] == 1

    def test_jsonl_sink_via_env(self, tmp_path, monkeypatch):
        path = str(tmp_path / "trace.jsonl")
        monkeypatch.setenv(trace.TRACE_FILE_ENV, path)
        trace.reset()  # re-resolve the sink from env, like process start
        with trace.span("a"):
            pass
        with trace.span("b", k=2):
            pass
        lines = [json.loads(x) for x in open(path)]
        assert [x["name"] for x in lines] == ["a", "b"]
        assert {"trace", "span", "parent", "ts", "dur_us", "status",
                "thread", "attrs"} <= set(lines[0])

    def test_unwritable_sink_never_breaks_spans(self, tmp_path):
        trace.configure(str(tmp_path))  # a directory: open() fails
        with trace.span("survives"):
            pass
        assert trace.tail(1)[0]["name"] == "survives"

    def test_threads_are_isolated(self):
        seen = {}

        def worker():
            with trace.span("worker-root") as s:
                seen["worker"] = s.trace_id

        with trace.span("main-root") as s:
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            # The worker must NOT have inherited main's context.
            assert seen["worker"] != s.trace_id

    def test_malformed_ring_env_never_kills_import(self):
        """TPU_TRACE_RING=garbage must degrade to the default, not
        crash-loop every agent that transitively imports obs.trace."""
        proc = subprocess.run(
            [sys.executable, "-c",
             "from container_engine_accelerators_tpu_torch.utils import retry; "
             "print('IMPORT_OK')"],
            cwd=REPO, capture_output=True, text=True, timeout=60,
            env={**os.environ, trace.RING_CAPACITY_ENV: "oops"},
        )
        assert proc.returncode == 0, proc.stderr
        assert "IMPORT_OK" in proc.stdout

    def test_ring_is_bounded(self):
        trace.configure(ring_capacity=8)
        try:
            for i in range(20):
                with trace.span(f"s{i}"):
                    pass
            spans = trace.tail()
            assert len(spans) == 8
            assert spans[-1]["name"] == "s19"
        finally:
            trace.configure(ring_capacity=trace.DEFAULT_RING_CAPACITY)


class TestTraceContext:
    """Cross-process context: attach() joins a foreign trace; the
    TPU_TRACE_CONTEXT env hands it between coordinator and workers."""

    def test_attach_joins_remote_trace(self):
        with trace.attach("cafe0123cafe0123", "ab12cd34"):
            with trace.span("child") as s:
                assert s.trace_id == "cafe0123cafe0123"
                assert s.parent_id == "ab12cd34"
        # The placeholder itself is never recorded.
        assert all(sp["name"] != "remote" for sp in trace.tail())

    def test_attach_none_is_noop(self):
        with trace.attach(None):
            with trace.span("orphan") as s:
                assert s.parent_id is None

    def test_context_env_roundtrip(self):
        with trace.span("root") as root:
            env = {trace.TRACE_CONTEXT_ENV: trace.context_env()}
        with trace.attach_from_env(env):
            with trace.span("worker") as s:
                assert s.trace_id == root.trace_id
                assert s.parent_id == root.span_id

    def test_malformed_env_context_degrades_to_fresh_trace(self):
        with trace.attach_from_env({trace.TRACE_CONTEXT_ENV: "garbage"}):
            with trace.span("worker") as s:
                assert s.trace_id != "garbage"


class TestTraceSampling:
    """TPU_TRACE_SAMPLE head sampling: whole traces share a fate by a
    deterministic trace-id hash; the ring is never sampled; malformed
    rates degrade to sample-everything."""

    def _spans_in(self, path):
        if not os.path.exists(path):
            return []
        return [json.loads(line) for line in open(path)]

    def test_rate_zero_silences_sink_but_not_ring(
            self, tmp_path, monkeypatch):
        path = str(tmp_path / "t.jsonl")
        monkeypatch.setenv(trace.TRACE_FILE_ENV, path)
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "0.0")
        trace.reset()
        for _ in range(5):
            with trace.span("s"):
                pass
        trace.reset()
        assert self._spans_in(path) == []
        # ...but the flight recorder's ring is untouched by sampling:
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "0.0")
        with trace.span("ringed"):
            pass
        assert any(s["name"] == "ringed" for s in trace.tail())

    def test_decision_is_deterministic_by_trace_id(self, monkeypatch):
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "0.5")
        trace.reset()
        # The first 8 hex chars drive the hash: all-zeros is always in,
        # all-fs always out at any rate < 1.
        assert trace.sampled("0000000012345678")
        assert not trace.sampled("ffffffff12345678")
        # Same id, same fate — what makes HEAD sampling coherent across
        # processes sharing the id.
        assert trace.sampled("0000000012345678")

    def test_whole_trace_shares_one_fate(self, tmp_path, monkeypatch):
        path = str(tmp_path / "t.jsonl")
        monkeypatch.setenv(trace.TRACE_FILE_ENV, path)
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "0.5")
        trace.reset()
        for _ in range(40):
            with trace.span("root"):
                with trace.span("child"):
                    pass
        trace.reset()
        spans = self._spans_in(path)
        by_trace = {}
        for s in spans:
            by_trace.setdefault(s["trace"], []).append(s["name"])
        # Every sampled-in trace arrived COMPLETE (root + child).
        for names in by_trace.values():
            assert sorted(names) == ["child", "root"]

    def test_malformed_rate_samples_everything(self, tmp_path,
                                               monkeypatch):
        path = str(tmp_path / "t.jsonl")
        monkeypatch.setenv(trace.TRACE_FILE_ENV, path)
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "not-a-rate")
        trace.reset()
        with trace.span("s"):
            pass
        trace.reset()
        assert len(self._spans_in(path)) == 1

    @pytest.mark.parametrize("bad", ["-0.5", "1.5", "nan"])
    def test_out_of_range_rates_sample_everything(self, bad, monkeypatch):
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, bad)
        trace.reset()
        assert trace.sampled("ffffffffffffffff")

    def test_foreign_trace_ids_sample_in(self, monkeypatch):
        monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, "0.5")
        trace.reset()
        assert trace.sampled("not-hex-at-all")


# ---------------------------------------------------------------------------
# histo
# ---------------------------------------------------------------------------


class TestHisto:
    def setup_method(self):
        histo.reset()

    def test_log2_bucketing(self):
        assert histo.bucket_le_us(0.0) == 1
        assert histo.bucket_le_us(1e-6) == 1
        assert histo.bucket_le_us(3e-6) == 4
        assert histo.bucket_le_us(1024e-6) == 1024
        assert histo.bucket_le_us(1025e-6) == 2048

    def test_observe_and_snapshot(self):
        for us in (100, 200, 900, 5000):
            histo.observe("op", us / 1e6)
        snap = histo.snapshot()["op"]
        assert snap["count"] == 4
        assert snap["buckets"] == {"128": 1, "256": 1, "1024": 1, "8192": 1}
        assert snap["sum_us"] == pytest.approx(6200, rel=1e-3)

    def test_percentiles_are_upper_bounds(self):
        for _ in range(99):
            histo.observe("p", 100e-6)  # bucket le=128us
        histo.observe("p", 1.0)  # one straggler: le=2^20us
        assert histo.percentile("p", 0.5) == 128 / 1e6
        assert histo.percentile("p", 0.99) == 128 / 1e6
        assert histo.percentile("p", 1.0) == (1 << 20) / 1e6
        assert histo.percentile("missing", 0.5) is None

    def test_ops_are_independent(self):
        histo.observe("a", 1e-3)
        histo.observe("b", 1e-3)
        snap = histo.snapshot()
        assert snap["a"]["count"] == 1 and snap["b"]["count"] == 1


class TestExemplars:
    """Each histogram bucket remembers the trace id of its WORST
    sample — the metric → trace hop."""

    def setup_method(self):
        histo.reset()

    def test_bucket_keeps_worst_sample(self):
        histo.observe("op", 100e-6, trace_id="fast")
        histo.observe("op", 120e-6, trace_id="slow")  # same le=128 bucket
        histo.observe("op", 110e-6, trace_id="mid")
        snap = histo.snapshot()["op"]["exemplars"]
        assert snap["128"]["trace"] == "slow"
        assert snap["128"]["dur_us"] == pytest.approx(120, rel=1e-3)

    def test_overall_exemplar_is_cross_bucket_worst(self):
        histo.observe("op", 100e-6, trace_id="small")
        histo.observe("op", 0.5, trace_id="huge")
        trace_id, dur = histo.exemplar("op")
        assert trace_id == "huge" and dur == pytest.approx(0.5)
        assert histo.exemplar("missing") is None

    def test_untraced_observations_keep_no_exemplar(self):
        histo.observe("op", 1e-3)
        assert histo.snapshot()["op"]["exemplars"] == {}
        assert histo.exemplar("op") is None

    def test_span_histogram_wires_trace_id_through(self):
        with trace.span("timed", histogram="timed.op") as s:
            pass
        trace_id, _dur = histo.exemplar("timed.op")
        assert trace_id == s.trace_id


# ---------------------------------------------------------------------------
# timeseries
# ---------------------------------------------------------------------------


class TestTimeseries:
    """Windowed ring-bucket rates: decay to zero by construction, no
    background thread; every function takes an injectable clock."""

    def setup_method(self):
        timeseries.reset()

    def test_rate_over_window(self):
        t0 = 1000.0
        for i in range(5):
            timeseries.record("ev", 2, now=t0 + i)  # 10 over 5 buckets
        assert timeseries.rate("ev", window_s=10, now=t0 + 4) == \
            pytest.approx(1.0)

    def test_rate_decays_to_zero_when_traffic_stops(self):
        t0 = 2000.0
        timeseries.record("ev", 100, now=t0)
        assert timeseries.rate("ev", window_s=10, now=t0) > 0
        assert timeseries.rate("ev", window_s=10, now=t0 + 11) == 0.0

    def test_unknown_series_is_zero_not_error(self):
        assert timeseries.rate("never.recorded") == 0.0

    def test_old_buckets_are_recycled_not_leaked(self):
        t0 = 3000.0
        timeseries.record("ev", 7, now=t0)
        # One full ring later the same slot is reused; the stale value
        # must not bleed into the new epoch's rate.
        t1 = t0 + timeseries.NUM_BUCKETS * timeseries.BUCKET_S
        timeseries.record("ev", 3, now=t1)
        assert timeseries.rate("ev", window_s=1, now=t1) == \
            pytest.approx(3.0)

    def test_gauges(self):
        timeseries.gauge("inflight", 4)
        assert timeseries.gauge_add("inflight", -1) == 3
        timeseries.gauge_add("fresh", 2)
        assert timeseries.gauges() == {"inflight": 3.0, "fresh": 2.0}

    def test_split_goodput(self):
        assert timeseries.split_goodput("goodput.link.n0->n1") == \
            ("link", "n0->n1")
        assert timeseries.split_goodput("goodput.flow.r1.a.b") == \
            ("flow", "r1.a.b")
        assert timeseries.split_goodput("dcn.tx.bytes") is None
        assert timeseries.split_goodput("goodput.") is None

    def test_counters_feed_rates(self):
        counters.inc("ts.coupling.marker", 5)
        assert timeseries.rate("ts.coupling.marker",
                               window_s=timeseries.NUM_BUCKETS) > 0

    def test_malformed_window_env_degrades(self, monkeypatch):
        monkeypatch.setenv(timeseries.RATE_WINDOW_ENV, "not-a-window")
        assert timeseries.default_window_s() == \
            timeseries.DEFAULT_WINDOW_S
        monkeypatch.setenv(timeseries.RATE_WINDOW_ENV, "-4")
        assert timeseries.default_window_s() == \
            timeseries.DEFAULT_WINDOW_S
        monkeypatch.setenv(timeseries.RATE_WINDOW_ENV, "5")
        assert timeseries.default_window_s() == 5.0

    def test_snapshot_shape(self):
        timeseries.record("a.bytes", 10)
        timeseries.gauge("g", 1)
        snap = timeseries.snapshot(window_s=10)
        assert snap["window_s"] == 10
        assert "a.bytes" in snap["rates"]
        assert snap["gauges"] == {"g": 1.0}

    def test_dead_series_are_pruned_not_leaked(self):
        """Per-flow goodput names are unique per transfer; a long-lived
        agent must not grow one series per transfer forever.  Past
        MAX_SERIES, fully-idle series (no bucket inside the ring span)
        are evicted on the next record."""
        t0 = 5000.0
        for i in range(timeseries.MAX_SERIES):
            timeseries.record(f"goodput.flow.dead{i}", 1, now=t0)
        # Well past the ring span: every dead series is evictable.
        t1 = t0 + 2 * timeseries.NUM_BUCKETS * timeseries.BUCKET_S
        timeseries.record("goodput.flow.live", 1, now=t1)
        rates = timeseries.rates(now=t1)
        assert "goodput.flow.live" in rates
        assert len(rates) == 1  # the dead five hundred are gone
        # A series still inside the span survives pruning (it is the
        # explicit-0.0 decay window, not an instant eviction).
        timeseries.reset()
        timeseries.record("recent", 1, now=t1 - 5)
        for i in range(timeseries.MAX_SERIES):
            timeseries.record(f"filler{i}", 1, now=t1)
        assert "recent" in timeseries.rates(now=t1)

    def test_series_storm_is_hard_bounded(self):
        """Thousands of still-LIVE unique names (a flow storm inside
        one ring span) must hit a hard cardinality ceiling, not grow
        with the churn rate."""
        t0 = 9000.0
        for i in range(3 * timeseries.HARD_MAX_SERIES):
            timeseries.record(f"goodput.flow.storm{i}", 1, now=t0)
        with timeseries._lock:
            n = len(timeseries._series)
        assert n <= timeseries.HARD_MAX_SERIES


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------


class TestFlightRecorder:
    def test_dump_contains_spans_counters_histograms(self, tmp_path,
                                                     capsys):
        histo.reset()
        with trace.span("evidence", histogram="evidence.op"):
            pass
        counters.inc("test.flight.marker", 7)
        path = str(tmp_path / "flight.jsonl")
        blob = flight.dump("unit-test", file=path)
        assert blob["reason"] == "unit-test"
        assert blob["counters"]["test.flight.marker"] >= 7
        assert blob["histograms"]["evidence.op"]["count"] >= 1
        assert any(s["name"] == "evidence" for s in blob["spans"])
        # Windowed snapshot rides along: what was the node DOING.
        assert blob["rates"]["rates"]["test.flight.marker"] > 0
        # File copy is one parseable JSON line with a schema tag.
        (line,) = open(path).read().splitlines()
        assert json.loads(line)["flight_recorder"] == 1
        # stderr copy carries the grep-able marker.
        assert flight.STDERR_MARKER in capsys.readouterr().err

    def test_span_cap_respected(self, monkeypatch):
        monkeypatch.setenv(flight.FLIGHT_SPANS_ENV, "3")
        for i in range(10):
            with trace.span(f"s{i}"):
                pass
        blob = flight.snapshot("cap")
        assert [s["name"] for s in blob["spans"]] == ["s7", "s8", "s9"]

    def test_malformed_span_cap_still_dumps(self, monkeypatch):
        """A typo in TPU_FLIGHT_SPANS must cost the tuning knob, not
        the evidence: the dump degrades to the default cap."""
        monkeypatch.setenv(flight.FLIGHT_SPANS_ENV, "not-a-number")
        with trace.span("still-here"):
            pass
        blob = flight.dump("bad-knob")
        assert blob is not None
        assert any(s["name"] == "still-here" for s in blob["spans"])

    def test_sigusr1_dumps_async(self, tmp_path, monkeypatch):
        path = str(tmp_path / "sig.jsonl")
        monkeypatch.setenv(flight.FLIGHT_FILE_ENV, path)
        with trace.span("pre-signal"):
            pass
        assert flight.install()  # main thread here
        try:
            os.kill(os.getpid(), signal.SIGUSR1)
            deadline = time.monotonic() + 5
            while not os.path.exists(path):
                assert time.monotonic() < deadline, "no flight dump"
                time.sleep(0.01)
            # The handler thread may still be writing; poll for a full
            # line.
            blob = None
            while time.monotonic() < deadline:
                content = open(path).read()
                if content.endswith("\n"):
                    blob = json.loads(content.splitlines()[0])
                    break
                time.sleep(0.01)
            assert blob and blob["reason"].startswith("signal")
            assert any(s["name"] == "pre-signal" for s in blob["spans"])
        finally:
            signal.signal(signal.SIGUSR1, signal.SIG_DFL)

    def test_dump_carries_slo_verdicts(self):
        timeseries.gauge("slo.min_goodput_bps.ok", 0.0)
        timeseries.gauge("slo.min_goodput_bps.value", 12.5)
        timeseries.gauge("dcn.chunks.inflight", 2)
        try:
            blob = flight.snapshot("slo-test")
            assert blob["slo"] == {"slo.min_goodput_bps.ok": 0.0,
                                   "slo.min_goodput_bps.value": 12.5}
            assert blob["rates"]["gauges"]["dcn.chunks.inflight"] == 2
        finally:
            timeseries.reset()

    def test_install_off_main_thread_degrades(self):
        result = {}

        def worker():
            result["ok"] = flight.install()

        t = threading.Thread(target=worker)
        t.start()
        t.join()
        assert result["ok"] is False


# ---------------------------------------------------------------------------
# Parity: the same inputs through both packages
# ---------------------------------------------------------------------------

# The fields that differ by construction: random ids and the clocks.
_VOLATILE = ("trace", "span", "parent", "ts", "dur_us")


def _strip(span):
    return {k: v for k, v in span.items() if k not in _VOLATILE}


def _drive_spans(mod):
    """One scripted span sequence: nesting, an error, an annotation, a
    zero-duration event, a recorded span, a remote attach."""
    with mod.span("outer", a=1):
        with mod.span("inner", histogram="inner.op", k="v"):
            mod.annotate(fault="site", fault_mode="fail")
        try:
            with mod.span("failing"):
                raise OSError("boom")
        except OSError:
            pass
        mod.event("marker", device="d0")
    mod.record_span("recorded", 0.25, end_ts=1000.0, status="error", x=2)
    with mod.attach("cafe0123cafe0123", "ab12cd34"):
        with mod.span("joined"):
            pass
    return mod.tail()


def _links(spans):
    """The tree's shape with ids replaced by positions."""
    index = {s["span"]: i for i, s in enumerate(spans)}
    return [(index.get(s["parent"]), s["parent"] is None) for s in spans]


def test_same_span_sequence_gives_same_ring_dicts():
    jax_spans = _drive_spans(jax_trace)
    port_spans = _drive_spans(trace)
    assert [_strip(s) for s in port_spans] == \
        [_strip(s) for s in jax_spans]
    assert _links(port_spans) == _links(jax_spans)
    assert [sorted(s) for s in port_spans] == [sorted(s) for s in jax_spans]
    # Recorded and attached spans carry their given fields in both.
    for spans in (jax_spans, port_spans):
        assert spans[-2]["dur_us"] == 250000.0
        assert spans[-2]["ts"] == 999.75
        assert spans[-1]["trace"] == "cafe0123cafe0123"
        assert spans[-1]["parent"] == "ab12cd34"


def test_jsonl_lines_have_the_same_keys_and_values(tmp_path):
    lines = {}
    for name, mod in (("jax", jax_trace), ("port", trace)):
        path = str(tmp_path / f"{name}.jsonl")
        mod.configure(path)
        _drive_spans(mod)
        mod.configure(None)
        lines[name] = [json.loads(x) for x in open(path)]
    assert [_strip(s) for s in lines["port"]] == \
        [_strip(s) for s in lines["jax"]]
    assert [list(s) for s in lines["port"]] == [list(s) for s in lines["jax"]]


def test_context_env_format_crosses_packages():
    """A context exported by one package is joined by the other."""
    with jax_trace.span("jax-root") as root:
        env = {jax_trace.TRACE_CONTEXT_ENV: jax_trace.context_env()}
    with trace.attach_from_env(env):
        with trace.span("port-child") as child:
            assert (child.trace_id, child.parent_id) == \
                (root.trace_id, root.span_id)
    with trace.span("port-root") as root:
        env = {trace.TRACE_CONTEXT_ENV: trace.context_env()}
    with jax_trace.attach_from_env(env):
        with jax_trace.span("jax-child") as child:
            assert (child.trace_id, child.parent_id) == \
                (root.trace_id, root.span_id)
    assert trace.TRACE_CONTEXT_ENV == jax_trace.TRACE_CONTEXT_ENV


@pytest.mark.parametrize("rate", ["0.0", "0.25", "0.5", "1.0", "bad"])
def test_sampling_decisions_equal(rate, monkeypatch):
    monkeypatch.setenv(trace.TRACE_SAMPLE_ENV, rate)
    trace.reset()
    jax_trace.reset()
    ids = [f"{i * 0x01010101 % (1 << 32):08x}00000000" for i in range(300)]
    ids += ["not-hex", "ffffffffffffffff", "0000000000000000"]
    assert [trace.sampled(i) for i in ids] == \
        [jax_trace.sampled(i) for i in ids]


def test_tail_since_pages_equal():
    trace.configure(ring_capacity=16)
    jax_trace.configure(ring_capacity=16)
    try:
        pages = {}
        for name, mod in (("jax", jax_trace), ("port", trace)):
            for i in range(40):
                with mod.span(f"s{i}"):
                    pass
            got = []
            for cursor, limit in ((0, 5), (20, 3), (30, None), (40, 4),
                                  (-3, 2), (25, 100)):
                spans, nxt, dropped = mod.tail_since(cursor, limit)
                got.append(([s["name"] for s in spans], nxt, dropped))
            pages[name] = got
        assert pages["port"] == pages["jax"]
    finally:
        trace.configure(ring_capacity=trace.DEFAULT_RING_CAPACITY)
        jax_trace.configure(ring_capacity=jax_trace.DEFAULT_RING_CAPACITY)


def _seeded_durations(seed, n=400):
    import numpy as np

    rng = np.random.default_rng(seed)
    # Log-uniform over 0.1 µs .. 10 s: every bucket from 1 µs up.
    return [float(x) for x in 10 ** rng.uniform(-7, 1, size=n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histograms_percentiles_and_exemplars_equal(seed):
    durations = _seeded_durations(seed)
    for mod in (jax_histo, histo):
        for i, d in enumerate(durations):
            mod.observe(f"op{i % 3}", d,
                        trace_id=f"t{i:04d}" if i % 2 else None)
    assert histo.snapshot() == jax_histo.snapshot()
    qs = (0.01, 0.25, 0.5, 0.9, 0.99, 1.0)
    for op in ("op0", "op1", "op2", "missing"):
        assert histo.percentiles(op, qs) == jax_histo.percentiles(op, qs)
        assert histo.exemplar(op) == jax_histo.exemplar(op)
    base = {le: n // 2 for le, n in histo.snapshot()["op1"]["buckets"].items()}
    for q in qs:
        assert histo.delta_percentile_us("op1", base, q) == \
            jax_histo.delta_percentile_us("op1", base, q)
    for s in durations[:50]:
        assert histo.bucket_le_us(s) == jax_histo.bucket_le_us(s)


@pytest.mark.parametrize("seed", [0, 1])
def test_rates_equal_under_an_injected_clock(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    t0 = 10_000.0
    events = [(f"s{int(k)}", float(v), t0 + float(dt)) for k, v, dt in zip(
        rng.integers(0, 6, 500), rng.uniform(0, 100, 500),
        np.sort(rng.uniform(0, 90, 500)))]
    for mod in (jax_timeseries, timeseries):
        for name, value, now in events:
            mod.record(name, value, now=now)
        mod.record("goodput.link.n0->n1", 4096, now=t0 + 89)
        mod.gauge("inflight", 3)
        mod.gauge_add("inflight", -1)
    for window in (1.0, 5.0, 10.0, 64.0, 1000.0):
        for now in (t0 + 89.5, t0 + 95, t0 + 200):
            assert timeseries.rates(window, now=now) == \
                jax_timeseries.rates(window, now=now)
            assert timeseries.snapshot(window, now=now) == \
                jax_timeseries.snapshot(window, now=now)
    assert timeseries.gauges() == jax_timeseries.gauges()
    for name in ("goodput.link.n0->n1", "goodput.flow.a.b", "goodput.",
                 "s1", "goodput.x"):
        assert timeseries.split_goodput(name) == \
            jax_timeseries.split_goodput(name)
    pts = [(float(x), float(y)) for x, y in rng.normal(size=(30, 2))]
    assert timeseries.least_squares_slope(pts) == \
        jax_timeseries.least_squares_slope(pts)


def test_counters_feed_the_same_rates():
    for c in (jax_counters, counters):
        c.inc("health.unhealthy", 3)
        c.inc("kubelet.register.failed")
    now = time.monotonic()
    assert {k: v for k, v in timeseries.rates(10, now=now).items()} == \
        {k: v for k, v in jax_timeseries.rates(10, now=now).items()}
    assert counters.snapshot() == jax_counters.snapshot()


PROM_TEXT = """# HELP agent_events Cumulative events
# TYPE agent_events gauge
agent_events{event="health.unhealthy"} 3.0
agent_latency{op="plugin.allocate",bucket="128"} 97.0
agent_latency{op="plugin.allocate",bucket="+Inf"} 100.0
agent_exemplar{op="plugin.allocate",bucket="1024",trace="9f2c0011aa"} 812.5
agent_gauge{name="slo.a\\nb.ok"} 1.0
agent_rate{event="x\\"y"} 0.5
unlabelled 7
broken{line 1
not_a_float{a="b"} NaNish

duty_cycle_gpu_node{make="nvidia",accelerator_id="nvidia0",model="H100"} 78
"""


def test_promtext_parse_equal():
    port = promtext.parse_samples(PROM_TEXT)
    assert port == jax_promtext.parse_samples(PROM_TEXT)
    assert port["agent_events"] == [({"event": "health.unhealthy"}, 3.0)]
    assert port["unlabelled"] == [({}, 7.0)]
    assert "broken" not in port and "not_a_float" not in port


def test_flight_snapshot_has_the_same_keys(monkeypatch):
    monkeypatch.setenv(flight.FLIGHT_SPANS_ENV, "4")
    blobs = {}
    for name, (tr, c, ts, fl) in (
            ("jax", (jax_trace, jax_counters, jax_timeseries, jax_flight)),
            ("port", (trace, counters, timeseries, flight))):
        for i in range(6):
            with tr.span(f"s{i}", histogram="op"):
                c.inc("flight.test")
        ts.gauge("slo.min_qps.ok", 1)
        blobs[name] = fl.snapshot("parity")
    jax_blob, port_blob = blobs["jax"], blobs["port"]
    assert sorted(port_blob) == sorted(jax_blob)
    assert sorted(port_blob["profile"]) == sorted(jax_blob["profile"])
    assert sorted(port_blob["rates"]) == sorted(jax_blob["rates"])
    assert [_strip(s) for s in port_blob["spans"]] == \
        [_strip(s) for s in jax_blob["spans"]]
    assert port_blob["counters"] == jax_blob["counters"]
    assert port_blob["slo"] == jax_blob["slo"] == {"slo.min_qps.ok": 1.0}
    assert port_blob["histograms"]["op"]["count"] == \
        jax_blob["histograms"]["op"]["count"] == 6
    assert port_blob["flight_recorder"] == jax_blob["flight_recorder"] == 1
    assert flight.STDERR_MARKER == jax_flight.STDERR_MARKER


@pytest.mark.parametrize("name", [
    "TRACE_FILE_ENV", "RING_CAPACITY_ENV", "TRACE_SAMPLE_ENV",
    "TRACE_CONTEXT_ENV", "TRACE_MAX_BYTES_ENV", "DEFAULT_RING_CAPACITY"])
def test_trace_knobs_keep_the_jax_names(name):
    assert getattr(trace, name) == getattr(jax_trace, name)


def test_other_knobs_keep_the_jax_names():
    from container_engine_accelerators_tpu.obs import (
        anomaly as jax_anomaly,
        history as jax_history,
        profiler as jax_profiler,
    )
    from container_engine_accelerators_tpu_torch.obs import (
        anomaly,
        history,
        profiler,
    )

    assert (flight.FLIGHT_FILE_ENV, flight.FLIGHT_SPANS_ENV) == \
        (jax_flight.FLIGHT_FILE_ENV, jax_flight.FLIGHT_SPANS_ENV)
    assert (profiler.PROF_ENV, profiler.HZ_ENV) == \
        (jax_profiler.PROF_ENV, jax_profiler.HZ_ENV)
    assert timeseries.RATE_WINDOW_ENV == jax_timeseries.RATE_WINDOW_ENV
    assert (history.HISTORY_DIR_ENV, history.HISTORY_CAP_ENV) == \
        (jax_history.HISTORY_DIR_ENV, jax_history.HISTORY_CAP_ENV)
    assert anomaly.KILL_SWITCH_ENV == jax_anomaly.KILL_SWITCH_ENV


# ---------------------------------------------------------------------------
# The import contract
# ---------------------------------------------------------------------------

_BLOCKED = ("torch", "prometheus_client", "grpc", "jax",
            "container_engine_accelerators_tpu")


def test_obs_imports_no_torch_prometheus_grpc_or_jax_package():
    """The node DaemonSet's image carries none of these: the port's obs/
    (and the counters it dumps) must import and work without them, and
    must not pull any of them in."""
    code = f"""
import builtins, sys
BLOCKED = {_BLOCKED!r}
real_import = builtins.__import__
def guarded(name, *args, **kwargs):
    if name.split(".")[0] in BLOCKED:
        raise ImportError("blocked: " + name)
    return real_import(name, *args, **kwargs)
builtins.__import__ = guarded
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import (
    anomaly, critpath, flight, histo, history, profiler, promtext,
    timeseries, trace)
from container_engine_accelerators_tpu_torch.utils import faults, retry
with trace.span("bare", histogram="bare.op"):
    counters.inc("bare.counter")
timeseries.record("goodput.link.a->b", 4096)
assert profiler.sample_once() >= 0
profiler.ingest("bare.stack", "other", 2)
blob = flight.dump("no-deps")
assert blob["histograms"]["bare.op"]["count"] == 1
assert blob["counters"]["bare.counter"] == 1
assert blob["rates"]["rates"]["bare.counter"] > 0
assert blob["profile"]["samples"] >= 2
assert histo.exemplar("bare.op") is not None
assert trace.tail(1)[0]["name"] == "bare"
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout
