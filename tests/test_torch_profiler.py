"""The port's continuous profiler (``obs/profiler.py``) against the JAX
package's.

The JAX package's cases (classification, knobs, bounded aggregation and
cursors, the flight recorder's slice, the ``/profile`` endpoint and the
``agent_prof`` tool), run against the port's modules and its
MetricServer; then parity on the same inputs: fold and classify on
synthetic frames (equal, since labels are package-relative), cursor
paging, the LRU bound and ``subsystem_shares``.
"""

import importlib
import json
import os
import sys
import threading
import time
import types
import urllib.request

import numpy as np
import pytest
from prometheus_client import CollectorRegistry

from container_engine_accelerators_tpu.obs import profiler as jax_profiler
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.metrics.metrics import MetricServer
from container_engine_accelerators_tpu_torch.obs import (
    flight,
    profiler,
    timeseries,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PKG = os.path.join(REPO, "container_engine_accelerators_tpu_torch")
JAX_PKG = os.path.join(REPO, "container_engine_accelerators_tpu")

FAST_BIND = RetryPolicy(max_attempts=8, initial_backoff_s=0.05,
                        max_backoff_s=0.2, deadline_s=10.0)


@pytest.fixture(autouse=True)
def clean_profiler():
    profiler.reset()
    jax_profiler.reset()
    yield
    profiler.reset()
    jax_profiler.reset()


def _load_cli(name):
    return importlib.import_module(
        f"container_engine_accelerators_tpu_torch.cmd.{name}")


def _server(tmp_path):
    class _NoGpus:
        def collect_gpu_device(self, name):  # pragma: no cover
            raise RuntimeError("no GPUs")

        def devices(self):
            return []

        def model(self, name):  # pragma: no cover
            return "none"

    return MetricServer(
        collector=_NoGpus(),
        registry=CollectorRegistry(),
        pod_resources_socket=str(tmp_path / "missing.sock"),
        port=0,
        collection_interval_s=3600,
    )


# ---------------------------------------------------------------------------
# The JAX package's cases, against the port's modules
# ---------------------------------------------------------------------------


class TestClassify:
    def test_subsystem_map(self):
        assert profiler.classify(
            [("parallel/dcn_shm.py", "post")]) == "shm-staging"
        assert profiler.classify(
            [("parallel/dcn_pipeline.py", "_shm_stage")]) \
            == "shm-staging"
        assert profiler.classify(
            [("parallel/dcn_pipeline.py", "_send_worker")]) \
            == "dcn_pipeline"
        assert profiler.classify(
            [("parallel/dcn.py", "wait_flow_rx")]) == "dcn_pipeline"
        assert profiler.classify(
            [("fleet/xferd.py", "_recv_and_land")]) == "xferd"
        assert profiler.classify(
            [("serving/frontend.py", "_dispatch")]) == "serving"
        assert profiler.classify(
            [("utils/retry.py", "call")]) == "other"
        assert profiler.classify([]) == "other"

    def test_idle_heuristic_is_stdlib_leaf_only(self):
        # A stdlib waiter at the leaf = parked thread.
        assert profiler.classify(
            [(None, "wait"), (None, "run")]) == "idle"
        assert profiler.classify(
            [(None, "accept"), ("fleet/xferd.py", "_accept_loop")]) \
            == "idle"
        # The same function name in FIRST-PARTY code is not idle —
        # the GIL half of the heuristic: blocked-in-first-party IO
        # stays attributed to its subsystem.
        assert profiler.classify(
            [("fleet/xferd.py", "wait"), (None, "run")]) == "xferd"

    def test_shm_wins_over_the_whole_stack(self):
        """A stack passing through shm machinery anywhere is
        shm-staging, even when its leaf-side helpers (control ops,
        span plumbing) are pipeline/client frames — otherwise the
        staging memcpy's samples land on whatever GIL-release point
        follows the copy."""
        assert profiler.classify([
            (None, "_new_id"),
            ("parallel/dcn_client.py", "_call"),
            ("parallel/dcn_client.py", "shm_commit"),
            ("parallel/dcn_pipeline.py", "_shm_stage"),
        ]) == "shm-staging"

    def test_fold_current_frame_labels_and_order(self):
        folded, subsystem = profiler.fold(sys._getframe())
        # Root-first: this test function is the LAST label.
        assert folded.endswith(
            "test_fold_current_frame_labels_and_order")
        assert ";" in folded
        assert subsystem == "other"

    def test_sample_once_sees_parked_thread_as_idle(self):
        ev = threading.Event()
        t = threading.Thread(target=ev.wait, name="parked",
                             daemon=True)
        t.start()
        try:
            time.sleep(0.05)
            n = profiler.sample_once()
            assert n >= 1
            snap = profiler.snapshot()
            assert snap["samples"] == n
            assert snap["subsystems"].get("idle", 0) >= 1
            assert any("threading.wait" in e["stack"]
                       for e in snap["stacks"])
        finally:
            ev.set()
            t.join(timeout=5)

    def test_sampler_excludes_its_own_thread(self):
        """sample_once never records the calling thread — the sampler
        must not profile itself into every scrape."""
        profiler.sample_once()
        me = "test_sampler_excludes_its_own_thread"
        assert not any(me in e["stack"]
                       for e in profiler.snapshot()["stacks"])


# ---------------------------------------------------------------------------
# knobs: kill switch, rate, malformed degrade
# ---------------------------------------------------------------------------


class TestKnobs:
    def test_kill_switch_disables_start(self, monkeypatch):
        monkeypatch.setenv(profiler.PROF_ENV, "0")
        assert profiler.enabled() is False
        assert profiler.start() is False
        assert profiler.running() is False

    def test_default_is_enabled(self, monkeypatch):
        monkeypatch.delenv(profiler.PROF_ENV, raising=False)
        assert profiler.enabled() is True

    @pytest.mark.parametrize("raw", ["nope", "", "-5", "0"])
    def test_malformed_hz_degrades_to_default(self, raw, monkeypatch):
        monkeypatch.setenv(profiler.HZ_ENV, raw)
        assert profiler.resolve_hz() == profiler.DEFAULT_HZ

    def test_hz_clamped(self, monkeypatch):
        monkeypatch.setenv(profiler.HZ_ENV, "999999")
        assert profiler.resolve_hz() == profiler.MAX_HZ
        monkeypatch.setenv(profiler.HZ_ENV, "0.01")
        assert profiler.resolve_hz() == profiler.MIN_HZ

    def test_start_stop_thread_lifecycle(self):
        assert profiler.start(hz=200) is True
        assert profiler.running()
        assert profiler.start(hz=200) is True  # idempotent
        deadline = time.monotonic() + 5
        while profiler.snapshot()["samples"] == 0:
            assert time.monotonic() < deadline, "sampler never sampled"
            time.sleep(0.01)
        profiler.stop()
        assert not profiler.running()
        # Registry survives stop (the scrape surface stays readable).
        assert profiler.snapshot()["samples"] > 0

    def test_overhead_ratio_gauge_published(self):
        profiler.sample_once()
        time.sleep(0.01)
        profiler.sample_once()
        snap = profiler.snapshot()
        assert snap["overhead_ratio"] is not None
        assert 0.0 <= snap["overhead_ratio"] <= 1.0
        assert "prof.overhead_ratio" in timeseries.gauges()

    def test_overhead_ratio_at_most_one_over_many_deep_threads(self):
        """The first pass's fold counts in the wall time too: over 800
        idle threads 150 frames deep the fold takes longer than the gap
        between two passes, and a clock started after it read above 1."""
        release = threading.Event()
        ready = threading.Semaphore(0)

        def deep(n):
            if n:
                return deep(n - 1)
            ready.release()
            release.wait()

        threads = [threading.Thread(target=deep, args=(150,), daemon=True)
                   for _ in range(800)]
        try:
            for t in threads:
                t.start()
            for _ in threads:
                ready.acquire()
            profiler.sample_once()
            time.sleep(0.01)
            profiler.sample_once()
            ratio = profiler.snapshot()["overhead_ratio"]
        finally:
            release.set()
            for t in threads:
                t.join()
        assert ratio is not None and 0.0 < ratio <= 1.0


# ---------------------------------------------------------------------------
# bounded aggregation + cursor semantics
# ---------------------------------------------------------------------------


class TestAggregation:
    def test_top_k_lru_bound_counts_dropped(self):
        d0 = counters.get("prof.dropped")
        with_lock_samples = 0
        for i in range(profiler.MAX_STACKS + 40):
            profiler.ingest(f"root.r;leaf.f{i}", "other", 2)
            with_lock_samples += 2
        snap = profiler.snapshot()
        assert len(snap["stacks"]) <= profiler.MAX_STACKS
        assert snap["dropped"] > 0
        # Dropped + retained = everything ever sampled: nothing is
        # silently lost.
        retained = sum(e["count"] for e in snap["stacks"])
        assert retained + snap["dropped"] == with_lock_samples
        assert snap["samples"] == with_lock_samples
        # ingest seeds the registry without claiming real sampling —
        # but real sampling (sample_once) feeds prof.dropped.
        assert counters.get("prof.dropped") == d0

    def test_sample_once_feeds_prof_counters(self):
        s0 = counters.get("prof.samples")
        n = profiler.sample_once()
        assert counters.get("prof.samples") == s0 + n

    def test_cursor_pages_only_changes(self):
        profiler.ingest("a.a;b.b", "xferd", 3)
        first = profiler.scrape(since=0)
        assert [e["stack"] for e in first["stacks"]] == ["a.a;b.b"]
        cursor = first["cursor"]
        assert profiler.scrape(since=cursor)["stacks"] == []
        profiler.ingest("c.c;d.d", "serving", 1)
        second = profiler.scrape(since=cursor)
        assert [e["stack"] for e in second["stacks"]] == ["c.c;d.d"]
        # Totals stay cumulative whatever the cursor.
        assert second["samples"] == 4

    def test_snapshot_top_is_count_ordered(self):
        profiler.ingest("hot.h", "other", 10)
        profiler.ingest("warm.w", "other", 5)
        profiler.ingest("cold.c", "other", 1)
        rows = profiler.snapshot(top=2)["stacks"]
        assert [e["stack"] for e in rows] == ["hot.h", "warm.w"]

    def test_truncated_page_never_skips_rows(self):
        """The /spans cursor contract on /profile: when `limit`
        truncates a page, the cursor advances only past what was
        returned — paging forward delivers EVERY changed stack, and
        any re-delivered rows are idempotent (counts cumulative)."""
        for i in range(10):
            profiler.ingest(f"s.f{i}", "other", 1)
        seen = {}
        cursor = 0
        for _page in range(10):
            resp = profiler.scrape(since=cursor, limit=3)
            if not resp["stacks"]:
                break
            for e in resp["stacks"]:
                seen[e["stack"]] = e["count"]
            assert resp["cursor"] > cursor  # monotonic progress
            cursor = resp["cursor"]
        assert len(seen) == 10
        assert all(c == 1 for c in seen.values())

    def test_reset_clears_everything(self):
        profiler.ingest("x.y", "other", 5)
        profiler.reset()
        snap = profiler.snapshot()
        assert snap["samples"] == 0 and snap["stacks"] == []
        assert snap["subsystems"] == {}

    def test_subsystem_shares_excludes_idle_and_deltas(self):
        profiler.ingest("a.a", "idle", 80)
        profiler.ingest("b.b", "xferd", 15)
        profiler.ingest("c.c", "shm-staging", 5)
        base = profiler.snapshot()["subsystems"]
        shares = profiler.subsystem_shares()
        assert shares["xferd"] == pytest.approx(0.75)
        assert shares["shm-staging"] == pytest.approx(0.25)
        assert "idle" not in shares
        profiler.ingest("c.c", "shm-staging", 10)
        delta = profiler.subsystem_shares(baseline=base)
        assert delta == {"shm-staging": pytest.approx(1.0)}
        assert profiler.subsystem_shares(
            baseline=profiler.snapshot()["subsystems"]) == {}


# ---------------------------------------------------------------------------
# flight recorder rides along
# ---------------------------------------------------------------------------


class TestFlightProfile:
    def test_flight_snapshot_carries_top_stacks(self):
        profiler.ingest("hot.spot;deep.er", "xferd", 9)
        blob = flight.snapshot("unit")
        prof = blob["profile"]
        assert prof["samples"] == 9
        assert prof["top"][0]["stack"] == "hot.spot;deep.er"
        assert prof["subsystems"] == {"xferd": 9}


# ---------------------------------------------------------------------------
# /profile endpoint (MetricServer)
# ---------------------------------------------------------------------------


class TestProfileEndpoint:
    def _get(self, port, query=""):
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/profile{query}",
                timeout=10) as resp:
            return json.loads(resp.read().decode())

    def test_scrape_pages_and_bounds(self, tmp_path):
        profiler.ingest("srv.a;srv.b", "dcn_pipeline", 4)
        server = _server(tmp_path)
        server.start(retry=FAST_BIND)
        try:
            obj = self._get(server.port)
            assert obj["samples"] == 4
            assert obj["stacks"][0]["stack"] == "srv.a;srv.b"
            assert obj["hz"] == profiler.resolve_hz()
            # Cursor paging: nothing new -> empty stacks, same cursor.
            again = self._get(server.port, f"?since={obj['cursor']}")
            assert again["stacks"] == []
            profiler.ingest("srv.c", "xferd", 1)
            fresh = self._get(server.port, f"?since={obj['cursor']}")
            assert [e["stack"] for e in fresh["stacks"]] == ["srv.c"]
            # limit caps rows.
            profiler.ingest("srv.d", "xferd", 9)
            capped = self._get(server.port, "?limit=1")
            assert len(capped["stacks"]) == 1
        finally:
            server.stop()

    def test_malformed_query_degrades_not_500s(self, tmp_path):
        profiler.ingest("m.a", "other", 2)
        server = _server(tmp_path)
        server.start(retry=FAST_BIND)
        try:
            obj = self._get(server.port, "?since=garbage&limit=wat")
            assert obj["samples"] == 2
            assert len(obj["stacks"]) == 1
        finally:
            server.stop()

    def test_metrics_endpoint_untouched_beside_profile(self, tmp_path):
        """/profile joins /metrics and /spans on one listener; the
        prometheus exposition keeps serving."""
        server = _server(tmp_path)
        server.start(retry=FAST_BIND)
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics",
                    timeout=10) as resp:
                assert resp.status == 200
        finally:
            server.stop()


# ---------------------------------------------------------------------------
# agent_prof CLI
# ---------------------------------------------------------------------------


class TestAgentProfCli:
    def test_live_scrape_renders_table(self, tmp_path, capsys):
        profiler.ingest("live.a;live.b", "shm-staging", 6)
        profiler.ingest("live.idle", "idle", 4)
        server = _server(tmp_path)
        server.start(retry=FAST_BIND)
        try:
            prof_cli = _load_cli("agent_prof")
            rc = prof_cli.main(["--port", str(server.port)])
        finally:
            server.stop()
        out = capsys.readouterr().out
        assert rc == 0
        assert "live.a;live.b" in out
        assert "shm-staging" in out
        assert "samples 10" in out

    def test_folded_output_is_collapsed_format(self, tmp_path, capsys):
        profiler.ingest("r.a;l.b", "xferd", 7)
        server = _server(tmp_path)
        server.start(retry=FAST_BIND)
        try:
            prof_cli = _load_cli("agent_prof")
            rc = prof_cli.main(["--port", str(server.port),
                                "--folded"])
        finally:
            server.stop()
        assert rc == 0
        assert "r.a;l.b 7" in capsys.readouterr().out.splitlines()

    def test_report_file_fleet_and_node_views(self, tmp_path, capsys):
        report = {
            "profile": {
                "nodes": {
                    "n0": {"samples": 5, "dropped": 0,
                           "subsystems": {"xferd": 5},
                           "top": [{"stack": "n0.stack",
                                    "subsystem": "xferd",
                                    "count": 5}]},
                },
                "fleet": {"samples": 5, "dropped": 0,
                          "subsystems": {"xferd": 5},
                          "top": [{"stack": "n0.stack",
                                   "subsystem": "xferd",
                                   "count": 5}]},
            },
        }
        path = str(tmp_path / "report.json")
        with open(path, "w") as f:
            json.dump(report, f)
        prof_cli = _load_cli("agent_prof")
        assert prof_cli.main([path]) == 0
        assert "n0.stack" in capsys.readouterr().out
        assert prof_cli.main([path, "--node", "n0",
                              "--subsystem"]) == 0
        out = capsys.readouterr().out
        assert "xferd" in out
        # A node the report never profiled is a clear error, not a
        # stack trace.
        assert prof_cli.main([path, "--node", "nope"]) == 1
        assert "no profile entry" in capsys.readouterr().err

    def test_scrape_failure_exits_1(self, capsys):
        from tests.mp_runner import free_port

        prof_cli = _load_cli("agent_prof")
        assert prof_cli.main(["--port", str(free_port())]) == 1
        assert "failed" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# Parity with the JAX package's profiler
# ---------------------------------------------------------------------------


def test_package_prefix_is_the_ports_own_directory():
    assert profiler._PKG_PREFIX == \
        os.path.abspath(PORT_PKG).replace(os.sep, "/") + "/"
    assert jax_profiler._PKG_PREFIX == \
        os.path.abspath(JAX_PKG).replace(os.sep, "/") + "/"


def test_subsystem_tables_are_the_jax_packages():
    assert profiler.SUBSYSTEMS == jax_profiler.SUBSYSTEMS
    assert profiler._DCN_PIPELINE_FILES == jax_profiler._DCN_PIPELINE_FILES
    assert profiler.IDLE_FUNCS == jax_profiler.IDLE_FUNCS
    assert (profiler.MAX_STACKS, profiler.MAX_DEPTH,
            profiler.SCRAPE_DEFAULT_LIMIT, profiler.SCRAPE_MAX_LIMIT) == \
        (jax_profiler.MAX_STACKS, jax_profiler.MAX_DEPTH,
         jax_profiler.SCRAPE_DEFAULT_LIMIT, jax_profiler.SCRAPE_MAX_LIMIT)


# Synthetic stacks, leaf first: (package-relative path or a stdlib file
# name, function).  A relative path lies inside the package.
STACKS = [
    [("parallel/dcn_shm.py", "post")],
    [("parallel/dcn_pipeline.py", "_shm_stage"), ("cmd/x.py", "main")],
    [("parallel/dcn_pipeline.py", "_send_worker")],
    [("parallel/dcn.py", "wait_flow_rx"), ("threading.py", "run")],
    [("fleet/xferd.py", "_recv_and_land"), ("threading.py", "run")],
    [("serving/frontend.py", "_dispatch")],
    [("threading.py", "wait"), ("threading.py", "run")],
    [("selectors.py", "select"), ("socketserver.py", "serve_forever")],
    [("fleet/xferd.py", "wait"), ("threading.py", "run")],
    [("queue.py", "get"), ("deviceplugin/service.py", "ListAndWatch")],
    [("health/health_checker.py", "_listen_to_events"),
     ("threading.py", "run")],
    [("uuid.py", "_new_id"), ("parallel/dcn_client.py", "_call"),
     ("parallel/dcn_client.py", "shm_commit"),
     ("parallel/dcn_pipeline.py", "_shm_stage")],
    [("utils/retry.py", "call")],
    [],
]


def _frames(stack, prefix):
    """A chain of frame-like objects for ``fold``, leaf first."""
    frame = None
    for path, func in reversed(stack):
        filename = ("/usr/lib/python3.12/" + path if "/" not in path
                    else prefix + path)
        frame = types.SimpleNamespace(
            f_code=types.SimpleNamespace(co_filename=filename, co_name=func),
            f_back=frame)
    return frame


def _rel(stack):
    return [(path if "/" in path else None, func) for path, func in stack]


@pytest.mark.parametrize("stack", STACKS, ids=range(len(STACKS)))
def test_fold_and_classify_equal_on_synthetic_frames(stack):
    assert profiler.classify(_rel(stack)) == \
        jax_profiler.classify(_rel(stack))
    if stack:
        port = profiler.fold(_frames(stack, profiler._PKG_PREFIX))
        jax = jax_profiler.fold(_frames(stack, jax_profiler._PKG_PREFIX))
        assert port == jax


def test_a_deep_stack_folds_to_the_same_depth():
    stack = [("serving/frontend.py", f"f{i}") for i in range(100)]
    port = profiler.fold(_frames(stack, profiler._PKG_PREFIX))
    jax = jax_profiler.fold(_frames(stack, jax_profiler._PKG_PREFIX))
    assert port == jax
    assert port[0].count(";") == profiler.MAX_DEPTH - 1


def _seeded_ingests(seed, n):
    rng = np.random.default_rng(seed)
    subs = list(profiler.SUBSYSTEMS) + ["not-a-subsystem"]
    return [(f"root.r;mid.m{int(a)};leaf.f{int(b)}", subs[int(s)], int(c))
            for a, b, s, c in zip(rng.integers(0, 30, n),
                                  rng.integers(0, 20, n),
                                  rng.integers(0, len(subs), n),
                                  rng.integers(1, 9, n))]


def _comparable(payload):
    return {k: v for k, v in payload.items()
            if k not in ("overhead_ratio", "running")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lru_bound_cursor_paging_and_shares_equal(seed):
    """More distinct stacks than MAX_STACKS: the same evictions, the
    same dropped counts, the same pages and shares."""
    ingests = _seeded_ingests(seed, 900)
    baselines = {}
    pages = {}
    for name, mod in (("jax", jax_profiler), ("port", profiler)):
        got = []
        for i, (folded, sub, n) in enumerate(ingests):
            mod.ingest(folded, sub, n)
            if i == 450:
                baselines[name] = mod.snapshot()["subsystems"]
            if i % 150 == 149:
                cursor = 0
                while True:
                    page = mod.scrape(since=cursor, limit=37)
                    got.append(_comparable(page))
                    if not page["stacks"]:
                        break
                    cursor = page["cursor"]
        got.append(_comparable(mod.snapshot()))
        got.append(_comparable(mod.snapshot(top=10)))
        got.append(mod.subsystem_shares())
        got.append(mod.subsystem_shares(include_idle=True))
        got.append(mod.subsystem_shares(baseline=baselines[name]))
        summary = mod.summary(top=5)
        summary.pop("overhead_ratio")
        got.append(summary)
        pages[name] = got
    assert pages["port"] == pages["jax"]
    assert pages["port"][-7]["dropped"] > 0  # the LRU bound was reached


@pytest.mark.parametrize("env", [{}, {"TPU_PROF": "0"}, {"TPU_PROF": "off"},
                                 {"TPU_PROF_HZ": "250"},
                                 {"TPU_PROF_HZ": "junk"},
                                 {"TPU_PROF_HZ": "1e9"}])
def test_knobs_resolve_equal(env):
    assert profiler.enabled(env) == jax_profiler.enabled(env)
    assert profiler.resolve_hz(env) == jax_profiler.resolve_hz(env)
