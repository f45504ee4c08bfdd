"""The port's run ledger and trend engine (``obs/history.py``) against
the JAX package's.

The JAX package's cases (the ledger's append, read, rotation and torn
lines, the baseline math, trend verdicts with attribution, fleet report
evidence and the ``agent_trend`` tool) run against the port's modules;
then ``median``, ``mad``, ``learned_limit`` and ``trend_verdict`` on
seeded series give equal results in both packages, and each package
reads the other's ledger.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from container_engine_accelerators_tpu.obs import history as jax_history
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import history

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_cli(name):
    return importlib.import_module(
        f"container_engine_accelerators_tpu_torch.cmd.{name}")


@pytest.fixture(autouse=True)
def _no_ambient_history(monkeypatch):
    """Tests drive the ledger through explicit roots: an operator's
    TPU_HISTORY_DIR must never leak in (or be written to)."""
    monkeypatch.delenv(history.HISTORY_DIR_ENV, raising=False)
    monkeypatch.delenv(history.HISTORY_CAP_ENV, raising=False)


def _prior(values, metric="p99_ms", cpu_attr=None, phase=None):
    return [{"metrics": {metric: v},
             **({"cpu_attr": cpu_attr} if cpu_attr else {}),
             **({"dominant_phase": phase} if phase else {})}
            for v in values]


# ---------------------------------------------------------------------------
# The JAX package's cases, against the port's modules
# ---------------------------------------------------------------------------


class TestRunLedger:
    def test_record_round_trip(self, tmp_path):
        led = history.RunLedger(str(tmp_path))
        rec = led.record("dcn_bench", "dcn_bench:shm:4096",
                         {"mbps": 1234.5}, run_id="r1", seed=7,
                         cpu_attr={"shm-staging": 0.6, "other": 0.4},
                         dominant_phase="dcn.shm.stage",
                         sentinels={"leak_slopes": {"fds": 0.1}},
                         slo={"ok": True})
        assert rec["schema"] == history.SCHEMA_VERSION
        assert rec["version"]  # VERSION stamp (or "unknown")
        got = led.records(kind="dcn_bench",
                          cfg_key="dcn_bench:shm:4096")
        assert len(got) == 1
        assert got[0]["run_id"] == "r1"
        assert got[0]["seed"] == 7
        assert got[0]["metrics"] == {"mbps": 1234.5}
        assert got[0]["cpu_attr"]["shm-staging"] == 0.6
        assert got[0]["dominant_phase"] == "dcn.shm.stage"
        assert got[0]["sentinels"]["leak_slopes"]["fds"] == 0.1
        assert got[0]["slo"] == {"ok": True}

    def test_filters(self, tmp_path):
        led = history.RunLedger(str(tmp_path))
        led.record("a", "k1", {"x": 1.0})
        led.record("a", "k2", {"y": 2.0})
        led.record("b", "k1", {"x": 3.0})
        assert len(led.records()) == 3
        assert len(led.records(kind="a")) == 2
        assert len(led.records(cfg_key="k1")) == 2
        assert len(led.records(metric="y")) == 1
        assert len(led.records(kind="a", cfg_key="k1",
                               metric="x")) == 1

    def test_unconfigured_env_is_silently_off(self):
        led = history.RunLedger()
        assert not led.enabled
        assert led.record("k", "c", {"m": 1.0}) is None
        assert led.records() == []

    def test_torn_final_line_is_counted_skip(self, tmp_path):
        """A writer killed mid-append leaves a torn last line: the
        read side skips it, counts it, and returns every whole
        record — never a crash."""
        led = history.RunLedger(str(tmp_path))
        led.record("k", "c", {"m": 1.0}, run_id="whole")
        with open(led.path, "ab") as fh:
            fh.write(b'{"schema": 1, "run_id": "torn", "metr')
        before = counters.get("history.skipped")
        got = led.records()
        assert [r["run_id"] for r in got] == ["whole"]
        assert counters.get("history.skipped") == before + 1

    def test_corrupt_and_wrong_shape_lines_skipped(self, tmp_path):
        led = history.RunLedger(str(tmp_path))
        led.record("k", "c", {"m": 1.0}, run_id="good")
        with open(led.path, "ab") as fh:
            fh.write(b"\xff\xfe not json\n")      # undecodable
            fh.write(b'"a json string"\n')         # not a dict
            fh.write(b'{"no": "metrics"}\n')       # not a run record
        before = counters.get("history.skipped")
        assert [r["run_id"] for r in led.records()] == ["good"]
        assert counters.get("history.skipped") == before + 3

    def test_rotation_keeps_one_generation(self, tmp_path):
        """Past the cap the live file becomes ``.1`` (the trace-sink
        discipline) and reads stitch rotated-then-live oldest
        first."""
        led = history.RunLedger(str(tmp_path), cap_bytes=600)
        before = counters.get("history.rotated")
        for i in range(12):
            led.record("k", "c", {"m": float(i)}, run_id=f"r{i}")
        assert os.path.exists(led.path + ".1")
        assert counters.get("history.rotated") > before
        got = led.records()
        # Whatever survived rotation is in append order, the newest
        # record always last (it just went to the live file).
        vals = [r["metrics"]["m"] for r in got]
        assert vals == sorted(vals)
        assert vals[-1] == 11.0

    def test_concurrent_append_two_processes(self, tmp_path):
        """Two recorders appending concurrently interleave WHOLE
        lines (single O_APPEND write per record): every record
        parses, none are lost or torn."""
        script = (
            "import sys; sys.path.insert(0, sys.argv[1])\n"
            "from container_engine_accelerators_tpu_torch.obs import "
            "history\n"
            "led = history.RunLedger(sys.argv[2], cap_bytes=0)\n"
            "for i in range(120):\n"
            "    led.record('k', 'c', {'m': float(i)},\n"
            "               run_id=f'{sys.argv[3]}-{i}',\n"
            "               cpu_attr={'serving': 0.5, 'other': 0.5})\n"
        )
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", script, REPO, str(tmp_path),
                 tag])
            for tag in ("a", "b")
        ]
        for p in procs:
            assert p.wait(timeout=60) == 0
        before = counters.get("history.skipped")
        got = history.RunLedger(str(tmp_path)).records()
        assert counters.get("history.skipped") == before
        ids = [r["run_id"] for r in got]
        assert len(ids) == 240 and len(set(ids)) == 240

    def test_malformed_dir_disables_with_counted_event(self, tmp_path):
        """TPU_HISTORY_DIR pointing at a FILE cannot hold a ledger:
        recording turns off loudly (history.disabled) and every
        record is a no-op — the run itself is untouched."""
        bogus = tmp_path / "not-a-dir"
        bogus.write_text("occupied")
        before = counters.get("history.disabled")
        led = history.RunLedger(str(bogus))
        assert not led.enabled
        assert counters.get("history.disabled") == before + 1
        assert led.record("k", "c", {"m": 1.0}) is None
        assert led.records() == []

    def test_env_resolution(self, tmp_path, monkeypatch):
        monkeypatch.setenv(history.HISTORY_DIR_ENV, str(tmp_path))
        led = history.RunLedger()
        assert led.enabled
        led.record("k", "c", {"m": 2.0})
        assert len(history.RunLedger().records()) == 1

    def test_unreadable_ledger_raises_ledger_error(self, tmp_path):
        led = history.RunLedger(str(tmp_path))
        # A directory squatting on the ledger path: exists, cannot be
        # read as a file — the exit-2 signal, distinct from "empty".
        os.mkdir(led.path)
        with pytest.raises(history.LedgerError):
            led.records()


class TestBaselineMath:
    def test_median_and_mad(self):
        assert history.median([3, 1, 2]) == 2
        assert history.median([4, 1, 2, 3]) == 2.5
        assert history.median([]) == 0.0
        assert history.mad([1, 1, 1]) == 0.0
        # values 1..5: deviations from median 3 are [2,1,0,1,2]
        assert history.mad([1, 2, 3, 4, 5]) == 1.0

    def test_metric_direction(self):
        assert history.metric_direction("p99_e2e_ms") == "lower"
        assert history.metric_direction("leak_slope.fds") == "lower"
        assert history.metric_direction("max_dedup_ratio") == "lower"
        assert history.metric_direction("min_goodput_bps") == "higher"
        assert history.metric_direction("mbps") == "higher"
        # Unknown names default to throughput-shaped.
        assert history.metric_direction("frobnications") == "higher"

    def test_learned_limit_pinned_fallback(self):
        out = history.learned_limit([0.4, 0.5], pinned=2.0,
                                    min_runs=3)
        assert out["source"] == "pinned"
        assert out["limit"] == 2.0

    def test_learned_limit_tightens_ceiling(self):
        out = history.learned_limit([0.4, 0.5, 0.45, 0.5, 0.4],
                                    pinned=2.0, min_runs=3)
        assert out["source"] == "learned"
        # median 0.45 + 3*max(MAD 0.05, floor) — far below pinned.
        assert 0.45 < out["limit"] < 1.0
        assert out["ceiling"] == 2.0

    def test_learned_limit_never_relaxes_past_pinned(self):
        """History worse than the pinned budget must not loosen it:
        the ceiling clamp is the hard bound."""
        out = history.learned_limit([5.0, 6.0, 5.5, 6.5],
                                    pinned=2.0, min_runs=3)
        assert out["source"] == "learned"
        assert out["limit"] == 2.0

    def test_learned_limit_floor_kind(self):
        """Floor-shaped budgets (min_goodput_bps) learn median -
        k*MAD and may only come UP from the pinned floor."""
        out = history.learned_limit([100.0, 102.0, 98.0, 101.0],
                                    pinned=10.0, min_runs=3,
                                    kind="floor")
        assert out["source"] == "learned"
        assert 10.0 < out["limit"] < 100.0
        # A pinned floor ABOVE history: learned may not sink past it.
        out = history.learned_limit([100.0, 102.0, 98.0],
                                    pinned=99.0, min_runs=3,
                                    kind="floor")
        assert out["limit"] == 99.0


class TestTrendVerdict:
    def test_no_baseline_when_thin(self):
        v = history.trend_verdict(_prior([40.0, 41.0]), "p99_ms",
                                  44.0)
        assert v["status"] == "no_baseline" and v["ok"]

    def test_ok_inside_band(self):
        v = history.trend_verdict(_prior([40.0, 41.0, 40.5, 41.5]),
                                  "p99_ms", 41.0)
        assert v["status"] == "ok" and v["ok"]
        assert v["median"] == pytest.approx(40.75)

    def test_regression_latency_up(self):
        v = history.trend_verdict(_prior([40.0, 41.0, 40.5, 41.5]),
                                  "p99_ms", 80.0)
        assert v["status"] == "regressed" and not v["ok"]
        assert v["delta_pct"] > 90

    def test_improvement_never_gates(self):
        v = history.trend_verdict(_prior([40.0, 41.0, 40.5, 41.5]),
                                  "p99_ms", 20.0)
        assert v["status"] == "improved" and v["ok"]

    def test_throughput_direction(self):
        prior = _prior([900.0, 905.0, 910.0], metric="mbps")
        assert history.trend_verdict(prior, "mbps", 400.0)["status"] \
            == "regressed"
        assert history.trend_verdict(prior, "mbps", 1500.0)["status"] \
            == "improved"

    def test_mad_floor_tolerates_flat_history_noise(self):
        """A perfectly flat history has MAD 0 — the floor keeps
        ordinary scheduling noise inside the band."""
        prior = _prior([100.0] * 6, metric="mbps")
        assert history.trend_verdict(prior, "mbps", 99.0)["status"] \
            == "ok"

    def test_attribution_names_the_mover(self):
        base_attr = {"serving": 0.6, "shm-staging": 0.2,
                     "dcn_pipeline": 0.2}
        prior = _prior([40.0, 41.0, 40.5, 41.5],
                       cpu_attr=base_attr, phase="dcn.chunk.send")
        v = history.trend_verdict(
            prior, "p99_ms", 80.0,
            cpu_attr={"serving": 0.45, "shm-staging": 0.38,
                      "dcn_pipeline": 0.17},
            dominant_phase="dcn.chunk.stage")
        attr = v["attribution"]
        movers = {m["subsystem"]: m["delta_pts"]
                  for m in attr["subsystems"]}
        assert movers["shm-staging"] == pytest.approx(18.0)
        assert movers["serving"] == pytest.approx(-15.0)
        assert attr["dominant_phase"] == "dcn.chunk.stage"
        assert attr["prior_dominant_phase"] == "dcn.chunk.send"
        line = history.format_verdict(v)
        assert "REGRESSED" in line
        assert "shm-staging share +18.0pts" in line
        assert "dcn.chunk.stage (was dcn.chunk.send)" in line

    def test_attribution_flat_shares_reported_flat(self):
        attr = history.attribute(
            {"serving": 0.5, "other": 0.5}, None,
            _prior([1.0], cpu_attr={"serving": 0.51, "other": 0.49}))
        assert attr["subsystems"] == []
        assert set(attr["flat"]) == {"serving", "other"}


class TestFleetReportEvidence:
    def test_extracts_measured_shares_and_phase(self):
        report = {
            "slo": {"measured": {"min_goodput_bps": 5e6,
                                 "p99_leg_ms": 12.5,
                                 "elapsed_s": 9.0,
                                 "stale_entries_skipped": 2}},
            "profile": {"fleet": {"subsystems": {
                "serving": 30, "shm-staging": 10, "idle": 200}}},
            "critical_path": {"dominant_phase": "dcn.chunk.send"},
        }
        metrics, cpu_attr, phase = \
            history.fleet_report_evidence(report)
        assert metrics == {"min_goodput_bps": 5e6,
                           "p99_leg_ms": 12.5}
        assert cpu_attr["serving"] == pytest.approx(0.75)
        assert cpu_attr["shm-staging"] == pytest.approx(0.25)
        assert "idle" not in cpu_attr
        assert phase == "dcn.chunk.send"

    def test_absent_sections_attribute_nothing(self):
        metrics, cpu_attr, phase = history.fleet_report_evidence({})
        assert metrics == {} and cpu_attr is None and phase is None


class TestAgentTrendCli:
    def _seed_regression(self, root):
        """Four quiet runs then one regressed run with a planted
        shm-staging CPU skew — the acceptance fixture shape."""
        led = history.RunLedger(str(root))
        for i in range(4):
            led.record("fleet_serving", "fleet-serving:n4",
                       {"p99_e2e_ms": 40.0 + i * 0.5,
                        "sustained_qps": 900.0 + i},
                       cpu_attr={"serving": 0.6, "shm-staging": 0.2,
                                 "dcn_pipeline": 0.2},
                       dominant_phase="serve.batch")
        led.record("fleet_serving", "fleet-serving:n4",
                   {"p99_e2e_ms": 80.0, "sustained_qps": 895.0},
                   cpu_attr={"serving": 0.45, "shm-staging": 0.38,
                             "dcn_pipeline": 0.17},
                   dominant_phase="dcn.chunk.stage")

    def test_regression_exits_1_and_names_subsystem(
            self, tmp_path, capsys):
        self._seed_regression(tmp_path)
        at = _load_cli("agent_trend")
        rc = at.main(["--dir", str(tmp_path)])
        assert rc == 1
        captured = capsys.readouterr()
        assert "shm-staging share +18.0pts" in captured.err
        assert "REGRESSED" in captured.err
        summary = json.loads(captured.out.strip().splitlines()[-1])
        assert summary["regressed"] == 1 and not summary["ok"]
        bad = [s for s in summary["series"]
               if s["verdict"]["status"] == "regressed"]
        assert [s["metric"] for s in bad] == ["p99_e2e_ms"]

    def test_clean_history_exits_0(self, tmp_path, capsys):
        led = history.RunLedger(str(tmp_path))
        for i in range(5):
            led.record("dcn_bench", "dcn_bench:shm:4096",
                       {"mbps": 1000.0 + i})
        at = _load_cli("agent_trend")
        assert at.main(["--dir", str(tmp_path)]) == 0
        summary = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        assert summary["ok"]

    def test_unreadable_ledger_exits_2(self, tmp_path, capsys):
        os.mkdir(os.path.join(str(tmp_path), history.LEDGER_NAME))
        at = _load_cli("agent_trend")
        assert at.main(["--dir", str(tmp_path)]) == 2

    def test_no_history_dir_exits_2(self, capsys):
        at = _load_cli("agent_trend")
        assert at.main([]) == 2

    def test_min_runs_flag_judges_thin_history(self, tmp_path,
                                               capsys):
        """The two-run `make trend` fixture: with --min-runs 1 a
        single prior run is a baseline."""
        led = history.RunLedger(str(tmp_path))
        led.record("dcn_bench", "k", {"mbps": 1000.0})
        led.record("dcn_bench", "k", {"mbps": 400.0})
        at = _load_cli("agent_trend")
        assert at.main(["--dir", str(tmp_path),
                        "--min-runs", "1"]) == 1

    def test_import_seeds_bench_rounds_idempotently(self, tmp_path,
                                                    capsys):
        at = _load_cli("agent_trend")
        rounds = [os.path.join(REPO, f"BENCH_r0{n}.json")
                  for n in (1, 2, 4, 5)]
        rounds += [os.path.join(REPO, f"MULTICHIP_r0{n}.json")
                   for n in (1, 2)]
        argv = ["--dir", str(tmp_path)]
        for r in rounds:
            argv += ["--import", r]
        at.main(argv)
        err = capsys.readouterr().err
        # r01 failed (rc=1): skipped with a note, never a crash.
        assert "BENCH_r01.json: skipped" in err
        assert "BENCH_r02.json: imported" in err
        led = history.RunLedger(str(tmp_path))
        bench = led.records(kind="bench_hw")
        assert len(bench) == 3  # r02, r04, r05 carry parsed metrics
        assert all(r["run_id"].startswith("import-") for r in bench)
        multi = led.records(kind="multichip")
        assert [r["metrics"]["ok"] for r in multi] == [0.0, 1.0]
        # Re-import: no duplicate records.
        at.main(argv)
        capsys.readouterr()
        assert len(history.RunLedger(str(tmp_path)).records()) \
            == len(bench) + len(multi)

    def test_filters_scope_the_tables(self, tmp_path, capsys):
        self._seed_regression(tmp_path)
        led = history.RunLedger(str(tmp_path))
        for i in range(4):
            led.record("dcn_bench", "k", {"mbps": 1000.0})
        at = _load_cli("agent_trend")
        rc = at.main(["--dir", str(tmp_path), "--kind", "dcn_bench"])
        assert rc == 0  # the regression lives in fleet_serving
        summary = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
        assert {s["kind"] for s in summary["series"]} == {"dcn_bench"}


# ---------------------------------------------------------------------------
# Parity with the JAX package's trend engine
# ---------------------------------------------------------------------------

SUBSYSTEMS = ("serving", "shm-staging", "dcn_pipeline", "xferd", "other")
METRICS = ("p99_e2e_ms", "mbps", "sustained_qps", "leak_slope.fds",
           "max_dedup_ratio", "frobnications")


def _series(rng, n):
    level = float(rng.uniform(1, 1000))
    return [float(x) for x in level * (1 + rng.normal(0, 0.05, n))]


def _shares(rng):
    raw = rng.dirichlet(np.ones(len(SUBSYSTEMS)))
    return {k: float(v) for k, v in zip(SUBSYSTEMS, raw)}


@pytest.mark.parametrize("seed", range(6))
def test_baseline_math_equal_on_seeded_series(seed):
    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 7, 20):
        xs = _series(rng, n)
        assert history.median(xs) == jax_history.median(xs)
        assert history.mad(xs) == jax_history.mad(xs)
        assert history.baseline(xs) == jax_history.baseline(xs)
        for kind in ("ceiling", "floor"):
            for pinned in (0.5, float(np.median(xs)) if xs else 1.0, 1e6):
                for min_runs in (1, 3, 5):
                    assert history.learned_limit(
                        xs, pinned, kind=kind, min_runs=min_runs) == \
                        jax_history.learned_limit(
                            xs, pinned, kind=kind, min_runs=min_runs)
    for name in METRICS:
        assert history.metric_direction(name) == \
            jax_history.metric_direction(name)


@pytest.mark.parametrize("seed", range(6))
def test_trend_verdicts_equal_on_seeded_series(seed):
    rng = np.random.default_rng(seed)
    for metric in METRICS:
        values = _series(rng, int(rng.integers(0, 12)))
        prior = [{"metrics": {metric: v}, "cpu_attr": _shares(rng),
                  "dominant_phase": f"phase{int(rng.integers(0, 3))}"}
                 for v in values]
        base = float(np.median(values)) if values else 1.0
        for factor in (0.3, 0.97, 1.0, 1.04, 2.5):
            kwargs = dict(cpu_attr=_shares(rng),
                          dominant_phase=f"phase{int(rng.integers(0, 3))}")
            for min_runs in (1, 3):
                v = history.trend_verdict(prior, metric, base * factor,
                                          min_runs=min_runs, **kwargs)
                j = jax_history.trend_verdict(prior, metric, base * factor,
                                              min_runs=min_runs, **kwargs)
                assert v == j
                assert history.format_verdict(v) == \
                    jax_history.format_verdict(j)


def test_fleet_report_evidence_equal():
    report = {
        "slo": {"measured": {"min_goodput_bps": 5e6, "p99_leg_ms": 12.5,
                             "elapsed_s": 9.0}},
        "profile": {"fleet": {"subsystems": {
            "serving": 30, "shm-staging": 10, "idle": 200}}},
        "critical_path": {"dominant_phase": "dcn.chunk.send"},
    }
    for r in (report, {}, {"profile": {"fleet": {"subsystems": {}}}}):
        assert history.fleet_report_evidence(r) == \
            jax_history.fleet_report_evidence(r)


def _strip_record(rec):
    return {k: v for k, v in rec.items() if k not in ("ts", "version")}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_ledger(tmp_path, writer):
    write, read = ((history, jax_history) if writer == "port"
                   else (jax_history, history))
    led = write.RunLedger(str(tmp_path))
    rng = np.random.default_rng(7)
    for i in range(6):
        led.record("fleet_serving", "fleet-serving:n4",
                   {"p99_e2e_ms": float(rng.uniform(30, 50))},
                   run_id=f"r{i}", seed=i, cpu_attr=_shares(rng),
                   dominant_phase="serve.batch")
    mine = [_strip_record(r) for r in led.records()]
    theirs = [_strip_record(r) for r in
              read.RunLedger(str(tmp_path)).records(kind="fleet_serving")]
    assert theirs == mine and len(mine) == 6
    assert history.SCHEMA_VERSION == jax_history.SCHEMA_VERSION
    assert history.LEDGER_NAME == jax_history.LEDGER_NAME
