"""The port's continuous soak world (container_engine_accelerators_tpu_
torch/fleet/soak.py) against the JAX package's fleet/soak.py, mirroring
its tests/test_soak.py.

The JAX package's cases run against the port's modules: the seeded
schedule, the invariant sentinels judged on synthetic inputs with large
planted slopes, the exit contract, the workers' resource RPC and grey
burn, the tuner's observability, the scenario plumbing and the
history-learned limits; the composed short soak is ``slow``, as in JAX.
Then the two packages side by side: the same seeds, windows and nodes
draw the same schedule, the same inputs give the sentinels the same
verdicts, and ``exit_code_for`` the same codes.
"""

import importlib.util
import io
import json
import os
import random
import subprocess
import sys
import time

import pytest

from container_engine_accelerators_tpu.fleet import soak as jax_soak
from container_engine_accelerators_tpu_torch.cmd import fleet_soak
from container_engine_accelerators_tpu_torch.fleet import soak
from container_engine_accelerators_tpu_torch.fleet.proc import (
    HANG_ENV,
    ProcNode,
    _resource_snapshot,
)
from container_engine_accelerators_tpu_torch.fleet.soak import (
    LeakSentinel,
    MonotonicitySentinel,
    SoakSchedule,
    exit_code_for,
    judge_tuner_convergence,
    run_soak,
)
from container_engine_accelerators_tpu_torch.fleet.topology import NodeSpec
from container_engine_accelerators_tpu_torch.obs import timeseries
from container_engine_accelerators_tpu_torch.parallel import dcn_tune

NAMES = ["n0", "n1", "n2"]


def _node(tmp_path, name, **kw):
    kw.setdefault("handshake_timeout_s", 60.0)
    env = dict(os.environ)
    env.pop("TPU_FAULT_SPEC", None)  # determinism under make chaos
    kw.setdefault("env", env)
    return ProcNode(NodeSpec(name=name, chips=2, topology="1x2x1"),
                    str(tmp_path / name), **kw)


# ---------------------------------------------------------------------------
# seeded schedule
# ---------------------------------------------------------------------------


class TestSoakSchedule:
    def test_same_seed_same_schedule(self):
        a = SoakSchedule(1234, NAMES)
        b = SoakSchedule(1234, NAMES)
        tape_a = [a.faults_for(w) for w in range(40)]
        tape_b = [b.faults_for(w) for w in range(40)]
        assert tape_a == tape_b
        # Windows are independent draws: recomputing one window out
        # of order must not change its verdict.
        assert a.faults_for(17) == tape_a[17]

    def test_different_seed_different_schedule(self):
        a = [SoakSchedule(1, NAMES).faults_for(w) for w in range(40)]
        b = [SoakSchedule(2, NAMES).faults_for(w) for w in range(40)]
        assert a != b

    def test_deterministic_coverage_prologue(self):
        """Window 0 is clean; windows 1-4 guarantee one kill, one
        grey, one link fault, one slow ring completer — every run's
        coverage floor."""
        s = SoakSchedule(99, NAMES)
        assert s.faults_for(0) == []
        (kill,) = s.faults_for(1)
        assert kill["action"] == "kill" and kill["node"] in NAMES
        assert kill["for"] == 1
        (grey,) = s.faults_for(2)
        assert grey["grey"] in NAMES and grey["for"] == 1
        (link,) = s.faults_for(3)
        assert link["link"].startswith("node:")
        assert ":latency:" in link["link"]
        (slow,) = s.faults_for(4)
        assert slow["slow_ring"] in NAMES and slow["for"] == 1

    def test_draws_are_well_formed(self):
        s = SoakSchedule(7, NAMES)
        for w in range(5, 60):
            for entry in s.faults_for(w):
                assert ("link" in entry or "grey" in entry
                        or "slow_ring" in entry
                        or entry.get("action") == "kill")
                if "grey" in entry:
                    assert entry["grey"] in NAMES
                if "slow_ring" in entry:
                    assert entry["slow_ring"] in NAMES

    def test_single_node_never_draws_link_faults(self):
        s = SoakSchedule(5, ["only"])
        for w in range(40):
            for entry in s.faults_for(w):
                assert "link" not in entry


# ---------------------------------------------------------------------------
# monotonicity sentinel
# ---------------------------------------------------------------------------


class TestMonotonicitySentinel:
    def test_planted_decrease_fails_the_verdict(self):
        m = MonotonicitySentinel()
        m.observe("n0", "frames", 100, gen=1)
        m.observe("n0", "frames", 40, gen=1)  # planted: went DOWN
        rep = m.report()
        assert not rep["ok"]
        (v,) = rep["violations"]
        assert v["node"] == "n0" and v["last"] == 100 \
            and v["current"] == 40
        # ...and it fails the whole soak verdict through the shared
        # exit-code mapping.
        report = {"converged": True, "slo": {"ok": True},
                  "soak": {"sentinels": {"ok": False}}}
        assert exit_code_for(report) == 3

    def test_respawn_generation_bump_is_not_a_violation(self):
        m = MonotonicitySentinel()
        m.observe("n0", "frames", 100, gen=1)
        m.observe("n0", "frames", 3, gen=2)   # respawn: fresh counter
        m.observe("n0", "frames", 50, gen=2)  # climbing again
        assert m.report()["ok"]

    def test_increases_are_clean(self):
        m = MonotonicitySentinel()
        for v in (1, 5, 5, 900):
            m.observe("n1", "deduped", v, gen=3)
        assert m.report()["ok"]

    def test_folds_telemetry_misreads(self):
        """The scrape path's same-generation decreases (telemetry's
        ``_accumulate`` misread log) are verdict inputs too."""
        m = MonotonicitySentinel()
        m.fold([{"node": "n2", "key": "frames", "last": 10.0,
                 "current": 4.0, "gen": 1}])
        rep = m.report()
        assert not rep["ok"] and rep["violations"][0]["node"] == "n2"


# ---------------------------------------------------------------------------
# leak sentinel
# ---------------------------------------------------------------------------


class TestLeakSentinel:
    def test_planted_fd_leak_breaches(self):
        s = LeakSentinel()
        for w in range(8):  # +50 fds per window: unmistakable
            s.observe(w, "n0", {"fds": 100 + 50 * w}, gen=1)
        rep = s.report()
        assert not rep["ok"]
        (b,) = rep["breaches"]
        assert b["node"] == "n0" and b["metric"] == "fds"
        assert b["slope_per_window"] == pytest.approx(50.0)
        report = {"converged": True, "slo": {"ok": True},
                  "soak": {"sentinels": {"ok": False}}}
        assert exit_code_for(report) == 3

    def test_flat_series_is_clean(self):
        s = LeakSentinel()
        for w in range(8):
            s.observe(w, "n0", {"fds": 120 + (w % 2),  # wobble, flat
                                "threads": 14,
                                "rss_bytes": 50 << 20}, gen=1)
        rep = s.report()
        assert rep["ok"] and not rep["breaches"]
        assert len(rep["series"]) == 3

    def test_generation_segmentation_no_false_positive(self):
        """A respawn drops fds from 300 to 100 — stitched into one
        series that cliff would dominate the fit; segmented per
        generation each half is flat and clean."""
        s = LeakSentinel()
        for w in range(5):
            s.observe(w, "n0", {"fds": 300}, gen=1)
        for w in range(5, 10):
            s.observe(w, "n0", {"fds": 100}, gen=2)
        assert s.report()["ok"]

    def test_short_segments_judge_nothing(self):
        s = LeakSentinel(min_samples=4)
        s.observe(0, "n0", {"fds": 10}, gen=1)
        s.observe(1, "n0", {"fds": 500}, gen=1)  # huge slope, 2 pts
        assert s.report()["ok"]

    def test_boot_ramp_inside_warmup_is_not_a_leak(self):
        """A respawned worker ramps threads while its stagers spin up;
        the per-generation warm-up allowance must keep that ramp out
        of the fit — only the plateau is evidence."""
        ramp = [2, 9, 13, 13, 14, 13]  # the respawn shape from a
        # real CI soak: a thread ramp, then a plateau
        s = LeakSentinel(warmup_samples=2)
        for w, v in enumerate(ramp):
            s.observe(w, "n2", {"threads": v}, gen=2)
        rep = s.report()
        assert rep["ok"], rep["breaches"]
        # The fit saw only the post-warm-up plateau.
        assert rep["series"]["n2.threads.gen2"]["samples"] == 4
        # With the allowance off, the same ramp WOULD read as a leak
        # (slope 2.0/window against the 1.5 budget) — the warm-up is
        # load-bearing, not cosmetic.
        raw = LeakSentinel(warmup_samples=0)
        for w, v in enumerate(ramp):
            raw.observe(w, "n2", {"threads": v}, gen=2)
        assert not raw.report()["ok"]

    def test_slope_helper(self):
        assert timeseries.least_squares_slope(
            [(0, 0), (1, 2), (2, 4)]) == pytest.approx(2.0)
        assert timeseries.least_squares_slope([(3, 9)]) == 0.0
        assert timeseries.least_squares_slope(
            [(1, 5), (1, 9)]) == 0.0  # zero x-variance


# ---------------------------------------------------------------------------
# tuner convergence sentinel
# ---------------------------------------------------------------------------


class TestTunerConvergence:
    def test_no_heals_is_vacuously_ok(self):
        rep = judge_tuner_convergence([3, 3, 3], [])
        assert rep["ok"] and rep["reason"] == "no heals observed"

    def test_decay_after_heal_converges(self):
        # Heal at window 2, settle 3 → tail starts at 5: quiet tail.
        moves = [0, 4, 5, 3, 1, 0, 0, 1, 0]
        rep = judge_tuner_convergence(moves, [2], settle_windows=3,
                                      max_tail_moves=1)
        assert rep["ok"] and rep["reason"] == "converged"
        assert rep["tail_moves"] == [0, 0, 1, 0]

    def test_planted_oscillation_fails(self):
        moves = [0, 4, 2, 3, 2, 3, 2, 3]
        rep = judge_tuner_convergence(moves, [1], settle_windows=3,
                                      max_tail_moves=1)
        assert not rep["ok"]
        assert "did not decay" in rep["reason"]

    def test_limit_cycle_of_small_moves_fails(self):
        # Never a big move, but never quiet either: the limit cycle.
        moves = [0, 5, 1, 1, 1, 1, 1, 1]
        rep = judge_tuner_convergence(moves, [1], settle_windows=3,
                                      max_tail_moves=1)
        assert not rep["ok"]
        assert "limit cycle" in rep["reason"]

    def test_only_the_last_heal_starts_the_clock(self):
        # Heavy moves BEFORE the last heal are fine — only the tail
        # after last_heal + settle (moves[2+3:] here) is judged.
        moves = [4, 4, 4, 4, 4, 1, 0, 0]
        rep = judge_tuner_convergence(moves, [0, 1, 2], settle_windows=3,
                                      max_tail_moves=1)
        assert rep["ok"] and rep["reason"] == "converged"
        assert rep["tail_start"] == 5
        assert rep["tail_moves"] == [1, 0, 0]

    def test_run_ending_inside_settle_window_is_ok(self):
        rep = judge_tuner_convergence([1, 2], [1], settle_windows=3)
        assert rep["ok"]
        assert rep["reason"] == "run ended inside the settle window"


# ---------------------------------------------------------------------------
# exit contract
# ---------------------------------------------------------------------------


class TestExitContract:
    CLEAN = {"converged": True, "slo": {"ok": True},
             "soak": {"sentinels": {"ok": True}}}

    def test_clean_run_exits_zero(self):
        assert exit_code_for(self.CLEAN) == 0

    def test_non_convergence_exits_two(self):
        assert exit_code_for({**self.CLEAN, "converged": False}) == 2

    def test_sentinel_breach_exits_three(self):
        report = {**self.CLEAN, "soak": {"sentinels": {"ok": False}}}
        assert exit_code_for(report) == 3

    def test_slo_breach_exits_three(self):
        assert exit_code_for({**self.CLEAN, "slo": {"ok": False}}) == 3

    def test_non_convergence_outranks_breach(self):
        report = {"converged": False, "slo": {"ok": False},
                  "soak": {"sentinels": {"ok": False}}}
        assert exit_code_for(report) == 2


# ---------------------------------------------------------------------------
# worker resource RPC + grey burn
# ---------------------------------------------------------------------------


class TestResourceSnapshot:
    def test_in_process_snapshot_shape(self, tmp_path):
        for i in range(3):
            (tmp_path / f"seg{i}").write_bytes(b"x")
        snap = _resource_snapshot(str(tmp_path))
        assert snap["fds"] > 0
        assert snap["threads"] >= 1
        assert snap["shm_segments"] == 3
        assert snap["rss_bytes"] > 0

    def test_missing_shm_dir_degrades_to_zero(self):
        snap = _resource_snapshot("/nonexistent/shm/dir")
        assert snap["shm_segments"] == 0
        assert snap["fds"] > 0

    def test_worker_rpc_live_burn_and_dark_path(self, tmp_path):
        """One worker spawn covers the live census, the grey burn
        arm/disarm, and the dark-worker path: after a SIGKILL the
        ``resources`` RPC must raise (no cached stale census — a
        stale series would fake a leak-free window)."""
        node = _node(tmp_path, "nr")
        try:
            res = node.resources()
            assert res["fds"] > 0
            assert res["threads"] >= 1
            assert res["rss_bytes"] > 0
            assert res["shm_segments"] >= 0
            # Grey burn: armed (worker caps the duration), disarmed.
            assert node.burn_cpu(0.4) == pytest.approx(0.4)
            node.stop_burn()
            # Census is repeatable while live.
            again = node.resources()
            assert again["fds"] > 0
            node.kill_daemon()
            with pytest.raises(OSError):
                node.resources()
        finally:
            node.close()


# ---------------------------------------------------------------------------
# tuner observability: history + cpu-bound bridge
# ---------------------------------------------------------------------------


class TestTunerObservability:
    def _tuner(self, shares):
        seq = list(shares)
        return dcn_tune.FlowTuner(
            "t:1", staging_share=lambda: seq.pop(0) if seq else None)

    def test_cpu_bound_gauge_share_grows_goodput_stalls(self):
        t = self._tuner([0.10, 0.30])
        t.plan(4096, 2)
        t.on_round(4, 0, 4096, 1.0)  # baseline: share .10, 4096 B/s
        t.on_round(4, 0, 4096, 1.0)  # share .30, goodput flat
        assert timeseries.gauges()["dcn.tune.cpu_bound"] == 1.0
        assert t.snapshot()["cpu_bound"] is True

    def test_not_cpu_bound_when_goodput_scales(self):
        t = self._tuner([0.10, 0.30])
        t.plan(4096, 2)
        t.on_round(4, 0, 4096, 1.0)
        t.on_round(4, 0, 8192, 1.0)  # share grew AND goodput doubled
        assert timeseries.gauges()["dcn.tune.cpu_bound"] == 0.0
        assert t.snapshot()["cpu_bound"] is False

    def test_not_cpu_bound_when_share_flat(self):
        t = self._tuner([0.10, 0.12])  # within the step threshold
        t.plan(4096, 2)
        t.on_round(4, 0, 4096, 1.0)
        t.on_round(4, 0, 4096, 1.0)
        assert timeseries.gauges()["dcn.tune.cpu_bound"] == 0.0

    def test_history_records_observations_and_decisions(self):
        t = self._tuner([0.10, 0.20, 0.25])
        t.plan(4096, 2)
        t.on_round(4, 0, 4096, 1.0)
        t.on_round(4, 2, 2048, 1.0)  # retx 0.5: stripe backoff fires
        hist = t.history()
        assert len(hist) == 2
        assert hist[0]["decision"] is None
        assert hist[0]["staging_share"] == pytest.approx(0.10)
        assert hist[1]["decision"] == "backoff_stripe"
        assert hist[1]["retx"] == pytest.approx(0.5)
        assert t.snapshot()["decisions"] == 1

    def test_history_is_bounded(self):
        t = dcn_tune.FlowTuner("t:2", staging_share=lambda: None)
        t.plan(4096, 2)
        for _ in range(dcn_tune.MAX_HISTORY + 50):
            t.on_round(4, 0, 4096, 1.0)
        assert len(t.history()) == dcn_tune.MAX_HISTORY

    def test_registry_decision_history_export(self):
        dcn_tune.reset()
        try:
            t = dcn_tune.tuner_for("127.0.0.1:9999")
            t.on_round(4, 0, 4096, 1.0)
            hist = dcn_tune.decision_history()
            assert list(hist) == ["127.0.0.1:9999"]
            assert len(hist["127.0.0.1:9999"]) == 1
        finally:
            dcn_tune.reset()


# ---------------------------------------------------------------------------
# the composed soak, for real (short; cmd.fleet_soak owns the long one)
# ---------------------------------------------------------------------------


@pytest.mark.slow
class TestSoakWorld:
    def test_short_soak_composes_chaos_and_verdicts(self):
        t0 = time.monotonic()
        report = run_soak({"nodes": 3}, duration_s=9.0,
                          window_s=1.0, seed=1234)
        assert report["converged"], report.get("rounds", [])[-1:]
        soak_sec = report["soak"]
        # Coverage floor: the deterministic prologue fired and healed.
        assert soak_sec["kills"] >= 1
        assert soak_sec["greys"] >= 1
        assert soak_sec["heals"] >= 1
        assert soak_sec["windows"] >= 6
        # The killed node respawned (generation advanced).
        assert any(n["daemon_generation"] > 1
                   for n in report["nodes"].values())
        # Composition: every window carries all three workloads.
        for rnd in report["rounds"]:
            kinds = {leg.get("workload", "exchange")
                     for leg in rnd["legs"]}
            assert "serving" in kinds and "collective" in kinds
        sentinels = soak_sec["sentinels"]
        assert sentinels["monotonicity"]["ok"], sentinels
        assert sentinels["leaks"]["ok"], sentinels
        assert sentinels["tuner"]["ok"], sentinels
        assert sentinels["ok"]
        # Leak series actually collected from the workers' RPC.
        assert sentinels["leaks"]["series"]
        # The tuner ran (closed loop on by default) and its history
        # export is in the report.
        assert soak_sec["tuner_history"]
        assert exit_code_for(report) == 0
        # Reproducibility: the report's schedule is exactly what the
        # seed's pure schedule says for those windows.
        sched = SoakSchedule(1234, list(report["nodes"]))
        by_window = {}
        for e in soak_sec["schedule"]:
            by_window.setdefault(e["window"], []).append(e)
        for w, entries in by_window.items():
            drawn = sched.faults_for(w)
            assert len(drawn) == len(entries)
        assert time.monotonic() - t0 < 120


class TestSoakWorldScenarioPlumbing:
    def test_scenario_overrides_merge(self):
        w = soak.SoakWorld({"nodes": 2, "seed": 77},
                           duration_s=1.0, window_s=0.5)
        try:
            assert w.seed == 77
            assert len(w.topology.specs) == 2
            assert w.pipe_cfg.tuned  # closed loop on in the soak world
            assert w.scenario["workload"] == "soak"
            assert w.schedule.names == list(w.topology.specs)
        finally:
            w.close()

    def test_ctor_args_beat_scenario(self):
        w = soak.SoakWorld({"seed": 77, "duration_s": 100},
                           duration_s=2.0, seed=5)
        try:
            assert w.seed == 5 and w.duration_s == 2.0
        finally:
            w.close()


# ---------------------------------------------------------------------------
# history-learned sentinel thresholds
# ---------------------------------------------------------------------------


class TestHistoryLearnedThresholds:
    """Prior soak runs in the history ledger tighten the leak and SLO
    budgets toward the fleet's demonstrated baseline; pinned
    constants stay the fallback (thin history) AND the hard bound
    (history can never relax a budget)."""

    CFG = "soak:soak:n3"

    def _seed(self, root, slopes):
        from container_engine_accelerators_tpu_torch.obs import history
        led = history.RunLedger(str(root))
        for s in slopes:
            led.record("fleet_soak", self.CFG,
                       {"leak_slope.fds": s},
                       sentinels={"leak_slopes": {"fds": s}},
                       slo={"measured": {"p99_leg_ms": 30.0 + s},
                            "ok": True})
        return led

    def test_learned_leak_budget_flags_run_pinned_passes(
            self, tmp_path):
        """The acceptance fixture: demonstrated slopes ~0.05/window
        learn a budget ~0.07; a planted 0.5/window creep — well under
        the pinned 2.0 — breaches the learned sentinel and sails
        through the pinned one."""
        led = self._seed(tmp_path, [0.04, 0.045, 0.05, 0.055, 0.06])
        leak, _ = soak.history_learned_limits(self.CFG, None,
                                              ledger=led)
        assert leak["fds"]["source"] == "learned"
        assert leak["fds"]["limit"] \
            < soak.DEFAULT_LEAK_LIMITS["fds"] / 10

        def drive(sentinel):
            for w in range(8):
                sentinel.observe(w, "n0", {"fds": 100 + 0.5 * w},
                                 gen=1)
            return sentinel.report()

        pinned_rep = drive(LeakSentinel())
        assert pinned_rep["ok"]  # 0.5/window under the pinned 2.0
        learned_rep = drive(LeakSentinel(learned=leak))
        assert not learned_rep["ok"]
        (b,) = learned_rep["breaches"]
        assert b["metric"] == "fds"
        assert b["limit_source"] == "learned"
        assert learned_rep["learned_limits"]["fds"]["pinned"] \
            == soak.DEFAULT_LEAK_LIMITS["fds"]

    def test_thin_history_stays_pinned(self, tmp_path):
        led = self._seed(tmp_path, [0.05, 0.06])  # < MIN_BASELINE_RUNS
        leak, slo = soak.history_learned_limits(self.CFG, None,
                                                ledger=led)
        assert leak == {} and slo == {}
        s = LeakSentinel(learned=leak)
        assert s.limits == soak.DEFAULT_LEAK_LIMITS

    def test_unconfigured_ledger_stays_pinned(self, monkeypatch):
        monkeypatch.delenv("TPU_HISTORY_DIR", raising=False)
        leak, slo = soak.history_learned_limits(self.CFG)
        assert leak == {} and slo == {}

    def test_learned_slo_ceiling_from_measured_history(self,
                                                       tmp_path):
        led = self._seed(tmp_path, [0.04, 0.05, 0.05, 0.06])
        _, slo = soak.history_learned_limits(
            self.CFG, {"p99_leg_ms": 1000}, ledger=led)
        assert slo["p99_leg_ms"]["source"] == "learned"
        # Demonstrated p99 ~30ms: the learned ceiling sits near it,
        # nowhere near the generous pinned 1000ms.
        assert slo["p99_leg_ms"]["limit"] < 100
        assert slo["p99_leg_ms"]["ceiling"] == 1000

    def test_soak_world_wires_learned_limits(self, tmp_path,
                                             monkeypatch):
        self._seed(tmp_path, [0.04, 0.045, 0.05, 0.055])
        monkeypatch.setenv("TPU_HISTORY_DIR", str(tmp_path))
        w = soak.SoakWorld({"nodes": 3})
        try:
            assert w.history_key == self.CFG
            assert w._learned_leak["fds"]["source"] == "learned"
            assert w.leak.limits["fds"] \
                < soak.DEFAULT_LEAK_LIMITS["fds"]
            assert w.leak.limit_sources["fds"]["source"] == "learned"
        finally:
            w.close()


# ---------------------------------------------------------------------------
# Parity with the JAX package's soak world
# ---------------------------------------------------------------------------

NODE_SETS = (["n0"], ["n0", "n1"], ["n0", "n1", "n2"],
             [f"n{i}" for i in range(16)])


@pytest.mark.parametrize("shm", [False, True], ids=["socket", "shm"])
@pytest.mark.parametrize("seed", [0, 1, 77, 1234, 2 ** 31 - 1])
def test_schedule_draws_equal_the_jax_schedules(seed, shm):
    """Tolerance: none — every draw of windows 0-199 over one to
    sixteen nodes."""
    for names in NODE_SETS:
        ours = SoakSchedule(seed, names, shm=shm)
        ref = jax_soak.SoakSchedule(seed, names, shm=shm)
        assert ours.last_deterministic == ref.last_deterministic
        for w in range(-1, 200):
            assert ours.faults_for(w) == ref.faults_for(w), (names, w)


def _series(seed):
    """Seeded census windows: per node and generation, a flat, wobbling
    or leaking series of each resource, with respawns mid-run."""
    rng = random.Random(seed)
    out = []
    for node in ("n0", "n1", "n2"):
        gen, base = 1, {m: rng.uniform(10, 500) for m in
                        soak.DEFAULT_LEAK_LIMITS}
        slope = {m: rng.choice([0.0, 0.3, 3.0, 40.0]) for m in base}
        for w in range(24):
            if rng.random() < 0.1:
                gen += 1
            out.append((w, node, {m: base[m] + slope[m] * w
                                  + rng.uniform(-2, 2)
                                  for m in base}, gen))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_sentinels_give_the_jax_verdicts(seed):
    """Tolerance: none — the same inputs give equal reports (slopes are
    the same float arithmetic in the same order)."""
    ours, ref = LeakSentinel(), jax_soak.LeakSentinel()
    for w, node, res, gen in _series(seed):
        ours.observe(w, node, res, gen=gen)
        ref.observe(w, node, res, gen=gen)
    assert ours.report() == ref.report()
    m, jm = MonotonicitySentinel(), jax_soak.MonotonicitySentinel()
    for w, node, res, gen in _series(seed + 100):
        for key, v in res.items():
            m.observe(node, key, v, gen=gen)
            jm.observe(node, key, v, gen=gen)
    assert m.report() == jm.report()
    rng = random.Random(seed)
    moves = [rng.choice([0, 0, 1, 2, 5]) for _ in range(20)]
    heals = sorted(rng.sample(range(20), rng.randint(0, 4)))
    for settle in (1, 3):
        assert judge_tuner_convergence(moves, heals, settle_windows=settle) \
            == jax_soak.judge_tuner_convergence(moves, heals,
                                                settle_windows=settle)


@pytest.mark.parametrize("converged", [True, False])
@pytest.mark.parametrize("slo_ok", [True, False, None])
@pytest.mark.parametrize("sentinels_ok", [True, False, None])
def test_exit_code_for_agrees_with_jax(converged, slo_ok, sentinels_ok):
    report = {"converged": converged}
    if slo_ok is not None:
        report["slo"] = {"ok": slo_ok}
    if sentinels_ok is not None:
        report["soak"] = {"sentinels": {"ok": sentinels_ok}}
    assert exit_code_for(report) == jax_soak.exit_code_for(report)


def test_defaults_equal_the_jax_world():
    for name in ("GREY_LATENCY_S", "RING_DELAY_S", "SHM_DELAY_S",
                 "LAST_DETERMINISTIC_WINDOW", "ANOMALY_SETTLE_WINDOWS",
                 "REACTIVE_DECISIONS", "DEFAULT_LEAK_LIMITS",
                 "DEFAULT_SOAK_SCENARIO"):
        assert getattr(soak, name) == getattr(jax_soak, name), name


# ---------------------------------------------------------------------------
# cmd/fleet_soak.py: the CLI contract, against the root script
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_fleet_soak", os.path.join(REPO, "cmd", "fleet_soak.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cli_flags_and_schema_equal_the_jax_clis():
    argv = ["--scenario", "s.json", "--duration", "5", "--window", "1",
            "--seed", "9", "--nodes", "2", "--slo", "max_dedup_ratio=0.5",
            "--trace-file", "t.jsonl", "--trend-gate", "--anomaly-gate",
            "--anomaly-fp-budget", "3"]
    jax_cli = _jax_cli()
    for args in ([], argv):
        assert vars(fleet_soak.parse_args(args)) == \
            vars(jax_cli.parse_args(args))
    assert fleet_soak.REPORT_SCHEMA_VERSION == jax_cli.REPORT_SCHEMA_VERSION


def test_cli_typoed_slo_and_hanging_worker_exit_2(tmp_path, capsys,
                                                  monkeypatch):
    assert fleet_soak.main(["--slo", "max_dedup=1"]) == 2
    assert "bad --slo" in capsys.readouterr().err
    path = tmp_path / "hang.json"
    path.write_text(json.dumps({"nodes": 1, "handshake_timeout_s": 2.0}))
    monkeypatch.setenv(HANG_ENV, "1")
    monkeypatch.delenv("TPU_FAULT_SPEC", raising=False)
    assert fleet_soak.main(["--scenario", str(path), "--duration", "1"]) \
        == 2
    assert "fleet boot failed" in capsys.readouterr().err


def _detection(recall, fps, truth=2):
    return {"anomaly": {"detection": {
        "recall": recall, "truth": truth, "k": 2,
        "detections": [{}] * truth, "missed": [] if recall == 1.0 else ["w3"],
        "false_positive_count": fps, "false_positives": ["w9"] * fps,
        "detect_windows_max": 1.0, "clean_windows": 6}}}


@pytest.mark.parametrize("report,gate,budget", [
    ({}, False, 2),
    ({}, True, 2),
    (_detection(1.0, 0, truth=0), True, 2),
    (_detection(1.0, 2), True, 2),
    (_detection(1.0, 3), True, 2),
    (_detection(0.5, 0), True, 2),
    (_detection(1.0, 3), True, 3),
])
def test_cli_anomaly_gate_equals_jax(report, gate, budget, capsys):
    argv = (["--anomaly-gate"] if gate else []) + [
        "--anomaly-fp-budget", str(budget)]
    ours = fleet_soak._anomaly_gate(report, fleet_soak.parse_args(argv))
    ours_err = capsys.readouterr().err
    jax_cli = _jax_cli()
    ref = jax_cli._anomaly_gate(report, jax_cli.parse_args(argv))
    assert (ours, ours_err) == (ref, capsys.readouterr().err)


def _report():
    return {
        "scenario": "soak", "converged": True,
        "soak": {"seed": 7, "windows": 3, "duration_s": 3.5, "kills": 1,
                 "greys": 1, "heals": 2, "heal_windows": [2, 3],
                 "sentinels": {
                     "monotonicity": {"ok": False, "violations": [
                         {"node": "n0", "key": "frames", "last": 9,
                          "current": 2}]},
                     "leaks": {"ok": True, "breaches": [],
                               "series": {"n0.fds.gen1": {}}},
                     "tuner": {"ok": True, "reason": "converged"}}},
        "anomaly": _detection(0.5, 1)["anomaly"],
        "nodes": {"n0": {"rack": "r0", "healthy": 2, "total": 2,
                         "daemon_generation": 2, "legs_ok": 9,
                         "legs_failed": 1, "down": False}},
        "slo": {"ok": True, "checks": [
            {"slo": "max_dedup_ratio", "kind": "ceiling", "limit": 0.9,
             "value": 0.0, "ok": True}]}}


def test_cli_tables_render_as_the_jax_clis():
    ours, ref = io.StringIO(), io.StringIO()
    fleet_soak._print_report(_report(), file=ours)
    _jax_cli()._print_report(_report(), file=ref)
    assert ours.getvalue() == ref.getvalue()
    assert "violation:" in ours.getvalue()


def test_cli_trend_gate_regression_exits_1(tmp_path, monkeypatch, capsys):
    """A run whose leak slope sits far past its history's band regresses:
    1 under --trend-gate, 0 without; the ledger records every run."""
    from container_engine_accelerators_tpu_torch.obs import history

    monkeypatch.setenv("TPU_HISTORY_DIR", str(tmp_path))
    report = _report()
    report["soak"]["sentinels"]["leaks"]["max_slopes"] = {"fds": 0.05}
    gate = fleet_soak.parse_args(["--trend-gate"])
    for i in range(history.MIN_BASELINE_RUNS):
        assert fleet_soak._record_and_trend(report, gate, f"run{i}") == 0
    report["soak"]["sentinels"]["leaks"]["max_slopes"] = {"fds": 50.0}
    assert fleet_soak._record_and_trend(
        report, fleet_soak.parse_args([]), "quiet") == 0
    assert fleet_soak._record_and_trend(report, gate, "loud") == 1
    assert report["trend"]["ok"] is False
    assert "trend:" in capsys.readouterr().err
    assert [r["run_id"] for r in history.RunLedger().records(
        kind="fleet_soak")][-2:] == ["quiet", "loud"]


def test_module_entry_runs_a_short_soak():
    """``python -m ...cmd.fleet_soak`` as a user runs it: exit 0, the
    last stdout line the stamped JSON report."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPU_FAULT_SPEC", "TPU_HISTORY_DIR")}
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.fleet_soak",
         "--duration", "2", "--window", "1", "--nodes", "2"],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    assert report["converged"] and len(report["nodes"]) == 2
    assert report["schema_version"] == fleet_soak.REPORT_SCHEMA_VERSION
    assert len(report["run_id"]) == 16
    assert report["soak"]["sentinels"]["ok"]
    assert "sentinel" in proc.stderr and "monotonicity" in proc.stderr
