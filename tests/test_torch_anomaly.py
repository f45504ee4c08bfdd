"""The port's grey-failure detector (``obs/anomaly.py``) against the JAX
package's.

The JAX package's cases (peer-relative robust z-scores, the verdict
ladder, the kill switch, the scheduler surcharge on the port's
``scheduler/topology.py`` labels, windowed p99 from scraped buckets,
the detection report, ``agent_top``'s suspicion panel, and the soak
world's side: the ``slow_shm`` schedule and daemon throttle, the
ground truth a fault records, and — ``slow``, as in JAX — a scripted
grey node confirmed and cleared end to end) run against the port's
modules; then the same seeded evidence windows give the same
verdict sequence, scores and reports in both packages.
"""

import importlib
import time

import numpy as np
import pytest

from container_engine_accelerators_tpu.obs import anomaly as jax_anomaly
from container_engine_accelerators_tpu_torch.fleet import soak
from container_engine_accelerators_tpu_torch.fleet.soak import SoakSchedule
from container_engine_accelerators_tpu_torch.fleet.xferd import PyXferd
from container_engine_accelerators_tpu_torch.obs import anomaly
from container_engine_accelerators_tpu_torch.obs.anomaly import (
    CONFIRMED,
    HEALTHY,
    SUSPECT,
    AnomalyDetector,
    Evidence,
    TruthWindow,
    bucket_delta_p99_us,
    detection_report,
    robust_zscores,
)
from container_engine_accelerators_tpu_torch.scheduler import (
    topology as sched_topo,
)

NAMES = ["n0", "n1", "n2"]


def _load_cli(name):
    return importlib.import_module(
        f"container_engine_accelerators_tpu_torch.cmd.{name}")


def _ev(values, direction="high", abs_floor=0.1):
    return [Evidence("m", values, direction=direction,
                     abs_floor=abs_floor)]


HOT = {"a": 100.0, "b": 1.0, "c": 1.0}
QUIET = {"a": 1.0, "b": 1.0, "c": 1.0}


# ---------------------------------------------------------------------------
# The JAX package's cases, against the port's modules
# ---------------------------------------------------------------------------


class TestRobustZScores:
    def test_one_sick_of_three_convicts_only_the_sick(self):
        """The healthy majority pins the median and the MAD collapses
        to the floor — the sick node's z is enormous, its peers' 0."""
        zs = robust_zscores({"a": 100.0, "b": 1.0, "c": 1.1},
                            direction="high", abs_floor=0.5)
        assert zs["a"] > 50.0
        assert zs["b"] == 0.0
        assert zs["c"] < 2.0

    def test_uniform_slowdown_convicts_nobody(self):
        """A GLOBAL slowdown (a loaded host) moves the median with the
        fleet: nobody deviates from peers, nobody scores."""
        zs = robust_zscores({"a": 500.0, "b": 500.0, "c": 500.0},
                            direction="high", abs_floor=0.5)
        assert all(z == 0.0 for z in zs.values())

    def test_idle_degenerate_window_is_not_evidence(self):
        """Median AND MAD under the absolute floor = an idle fleet: no
        dispersion baseline, no conviction — the ledger's no_baseline
        verdict applied across space."""
        zs = robust_zscores({"a": 0.01, "b": 0.0, "c": 0.0},
                            direction="high", abs_floor=1.0)
        assert all(z == 0.0 for z in zs.values())

    def test_outlier_among_idle_peers_still_convicts(self):
        """Idleness is judged on EVERY value, not the median: a 65ms
        p99 among sub-floor peers is the textbook one-sick-of-N, and
        a median-based idle test would wave it through."""
        zs = robust_zscores({"a": 65536.0, "b": 128.0, "c": 256.0},
                            direction="high", abs_floor=4096.0)
        assert zs["a"] > 10.0
        assert zs["b"] == 0.0 and zs["c"] == 0.0

    def test_too_few_peers_no_verdict(self):
        zs = robust_zscores({"a": 100.0, "b": 1.0},
                            direction="high", abs_floor=0.1,
                            min_peers=3)
        assert zs == {"a": 0.0, "b": 0.0}

    def test_good_direction_deviation_never_scores(self):
        """A node FASTER than its peers is not sick."""
        zs = robust_zscores({"a": 0.1, "b": 10.0, "c": 10.0},
                            direction="high", abs_floor=0.1)
        assert zs["a"] == 0.0

    def test_low_direction_scores_the_starved_node(self):
        """Goodput-shaped: direction="low" convicts the node BELOW its
        peers, never the ones above."""
        zs = robust_zscores({"a": 10.0, "b": 1000.0, "c": 1000.0},
                            direction="low", abs_floor=64.0)
        assert zs["a"] > 5.0
        assert zs["b"] == 0.0 and zs["c"] == 0.0


class TestVerdictLadder:
    def _det(self):
        return AnomalyDetector(dump_on_confirm=False)

    def test_single_window_spike_suspects_but_never_confirms(self):
        """One hot window steps healthy->suspect; quiet windows after
        it must decay and CLEAR without ever confirming — flap
        resistance is the ladder's whole contract."""
        det = self._det()
        det.observe(0, _ev(HOT))
        assert det.state["a"] == SUSPECT
        for w in range(1, 8):
            det.observe(w, _ev(QUIET))
        assert det.state["a"] == HEALTHY
        assert det.confirmations == []
        assert det.score["a"] < 0.5

    def test_sustained_deviation_confirms(self):
        det = self._det()
        det.observe(0, _ev(HOT))
        det.observe(1, _ev(HOT))
        assert det.state["a"] == CONFIRMED
        (conf,) = det.confirmations
        assert conf["entity"] == "a" and conf["window"] == 1
        # Peers never left healthy.
        assert det.state["b"] == HEALTHY

    def test_clear_needs_consecutive_quiet_windows(self):
        """One quiet window between hot ones resets nothing: clearing
        demands clear_windows CONSECUTIVE windows under clear_z."""
        det = self._det()
        det.observe(0, _ev(HOT))
        det.observe(1, _ev(HOT))
        assert det.state["a"] == CONFIRMED
        det.observe(2, _ev(QUIET))   # score 6 — loud, not quiet
        det.observe(3, _ev(HOT))     # hot again
        assert det.state["a"] == CONFIRMED
        for w in range(4, 12):
            det.observe(w, _ev(QUIET))
        assert det.state["a"] == HEALTHY

    def test_absent_entity_holds_state_and_score(self):
        """No observation is not evidence of health: a stale/down
        entity is excluded from scoring AND from decay."""
        det = self._det()
        det.observe(0, _ev(HOT))
        det.observe(1, _ev(HOT))
        assert det.state["a"] == CONFIRMED
        score = det.score["a"]
        det.observe(2, _ev(QUIET), absent={"a"})
        det.observe(3, _ev(QUIET), absent={"a"})
        assert det.state["a"] == CONFIRMED
        assert det.score["a"] == score

    def test_flagged_windows_record_suspect_and_worse(self):
        det = self._det()
        det.observe(3, _ev(HOT))
        det.observe(4, _ev(HOT))
        assert det.flagged["a"] == [3, 4]
        assert "b" not in det.flagged

    def test_report_shape(self):
        det = self._det()
        det.observe(0, _ev(HOT))
        rep = det.report()
        assert rep["enabled"] and rep["windows"] == 1
        assert rep["verdicts"]["a"]["state"] == "suspect"
        assert rep["flagged_windows"] == {"a": [0]}

    def test_warmup_windows_swallow_boot_transients(self):
        """Evidence inside the warmup is counted but never scored —
        the boot round's cold-start legs must not seed suspicion."""
        det = AnomalyDetector(
            anomaly.AnomalyConfig(warmup_windows=1),
            dump_on_confirm=False)
        assert det.observe(0, _ev(HOT)) == {}
        assert det.state == {} and det.flagged == {}
        assert det.windows_observed == 1
        det.observe(1, _ev(HOT))
        assert det.state["a"] == SUSPECT

    def test_per_stream_rel_floor_mutes_quantized_noise(self):
        """A stream with rel_floor=0.5 (windowed byte counts) caps a
        healthy node's burst-alignment dip well under suspect_z even
        when its two peers agree exactly and the MAD collapses."""
        det = AnomalyDetector(dump_on_confirm=False)
        noisy = [Evidence("bytes",
                          {"a": 49152.0, "b": 262144.0,
                           "c": 262144.0},
                          direction="low", abs_floor=4096.0,
                          rel_floor=0.5)]
        inst = det.observe(0, noisy)
        assert inst["a"] < det.cfg.suspect_z
        assert det.state.get("a", HEALTHY) == HEALTHY
        # Same values through the default floor WOULD convict: the
        # override is what holds the stream to corroborating duty.
        zs = robust_zscores({"a": 49152.0, "b": 262144.0,
                             "c": 262144.0},
                            direction="low", abs_floor=4096.0)
        assert zs["a"] > det.cfg.suspect_z


class TestKillSwitch:
    def test_disabled_detector_is_inert(self, monkeypatch):
        monkeypatch.setenv(anomaly.KILL_SWITCH_ENV, "0")
        assert not anomaly.enabled()
        det = AnomalyDetector()
        assert not det.enabled
        assert det.observe(0, _ev(HOT)) == {}
        assert det.windows_observed == 0
        assert det.state == {} and det.score == {}

    def test_disabled_penalty_is_zero_even_with_state(self,
                                                      monkeypatch):
        monkeypatch.setenv(anomaly.KILL_SWITCH_ENV, "0")
        det = AnomalyDetector()
        det.state["h0"] = CONFIRMED  # forced — observe won't set it
        pen = det.scheduler_penalty()
        node = {"node_labels": {sched_topo.HOST_LABEL: "h0"}}
        assert pen(node, node) == 0.0

    def test_default_is_enabled(self, monkeypatch):
        monkeypatch.delenv(anomaly.KILL_SWITCH_ENV, raising=False)
        assert anomaly.enabled()


class TestSchedulerPenalty:
    def _node(self, host):
        return {"node_labels": {sched_topo.HOST_LABEL: host}}

    def test_surcharges_by_state_and_never_vetoes(self):
        det = AnomalyDetector(dump_on_confirm=False)
        det.state["h_conf"] = CONFIRMED
        det.state["h_susp"] = SUSPECT
        pen = det.scheduler_penalty(suspect_surcharge=50.0,
                                    confirmed_surcharge=500.0)
        healthy = self._node("h_ok")
        assert pen(healthy, healthy) == 0.0
        assert pen(self._node("h_susp"), healthy) == 50.0
        assert pen(self._node("h_conf"), healthy) == 500.0
        both = pen(self._node("h_conf"), self._node("h_susp"))
        assert both == 550.0  # additive, finite — never a veto

    def test_unknown_host_pays_nothing(self):
        det = AnomalyDetector(dump_on_confirm=False)
        det.state["h0"] = CONFIRMED
        pen = det.scheduler_penalty()
        assert pen({}, {"node_labels": {}}) == 0.0


class TestBucketDeltaP99:
    def test_first_window_is_the_full_histogram(self):
        cur = {"1000": 5.0, "8000": 5.0, "+Inf": 5.0}
        assert bucket_delta_p99_us(cur, {}) == 1000.0

    def test_delta_sees_only_the_new_observations(self):
        """The old fast observations must not dilute a window whose
        NEW observations are all slow."""
        base = {"1000": 50.0, "8000": 50.0, "+Inf": 50.0}
        cur = {"1000": 50.0, "8000": 55.0, "+Inf": 55.0}
        assert bucket_delta_p99_us(cur, base) == 8000.0

    def test_no_new_observations_is_none(self):
        base = {"1000": 5.0, "+Inf": 5.0}
        assert bucket_delta_p99_us(dict(base), base) is None
        assert bucket_delta_p99_us({}, {}) is None

    def test_counter_regression_is_respawn_not_evidence(self):
        base = {"1000": 50.0, "+Inf": 50.0}
        cur = {"1000": 3.0, "+Inf": 3.0}  # worker restarted
        assert bucket_delta_p99_us(cur, base) is None


class TestDetectionReport:
    def test_flag_within_k_detects_with_latency(self):
        truth = [TruthWindow("n1", window=4, lifetime=1)]
        det = detection_report(truth, {"n1": [5, 6]}, windows=12, k=2)
        assert det["recall"] == 1.0 and not det["missed"]
        assert det["detections"][0]["detect_windows"] == 1
        assert det["detect_windows_max"] == 1.0

    def test_flag_past_k_is_a_miss(self):
        truth = [TruthWindow("n1", window=4, lifetime=1)]
        det = detection_report(truth, {"n1": [9]}, windows=12, k=2)
        assert det["recall"] == 0.0
        assert det["missed"][0]["node"] == "n1"

    def test_false_positive_only_on_clean_windows(self):
        """A flag inside any scheduled fault's footprint (lifetime +
        settle decay) is shared fate, not a detector bug; the same
        flag held across quiet windows is."""
        truth = [TruthWindow("n1", window=2, lifetime=1)]
        flagged = {"n1": [2, 3],      # the detection
                   "n0": [3],         # collateral during the fault
                   "n2": [10, 11]}    # persistent flag, QUIET fleet
        det = detection_report(truth, flagged, windows=12, k=2,
                               settle_windows=2)
        assert det["recall"] == 1.0
        assert det["false_positives"] == [
            {"node": "n2", "window": 10},
            {"node": "n2", "window": 11}]
        assert det["false_positive_count"] == 2

    def test_transient_single_window_flag_is_not_a_false_positive(self):
        """One hot window that self-clears is below the same
        persistence bar the ladder demands for conviction — a loaded
        host's scheduling hiccup, not a page."""
        det = detection_report([], {"n2": [11]}, windows=14,
                               settle_windows=2)
        assert det["false_positive_count"] == 0
        # Two isolated transients are still transients...
        det = detection_report([], {"n2": [5, 11]}, windows=14,
                               settle_windows=2)
        assert det["false_positive_count"] == 0
        # ...but consecutive windows are persistence.
        det = detection_report([], {"n2": [10, 11]}, windows=14,
                               settle_windows=2)
        assert det["false_positive_count"] == 2

    def test_chaos_windows_extend_the_footprint(self):
        """Non-grey scheduled faults (kills, link drops) carry no
        truth entry but their windows are still not clean."""
        det = detection_report([], {"n0": [7]}, windows=12,
                               chaos_windows={7})
        assert det["false_positive_count"] == 0

    def test_no_truth_is_vacuous(self):
        det = detection_report([], {}, windows=10)
        assert det["recall"] == 1.0
        assert det["detect_windows_max"] == 0.0
        assert det["clean_windows"] == 10


class TestAgentTopSuspicionPanel:
    def _fams(self, gauges, events=()):
        fams = {f: [] for f in ("agent_rate", "agent_goodput",
                                "agent_gauge", "agent_latency",
                                "agent_exemplar", "agent_events")}
        fams["agent_gauge"] = [({"name": n}, v) for n, v in gauges]
        fams["agent_events"] = [({"event": n}, v) for n, v in events]
        return fams

    def test_panel_rows_scores_and_verdicts(self):
        top = _load_cli("agent_top")
        model = top.digest(self._fams(
            [("anomaly.score.n0", 0.2), ("anomaly.state.n0", 0.0),
             ("anomaly.score.n2", 7.4), ("anomaly.state.n2", 2.0)],
            events=[("anomaly.confirmed", 1.0),
                    ("anomaly.suspect", 2.0)]))
        rows = model["suspicion"]["rows"]
        assert [r["node"] for r in rows] == ["n2", "n0"]  # worst first
        assert rows[0]["state"] == 2
        assert model["suspicion"]["confirmed"] == 1.0
        # The raw anomaly gauges do not double-render in the gauge
        # panel.
        assert not any(n.startswith("anomaly.")
                       for n, _ in model["gauges"])
        out = top.render(model, "test")
        assert "suspicion (grey-failure)" in out
        assert "CONFIRMED-GREY" in out
        assert "healthy" in out
        assert "#" in out  # the score bar

    def test_panel_absent_without_detector_gauges(self):
        top = _load_cli("agent_top")
        model = top.digest(self._fams([("dcn.stripes.active", 2.0)]))
        assert model["suspicion"] is None
        assert "suspicion" not in top.render(model, "test")

    def test_demo_seeds_the_panel(self, capsys):
        top = _load_cli("agent_top")
        rc = top.main(["--demo", "--once"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "suspicion (grey-failure)" in out
        assert "CONFIRMED-GREY" in out


# ---------------------------------------------------------------------------
# the slow_shm grey fault: schedule grammar + daemon throttle
# ---------------------------------------------------------------------------


class TestSlowShmSchedule:
    def test_shm_scenarios_add_the_window_five_leg(self):
        s = SoakSchedule(99, NAMES, shm=True)
        (slow,) = s.faults_for(5)
        assert slow["slow_shm"] in NAMES and slow["for"] == 1
        assert s.last_deterministic == 5

    def test_socket_scenarios_never_draw_slow_shm(self):
        """A socket-only fleet never commits to shm — the fault would
        be a no-op and the judge would count an undetectable truth."""
        s = SoakSchedule(99, NAMES)
        assert s.last_deterministic == 4
        for w in range(60):
            for entry in s.faults_for(w):
                assert "slow_shm" not in entry

    def test_shm_flag_never_perturbs_other_draws(self):
        """slow_shm draws from a band the non-shm grammar leaves
        clean: any window where the socket grammar drew something must
        draw EXACTLY the same thing with shm on."""
        plain = SoakSchedule(1234, NAMES)
        shm = SoakSchedule(1234, NAMES, shm=True)
        for w in range(6, 60):
            a, b = plain.faults_for(w), shm.faults_for(w)
            if a:
                assert a == b
            elif b:
                (extra,) = b
                assert "slow_shm" in extra

    def test_set_shm_delay_clamped(self, tmp_path):
        d = PyXferd(str(tmp_path / "a"), node="a")
        assert d.set_shm_delay(99.0) == 2.0
        assert d.set_shm_delay(-5.0) == 0.0
        assert d.set_shm_delay(0.25) == 0.25
        assert d.set_shm_delay(0.0) == 0.0


class TestRecordTruth:
    class _Stub:
        def __init__(self, tel):
            self.telemetry = tel

    class _Tel:
        def __init__(self):
            self.anomaly_truth = []
            self.anomaly_chaos = set()

    def test_grey_family_faults_become_truth_with_footprint(self):
        tel = self._Tel()
        world = self._Stub(tel)
        soak.SoakWorld._record_truth(
            world, 3, {"slow_shm": "n1", "for": 1, "applied": 2})
        (t,) = tel.anomaly_truth
        assert t == {"node": "n1", "window": 3, "lifetime": 1,
                     "kind": "slow_shm"}
        # Footprint: lifetime + the settle decay allowance.
        span = 1 + soak.ANOMALY_SETTLE_WINDOWS + 1
        assert tel.anomaly_chaos == set(range(3, 3 + span))

    def test_non_grey_faults_mark_chaos_only(self):
        tel = self._Tel()
        soak.SoakWorld._record_truth(
            self._Stub(tel), 1,
            {"action": "kill", "node": "n0", "for": 1, "applied": 1})
        assert tel.anomaly_truth == []
        assert 1 in tel.anomaly_chaos

    def test_unapplied_faults_are_not_truth(self):
        tel = self._Tel()
        soak.SoakWorld._record_truth(
            self._Stub(tel), 2,
            {"grey": "nX", "for": 1, "applied": 0,
             "skipped": "unknown node"})
        assert tel.anomaly_truth == [] and tel.anomaly_chaos == set()


# ---------------------------------------------------------------------------
# the composed proof: scripted grey -> confirm -> SIGKILL -> clear
# ---------------------------------------------------------------------------


class _ScriptedSchedule:
    """A deterministic stand-in for SoakSchedule: a sustained
    slow_ring grey on a known node (node-local completer throttle, so
    the attribution is unambiguous — the ``grey:`` kind smears link
    latency onto every peer), then a SIGKILL of the same node — the
    confirm must come from the peer-relative evidence, and the clear
    must survive the respawn's counter resets."""

    def __init__(self, names):
        self.names = list(names)
        self.grey_node = self.names[-1]
        self.last_deterministic = 5

    def faults_for(self, window):
        if window == 1:
            return [{"slow_ring": self.grey_node, "for": 3}]
        if window == 5:
            return [{"action": "kill", "node": self.grey_node,
                     "for": 1}]
        return []


@pytest.mark.slow
class TestGreyConfirmAndClearE2E:
    def test_scripted_grey_is_confirmed_then_cleared(self):
        t0 = time.monotonic()
        world = soak.SoakWorld(
            {"nodes": 3, "proc": True, "shm": True,
             "shm_direct": False, "min_windows": 14,
             "payload_bytes": 32768, "chunk_bytes": 8192,
             "slo": {"min_final_goodput_bps": 1024,
                     "max_dedup_ratio": 0.9,
                     "max_grey_detection_windows": 4}},
            duration_s=8.0, window_s=1.0, seed=77)
        try:
            world.schedule = _ScriptedSchedule(
                list(world.topology.specs))
            grey = world.schedule.grey_node
            report = world.run()
        finally:
            world.close()
        assert report["converged"]
        anom = report["anomaly"]
        assert anom["enabled"]
        # The grey node was CONFIRMED from peer-relative evidence...
        assert any(c["entity"] == grey
                   for c in anom["confirmations"]), anom
        # ...and cleared by the end: the heal plus the respawn's fresh
        # process left nothing to convict.
        assert anom["verdicts"][grey]["state"] == "healthy", anom
        det = anom["detection"]
        assert det["truth"] >= 1
        assert det["recall"] == 1.0, det
        assert det["false_positive_count"] == 0, det
        # The detection-latency SLO measurement landed.
        (check,) = [c for c in report["slo"]["checks"]
                    if c["slo"] == "max_grey_detection_windows"]
        assert check["value"] <= anomaly.DETECT_WINDOWS_K
        assert time.monotonic() - t0 < 120


# ---------------------------------------------------------------------------
# Parity with the JAX package's detector
# ---------------------------------------------------------------------------


def _windows(seed, n_windows=40, nodes=6):
    """Seeded evidence: a latency stream and a goodput stream over
    ``nodes`` nodes, with one node going grey for a stretch and a node
    absent now and then."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(nodes)]
    sick = names[int(rng.integers(0, nodes))]
    start = int(rng.integers(3, n_windows // 2))
    stop = start + int(rng.integers(2, 10))
    out = []
    for w in range(n_windows):
        lat = {n: float(rng.lognormal(8, 0.2)) for n in names}
        good = {n: float(rng.normal(2.6e5, 2e4)) for n in names}
        if start <= w < stop:
            lat[sick] *= float(rng.uniform(3, 30))
            good[sick] *= float(rng.uniform(0.05, 0.5))
        absent = ({names[int(rng.integers(0, nodes))]}
                  if rng.random() < 0.15 else set())
        out.append((w, lat, good, absent))
    return out, sick, start, stop


def _run(mod, windows, cfg_kwargs):
    det = mod.AnomalyDetector(mod.AnomalyConfig(**cfg_kwargs),
                              dump_on_confirm=False)
    seq = []
    for w, lat, good, absent in windows:
        evidence = [
            mod.Evidence("p99_us", lat, direction="high",
                         abs_floor=256.0),
            mod.Evidence("goodput", good, direction="low",
                         abs_floor=4096.0, rel_floor=0.1),
        ]
        inst = det.observe(w, evidence, absent=absent)
        seq.append((inst, dict(det.state), dict(det.score)))
    return seq, det.report()


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("cfg", [{}, {"warmup_windows": 2},
                                 {"confirm_windows": 3, "clear_windows": 2}],
                         ids=["default", "warmup", "slow-ladder"])
def test_verdict_sequence_equal_on_seeded_windows(seed, cfg):
    windows, sick, start, stop = _windows(seed)
    port_seq, port_report = _run(anomaly, windows, cfg)
    jax_seq, jax_report = _run(jax_anomaly, windows, cfg)
    assert port_seq == jax_seq
    assert port_report == jax_report
    truth = [anomaly.TruthWindow(sick, start, stop - start)]
    jax_truth = [jax_anomaly.TruthWindow(sick, start, stop - start)]
    flagged = port_report["flagged_windows"]
    assert anomaly.detection_report(truth, flagged, len(windows)) == \
        jax_anomaly.detection_report(jax_truth, flagged, len(windows))


@pytest.mark.parametrize("seed", range(4))
def test_robust_zscores_equal_on_seeded_values(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        n = int(rng.integers(1, 9))
        values = {f"n{i}": float(v)
                  for i, v in enumerate(rng.lognormal(5, 1.5, n))}
        for direction in ("high", "low"):
            for abs_floor in (0.0, 1.0, 500.0):
                assert robust_zscores(values, direction=direction,
                                      abs_floor=abs_floor) == \
                    jax_anomaly.robust_zscores(values, direction=direction,
                                               abs_floor=abs_floor)


@pytest.mark.parametrize("seed", range(3))
def test_bucket_delta_p99_equal_on_seeded_buckets(seed):
    rng = np.random.default_rng(seed)
    les = [str(1 << k) for k in range(4, 20)]
    prev = {}
    for _ in range(10):
        cum, total = {}, float(prev.get("+Inf", 0.0))
        base = {le: float(prev.get(le, 0.0)) for le in les}
        running = 0.0
        for le in les:
            running += float(rng.integers(0, 5))
            cum[le] = base[le] + running
        cum["+Inf"] = max(cum[les[-1]], total)
        assert bucket_delta_p99_us(cum, prev) == \
            jax_anomaly.bucket_delta_p99_us(cum, prev)
        prev = cum
