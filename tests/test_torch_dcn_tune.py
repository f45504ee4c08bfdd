"""Self-tuning data plane: the closed-loop controller's decision table,
its registry, and the pipeline integration, in the port (counterpart
of tests/test_dcn_tune.py).

The decision table is pinned row by row against a pure FlowTuner —
shrink-on-retransmit, back-off-on-loss, grow-while-goodput-scales,
narrow-when-fan-out-costs, hysteresis (no flap on a noisy signal),
floor/ceiling clamps, kill-switch inertness — because the controller
is the part that must stay correct under everything the chaos suites
throw at the pipeline.  Integration runs against a real PyXferd pair
with the proc-mode link shim injecting loss, proving the loop closes
end to end with exactly-once intact while the grid changes between
retry rounds.  The JAX file's fleet scenario (degrade mid-run, heal,
goodput floor; marked slow there) waits for the port of
``fleet/controller.py``.
"""

import uuid

import pytest

from container_engine_accelerators_tpu_torch.fleet.xferd import PyXferd
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries
from container_engine_accelerators_tpu_torch.parallel import (
    dcn_pipeline,
    dcn_tune,
)
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

FAST_RETRY = RetryPolicy(
    max_attempts=6, initial_backoff_s=0.01, max_backoff_s=0.1,
    deadline_s=10.0,
)

BASE_CHUNK = 1 << 20
BASE_STRIPES = 2


@pytest.fixture(autouse=True)
def _fresh_tuners():
    dcn_tune.reset()
    yield
    dcn_tune.reset()


def tuner(**cfg_kw):
    cfg_kw.setdefault("min_chunk_bytes", 4096)
    return dcn_tune.FlowTuner("t:1", dcn_tune.TuneConfig(**cfg_kw))


def clean(t, goodput=1000.0, n=1, lane="socket"):
    out = []
    for _ in range(n):
        out.append(t.on_round(attempted=8, failed=0,
                              bytes_confirmed=int(goodput),
                              elapsed_s=1.0, lane=lane))
    return out


def lossy(t, retx=0.5, lane="socket"):
    failed = int(8 * retx)
    return t.on_round(attempted=8, failed=failed,
                      bytes_confirmed=(8 - failed) * 100,
                      elapsed_s=1.0, lane=lane)


class TestDecisionTable:
    def test_shrink_on_retransmit_halves_chunk(self):
        t = tuner()
        t.plan(BASE_CHUNK, 1)  # one stripe: no stripe lever to take
        assert lossy(t, retx=0.125) == "shrink_chunk"
        assert t.plan(BASE_CHUNK, 1)[0] == BASE_CHUNK // 2
        # Repeated loss keeps shrinking (multiplicative decrease is
        # NOT cooldown-gated) down to the floor.
        while lossy(t, retx=0.5) == "shrink_chunk":
            pass
        assert t.plan(BASE_CHUNK, 1)[0] == 4096
        c0 = counters.get("dcn.tune.clamped")
        assert lossy(t, retx=0.5) is None  # both levers at floor
        assert counters.get("dcn.tune.clamped") == c0 + 1

    def test_backoff_stripes_on_heavy_loss_before_chunk(self):
        t = tuner()
        t.plan(BASE_CHUNK, 4)
        assert lossy(t, retx=0.5) == "backoff_stripe"
        assert t.stripes_now() == 3
        # Light loss (below backoff_retx) goes for the chunk instead.
        assert lossy(t, retx=0.125) == "shrink_chunk"
        assert t.stripes_now() == 3

    def test_grow_while_goodput_scales(self):
        t = tuner(max_stripes=4)
        t.plan(BASE_CHUNK, 2)
        seen = []
        for _ in range(14):
            s = t.stripes_now()
            seen.append(t.on_round(attempted=8, failed=0,
                                   bytes_confirmed=1000 * s,
                                   elapsed_s=1.0))
        # Every up-probe paid off (perfect scaling): grown 2->3->4 and
        # kept both times; at the ceiling the one exploratory narrow
        # probe reverts (narrower measurably loses) and a floor pins
        # the optimum — no oscillation after that.
        assert seen.count("grow_stripe") == 2
        assert seen.count("keep_stripe") == 2
        assert t.stripes_now() == 4  # ceiling reached, scaling held

    def test_probe_reverts_when_goodput_stops_scaling(self):
        t = tuner()
        t.plan(BASE_CHUNK, BASE_STRIPES)
        decisions = clean(t, goodput=1000, n=8)  # flat: growth never pays
        assert "grow_stripe" in decisions
        assert "revert_stripe" in decisions
        assert "keep_stripe" not in decisions[:decisions.index(
            "revert_stripe")]

    def test_no_flap_after_revert(self):
        """The hysteresis headline: once a probe reverted, the same
        value is never re-probed while its bound lives — a noisy flat
        signal settles instead of oscillating.  (bound_ttl pinned
        high: TTL re-exploration has its own test below.)"""
        t = tuner(bound_ttl_obs=1000)
        t.plan(BASE_CHUNK, BASE_STRIPES)
        decisions = clean(t, goodput=1000, n=30)
        # Bounded exploration: one up-probe (reverted), one down-probe
        # (reverted: flat noise must not drain stripes), then silence.
        assert decisions.count("grow_stripe") == 1
        assert decisions.count("narrow_stripe") == 1
        tail = decisions[-15:]
        assert set(tail) == {None}
        assert t.stripes_now() == BASE_STRIPES

    def test_bounds_expire_and_reexplore(self):
        """A bound pinned by one (possibly noisy) measurement ages out
        after bound_ttl_obs clean observations: the tuner re-probes —
        bounded, infrequent — instead of freezing the grid forever on
        a loss-free link."""
        t = tuner(bound_ttl_obs=6)
        t.plan(BASE_CHUNK, BASE_STRIPES)
        decisions = clean(t, goodput=1000, n=40)
        assert decisions.count("grow_stripe") >= 2  # re-explored
        # ...but re-exploration is rare: far more silence than moves.
        assert decisions.count(None) > len(decisions) * 0.6
        assert t.stripes_now() == BASE_STRIPES  # flat noise: no drift

    def test_narrow_probe_kept_when_fanout_costs(self):
        """The loopback-rig shape: per-stripe overhead, 1 stripe beats
        2 — the controller must find the optimum BELOW its base."""
        per_stripe = {1: 530, 2: 430, 3: 380}
        t = tuner()
        t.plan(BASE_CHUNK, 2)
        for _ in range(14):
            s = t.stripes_now()
            t.on_round(attempted=8, failed=0,
                       bytes_confirmed=per_stripe.get(s, 300),
                       elapsed_s=1.0)
        assert t.stripes_now() == 1

    def test_cooldown_blocks_new_probe_right_after_a_move(self):
        """Hysteresis: after a kept probe (a move), the next probe
        cannot launch until the cooldown has passed — even though the
        clean streak already qualifies."""
        t = tuner(cooldown_obs=2, grow_clean_rounds=1, max_stripes=8)
        t.plan(BASE_CHUNK, 2)
        seen = []
        for _ in range(6):
            s = t.stripes_now()
            seen.append(t.on_round(attempted=8, failed=0,
                                   bytes_confirmed=1000 * s,
                                   elapsed_s=1.0))
        # grow (obs1), judged kept (obs2, a move), then TWO cooldown
        # observations before the next probe may launch.
        i = seen.index("keep_stripe")
        assert seen[i + 1] is None and seen[i + 2] is None
        assert seen[i + 3] == "grow_stripe"

    def test_loss_clears_probe_bounds(self):
        t = tuner()
        t.plan(BASE_CHUNK, BASE_STRIPES)
        clean(t, goodput=1000, n=8)  # probe + revert: ceiling learned
        assert t.snapshot()["stripe_ceiling"] is not None
        lossy(t, retx=0.125)
        assert t.snapshot()["stripe_ceiling"] is None

    def test_exposed_ratio_objective_vetoes_probe(self):
        """Goodput up but overlap WORSE: the probe still reverts —
        dcn.exposed_ratio is the objective, not a bystander.  (Two
        failing observations: the probe's noise patience spends one.)"""
        t = tuner(grow_clean_rounds=1, cooldown_obs=0,
                  probe_patience=2)
        t.plan(BASE_CHUNK, BASE_STRIPES)
        t.on_transfer(True, exposed_ratio=0.3)
        assert clean(t, goodput=1000, n=1)[0] == "grow_stripe"
        t.on_transfer(True, exposed_ratio=0.9)  # overlap collapsed
        assert clean(t, goodput=5000, n=1)[0] is None  # patience
        assert clean(t, goodput=5000, n=1)[0] == "revert_stripe"

    def test_chunk_recovers_to_base_after_heal(self):
        t = tuner()
        t.plan(BASE_CHUNK, 1)
        lossy(t, retx=0.25)
        lossy(t, retx=0.25)
        assert t.plan(BASE_CHUNK, 1)[0] == BASE_CHUNK // 4
        decisions = clean(t, n=12)
        assert decisions.count("grow_chunk") == 2
        assert t.plan(BASE_CHUNK, 1)[0] == BASE_CHUNK
        # Recovery stops AT base: the grid never grows past what the
        # operator configured.
        assert "grow_chunk" not in clean(t, n=8)
        assert t.plan(BASE_CHUNK, 1)[0] == BASE_CHUNK

    def test_shm_lane_bypasses_stripe_adaptation_keeps_chunk(self):
        t = tuner()
        t.plan(BASE_CHUNK, BASE_STRIPES)
        # Heavy loss on the shm lane: no stripe lever there — the
        # chunk shrinks instead.
        assert lossy(t, retx=0.5, lane="shm") == "shrink_chunk"
        assert t.stripes_now() == BASE_STRIPES
        # Clean shm rounds never launch stripe probes either.
        assert "grow_stripe" not in clean(t, n=8, lane="shm")
        assert "narrow_stripe" not in clean(t, n=8, lane="shm")

    def test_incomparable_samples_never_feed_probe_verdicts(self):
        """shm rounds (memcpy-class B/s) and partial retry rounds
        (fixed-overhead-dominated B/s) are not capability evidence: a
        probe judged against a baseline they skewed would revert what
        works or keep what doesn't."""
        t = tuner(grow_clean_rounds=1, cooldown_obs=0)
        t.plan(BASE_CHUNK, BASE_STRIPES)
        # Inflate-attempt via shm rounds at memcpy speed: clean
        # evidence for the streak, but NEVER baseline samples — the
        # probe below must be judged against socket-lane goodput.
        clean(t, goodput=10_000_000, n=4, lane="shm")
        assert clean(t, goodput=1000, n=1)[0] == "grow_stripe"
        # Probed-grid rounds that are PARTIAL neither qualify nor
        # spend patience — the verdict waits for comparable evidence.
        for _ in range(6):
            assert t.on_round(attempted=2, failed=0,
                              bytes_confirmed=50, elapsed_s=1.0,
                              full_round=False) is None
        assert t.snapshot()["probing"]
        # A full round with honestly-scaled goodput keeps the probe.
        assert t.on_round(attempted=8, failed=0, bytes_confirmed=2000,
                          elapsed_s=1.0) == "keep_stripe"

    def test_failed_transfer_counts_as_full_loss(self):
        t = tuner()
        t.plan(BASE_CHUNK, 4)
        t.on_transfer(False)
        assert t.stripes_now() == 3  # backoff fired

    def test_floor_ceiling_clamps(self):
        t = tuner(min_chunk_bytes=65536, max_stripes=3, min_stripes=2)
        chunk, stripes = t.plan(32768, 8)
        assert chunk == 32768  # a base below the floor stays put —
        #                        the floor bounds shrinking, it never
        #                        raises the operator's grid
        assert stripes == 3    # base above the ceiling clamps down
        chunk, stripes = t.plan(1 << 20, 1)
        assert stripes == 2    # min_stripes floor
        # Shrinking a small base is a no-op at its own floor.
        t2 = tuner(min_chunk_bytes=65536, min_stripes=1)
        t2.plan(32768, 1)
        assert lossy(t2, retx=0.5) is None  # clamped, not shrunk
        assert t2.plan(32768, 1)[0] == 32768

    def test_malformed_env_knobs_degrade_to_defaults(self):
        cfg = dcn_tune.TuneConfig(env={
            dcn_tune.MIN_CHUNK_ENV: "not-a-number",
            dcn_tune.MAX_STRIPES_ENV: "-3",
        })
        assert cfg.min_chunk_bytes == dcn_tune.DEFAULT_MIN_CHUNK_BYTES
        assert cfg.max_stripes == dcn_tune.DEFAULT_MAX_STRIPES


class TestCpuBoundHold:
    """The profiler verdict acted on: while the cpu_bound latch is
    set, stripe-growth probes are HELD (dcn.tune.cpu_hold), not
    reverted — a hold is not a move, so hysteresis never resets and
    growth resumes the instant the latch clears."""

    @staticmethod
    def _tuner_with_shares(shares, **cfg_kw):
        seq = list(shares)

        def share():
            return seq.pop(0) if len(seq) > 1 else seq[0]

        cfg_kw.setdefault("min_chunk_bytes", 4096)
        t = dcn_tune.FlowTuner(
            "t:cpu", dcn_tune.TuneConfig(**cfg_kw),
            staging_share=share)
        t.plan(BASE_CHUNK, 2)
        return t

    def test_hold_suppresses_growth_then_resumes(self):
        # Staging share climbs 0.10 -> 0.20 with flat goodput: the
        # latch sets on obs 2 (clean streak still below the growth
        # law), obs 3 would grow but is HELD, and with share flat the
        # latch clears so obs 4 grows — one observation of lag on
        # each edge, exactly as designed.
        t = self._tuner_with_shares(
            [0.10, 0.20, 0.20], grow_clean_rounds=3, max_stripes=4)
        h0 = counters.get("dcn.tune.cpu_hold")
        assert clean(t, n=2) == [None, None]
        assert timeseries.gauges()["dcn.tune.cpu_bound"] == 1.0
        assert clean(t) == [None]  # growth-eligible, held instead
        assert counters.get("dcn.tune.cpu_hold") == h0 + 1
        assert timeseries.gauges()["dcn.tune.cpu_bound"] == 0.0
        assert clean(t) == ["grow_stripe"]  # latch gone: growth back
        assert t.stripes_now() == 3

    def test_hold_is_not_a_move_no_hysteresis_reset(self):
        # Share climbs every observation: the latch never clears and
        # every growth-eligible observation is a hold.  If a hold
        # reset _since_move the cooldown would swallow alternate
        # observations and the hold count would halve — each extra
        # clean round must produce its own dcn.tune.cpu_hold.
        t = self._tuner_with_shares(
            [0.10, 0.20, 0.30, 0.40, 0.50, 0.60],
            grow_clean_rounds=3, cooldown_obs=1, max_stripes=4)
        h0 = counters.get("dcn.tune.cpu_hold")
        assert clean(t, n=6) == [None] * 6
        assert counters.get("dcn.tune.cpu_hold") == h0 + 4
        assert t.stripes_now() == 2  # never grew, never reverted

    def test_goodput_scaling_defeats_the_latch(self):
        # Share climbs but goodput climbs with it (beyond the slack):
        # the host is spending more CPU AND moving more bytes — that
        # is healthy scaling, not saturation, and growth proceeds.
        t = self._tuner_with_shares(
            [0.10, 0.20, 0.30, 0.40], grow_clean_rounds=3,
            max_stripes=4)
        h0 = counters.get("dcn.tune.cpu_hold")
        out = [clean(t, goodput=1000.0 * (1.3 ** i))[0]
               for i in range(4)]
        assert "grow_stripe" in out
        assert counters.get("dcn.tune.cpu_hold") == h0
        assert timeseries.gauges()["dcn.tune.cpu_bound"] == 0.0


class TestKillSwitch:
    def test_enabled_by_default(self):
        """The soak world (fleet/soak.py) is the standing evidence:
        absent the env var, the closed loop is ON.  TPU_DCN_TUNE=0
        remains the kill switch."""
        assert dcn_tune.tune_enabled(env={})
        assert dcn_pipeline.PipelineConfig(env={}).tuned

    def test_env_values(self):
        for raw in ("1", "true", "on", "yes"):
            assert dcn_tune.tune_enabled(env={dcn_tune.TUNE_ENV: raw})
        # "" is EXPLICITLY-set-empty — still off: an operator that
        # blanked the var asked for the static grid, default flip or
        # not.
        for raw in ("0", "false", "off", ""):
            assert not dcn_tune.tune_enabled(
                env={dcn_tune.TUNE_ENV: raw})

    def test_config_override_beats_env(self):
        env = {dcn_tune.TUNE_ENV: "1"}
        assert dcn_pipeline.PipelineConfig(env=env).tuned
        assert not dcn_pipeline.PipelineConfig(env=env,
                                               tuned=False).tuned

    def test_kill_switch_is_inert(self, tmp_path):
        """tuned=False: send_pipelined never consults the registry —
        today's static grid runs byte-for-byte (same chunk count, same
        stripe count, no controller state created)."""
        a = PyXferd(str(tmp_path / "a"), node="ka").start()
        b = PyXferd(str(tmp_path / "b"), node="kb").start()
        ca = ResilientDcnXferClient(str(tmp_path / "a"),
                                    retry=FAST_RETRY)
        cb = ResilientDcnXferClient(str(tmp_path / "b"),
                                    retry=FAST_RETRY)
        try:
            payload = bytes(range(256)) * 64  # 16 KiB
            cfg = dcn_pipeline.PipelineConfig(
                chunk_bytes=4096, stripes=2, shm=False, tuned=False)
            flow = f"kill-{uuid.uuid4().hex[:8]}"
            cb.register_flow(flow, bytes=len(payload))
            ca.register_flow(flow, bytes=len(payload))
            res = dcn_pipeline.send_pipelined(
                ca, flow, payload, "127.0.0.1", b.data_port, cfg,
                timeout_s=10)
            assert res["chunks"] == 4 and res["stripes"] == 2
            assert dcn_tune.snapshot() == {}  # registry never touched
            got = dcn_pipeline.read_pipelined(cb, flow, len(payload),
                                              cfg, timeout_s=10)
            assert got == payload
        finally:
            for c in (ca, cb):
                try:
                    c.close()
                except OSError:
                    pass
            a.stop()
            b.stop()


class TestRegistry:
    def test_same_key_same_tuner(self):
        t1 = dcn_tune.tuner_for("h:1")
        t2 = dcn_tune.tuner_for("h:1")
        assert t1 is t2
        assert dcn_tune.tuner_for("h:2") is not t1

    def test_lru_eviction_bounds_the_registry(self):
        keys = [f"h:{i}" for i in range(dcn_tune.MAX_TUNERS + 8)]
        for k in keys:
            dcn_tune.tuner_for(k)
        snap = dcn_tune.snapshot()
        assert len(snap) == dcn_tune.MAX_TUNERS
        # The oldest keys (a respawned daemon's dead ports) aged out.
        assert "h:0" not in snap and keys[-1] in snap

    def test_fresh_key_means_fresh_state(self):
        """The SIGKILL-respawn contract: a respawned daemon binds a
        fresh port, so its tuner starts from the static grid."""
        t = dcn_tune.tuner_for("h:1")
        t.plan(BASE_CHUNK, 1)
        lossy(t, retx=0.25)
        assert t.plan(BASE_CHUNK, 1)[0] < BASE_CHUNK
        t2 = dcn_tune.tuner_for("h:9999")  # the respawn's new port
        assert t2.plan(BASE_CHUNK, 1)[0] == BASE_CHUNK

    def test_plan_publishes_gauges(self):
        t = dcn_tune.tuner_for("h:1")
        t.plan(123456, 3)
        g = timeseries.gauges()
        assert g["dcn.tune.chunk_bytes"] == 123456.0
        assert g["dcn.tune.stripes"] == 3.0
        assert g["dcn.tune.flows"] >= 1.0


@pytest.fixture
def pair(tmp_path):
    a = PyXferd(str(tmp_path / "a"), node="ta").start()
    b = PyXferd(str(tmp_path / "b"), node="tb").start()
    ca = ResilientDcnXferClient(str(tmp_path / "a"), retry=FAST_RETRY)
    cb = ResilientDcnXferClient(str(tmp_path / "b"), retry=FAST_RETRY)
    yield a, b, ca, cb
    for c in (ca, cb):
        try:
            c.close()
        except OSError:
            pass
    a.stop()
    b.stop()


TUNED_CFG_KW = dict(chunk_bytes=4096, stripes=2, shm=False, tuned=True)


class TestPipelineIntegration:
    def _xfer(self, pair, payload, cfg, flow=None):
        a, b, ca, cb = pair
        flow = flow or f"ti-{uuid.uuid4().hex[:8]}"
        cb.register_flow(flow, bytes=len(payload))
        ca.register_flow(flow, bytes=len(payload))
        res = dcn_pipeline.send_pipelined(
            ca, flow, payload, "127.0.0.1", b.data_port, cfg,
            timeout_s=15)
        got = dcn_pipeline.read_pipelined(cb, flow, len(payload), cfg,
                                          timeout_s=15)
        return res, got

    def test_loss_shrinks_grid_and_stays_exactly_once(self, pair):
        """The loop closed end to end: the link shim eats chunks, the
        tuner reacts between retry rounds and transfers, the payload
        still lands byte-exact under the SAME seqs (chaos-suite
        exactly-once while the grid changes mid-transfer)."""
        a, b, _ca, _cb = pair
        payload = bytes(range(256)) * 64  # 16 KiB = 4 chunks
        cfg = dcn_pipeline.PipelineConfig(**TUNED_CFG_KW)
        shrink0 = counters.get("dcn.tune.shrink_chunk")
        backoff0 = counters.get("dcn.tune.backoff_stripe")
        # Eat the first 4 outbound frames toward b: round 0 loses every
        # chunk, the retry round re-sends all four under the same seqs.
        a.set_link_fault("127.0.0.1", b.data_port, "drop", 4)
        res, got = self._xfer(pair, payload, cfg)
        assert got == payload
        assert res["rounds"] >= 2
        moved = (counters.get("dcn.tune.shrink_chunk") > shrink0
                 or counters.get("dcn.tune.backoff_stripe") > backoff0)
        assert moved, "a fully-lost round must move the controller"
        # The NEXT transfer toward this destination plans the adapted
        # grid — more chunks than the static 4 (chunk shrank) or fewer
        # stripes (backoff); either way the plan moved.
        t = dcn_tune.tuner_for(f"127.0.0.1:{b.data_port}")
        chunk, stripes = t.plan(4096, 2)
        assert chunk < 4096 or stripes < 2

    def test_retransmit_ratio_published_per_round(self, pair,
                                                  monkeypatch):
        """Satellite: the gauge reflects loss the moment a round ends,
        not only at transfer completion — the value published after
        the FIRST round already counts the chunks that round lost."""
        a, b, _ca, _cb = pair
        published = []
        real_gauge = timeseries.gauge

        def spy(name, value):
            if name == "dcn.pipeline.retransmit_ratio":
                published.append(value)
            return real_gauge(name, value)

        monkeypatch.setattr(dcn_pipeline.timeseries, "gauge", spy)
        payload = bytes(range(256)) * 64  # 4 chunks of 4096
        cfg = dcn_pipeline.PipelineConfig(chunk_bytes=4096, stripes=2,
                                          shm=False, tuned=False)
        a.set_link_fault("127.0.0.1", b.data_port, "drop", 2)
        res, got = self._xfer(pair, payload, cfg)
        assert got == payload and res["rounds"] == 2
        # After round 0: 2 of 4 chunks pending -> 0.5, BEFORE any
        # retry round started.  After round 1: 2 resent, 0 pending.
        assert published[0] == pytest.approx(0.5)
        assert published[-1] == pytest.approx(0.5)

    def test_tuned_roundtrip_clean_link_matches_static_grid(self, pair):
        """First transfer to a fresh destination: the plan IS the
        static grid (learning starts from the operator's base)."""
        payload = bytes(range(256)) * 64
        cfg = dcn_pipeline.PipelineConfig(**TUNED_CFG_KW)
        res, got = self._xfer(pair, payload, cfg)
        assert got == payload
        assert res["chunks"] == 4 and res["stripes"] == 2
