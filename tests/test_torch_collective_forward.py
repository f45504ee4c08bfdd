"""The port's forward op and daemon-routed collective rounds
(counterpart of tests/test_collective_forward.py).

Wire level: the ``forward`` op on a standalone daemon pair — capability
handshake and the capability-less handle, daemon→daemon movement with
reduce combining, caller-assigned seq discipline, the lost-response
replay converging exactly once, and ``_combine_into`` against
``synth.combine``.  Fleet level: routed rounds on the port's in-process
fleet — zero coordinator payload bytes, link loss on the forwarded hop
retried under the SAME seq (in the daemon, then re-posted by the
engine), a forward-less daemon downgrading mid-schedule, a killed daemon
failing the round cleanly then recovering — and a routed round's
accounting equal to the JAX package's on the same fleet.
"""

import time
import uuid

import pytest

from container_engine_accelerators_tpu_torch.collectives import synth
from container_engine_accelerators_tpu_torch.collectives.runner import (
    CollectiveConfig,
    CollectiveEngine,
)
from container_engine_accelerators_tpu_torch.fleet import (
    FleetController,
    PyXferd,
)
from container_engine_accelerators_tpu_torch.fleet.xferd import _combine_into
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries
from container_engine_accelerators_tpu_torch.parallel import dcn
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferError,
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

FAST_RETRY = RetryPolicy(
    max_attempts=8, initial_backoff_s=0.01, max_backoff_s=0.1,
    deadline_s=15.0,
)

PAYLOAD = bytes(range(256)) * 16  # 4 KiB
N = len(PAYLOAD)


@pytest.fixture
def xferd_pair(tmp_path):
    a = PyXferd(str(tmp_path / "a"), node="na").start()
    b = PyXferd(str(tmp_path / "b"), node="nb").start()
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


def _flow():
    return f"fwd-{uuid.uuid4().hex[:8]}"


def _stage_both(ca, cb, flow, a_bytes, b_bytes):
    """Routed-round setup discipline: the flow registered and staged
    on BOTH daemons (the destination's baseline is what reduce legs
    combine into)."""
    for c, data in ((ca, a_bytes), (cb, b_bytes)):
        c.register_flow(flow, bytes=len(data))
        c.put(flow, data)
        dcn.wait_flow_rx(c, flow, len(data), timeout_s=10)


def _wait_counter(name, floor, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if counters.get(name) >= floor:
            return True
        time.sleep(0.01)
    return False


# ---- wire level ------------------------------------------------------------


class TestForwardWire:
    def test_capability_advertised_and_removable(self, tmp_path,
                                                 xferd_pair):
        _a, _b, ca, _cb = xferd_pair
        assert ca.supports_forward()
        legacy = PyXferd(str(tmp_path / "legacy"), node="nl",
                         forward=False).start()
        try:
            cl = ResilientDcnXferClient(str(tmp_path / "legacy"),
                                        retry=FAST_RETRY)
            try:
                assert not cl.supports_forward()
                cl.register_flow("f", bytes=N)
                cl.put("f", PAYLOAD)
                with pytest.raises(DcnXferError,
                                   match="unknown op"):
                    cl.forward("f", "127.0.0.1", _b.data_port, 64,
                               seq=1)
            finally:
                cl.close()
        finally:
            legacy.stop()

    def test_forward_moves_range_daemon_to_daemon(self, xferd_pair):
        a, b, ca, cb = xferd_pair
        flow = _flow()
        base = bytes(N)  # zeros on the destination
        _stage_both(ca, cb, flow, PAYLOAD, base)
        off, ln = 512, 1024
        before_frames = counters.get("xferd.forward.frames")
        before_lane = timeseries.gauges().get(
            "dcn.lane.forward.total_bytes", 0)
        resp = ca.forward(flow, "127.0.0.1", b.data_port, ln,
                          offset=off, seq=1, total=N)
        assert resp["bytes"] == ln
        dcn.wait_flow_rx(cb, flow, N + ln, timeout_s=10)
        # plain (non-reduce) forward overwrites the range, leaves the
        # rest of the destination untouched
        landed = cb.read(flow, N)
        assert landed[off:off + ln] == PAYLOAD[off:off + ln]
        assert landed[:off] == base[:off]
        assert landed[off + ln:] == base[off + ln:]
        # the hop is its own lane: forward counters/gauges move …
        assert counters.get("xferd.forward.frames") \
            == before_frames + 1
        assert timeseries.gauges()["dcn.lane.forward.total_bytes"] \
            == before_lane + ln

    def test_reduce_forward_combines_like_synth(self, xferd_pair):
        a, b, ca, cb = xferd_pair
        flow = _flow()
        base = bytes(reversed(PAYLOAD))
        _stage_both(ca, cb, flow, PAYLOAD, base)
        ca.forward(flow, "127.0.0.1", b.data_port, N, seq=1,
                   total=N, reduce=True)
        dcn.wait_flow_rx(cb, flow, 2 * N, timeout_s=10)
        want = bytearray(base)
        synth.combine(want, 0, PAYLOAD)
        assert cb.read(flow, N) == bytes(want)

    def test_seq_is_caller_assigned_and_required(self, xferd_pair):
        _a, b, ca, cb = xferd_pair
        flow = _flow()
        _stage_both(ca, cb, flow, PAYLOAD, bytes(N))
        with pytest.raises(DcnXferError, match="seq"):
            ca.forward(flow, "127.0.0.1", b.data_port, 64, seq=0)

    def test_unstaged_range_errors_after_bounded_wait(self,
                                                     xferd_pair):
        _a, b, ca, _cb = xferd_pair
        flow = _flow()
        ca.register_flow(flow, bytes=N)  # registered, nothing staged
        with pytest.raises(DcnXferError, match="not staged"):
            ca.forward(flow, "127.0.0.1", b.data_port, 64, seq=1,
                       stage_wait_ms=50)

    def test_lost_response_replay_converges_exactly_once(
            self, xferd_pair):
        """The chaos gate's dedup evidence: the daemon forwards the
        frame, the answer is lost (conn severed before responding),
        the resilient client replays the op — SAME caller-assigned
        seq — and the destination dedups the second frame.  A reduce
        leg makes double-landing detectable byte-for-byte: applied
        twice, the result would differ."""
        a, b, ca, cb = xferd_pair
        flow = _flow()
        base = bytes(reversed(PAYLOAD))
        _stage_both(ca, cb, flow, PAYLOAD, base)
        before_dedup = counters.get("dcn.frames.deduped")
        a.drop_response_once("forward")
        ca.forward(flow, "127.0.0.1", b.data_port, N, seq=7,
                   total=N, reduce=True)
        # both frames reach the destination eventually; the second is
        # dropped by the seq window
        assert _wait_counter("dcn.frames.deduped", before_dedup + 1)
        dcn.wait_flow_rx(cb, flow, 2 * N, timeout_s=10)
        want = bytearray(base)
        synth.combine(want, 0, PAYLOAD)
        assert cb.read(flow, N) == bytes(want), \
            "replayed reduce leg applied more than once"

    @pytest.mark.parametrize("size", [3, 1024])
    def test_combine_into_matches_synth_combine(self, size):
        """The daemon's landing-side reduce and the oracle's reduce
        must be the same function, at both the small-buffer loop and
        the vectorized path."""
        total = size + 64
        dst_a = bytearray(bytes((i * 5) % 251 for i in range(total)))
        dst_b = bytearray(dst_a)
        payload = bytes((i * 11 + 3) % 249 for i in range(size))
        _combine_into(dst_a, 32, payload)
        synth.combine(dst_b, 32, payload)
        assert dst_a == dst_b


# ---- fleet level: routed rounds under chaos --------------------------------


class TestRoutedChaos:
    def _fleet(self, nodes=3, racks=1):
        return FleetController({
            "name": "routed-chaos", "nodes": nodes, "racks": racks,
            "chips": 2, "topology": "1x2x1", "rounds": 0,
            "metrics": False,
        }).boot()

    def _engine(self, ctl, **cfg_kw):
        cfg_kw.setdefault("op", "all_reduce")
        cfg_kw.setdefault("bytes", 8192)
        cfg_kw.setdefault("routed", True)
        return CollectiveEngine(ctl.nodes, ctl.topology,
                                links=ctl.links,
                                cfg=CollectiveConfig(**cfg_kw))

    def test_routed_round_is_pure_control_plane(self):
        ctl = self._fleet()
        try:
            engine = self._engine(ctl)
            try:
                before_lane = timeseries.gauges().get(
                    "dcn.lane.forward.total_bytes", 0)
                entry = engine.run_round(0)
                assert entry["ok"], entry
                routed = entry["routed"]
                assert routed["forward_legs"] > 0
                assert routed["forward_bytes"] > 0
                assert routed["downgraded_legs"] == 0
                # THE claim: zero payload bytes through the
                # coordinator's clients — every forwarded byte is on
                # the daemons' forward lane instead.
                assert routed["coordinator_payload_bytes"] == 0
                lane = timeseries.gauges()[
                    "dcn.lane.forward.total_bytes"]
                assert lane - before_lane == routed["forward_bytes"]
            finally:
                engine.close()
        finally:
            ctl.close()

    def test_link_drop_is_retried_in_daemon_under_same_seq(self):
        """drop:1 on a scheduled hop: the source daemon's in-op retry
        retransmits the SAME seq and the round completes verified —
        the coordinator never notices."""
        ctl = self._fleet()
        try:
            assert ctl.links.apply("node:n0->node:n1:drop:1")
            before = counters.get("fleet.link.dropped")
            engine = self._engine(ctl)
            try:
                entry = engine.run_round(0)
                assert entry["ok"], entry
                assert counters.get("fleet.link.dropped") \
                    == before + 1
                # the daemon reported its retry up through the leg
                # verdict into the round accounting
                assert entry["routed"]["forward_retries"] >= 1
            finally:
                engine.close()
        finally:
            ctl.close()

    def test_drop_budget_exhaustion_reposts_same_seq_from_engine(
            self):
        """drop:3 eats the daemon's whole per-hop budget: the leg
        verdict comes back terminal, the engine re-posts the leg —
        SAME seq, landed-or-dup either way — and the round still
        completes verified."""
        ctl = self._fleet()
        try:
            assert ctl.links.apply("node:n0->node:n1:drop:3")
            before_drop = counters.get("fleet.link.dropped")
            before_retry = counters.get("collective.forward.retried")
            engine = self._engine(ctl)
            try:
                entry = engine.run_round(0)
                assert entry["ok"], entry
                assert counters.get("fleet.link.dropped") \
                    == before_drop + 3
                assert counters.get("collective.forward.retried") \
                    > before_retry
            finally:
                engine.close()
        finally:
            ctl.close()

    def test_forwardless_daemon_downgrades_mid_schedule(self):
        """One daemon loses the forward capability: its legs answer
        "unknown op" and the engine downgrades them to
        coordinator-routed legs mid-schedule — same seqs, round still
        verifies, and the lane accounting shows exactly the
        downgraded bytes crossing the coordinator."""
        ctl = self._fleet()
        try:
            ctl.nodes["n1"].daemon.forward_enabled = False
            before = counters.get("collective.forward.downgraded")
            engine = self._engine(ctl)
            try:
                entry = engine.run_round(0)
                assert entry["ok"], entry
                routed = entry["routed"]
                assert routed["downgraded_legs"] > 0
                assert routed["forward_legs"] > 0  # others forwarded
                assert routed["coordinator_payload_bytes"] > 0
                assert counters.get("collective.forward.downgraded") \
                    > before
            finally:
                engine.close()
        finally:
            ctl.close()

    def test_killed_daemon_fails_round_cleanly_then_recovers(self):
        ctl = self._fleet()
        try:
            engine = self._engine(ctl)
            try:
                assert engine.run_round(0)["ok"]
                ctl.nodes["n2"].kill_daemon()
                entry = engine.run_round(1)
                assert not entry["ok"]
                assert "down" in entry["error"]
                ctl.nodes["n2"].restart_daemon()
                entry = engine.run_round(2)
                assert entry["ok"], entry
                assert entry["routed"]["coordinator_payload_bytes"] \
                    == 0
            finally:
                engine.close()
        finally:
            ctl.close()


def test_routed_round_accounting_equals_jax():
    """The same routed all_reduce round over both packages' fleets:
    the same schedule, legs, forwarded bytes and verdicts."""
    from container_engine_accelerators_tpu.collectives import runner as jr
    from container_engine_accelerators_tpu.fleet import controller as jc

    out = []
    for ctl_mod, run_mod in ((jc, jr), (None, None)):
        ctl_cls = (ctl_mod.FleetController if ctl_mod is not None
                   else FleetController)
        cfg_cls = (run_mod.CollectiveConfig if run_mod is not None
                   else CollectiveConfig)
        eng_cls = (run_mod.CollectiveEngine if run_mod is not None
                   else CollectiveEngine)
        ctl = ctl_cls({"name": "routed-parity", "nodes": 4, "racks": 2,
                       "chips": 2, "topology": "1x2x1", "rounds": 0,
                       "metrics": False}).boot()
        try:
            engine = eng_cls(ctl.nodes, ctl.topology, links=ctl.links,
                             cfg=cfg_cls(op="all_reduce", bytes=8192,
                                         routed=True))
            try:
                entry = engine.run_round(0)
                routed = entry["routed"]
                out.append({
                    "ok": entry["ok"],
                    "algorithm": entry["algorithm"],
                    "transfers": entry["transfers"],
                    "forward_legs": routed["forward_legs"],
                    "forward_bytes": routed["forward_bytes"],
                    "downgraded_legs": routed["downgraded_legs"],
                    "coordinator_payload_bytes":
                        routed["coordinator_payload_bytes"],
                    # The estimate prices measured goodput, which
                    # differs run to run; the plan itself does not.
                    "schedule": {
                        k: v for k, v
                        in engine.synth.current().to_dict().items()
                        if k != "est_cost_ms"},
                })
            finally:
                engine.close()
        finally:
            ctl.close()
    assert out[0]["ok"] and out[1] == out[0]
