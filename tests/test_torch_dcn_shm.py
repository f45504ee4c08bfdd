"""Zero-copy same-host staging lane and the memcpy-speed same-host plane
on top of it, in the port (counterpart of tests/test_dcn_shm.py).

Coverage map:

- capability handshake: the shm triple (``shm``/``shm_dir``/
  ``host_id``) is advertised only by shm-enabled daemons, and the
  client's capability cache is PER CONNECTION — a daemon restart is
  re-probed, never trusted stale;
- lane selection: same-host → shm; cross-host identity, shm-disabled
  daemon, or the ``TPU_DCN_SHM`` kill switch → socket, transparently
  (``dcn.shm.fallback`` only when the lane was wanted but unusable);
- segment lifecycle: release/restart unlink segments; frames that
  landed over sockets migrate into the segment on ``shm_read``;
- downgrade: a daemon that loses the capability mid-transfer drops
  the remaining rounds to the socket lane under the SAME chunk seqs;
- recv-into-mmap: chunk payloads land straight into
  assembly buffers; a torn receive never exposes a torn frame;
- descriptor ring: one doorbell per round, completion polled from
  shared memory, work-done-answer-lost chaos dedups on retry;
- daemon↔daemon lane: co-hosted peers move zero payload bytes over
  TCP, with inode-checked staleness rejection and TCP fallback.

The JAX package's chaos half (kill/loss exactly-once with one leg on
shm, tests/test_fleet.py) waits for the port of the fleet rig.
"""

import os
import socket
import struct
import time
import uuid

import pytest

from container_engine_accelerators_tpu_torch.fleet import xferd as xferd_mod
from container_engine_accelerators_tpu_torch.fleet.xferd import PyXferd
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import timeseries
from container_engine_accelerators_tpu_torch.parallel import (
    dcn_pipeline,
    dcn_shm,
)
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferClient,
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy
from tests.xferd_stub import XferdStub

FAST_RETRY = RetryPolicy(
    max_attempts=6, initial_backoff_s=0.01, max_backoff_s=0.1,
    deadline_s=10.0,
)

# tuned=False throughout: the shm suites pin exact lane/chunk wire
# behavior; the (now default-on) closed loop would adapt the grid.
CFG = dcn_pipeline.PipelineConfig(chunk_bytes=4096, stripes=2,
                                  shm=True, tuned=False)
CFG_SOCKET = dcn_pipeline.PipelineConfig(chunk_bytes=4096, stripes=2,
                                         shm=False, tuned=False)
PAYLOAD = bytes(range(256)) * 64  # 16 KiB == 4 chunks under CFG
N = len(PAYLOAD)


def _lane_total(lane):
    return timeseries.gauges().get(f"dcn.lane.{lane}.total_bytes",
                                   0.0)


def _wait_counter(name, floor, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while counters.get(name) < floor:
        assert time.monotonic() < deadline, \
            f"{name} never reached {floor}"
        time.sleep(0.01)


@pytest.fixture
def pair(tmp_path):
    a = PyXferd(str(tmp_path / "a"), node="sa").start()
    b = PyXferd(str(tmp_path / "b"), node="sb").start()
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


def _flow(prefix="sf"):
    return f"{prefix}-{uuid.uuid4().hex[:8]}"


def _roundtrip(ca, cb, b, cfg, payload=PAYLOAD, flow=None):
    flow = flow or _flow()
    cb.register_flow(flow, bytes=len(payload))
    ca.register_flow(flow, bytes=len(payload))
    res = dcn_pipeline.send_pipelined(
        ca, flow, payload, "127.0.0.1", b.data_port, cfg, timeout_s=10)
    got = dcn_pipeline.read_pipelined(cb, flow, len(payload), cfg,
                                      timeout_s=10)
    assert got == payload
    return res


class TestHostIdentity:
    def test_env_override_wins(self):
        assert dcn_shm.host_identity(
            env={dcn_shm.HOST_ID_ENV: "h:override"}) == "h:override"

    def test_identity_is_stable_and_nonempty(self):
        first = dcn_shm.host_identity(env={})
        assert first and first == dcn_shm.host_identity(env={})


class TestCapabilityHandshake:
    def test_daemon_advertises_the_shm_triple(self, pair):
        a, _b, ca, _cb = pair
        caps = ca.capabilities()
        assert caps["shm"] == 1
        assert caps["shm_dir"] == a.shm_dir
        assert caps["host_id"] == dcn_shm.host_identity()
        assert ca.supports_shm()
        assert dcn_pipeline.shm_same_host(ca)

    def test_shm_disabled_daemon_hides_the_capability(self, tmp_path):
        d = PyXferd(str(tmp_path / "d"), node="nd", shm=False).start()
        try:
            c = DcnXferClient(str(tmp_path / "d"))
            assert not c.supports_shm()
            assert not dcn_pipeline.shm_same_host(c)
            # The shm ops refuse loudly rather than half-working.
            c.register_flow("f", bytes=64)
            from container_engine_accelerators_tpu_torch.parallel.dcn_client \
                import DcnXferError

            with pytest.raises(DcnXferError, match="disabled"):
                c.shm_attach("f", 64)
            c.close()
        finally:
            d.stop()

    def test_stub_daemon_has_no_shm(self, tmp_path):
        stub = XferdStub(str(tmp_path / "tpu-dcn")).start()
        try:
            c = DcnXferClient(stub.uds_dir)
            assert not c.supports_shm()
            assert not dcn_pipeline.shm_same_host(c)
            c.close()
        finally:
            stub.stop()

    def test_caps_cache_invalidated_on_reconnect(self, tmp_path):
        """Satellite: capabilities are per-connection.  A daemon that
        restarts WITHOUT shm must be re-probed after the resilient
        client reconnects — a stale handshake would send the client
        into shm ops the new daemon rejects."""
        a = PyXferd(str(tmp_path / "a"), node="ra").start()
        ca = ResilientDcnXferClient(str(tmp_path / "a"),
                                    retry=FAST_RETRY)
        try:
            assert ca.supports_shm()
            assert ca._wait_supported is None  # not probed yet
            a.stop()
            a.shm_enabled = False
            a.start()
            ca.ping()  # reconnect + flow replay; caches dropped
            assert not ca.supports_shm()
            assert not dcn_pipeline.shm_same_host(ca)
        finally:
            ca.close()
            a.stop()


class TestLaneSelection:
    def test_same_host_takes_the_shm_lane(self, pair):
        _a, b, ca, cb = pair
        t0 = counters.get("dcn.shm.transfers")
        r0 = counters.get("dcn.shm.reads")
        f0 = counters.get("dcn.shm.fallback")
        res = _roundtrip(ca, cb, b, CFG)
        assert res["lane"] == "shm"
        assert res["chunks"] == 4 and res["rounds"] == 1
        assert counters.get("dcn.shm.transfers") == t0 + 1
        assert counters.get("dcn.shm.reads") == r0 + 1
        assert counters.get("dcn.shm.fallback") == f0

    def test_kill_switch_pins_the_socket_lane(self, pair):
        """shm=False is an explicit opt-out: socket lane, and NO
        fallback counter — nothing fell back, the operator chose."""
        _a, b, ca, cb = pair
        f0 = counters.get("dcn.shm.fallback")
        res = _roundtrip(ca, cb, b, CFG_SOCKET)
        assert res["lane"] == "socket"
        assert counters.get("dcn.shm.fallback") == f0

    def test_cross_host_identity_stays_on_sockets(self, tmp_path):
        """A daemon advertising a DIFFERENT boot identity (what a
        forwarded UDS to another machine looks like) must never be
        shm-attached, however same its address looks."""
        a = PyXferd(str(tmp_path / "a"), node="xa",
                    host_id="other-boot:other-host").start()
        b = PyXferd(str(tmp_path / "b"), node="xb").start()
        ca = ResilientDcnXferClient(str(tmp_path / "a"),
                                    retry=FAST_RETRY)
        cb = ResilientDcnXferClient(str(tmp_path / "b"),
                                    retry=FAST_RETRY)
        try:
            assert ca.supports_shm()  # offered...
            assert not dcn_pipeline.shm_same_host(ca)  # ...not taken
            res = _roundtrip(ca, cb, b, CFG)
            assert res["lane"] == "socket"
        finally:
            ca.close()
            cb.close()
            a.stop()
            b.stop()

    def test_capability_less_daemon_falls_back_with_counter(
            self, tmp_path):
        """The daemon speaks the pipeline but not shm (the future
        native DXF2 port): the lane is wanted (cfg.shm) but not
        offered — socket lane, silently, no fallback inflation (the
        fallback counter is for a lane that BROKE, not one that was
        never there)."""
        a = PyXferd(str(tmp_path / "a"), node="ca", shm=False).start()
        b = PyXferd(str(tmp_path / "b"), node="cb2").start()
        ca = ResilientDcnXferClient(str(tmp_path / "a"),
                                    retry=FAST_RETRY)
        cb = ResilientDcnXferClient(str(tmp_path / "b"),
                                    retry=FAST_RETRY)
        try:
            res = _roundtrip(ca, cb, b, CFG)
            assert res["lane"] == "socket"
        finally:
            ca.close()
            cb.close()
            a.stop()
            b.stop()


class TestSegmentLifecycle:
    def test_stats_reports_shm_backed_flows(self, pair):
        _a, b, ca, cb = pair
        flow = _flow()
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        assert not ca.stats(flow=flow)["flows"][0]["shm"]
        ca.shm_attach(flow, N)
        assert ca.stats(flow=flow)["flows"][0]["shm"]

    def test_release_unlinks_the_segment_file(self, pair):
        a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=N)
        path = ca.shm_attach(flow, N)["path"]
        assert os.path.exists(path)
        ca.release_flow(flow)
        assert not os.path.exists(path)

    def test_crash_leaves_files_and_restart_wipes_them(self, pair):
        a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=N)
        path = ca.shm_attach(flow, N)["path"]
        a.stop(crash=True)
        assert os.path.exists(path)  # SIGKILL cannot clean up
        a.start()
        assert not os.path.exists(path)  # ...so the next boot does

    def test_shm_read_migrates_socket_landed_frames(self, pair):
        """A frame that landed the classic way (socket staging, no
        segment) becomes shm-readable on demand: shm_read migrates it
        into a fresh segment with one copy."""
        from container_engine_accelerators_tpu_torch.parallel import dcn

        _a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=N)
        ca.put(flow, PAYLOAD)
        dcn.wait_flow_rx(ca, flow, N, timeout_s=10)
        resp = ca.shm_read(flow, N)
        assert resp["frame_bytes"] == N
        seg = dcn_shm.map_segment(resp["path"], resp["bytes"])
        try:
            assert bytes(seg.view[:N]) == PAYLOAD
        finally:
            seg.close()

    def test_attach_grows_in_place_and_keeps_content(self, pair):
        """Re-attaching with a larger size re-truncates the same
        inode: staged content survives, existing mappings of the old
        range stay valid."""
        _a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=N)
        first = ca.shm_attach(flow, N)
        seg = dcn_shm.map_segment(first["path"], first["bytes"])
        seg.view[:N] = PAYLOAD
        ca.shm_commit(flow, N)
        bigger = ca.shm_attach(flow, 4 * N)
        assert bigger["path"] == first["path"]
        assert bigger["bytes"] >= 4 * N
        seg2 = dcn_shm.map_segment(bigger["path"], bigger["bytes"])
        try:
            assert bytes(seg2.view[:N]) == PAYLOAD
            assert ca.shm_read(flow, N)["frame_bytes"] == N
        finally:
            seg.close()
            seg2.close()


class TestDowngrade:
    def test_lost_capability_downgrades_within_the_transfer(
            self, pair):
        """The daemon stops offering shm while the client's handshake
        cache still says yes (the stale-cache window): the shm round's
        attach is rejected, the SAME round completes on the socket
        lane, and the fallback counter records the downgrade."""
        a, b, ca, cb = pair
        assert _roundtrip(ca, cb, b, CFG)["lane"] == "shm"
        a.shm_enabled = False  # no restart: the client cache is stale
        f0 = counters.get("dcn.shm.fallback")
        res = _roundtrip(ca, cb, b, CFG, payload=PAYLOAD[::-1])
        assert res["lane"] == "socket"
        assert res["rounds"] == 1  # downgrade costs no extra round
        assert counters.get("dcn.shm.fallback") == f0 + 1

    def test_restart_without_shm_downgrades_next_transfers(self, pair):
        """Mid-run daemon restart into a capability-less binary: the
        reconnect re-probes the handshake, and later transfers ride
        sockets with no fallback noise (the lane was re-negotiated,
        not broken)."""
        a, b, ca, cb = pair
        flow = _flow()
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        assert res["lane"] == "shm"
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG,
                                           timeout_s=10) == PAYLOAD
        a.stop(crash=True)
        a.shm_enabled = False
        a.start()
        ca.ping()  # reconnect + flow replay + capability re-probe
        f0 = counters.get("dcn.shm.fallback")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD[::-1], "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        assert res["lane"] == "socket"
        assert counters.get("dcn.shm.fallback") == f0
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG,
                                           timeout_s=10) \
            == PAYLOAD[::-1]


class TestRecvIntoMmap:
    """Chunk payloads are received DIRECTLY into
    the flow's assembly buffer (segment view or heap) — and a partial
    ``recv_into`` (the sender died mid-chunk) can never expose a torn
    frame: the chunk stays unrecorded and its retransmit overwrites
    the partial bytes."""

    def _raw_chunk(self, daemon, flow, payload, seq, off, tot, xid,
                   truncate=0):
        """One v2 chunk frame over a raw data-plane socket, optionally
        truncated ``truncate`` bytes short of the payload's end (the
        torn-sender shape), then the connection dies."""
        frame = xferd_mod.encode_frame(
            flow, payload, seq=seq,
            meta={"off": off, "tot": tot, "xid": xid, "src": "raw"})
        s = socket.create_connection(("127.0.0.1", daemon.data_port),
                                     timeout=10)
        try:
            s.sendall(frame[:len(frame) - truncate] if truncate
                      else frame)
        finally:
            s.close()

    def _flow_state(self, client, flow):
        return next(f for f in client.stats(flow=flow)["flows"]
                    if f["flow"] == flow)

    @pytest.mark.parametrize("attach", [True, False],
                             ids=["segment", "heap"])
    def test_torn_chunk_stays_invisible_then_retransmit_lands(
            self, pair, attach):
        """Half a chunk arrives, the connection dies: no torn frame,
        no rx accounting, `dcn.chunks.torn` counts it — and the full
        retransmit (SAME seq: the torn chunk was never marked seen)
        assembles a byte-exact frame over the partial garbage."""
        a, b, ca, cb = pair
        flow = _flow("torn")
        cb.register_flow(flow, bytes=N)
        if attach:
            cb.shm_attach(flow, N)
        t0 = counters.get("dcn.chunks.torn")
        xid = "torn-xid"
        chunk = PAYLOAD[:4096]
        # A torn first chunk: header promises 4096, half arrives.
        self._raw_chunk(b, flow, chunk, 7, 0, N, xid, truncate=2048)
        _wait_counter("dcn.chunks.torn", t0 + 1)
        st = self._flow_state(cb, flow)
        assert st["frame_bytes"] == 0  # no torn frame visible
        assert st["rx_bytes"] == 0  # the torn chunk was never counted
        # Full retransmit under the SAME seq, then the rest.
        for i, off in enumerate(range(0, N, 4096)):
            self._raw_chunk(b, flow, PAYLOAD[off:off + 4096], 7 + i,
                            off, N, xid)
        from container_engine_accelerators_tpu_torch.parallel import dcn

        dcn.wait_flow_rx(cb, flow, N, timeout_s=10)
        assert cb.read(flow, N) == PAYLOAD

    def test_retired_xid_straggler_cannot_reset_live_assembly(
            self, pair):
        """A straggler chunk from a transfer the flow moved PAST — it
        COMPLETED, then a new transfer displaced it (the ring
        completer's late-send race) — is dropped as stale: it must
        not discard the LIVE transfer's assembly or inflate rx
        accounting.  (A straggler displacing an INCOMPLETE live
        assembly keeps the old recover-via-retransmit contract —
        tests/test_dcn_pipeline.py pins that direction.)"""
        _a, b, ca, cb = pair
        flow = _flow("ret")
        cb.register_flow(flow, bytes=N)
        s0 = counters.get("dcn.chunks.stale_drop")
        # Transfer A completes (all four chunks land)...
        for i, off in enumerate(range(0, N, 4096)):
            self._raw_chunk(b, flow, PAYLOAD[off:off + 4096], 1 + i,
                            off, N, "xid-A")
        cb.wait_rx(flow, N, timeout_s=10, mode="frame")
        # ...then the flow moves on: transfer B begins, so the
        # COMPLETED A is retired at displacement.
        rev = PAYLOAD[::-1]
        self._raw_chunk(b, flow, rev[4096:8192], 11, 4096, N,
                        "xid-B")
        deadline = time.monotonic() + 5
        while self._flow_state(cb, flow)["rx_bytes"] < N + 4096:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        # A's straggler arrives late (its seqs were un-seen with the
        # displacement, so only retirement stands between it and the
        # live assembly): dropped, never landed.
        self._raw_chunk(b, flow, PAYLOAD[8192:12288], 3, 8192, N,
                        "xid-A")
        _wait_counter("dcn.chunks.stale_drop", s0 + 1)
        st = self._flow_state(cb, flow)
        assert st["rx_bytes"] == N + 4096  # no straggler accounting
        # B keeps assembling to completion, untouched.
        for seq, off in ((12, 0), (13, 8192), (14, 12288)):
            self._raw_chunk(b, flow, rev[off:off + 4096], seq,
                            off, N, "xid-B")
        cb.wait_rx(flow, 2 * N, timeout_s=10)
        assert cb.read(flow, N) == rev

    def test_segment_attached_flow_assembles_in_the_mmap(self, pair):
        """White box: with a pre-attached segment, the assembly buffer
        IS a segment view (the recv-into-mmap premise), and a raw
        socket chunk lands through it."""
        a, b, ca, cb = pair
        flow = _flow("seg")
        cb.register_flow(flow, bytes=N)
        cb.shm_attach(flow, N)
        self._raw_chunk(b, flow, PAYLOAD[:4096], 3, 0, N, "sx")
        deadline = time.monotonic() + 5
        while self._flow_state(cb, flow)["rx_bytes"] < 4096:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        f = b._flows[flow]
        assert isinstance(f.asm_buf, memoryview)


class TestRingHandoff:
    """The descriptor-ring handoff — ONE doorbell
    per round instead of per-chunk control ops, completion polled
    lock-free out of the client's own ring mapping."""

    def test_one_doorbell_per_transfer(self, pair):
        _a, b, ca, cb = pair
        p0 = counters.get("dcn.shm.ring.posts")
        res = _roundtrip(ca, cb, b, CFG)
        assert res["lane"] == "shm"
        assert counters.get("dcn.shm.ring.posts") == p0 + 1

    def test_ring_kill_switch_runs_per_chunk_ops(self, pair):
        _a, b, ca, cb = pair
        cfg = dcn_pipeline.PipelineConfig(chunk_bytes=4096, stripes=2,
                                          shm=True, ring=False,
                                          tuned=False)
        p0 = counters.get("dcn.shm.ring.posts")
        res = _roundtrip(ca, cb, b, cfg)
        assert res["lane"] == "shm"
        assert counters.get("dcn.shm.ring.posts") == p0

    def test_attach_reports_ring_only_when_asked(self, pair):
        _a, _b, ca, _cb = pair
        flow = _flow("ring")
        ca.register_flow(flow, bytes=N)
        plain = ca.shm_attach(flow, N)
        assert "ring_path" not in plain
        ringed = ca.shm_attach(flow, N, ring=True)
        assert os.path.exists(ringed["ring_path"])
        assert ringed["ring_slots"] == xferd_mod.RING_SLOTS

    def test_doorbell_lost_response_lands_exactly_once(self, pair):
        """Work done, answer lost — handoff edition: the doorbell's
        response dies with the control connection, but the completer
        already has the round.  The client's downgrade re-sends the
        SAME seqs on whichever lane runs next; dedup + idempotent
        staging keep the landed bytes exact."""
        a, b, ca, cb = pair
        flow = _flow("db")
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        a.drop_response_once("shm_post")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        from container_engine_accelerators_tpu_torch.parallel import dcn

        dcn.wait_flow_rx(cb, flow, N, timeout_s=10)
        # Settle: the completer's late sends must dedup, not double-
        # land (rx accounting would exceed N otherwise).
        deadline = time.monotonic() + 0.5
        while time.monotonic() < deadline:
            st = next(f for f in cb.stats(flow=flow)["flows"]
                      if f["flow"] == flow)
            assert st["rx_bytes"] == N
            time.sleep(0.02)
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG,
                                           timeout_s=10) == PAYLOAD
        assert res["bytes"] == N


class TestShmDirectLane:
    """Daemon↔daemon shm — co-hosted peers land
    frames segment→segment; the peer TCP stream moves ZERO payload
    bytes (counter-level evidence), and every failure mode falls back
    to TCP transparently."""

    def test_cohosted_transfer_moves_zero_tcp_bytes(self, pair):
        _a, b, ca, cb = pair
        direct0 = _lane_total("shm_direct")
        socket0 = _lane_total("socket")
        frames0 = counters.get("dcn.shm_direct.frames")
        res = _roundtrip(ca, cb, b, CFG)
        assert res["lane"] == "shm"
        assert _lane_total("shm_direct") == direct0 + N
        assert _lane_total("socket") == socket0  # zero TCP payload
        assert counters.get("dcn.shm_direct.frames") >= frames0 + 4

    def test_direct_pin_off_rides_tcp(self, pair):
        _a, b, ca, cb = pair
        cfg = dcn_pipeline.PipelineConfig(
            chunk_bytes=4096, stripes=2, shm=True, shm_direct=False,
            tuned=False)
        direct0 = _lane_total("shm_direct")
        socket0 = _lane_total("socket")
        res = _roundtrip(ca, cb, b, cfg)
        assert res["lane"] == "shm"  # client lane unchanged...
        assert _lane_total("shm_direct") == direct0  # ...peer leg TCP
        assert _lane_total("socket") == socket0 + N

    def test_cross_host_peer_never_attached(self, tmp_path):
        """The RECEIVING daemon advertises a different boot identity:
        the sender's handshake refuses the lane (cached, no fallback
        noise — the lane was never there) and every frame rides TCP."""
        a = PyXferd(str(tmp_path / "a"), node="dxa").start()
        b = PyXferd(str(tmp_path / "b"), node="dxb",
                    host_id="other-boot:other-host").start()
        ca = ResilientDcnXferClient(str(tmp_path / "a"),
                                    retry=FAST_RETRY)
        cb = ResilientDcnXferClient(str(tmp_path / "b"),
                                    retry=FAST_RETRY)
        try:
            direct0 = _lane_total("shm_direct")
            fb0 = counters.get("dcn.shm_direct.fallback")
            res = _roundtrip(ca, cb, b, CFG)
            assert res["lane"] == "shm"  # client↔daemon staging is ours
            assert _lane_total("shm_direct") == direct0
            assert counters.get("dcn.shm_direct.fallback") == fb0
        finally:
            ca.close()
            cb.close()
            a.stop()
            b.stop()

    def test_stale_peer_segment_rejected_then_reattach_lands(
            self, pair):
        """The receiver released and re-registered the flow — the
        sender's cached mapping now points at an orphaned inode.  The
        inode check turns that into a loud ``rejected`` (never a
        silent landing of bytes nobody can see); the fallback drops
        the stale mapping, re-attaches the fresh segment, and the
        SAME transfer still lands byte-exact."""
        _a, b, ca, cb = pair
        flow = _flow("stale")
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        assert res["lane"] == "shm"
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG,
                                           timeout_s=10) == PAYLOAD
        # New incarnation of the flow on the receiver: fresh segment
        # file, fresh inode; the sender's lane cache is now stale.
        cb.release_flow(flow)
        cb.register_flow(flow, bytes=N)
        cb.shm_attach(flow, N)
        fb0 = counters.get("dcn.shm_direct.fallback")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD[::-1], "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG,
                                           timeout_s=10) \
            == PAYLOAD[::-1]
        # The stale mapping was refused (never silently landed) and
        # dropped; whether the retry then re-attached the fresh
        # segment or rode TCP, the books must show the refusal.
        assert counters.get("dcn.shm_direct.fallback") >= fb0 + 1

    def test_ring_and_direct_compose_with_retry_rounds(self, pair):
        """A multi-transfer sequence on ONE flow (what exchange_shard
        reuse looks like): every transfer rides the ring + direct
        lane, seqs keep climbing, and the landed frame is always the
        LATEST payload — reused flows never serve stale bytes."""
        _a, b, ca, cb = pair
        flow = _flow("seq")
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        cb.shm_attach(flow, N)
        for i in range(3):
            pay = PAYLOAD[i:] + PAYLOAD[:i]
            res = dcn_pipeline.send_pipelined(
                ca, flow, pay, "127.0.0.1", b.data_port, CFG,
                timeout_s=10)
            assert res["lane"] == "shm"
            from container_engine_accelerators_tpu_torch.parallel import dcn

            dcn.wait_flow_rx(cb, flow, N * (i + 1), timeout_s=10)
            assert dcn_pipeline.read_pipelined(
                cb, flow, N, CFG, timeout_s=10) == pay
