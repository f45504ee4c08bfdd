"""Pipelined DCN data plane of the port: chunking, striping, wait op,
bench (counterpart of tests/test_dcn_pipeline.py).

Protocol/unit tests for the
chunk-assembly daemon extensions and the client-side stripe
writer/reader, the blocking wait op and its polling fallback, the
stats flow filter, the empty-shard short-circuit, and the bench
harness's JSONL contract.  The JAX package's chaos half (kill/loss
exactly-once per chunk, tests/test_fleet.py) waits for the port of the
fleet rig.
"""

import json
import time
import uuid

import pytest

from container_engine_accelerators_tpu_torch.fleet.xferd import (
    PyXferd,
    encode_frame,
    encode_read_request,
)
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.parallel import dcn, dcn_pipeline
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnWaitUnsupported,
    DcnXferClient,
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy
from tests.xferd_stub import XferdStub

FAST_RETRY = RetryPolicy(
    max_attempts=6, initial_backoff_s=0.01, max_backoff_s=0.1,
    deadline_s=10.0,
)

# Small grid so tests exercise multi-chunk paths in milliseconds.
# tuned=False: these suites assert the STATIC wire contract (exact
# chunk grids, stripe counts, round budgets) — the closed loop is on
# by default now and would adapt the grid mid-assert.
CFG = dcn_pipeline.PipelineConfig(chunk_bytes=4096, stripes=2,
                                  tuned=False)
PAYLOAD = bytes(range(256)) * 64  # 16 KiB == 4 chunks under CFG
N = len(PAYLOAD)


@pytest.fixture
def pair(tmp_path):
    a = PyXferd(str(tmp_path / "a"), node="pa").start()
    b = PyXferd(str(tmp_path / "b"), node="pb").start()
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


def _flow(prefix="pf"):
    return f"{prefix}-{uuid.uuid4().hex[:8]}"


class TestChunkPlan:
    def test_grid_covers_payload_exactly(self):
        chunks = dcn_pipeline.plan_chunks(10_000, 4096)
        assert chunks == [(0, 4096), (4096, 4096), (8192, 1808)]
        assert sum(ln for _, ln in chunks) == 10_000

    def test_single_chunk_for_small_payload(self):
        assert dcn_pipeline.plan_chunks(10, 4096) == [(0, 10)]

    def test_client_framing_matches_daemon_framing(self):
        """The client-side chunk header and DXR1 request are
        deliberate duplicates of fleet/xferd's (the dcn_client.put
        idiom); these pins keep the two sides from drifting apart."""
        meta = {"off": 4096, "tot": 8192, "xid": "abc"}
        assert (dcn_pipeline._chunk_frame_header("f", 11, meta) + b"x" * 11
                == encode_frame("f", b"x" * 11, None, meta))
        assert (dcn_pipeline._read_request("f", 8, 4096)
                == encode_read_request("f", 8, 4096))

    def test_chunk_cap_fits_the_dedup_window(self):
        """A full transfer's seq span must fit the receiver's window
        with headroom, or a late retransmit silently drops as 'dup'."""
        from container_engine_accelerators_tpu_torch.fleet.xferd import (
            DEDUP_WINDOW,
        )

        assert 2 * dcn_pipeline.MAX_CHUNKS_PER_TRANSFER <= DEDUP_WINDOW

    def test_oversized_payload_grows_chunks_not_seqs(self, pair):
        """A payload worth more chunks than the cap gets a bigger
        chunk grid: the transfer still completes and burns at most
        MAX_CHUNKS_PER_TRANSFER seqs."""
        _a, b, ca, cb = pair
        tiny = dcn_pipeline.PipelineConfig(chunk_bytes=16, stripes=2,
                                           tuned=False)
        payload = bytes(range(256)) * 24  # 6144 B = 384 chunks of 16
        flow = _flow()
        cb.register_flow(flow, bytes=len(payload))
        ca.register_flow(flow, bytes=len(payload))
        res = dcn_pipeline.send_pipelined(
            ca, flow, payload, "127.0.0.1", b.data_port, tiny,
            timeout_s=10)
        assert res["chunks"] <= dcn_pipeline.MAX_CHUNKS_PER_TRANSFER
        got = dcn_pipeline.read_pipelined(cb, flow, len(payload), tiny,
                                          timeout_s=10)
        assert got == payload


class TestPipelinedTransfer:
    def test_roundtrip_byte_exact(self, pair):
        _a, b, ca, cb = pair
        flow = _flow()
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        t0 = counters.get("dcn.pipeline.transfers")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        assert res["chunks"] == 4 and res["rounds"] == 1
        got = dcn_pipeline.read_pipelined(cb, flow, N, CFG, timeout_s=10)
        assert got == PAYLOAD
        assert counters.get("dcn.pipeline.transfers") == t0 + 1

    def test_tail_chunk_payload(self, pair):
        """A payload that is not a chunk multiple: the tail chunk is
        short and the assembled frame is exactly the payload."""
        _a, b, ca, cb = pair
        payload = PAYLOAD[: N - 777]
        flow = _flow()
        cb.register_flow(flow, bytes=len(payload))
        ca.register_flow(flow, bytes=len(payload))
        dcn_pipeline.send_pipelined(
            ca, flow, payload, "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        got = dcn_pipeline.read_pipelined(cb, flow, len(payload), CFG,
                                          timeout_s=10)
        assert got == payload

    def test_chunk_replay_same_seq_dedups(self, pair):
        """Re-sending a chunk under its already-landed seq is dropped
        by the receiver's window — rx accounting does not move and the
        payload stays byte-exact (exactly-once PER CHUNK)."""
        a, b, ca, cb = pair
        flow = _flow()
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, CFG,
            timeout_s=10)
        cb.wait_rx(flow, N, timeout_s=10, mode="frame")
        d0 = counters.get("dcn.frames.deduped")
        rx0 = cb.stats(flow=flow)["flows"][0]["rx_bytes"]
        # Replay chunk 0 (seq 1 of this transfer) into the receiver —
        # the wire-level replay shape.  The seq check runs BEFORE any
        # xid/assembly handling, so the replay drops no matter what
        # transfer it claims to belong to.
        verdict = b.land_frame(flow, PAYLOAD[:CFG.chunk_bytes], 1,
                               {"off": 0, "tot": N, "xid": "whatever"})
        assert verdict == "dup"
        assert counters.get("dcn.frames.deduped") == d0 + 1
        assert cb.stats(flow=flow)["flows"][0]["rx_bytes"] == rx0
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG) == PAYLOAD

    def test_reader_never_sees_partial_assembly(self, pair):
        """frame_bytes stays 0 until every chunk landed: a read of a
        half-assembled flow returns empty, never a torn payload."""
        a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=N)
        # Land 3 of 4 chunks locally (seq-0 staging frames).
        for off in (0, 4096, 12288):
            a.land_frame(flow, PAYLOAD[off:off + 4096], None,
                         {"off": off, "tot": N, "xid": "t"})
        st = ca.stats(flow=flow)["flows"][0]
        assert st["rx_bytes"] == 3 * 4096 and st["frame_bytes"] == 0
        assert ca.read(flow, N) == b""
        a.land_frame(flow, PAYLOAD[8192:12288], None,
                     {"off": 8192, "tot": N, "xid": "t"})
        assert ca.stats(flow=flow)["flows"][0]["frame_bytes"] == N
        assert ca.read(flow, N) == PAYLOAD

    def test_flow_reuse_delivers_the_new_payload(self, pair):
        """Two pipelined transfers on the SAME registered flow: the
        second must deliver its own bytes — a stale completed frame
        must neither satisfy the sender's stage-wait nor the reader's
        frame-wait (silent-corruption regression)."""
        _a, b, ca, cb = pair
        flow = _flow()
        cb.register_flow(flow, bytes=N)
        ca.register_flow(flow, bytes=N)
        p1, p2 = PAYLOAD, PAYLOAD[::-1]
        dcn_pipeline.send_pipelined(ca, flow, p1, "127.0.0.1",
                                    b.data_port, CFG, timeout_s=10)
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG,
                                           timeout_s=10) == p1
        dcn_pipeline.send_pipelined(ca, flow, p2, "127.0.0.1",
                                    b.data_port, CFG, timeout_s=10)
        assert dcn_pipeline.read_pipelined(cb, flow, N, CFG,
                                           timeout_s=10) == p2

    def test_stale_xid_straggler_cannot_wedge_the_live_transfer(
            self, pair):
        """A straggler chunk from an abandoned attempt (old xid)
        resets the live attempt's assembly — discarding bytes whose
        seqs were already in the dedup window.  Those seqs must be
        un-seen with the discard, or the live attempt's retransmits
        dedup away and the flow can never complete."""
        a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=8192)
        half = PAYLOAD[:4096]
        # Live attempt (xid B) lands its first chunk, seq 3.
        assert a.land_frame(flow, half, 3,
                            {"off": 0, "tot": 8192, "xid": "B"}) \
            == "landed"
        # Straggler from the abandoned attempt (xid A) flushes late:
        # resets assembly, discarding B's chunk 0.
        assert a.land_frame(flow, half, 2,
                            {"off": 4096, "tot": 8192, "xid": "A"}) \
            == "landed"
        # B's retry round re-sends BOTH chunks under the same seqs;
        # they must land (not dedup) and complete the frame.
        assert a.land_frame(flow, half, 3,
                            {"off": 0, "tot": 8192, "xid": "B"}) \
            == "landed"
        assert a.land_frame(flow, PAYLOAD[4096:8192], 4,
                            {"off": 4096, "tot": 8192, "xid": "B"}) \
            == "landed"
        st = ca.stats(flow=flow)["flows"][0]
        assert st["frame_bytes"] == 8192
        assert ca.read(flow, 8192) == PAYLOAD[:8192]

    def test_bad_chunk_geometry_rejected(self, pair):
        a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=N)
        r0 = counters.get("dcn.chunks.rejected")
        verdict = a.land_frame(flow, b"x" * 100, None,
                               {"off": N, "tot": N, "xid": "t"})
        assert verdict == "rejected"
        assert counters.get("dcn.chunks.rejected") == r0 + 1


class TestWaitOp:
    def test_blocking_wait_beats_poll_quantum(self, pair):
        """The wait op returns on the landing, not on the next poll
        tick: land after 30 ms, observe a wakeup well under the old
        20 ms quantum's worst case."""
        a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=64)
        import threading

        threading.Timer(
            0.03, lambda: a.land_frame(flow, b"y" * 64)
        ).start()
        t0 = time.monotonic()
        resp = ca.wait_rx(flow, 64, timeout_s=5)
        waited = time.monotonic() - t0
        assert resp["done"] and resp["rx_bytes"] == 64
        assert 0.02 < waited < 1.0

    def test_wait_mode_frame_requires_completed_assembly(self, pair):
        a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=8192)
        a.land_frame(flow, b"z" * 4096, None,
                     {"off": 0, "tot": 8192, "xid": "w"})
        with pytest.raises(TimeoutError):
            ca.wait_rx(flow, 8192, timeout_s=0.2, mode="frame")
        a.land_frame(flow, b"z" * 4096, None,
                     {"off": 4096, "tot": 8192, "xid": "w"})
        assert ca.wait_rx(flow, 8192, timeout_s=5, mode="frame")["done"]

    def test_wait_timeout_raises(self, pair):
        _a, _b, ca, _cb = pair
        flow = _flow()
        ca.register_flow(flow, bytes=64)
        with pytest.raises(TimeoutError):
            ca.wait_rx(flow, 64, timeout_s=0.2)

    def test_stub_daemon_falls_back_to_polling(self, tmp_path):
        """Daemons without the wait op (the native daemon, the stub)
        answer 'unknown op'; wait_flow_rx degrades to the adaptive
        poll and wait_rx reports DcnWaitUnsupported exactly once."""
        stub = XferdStub(str(tmp_path / "tpu-dcn")).start()
        try:
            c = DcnXferClient(stub.uds_dir)
            c.register_flow("f", bytes=64)
            with pytest.raises(DcnWaitUnsupported):
                c.wait_rx("f", 0, timeout_s=1)
            # Cached: the second probe never talks to the daemon.
            with pytest.raises(DcnWaitUnsupported):
                c.wait_rx("f", 0, timeout_s=1)
            # The polling fallback completes (stub reports rx_bytes 0).
            dcn.wait_flow_rx(c, "f", 0, timeout_s=2)
            c.close()
        finally:
            stub.stop()


class TestStatsFlowFilter:
    def test_filter_returns_single_entry(self, pair):
        _a, _b, ca, _cb = pair
        for i in range(3):
            ca.register_flow(f"many-{i}", bytes=64)
        st = ca.stats(flow="many-1")
        assert [f["flow"] for f in st["flows"]] == ["many-1"]
        assert st["active_flows"] == 3  # totals still fleet-wide
        assert len(ca.stats()["flows"]) == 3

    def test_filter_unknown_flow_is_empty_not_error(self, pair):
        _a, _b, ca, _cb = pair
        assert ca.stats(flow="nope")["flows"] == []


class TestEmptyShardShortCircuit:
    def test_exchange_empty_registers_and_skips_data_plane(self, pair):
        a, b, ca, _cb = pair
        hit = []
        e0 = counters.get("dcn.exchange.empty")
        got = dcn.exchange_shard(
            ca, local_flow="e.tx", peer_flow="e.rx", data=b"",
            peer_host="127.0.0.1", peer_port=b.data_port,
            barrier=lambda: hit.append(1), timeout_s=5)
        assert got == b"" and hit == [1]
        assert counters.get("dcn.exchange.empty") == e0 + 1
        # Nothing was staged or streamed anywhere.
        assert a._stats()["total_transferred"] == 0
        assert b._stats()["total_transferred"] == 0
        # And the flows were released on the way out.
        assert ca.stats()["active_flows"] == 0


def _two_sided_exchange(pair, data_a, data_b, **kw):
    """Both workers of a 2-process collective leg, on threads: na
    sends flow 'ex.a' to nb's daemon, nb sends 'ex.b' to na's — the
    tests/dcn_xfer_worker.py pattern in-process."""
    import threading

    a, b, ca, cb = pair
    barrier = threading.Barrier(2)
    out, errs = {}, []

    def worker(name, client, data, peer_daemon, tx, rx):
        try:
            out[name] = dcn.exchange_shard(
                client, local_flow=tx, peer_flow=rx, data=data,
                peer_host="127.0.0.1", peer_port=peer_daemon.data_port,
                barrier=barrier.wait, timeout_s=15, **kw)
        except BaseException as e:  # surfaces in the test, not a hang
            errs.append(e)
            barrier.abort()

    ts = [
        threading.Thread(target=worker,
                         args=("a", ca, data_a, b, "ex.a", "ex.b")),
        threading.Thread(target=worker,
                         args=("b", cb, data_b, a, "ex.b", "ex.a")),
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    if errs:
        raise errs[0]
    return out


class TestExchangePipelined:
    def test_auto_threshold_keeps_small_payloads_serial(self, pair):
        t0 = counters.get("dcn.pipeline.transfers")
        out = _two_sided_exchange(pair, b"s" * 512, b"t" * 512)
        assert out["a"] == b"t" * 512 and out["b"] == b"s" * 512
        # Below chunk_bytes: the serial leg, not the pipeline.
        assert counters.get("dcn.pipeline.transfers") == t0

    def test_forced_pipelined_exchange(self, pair):
        """The full pipelined exchange leg, both directions at once —
        overlapped chunked stage+send and DXR1 read-back on each
        side."""
        t0 = counters.get("dcn.pipeline.transfers")
        import os as _os

        _os.environ[dcn_pipeline.CHUNK_BYTES_ENV] = "4096"
        try:
            out = _two_sided_exchange(pair, PAYLOAD, PAYLOAD[::-1],
                                      pipelined=True)
        finally:
            del _os.environ[dcn_pipeline.CHUNK_BYTES_ENV]
        assert out["a"] == PAYLOAD[::-1] and out["b"] == PAYLOAD
        assert counters.get("dcn.pipeline.transfers") == t0 + 2

    def test_should_pipeline_gates_on_daemon_capability(self, tmp_path):
        stub = XferdStub(str(tmp_path / "tpu-dcn")).start()
        try:
            c = DcnXferClient(stub.uds_dir)
            assert not dcn_pipeline.should_pipeline(c, 1 << 30, CFG)
            c.close()
        finally:
            stub.stop()

    def test_should_pipeline_respects_kill_switch(self, pair):
        _a, _b, ca, _cb = pair
        assert dcn_pipeline.should_pipeline(ca, 1 << 30, CFG)
        off = dcn_pipeline.PipelineConfig(
            chunk_bytes=4096, stripes=2,
            env={dcn_pipeline.PIPELINE_ENV: "0"})
        assert not dcn_pipeline.should_pipeline(ca, 1 << 30, off)


class TestBenchHarness:
    def test_bench_emits_well_formed_jsonl(self, tmp_path):
        """The bench smoke gate's contract: one JSON record
        per (mode, size) — serial, the socket pipelined lane, the shm
        lane, and the memcpy reference series — flat keys, parses
        line by line."""
        import importlib

        mod = importlib.import_module(
            "container_engine_accelerators_tpu_torch.cmd.dcn_bench")
        out = tmp_path / "bench.jsonl"
        rc = mod.main(["--sizes", "4096,16384", "--iters", "1",
                       "--chunk-bytes", "4096", "--stripes", "2",
                       "--out", str(out)])
        assert rc == 0
        lines = out.read_text().strip().splitlines()
        assert len(lines) == 8  # 2 sizes x 4 modes
        modes = set()
        run_ids = set()
        for line in lines:
            rec = json.loads(line)
            assert rec["bench"] == "dcn_xfer"
            assert rec["mode"] in mod.MODES
            modes.add(rec["mode"])
            assert rec["bytes"] in (4096, 16384)
            assert rec["mbps"] > 0 and rec["best_s"] > 0
            assert rec["chunk_bytes"] == 4096
            # Every record is history-joinable: one run id for the
            # whole invocation plus the repo VERSION stamp.
            assert len(rec["run_id"]) == 16
            run_ids.add(rec["run_id"])
            assert rec["version"]
        assert len(run_ids) == 1
        # The memcpy reference rides the SAME JSONL as the lanes — the
        # "how far from memcpy speed" gap is always on record.
        assert modes == set(mod.MODES)

    def test_bench_tuned_compare_gate(self, tmp_path):
        """The tuned bench leg in miniature: --tuned adds the
        closed-loop series, --compare sweeps the static --grid cells
        and gates tuned against the best of them; the JSONL carries
        both the tuned records and one dcn_xfer_grid record per
        cell."""
        import importlib.util
        import os

        spec = importlib.util.spec_from_file_location(
            "dcn_bench_tuned",
            os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "cmd", "dcn_bench.py"),
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out = tmp_path / "bench.jsonl"
        rc = mod.main(["--sizes", "16384", "--iters", "2",
                       "--chunk-bytes", "4096", "--stripes", "2",
                       "--tuned", "--compare", "--tune-warmup", "2",
                       "--grid", "4096:1,4096:2",
                       "--tune-min-ratio", "0.1",
                       "--min-ratio", "0", "--shm-min-ratio", "0",
                       "--exposed-slack", "1",
                       "--out", str(out)])
        # min-ratio 0.1: this test pins the plumbing and the JSONL
        # contract, not the rig's noise floor (the full bench owns that).
        assert rc == 0
        recs = [json.loads(line)
                for line in out.read_text().strip().splitlines()]
        sweep = [r for r in recs if r["bench"] == "dcn_xfer"]
        grid = [r for r in recs if r["bench"] == "dcn_xfer_grid"]
        assert {r["mode"] for r in sweep} == set(mod.MODES) | {"tuned"}
        assert {(r["chunk_bytes"], r["stripes"]) for r in grid} \
            == {(4096, 1), (4096, 2)}
        assert all(r["mbps"] > 0 for r in recs)


class TestLargeFrameShortWriteGuard:
    """Satellite: the rig's stack truncates very large single-syscall
    payloads, so every raw data-plane send loops under a per-syscall
    cap (utils/netio.py).  A multi-MiB frame must round-trip
    byte-exact on every lane."""

    MB6 = 6 << 20

    def test_netio_sendall_survives_tiny_caps(self):
        """The cap loop itself: a 3 MiB buffer pushed 8 KiB per
        syscall arrives byte-exact."""
        import socket as _socket
        import threading

        from container_engine_accelerators_tpu_torch.utils import netio

        a, b = _socket.socketpair()
        payload = bytes(range(256)) * (3 << 12)  # 3 MiB
        out = bytearray(len(payload))

        def rx():
            netio.recv_exact_into(b, memoryview(out))

        t = threading.Thread(target=rx)
        t.start()
        netio.sendall(a, payload, cap=8192)
        t.join(timeout=30)
        assert not t.is_alive() and bytes(out) == payload
        a.close()
        b.close()

    def test_multi_mib_frame_roundtrips_serial(self, pair):
        _a, b, ca, cb = pair
        payload = bytes(range(256)) * (self.MB6 // 256)
        flow = _flow("big")
        cb.register_flow(flow, bytes=len(payload))
        ca.register_flow(flow, bytes=len(payload))
        ca.put(flow, payload)
        dcn.wait_flow_rx(ca, flow, len(payload), timeout_s=30)
        ca.send(flow, "127.0.0.1", b.data_port, len(payload))
        dcn.wait_flow_rx(cb, flow, len(payload), timeout_s=30)
        assert cb.read(flow, len(payload)) == payload

    def test_multi_mib_frame_roundtrips_pipelined_socket(self, pair):
        _a, b, ca, cb = pair
        payload = bytes(range(256)) * (self.MB6 // 256)
        cfg = dcn_pipeline.PipelineConfig(chunk_bytes=1 << 20,
                                          stripes=2, shm=False,
                                          tuned=False)
        flow = _flow("bigp")
        cb.register_flow(flow, bytes=len(payload))
        ca.register_flow(flow, bytes=len(payload))
        res = dcn_pipeline.send_pipelined(
            ca, flow, payload, "127.0.0.1", b.data_port, cfg,
            timeout_s=60)
        assert res["lane"] == "socket"
        assert dcn_pipeline.read_pipelined(cb, flow, len(payload),
                                           cfg, timeout_s=60) \
            == payload
