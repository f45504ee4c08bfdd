"""Universal submission-ring data plane of the port: the socket lane
driven by posted descriptors (counterpart of tests/test_dcn_ring.py).

The client posts (off, len, seq) descriptors plus ONE doorbell per
round; the daemon's completer drives them through the normal send
machinery and publishes per-slot verdicts plus a completion cursor the
client polls lock-free out of shared memory.  These tests pin the
contract:

- one doorbell per round on the socket lane (no per-chunk control op);
- ring-full backpressure posts in ring-sized batches and BLOCKS the
  poster — extra doorbells, never dropped descriptors;
- completer death/refusal downgrades to the classic per-chunk path
  (``dcn.ring.fallback``) under the SAME seqs;
- producer mode pulls chunks INSIDE the completion window (after the
  doorbell), and exchange_shard's capture-tee keeps one-shot producers
  replayable across fallback legs.

The JAX file's proc-mode half (SIGKILL mid-ring over fleet worker
processes) waits for the port of ``fleet/proc.py``.
"""

import os
import threading
import time
import uuid

import pytest

import container_engine_accelerators_tpu_torch.fleet.xferd as xferd_mod
from container_engine_accelerators_tpu_torch.fleet.xferd import PyXferd
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.parallel import dcn, dcn_pipeline
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferError,
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

FAST_RETRY = RetryPolicy(
    max_attempts=6, initial_backoff_s=0.01, max_backoff_s=0.1,
    deadline_s=10.0,
)

# The ring-socket shape under test: submission ring on, zero-copy shm
# lane off (the ring must prove itself on the TCP lane), static grid
# (tuned=False — these suites assert exact chunk/doorbell counts).
RING_CFG = dcn_pipeline.PipelineConfig(chunk_bytes=4096, stripes=2,
                                       shm=False, shm_direct=False,
                                       ring=True, tuned=False)
# The legacy per-chunk shape the ring is judged against.
CLASSIC_CFG = dcn_pipeline.PipelineConfig(chunk_bytes=4096, stripes=2,
                                          shm=False, shm_direct=False,
                                          ring=False, tuned=False)
PAYLOAD = bytes(range(256)) * 64  # 16 KiB == 4 chunks under the grid
N = len(PAYLOAD)


@pytest.fixture
def pair(tmp_path):
    # ring=True pins the capability regardless of TPU_DCN_SHM_RING:
    # these tests assert ring behavior, not the kill switch's default.
    a = PyXferd(str(tmp_path / "a"), node="ra", ring=True).start()
    b = PyXferd(str(tmp_path / "b"), node="rb", ring=True).start()
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


def _flow(prefix="ring"):
    return f"{prefix}-{uuid.uuid4().hex[:8]}"


def _open(ca, cb, flow, nbytes=N):
    cb.register_flow(flow, bytes=nbytes)
    ca.register_flow(flow, bytes=nbytes)


class TestRingSocketLane:
    def test_one_doorbell_per_round(self, pair):
        """The tentpole pin: a multi-chunk socket-lane round costs
        exactly ONE control op (the doorbell) — descriptors and
        completion ride shared memory, payload rides TCP."""
        a, b, ca, cb = pair
        flow = _flow()
        _open(ca, cb, flow)
        posts0 = counters.get("dcn.shm.ring.posts")
        rounds0 = counters.get("dcn.ring.socket.rounds")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, RING_CFG,
            timeout_s=15)
        assert res["lane"] == "socket" and res["rounds"] == 1
        assert counters.get("dcn.shm.ring.posts") == posts0 + 1
        assert counters.get("dcn.ring.socket.rounds") == rounds0 + 1
        dcn.wait_flow_rx(cb, flow, N, timeout_s=10)
        assert dcn_pipeline.read_pipelined(
            cb, flow, N, RING_CFG) == PAYLOAD

    def test_ring_full_backpressure_blocks_not_drops(
            self, pair, monkeypatch):
        """A round larger than the ring posts in ring-sized batches:
        the poster BLOCKS until the previous batch's cursor drains
        (one extra doorbell per extra batch, ``dcn.ring.backpressure``
        counted) and every chunk still lands byte-exact — descriptors
        are never silently dropped."""
        monkeypatch.setattr(xferd_mod, "RING_SLOTS", 2)
        a, b, ca, cb = pair
        flow = _flow("bp")
        _open(ca, cb, flow)
        posts0 = counters.get("dcn.shm.ring.posts")
        bp0 = counters.get("dcn.ring.backpressure")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, RING_CFG,
            timeout_s=15)
        # 4 chunks over a 2-slot ring: two batches, two doorbells,
        # one blocked-poster event — and still one logical round.
        assert res["lane"] == "socket" and res["rounds"] == 1
        assert counters.get("dcn.shm.ring.posts") == posts0 + 2
        assert counters.get("dcn.ring.backpressure") == bp0 + 1
        dcn.wait_flow_rx(cb, flow, N, timeout_s=10)
        assert dcn_pipeline.read_pipelined(
            cb, flow, N, RING_CFG) == PAYLOAD

    def test_completer_refusal_falls_back_to_classic(
            self, pair, monkeypatch):
        """An unusable ring handoff (attach refused — the completer-
        death shape) downgrades the SAME transfer to the classic
        per-chunk path: ``dcn.ring.fallback`` counts it, no doorbell
        is charged, and the payload lands byte-exact."""
        a, b, ca, cb = pair
        monkeypatch.setattr(
            a, "_ring_attach",
            lambda req: {"ok": False, "error": "completer dead"})
        flow = _flow("fb")
        _open(ca, cb, flow)
        posts0 = counters.get("dcn.shm.ring.posts")
        fb0 = counters.get("dcn.ring.fallback")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, RING_CFG,
            timeout_s=15)
        assert res["lane"] == "socket" and res["rounds"] == 1
        assert counters.get("dcn.ring.fallback") == fb0 + 1
        assert counters.get("dcn.shm.ring.posts") == posts0
        dcn.wait_flow_rx(cb, flow, N, timeout_s=10)
        assert dcn_pipeline.read_pipelined(
            cb, flow, N, RING_CFG) == PAYLOAD

    def test_ring_kill_switch_stays_classic(self, pair):
        """cfg.ring=False (TPU_DCN_SHM_RING=0) pins the legacy
        per-chunk socket pipeline: no ring attach, no doorbell, no
        fallback noise — the escape hatch stays byte-identical."""
        a, b, ca, cb = pair
        flow = _flow("ks")
        _open(ca, cb, flow)
        posts0 = counters.get("dcn.shm.ring.posts")
        rounds0 = counters.get("dcn.ring.socket.rounds")
        fb0 = counters.get("dcn.ring.fallback")
        res = dcn_pipeline.send_pipelined(
            ca, flow, PAYLOAD, "127.0.0.1", b.data_port, CLASSIC_CFG,
            timeout_s=15)
        assert res["lane"] == "socket"
        assert counters.get("dcn.shm.ring.posts") == posts0
        assert counters.get("dcn.ring.socket.rounds") == rounds0
        assert counters.get("dcn.ring.fallback") == fb0
        dcn.wait_flow_rx(cb, flow, N, timeout_s=10)
        assert dcn_pipeline.read_pipelined(
            cb, flow, N, CLASSIC_CFG) == PAYLOAD

    def test_set_ring_delay_clamped(self, pair):
        """The grey-fault knob (slow completer, soak's slow_ring
        grammar) clamps to [0, 2] seconds — a fault injector cannot
        turn 'slow' into 'wedged forever'."""
        a, _b, _ca, _cb = pair
        assert a.set_ring_delay(99.0) == 2.0
        assert a.set_ring_delay(-5.0) == 0.0
        assert a.set_ring_delay(0.25) == 0.25
        a.set_ring_delay(0.0)


class TestProducerMode:
    def test_producer_pulled_after_doorbell(self, pair):
        """Producer chunks are pulled INSIDE the completion window:
        every pull happens after the round's doorbell posted, so
        production time hides behind the DCN leg instead of preceding
        it — the overlap exchange_shard's producer mode exists for."""
        a, b, ca, cb = pair
        flow = _flow("pr")
        _open(ca, cb, flow)
        posts0 = counters.get("dcn.shm.ring.posts")
        pt0 = counters.get("dcn.ring.producer.transfers")
        pulls = []

        def produce():
            for off in range(0, N, 4096):
                pulls.append(counters.get("dcn.shm.ring.posts"))
                yield PAYLOAD[off:off + 4096]

        res = dcn_pipeline.send_pipelined(
            ca, flow, None, "127.0.0.1", b.data_port, RING_CFG,
            timeout_s=15, producer=produce(), nbytes=N)
        assert res["lane"] == "socket" and res["rounds"] == 1
        assert counters.get("dcn.ring.producer.transfers") == pt0 + 1
        assert len(pulls) == 4
        assert all(p > posts0 for p in pulls), pulls
        dcn.wait_flow_rx(cb, flow, N, timeout_s=10)
        assert dcn_pipeline.read_pipelined(
            cb, flow, N, RING_CFG) == PAYLOAD

    def test_producer_ended_early_raises(self, pair):
        a, b, ca, cb = pair
        flow = _flow("pe")
        _open(ca, cb, flow)
        with pytest.raises(DcnXferError, match="ended early"):
            dcn_pipeline.send_pipelined(
                ca, flow, None, "127.0.0.1", b.data_port, RING_CFG,
                timeout_s=15, producer=iter([PAYLOAD[:4096]]),
                nbytes=N)

    def test_data_and_producer_are_exclusive(self, pair):
        _a, b, ca, _cb = pair
        with pytest.raises(ValueError, match="data OR producer"):
            dcn_pipeline.send_pipelined(
                ca, "x", PAYLOAD, "127.0.0.1", b.data_port, RING_CFG,
                producer=iter([b"y"]), nbytes=N)
        with pytest.raises(ValueError, match="nbytes"):
            dcn_pipeline.send_pipelined(
                ca, "x", None, "127.0.0.1", b.data_port, RING_CFG,
                producer=iter([b"y"]))


def _producer_exchange(pair, data_a, data_b, **kw):
    """Both workers of the 2-process collective leg on threads, each
    side feeding its shard through a one-shot producer — the
    tests/dcn_xfer_worker.py pattern with production overlapped."""
    a, b, ca, cb = pair
    barrier = threading.Barrier(2)
    out, errs = {}, []

    def chunks(payload):
        for off in range(0, len(payload), 4096):
            yield payload[off:off + 4096]

    def worker(name, client, data, peer_daemon, tx, rx):
        try:
            out[name] = dcn.exchange_shard(
                client, local_flow=tx, peer_flow=rx,
                producer=chunks(data), nbytes=len(data),
                peer_host="127.0.0.1", peer_port=peer_daemon.data_port,
                barrier=barrier.wait, timeout_s=15, **kw)
        except BaseException as e:  # surfaces in the test, not a hang
            errs.append(e)
            barrier.abort()

    ts = [
        threading.Thread(target=worker,
                         args=("a", ca, data_a, b, "rex.a", "rex.b")),
        threading.Thread(target=worker,
                         args=("b", cb, data_b, a, "rex.b", "rex.a")),
    ]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    if errs:
        raise errs[0]
    return out


class TestExchangeShardProducer:
    def test_two_sided_producer_exchange_rides_the_ring(
            self, pair, monkeypatch):
        """The full collective leg with BOTH shards producer-fed:
        shm pinned off so each side takes the ring-socket lane, and
        both read back the peer's shard byte-exact."""
        monkeypatch.setenv("TPU_DCN_SHM", "0")
        monkeypatch.setenv(dcn_pipeline.CHUNK_BYTES_ENV, "4096")
        pt0 = counters.get("dcn.ring.producer.transfers")
        out = _producer_exchange(pair, PAYLOAD, PAYLOAD[::-1],
                                 pipelined=True)
        assert out["a"] == PAYLOAD[::-1] and out["b"] == PAYLOAD
        assert counters.get("dcn.ring.producer.transfers") == pt0 + 2

    def test_serial_fallback_materializes_one_shot_producer(
            self, pair):
        """A producer-fed shard forced down the SERIAL path: the
        capture-tee materializes the one-shot iterator, so the leg
        that never stages chunk-wise still sends the full payload."""
        small_a, small_b = b"s" * 512, b"t" * 512
        out = _producer_exchange(pair, small_a, small_b,
                                 pipelined=False)
        assert out["a"] == small_b and out["b"] == small_a

    def test_producer_length_mismatch_raises(self, pair):
        _a, b, ca, _cb = pair
        with pytest.raises(DcnXferError, match="expected"):
            dcn.exchange_shard(
                ca, local_flow="rex.m", peer_flow="rex.n",
                producer=iter([b"x" * 100]), nbytes=512,
                peer_host="127.0.0.1", peer_port=b.data_port,
                timeout_s=5, pipelined=False)
