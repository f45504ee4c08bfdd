"""The port's DCN transfer plane against the JAX package's, both ways.

The two packages share one wire: the data-plane frames, the ``DXR1``
read-back, the descriptor-ring file, the control ops and the
``TPU_DCN_*`` variables.  These tests hold the port to it on seeded
payloads:

- ``encode_frame*`` / ``encode_read_request`` (and the pipeline's
  client-side copies of them) and ``RingView`` give the JAX package's
  bytes, and a ring one package posts into the other completes;
- each package's client drives the other package's ``PyXferd`` pair
  through ``exchange_shard`` in the serial, socket-pipelined, shm and
  ring lanes, byte-exact, with the lane's own counter moving;
- the port's daemon sends daemon-to-daemon into the JAX daemon and
  back, over TCP and over the same-host segment lane;
- the port's client runs a leg between two native daemons;
- the same scripted transfers leave the same span names, counters and
  counts in each package's ``obs``; the same observations give the same
  tuner decisions; the same lock scenarios give the same lockwatch
  findings.
"""

import os
import signal
import subprocess
import threading
import time
import types
import uuid

import numpy as np
import pytest

from container_engine_accelerators_tpu.analysis import (
    lockwatch as jax_lockwatch,
)
from container_engine_accelerators_tpu.fleet import xferd as jax_xferd
from container_engine_accelerators_tpu.metrics import (
    counters as jax_counters,
)
from container_engine_accelerators_tpu.obs import histo as jax_histo
from container_engine_accelerators_tpu.obs import timeseries as jax_ts
from container_engine_accelerators_tpu.obs import trace as jax_trace
from container_engine_accelerators_tpu.parallel import dcn as jax_dcn
from container_engine_accelerators_tpu.parallel import (
    dcn_client as jax_client,
)
from container_engine_accelerators_tpu.parallel import (
    dcn_pipeline as jax_pipeline,
)
from container_engine_accelerators_tpu.parallel import dcn_shm as jax_shm
from container_engine_accelerators_tpu.parallel import dcn_tune as jax_tune
from container_engine_accelerators_tpu.utils.retry import (
    RetryPolicy as JaxRetryPolicy,
)
from container_engine_accelerators_tpu_torch.analysis import lockwatch
from container_engine_accelerators_tpu_torch.fleet import xferd
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import histo, timeseries
from container_engine_accelerators_tpu_torch.obs import trace
from container_engine_accelerators_tpu_torch.parallel import (
    dcn,
    dcn_client,
    dcn_pipeline,
    dcn_shm,
    dcn_tune,
)
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XFERD_BIN = os.environ.get(
    "DCNXFERD_BIN",
    os.path.join(REPO, "native", "dcnxferd", "build", "dcnxferd"),
)

PKG = {
    "jax": types.SimpleNamespace(
        xferd=jax_xferd, client=jax_client, dcn=jax_dcn,
        pipeline=jax_pipeline, shm=jax_shm, tune=jax_tune,
        counters=jax_counters, trace=jax_trace, ts=jax_ts,
        histo=jax_histo, lockwatch=jax_lockwatch,
        retry=JaxRetryPolicy(max_attempts=8, initial_backoff_s=0.01,
                             max_backoff_s=0.1, deadline_s=15.0)),
    "torch": types.SimpleNamespace(
        xferd=xferd, client=dcn_client, dcn=dcn, pipeline=dcn_pipeline,
        shm=dcn_shm, tune=dcn_tune, counters=counters, trace=trace,
        ts=timeseries, histo=histo, lockwatch=lockwatch,
        retry=RetryPolicy(max_attempts=8, initial_backoff_s=0.01,
                          max_backoff_s=0.1, deadline_s=15.0)),
}

CHUNK = 16384
# Each lane's env (read by PipelineConfig() in exchange_shard and by
# PyXferd at construction) and the series that proves the lane moved
# the payload: (package side, gauge).
LANES = {
    "serial": ({}, None),
    "pipelined": ({"TPU_DCN_SHM": "0", "TPU_DCN_SHM_RING": "0",
                   "TPU_DCN_SHM_DIRECT": "0"},
                  ("daemon", "dcn.lane.socket.total_bytes")),
    "shm": ({"TPU_DCN_SHM": "1", "TPU_DCN_SHM_RING": "0",
             "TPU_DCN_SHM_DIRECT": "1"},
            ("client", "dcn.lane.shm.total_bytes")),
    "ring": ({"TPU_DCN_SHM": "0", "TPU_DCN_SHM_RING": "1",
              "TPU_DCN_SHM_DIRECT": "0"},
             ("daemon", "dcn.lane.socket.total_bytes")),
}


def _payload(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, size=n, dtype=np.uint8).tobytes()


def _lane_env(monkeypatch, lane):
    monkeypatch.setenv("TPU_DCN_CHUNK_BYTES", str(CHUNK))
    monkeypatch.setenv("TPU_DCN_TUNE", "0")
    monkeypatch.delenv("TPU_FAULT_SPEC", raising=False)
    for key, value in LANES[lane][0].items():
        monkeypatch.setenv(key, value)


def _daemons(pkg, tmp_path, names=("a", "b")):
    out = []
    for name in names:
        d = PKG[pkg].xferd.PyXferd(str(tmp_path / f"x{pkg[0]}{name}"),
                                  node=name)
        out.append(d.start())
    return out


def _exchange(pkg, clients, ports, pay_a, pay_b, **kw):
    """Both sides of one leg, each in its own thread, through
    ``pkg``'s ``exchange_shard``: returns (what a read, what b read)."""
    barrier = threading.Barrier(2, timeout=30)
    tag = uuid.uuid4().hex[:8]
    results, errors = {}, []

    def side(me, peer, client, data):
        try:
            results[me] = PKG[pkg].dcn.exchange_shard(
                client, local_flow=f"x{tag}.{me}",
                peer_flow=f"x{tag}.{peer}", data=data,
                peer_host="127.0.0.1", peer_port=ports[peer],
                barrier=barrier.wait, timeout_s=30, **kw)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=side, args=a, daemon=True) for a in
               (("a", "b", clients[0], pay_a), ("b", "a", clients[1],
                                                 pay_b))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return results["a"], results["b"]


# ---- wire bytes ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_frames_and_read_requests_are_the_jax_bytes(seed):
    rng = np.random.default_rng(seed)
    payload = _payload(seed, int(rng.integers(0, 5000)))
    flow = f"grad{seed}.shard-{int(rng.integers(1 << 30))}"
    meta = {"trace": f"{int(rng.integers(1 << 62)):016x}",
            "span": f"{int(rng.integers(1 << 30)):08x}", "src": "n0",
            "off": int(rng.integers(1 << 20)),
            "tot": int(rng.integers(1 << 20, 1 << 24)),
            "xid": uuid.UUID(int=int(rng.integers(1 << 62))).hex}
    seq = int(rng.integers(1, 1 << 40))
    for kw in ({}, {"seq": seq}, {"meta": meta}, {"seq": seq, "meta": meta}):
        assert xferd.encode_frame(flow, payload, **kw) == \
            jax_xferd.encode_frame(flow, payload, **kw)
        assert xferd.encode_frame_header(flow, len(payload), **kw) == \
            jax_xferd.encode_frame_header(flow, len(payload), **kw)
    off, n = int(rng.integers(1 << 40)), int(rng.integers(1 << 40))
    assert xferd.encode_read_request(flow, off, n) == \
        jax_xferd.encode_read_request(flow, off, n)
    # The pipeline's deliberate client-side copies of the encoders.
    assert dcn_pipeline._chunk_frame_header(flow, len(payload), meta) == \
        jax_pipeline._chunk_frame_header(flow, len(payload), meta)
    assert dcn_pipeline._read_request(flow, off, n) == \
        jax_pipeline._read_request(flow, off, n)


def test_wire_constants_and_env_names_match():
    for name in ("_MAGIC_V1", "_MAGIC_V2", "_MAGIC_READ", "SOCKET_NAME",
                 "DEDUP_WINDOW"):
        assert getattr(xferd, name) == getattr(jax_xferd, name), name
    for name in ("RING_MAGIC", "RING_HDR_BYTES", "RING_SLOT_BYTES",
                 "RING_VERDICTS", "HOST_ID_ENV", "SHM_ENV",
                 "SHM_DIRECT_ENV", "SHM_RING_ENV"):
        assert getattr(dcn_shm, name) == getattr(jax_shm, name), name
    for name in ("DEFAULT_UDS_DIR", "SOCKET_NAME"):
        assert getattr(dcn_client, name) == getattr(jax_client, name), name
    assert dcn.DCN_UDS_ENV == jax_dcn.DCN_UDS_ENV == "DCN_UDS_DIR"
    assert (dcn.POLL_MIN_S, dcn.POLL_MAX_S) == (jax_dcn.POLL_MIN_S,
                                                jax_dcn.POLL_MAX_S)
    for name in ("PIPELINE_ENV", "CHUNK_BYTES_ENV", "STRIPES_ENV"):
        assert getattr(dcn_pipeline, name) == getattr(jax_pipeline, name)
    assert dcn_tune.TUNE_ENV == jax_tune.TUNE_ENV
    assert dcn_shm.host_identity() == jax_shm.host_identity()


@pytest.mark.parametrize("seed", range(3))
def test_ring_view_bytes_are_the_jax_bytes(seed):
    rng = np.random.default_rng(seed)
    slots = int(rng.integers(2, 17))
    bufs = {k: bytearray(dcn_shm.ring_bytes(slots)) for k in PKG}
    views = {k: PKG[k].shm.RingView(bufs[k]) for k in PKG}
    for v in views.values():
        v.init(slots)
    assert bufs["torch"] == bufs["jax"]
    for _ in range(4):
        n = int(rng.integers(1, slots + 1))
        descs = [tuple(int(x) for x in rng.integers(0, 1 << 40, 3))
                 for _ in range(n)]
        rounds = {k: v.post(descs) for k, v in views.items()}
        assert rounds["torch"] == rounds["jax"]
        assert bufs["torch"] == bufs["jax"]
        statuses = [int(s) for s in rng.integers(1, 9, n)]
        for k, v in views.items():
            v.begin_round(rounds[k])
            assert bufs["torch"] != bufs["jax"] or k == "torch"
            for i, st in enumerate(statuses):
                v.complete(i, st, i + 1)
        assert bufs["torch"] == bufs["jax"]
        assert views["torch"].completion() == views["jax"].completion()
        assert views["torch"].statuses(n) == views["jax"].statuses(n)


@pytest.mark.parametrize("poster,completer", [("torch", "jax"),
                                              ("jax", "torch")])
def test_ring_posted_by_one_package_completes_in_the_other(poster,
                                                           completer):
    buf = bytearray(dcn_shm.ring_bytes(8))
    PKG[completer].shm.RingView(buf).init(8)
    client = PKG[poster].shm.RingView(buf)
    daemon = PKG[completer].shm.RingView(buf)
    descs = [(0, 4096, 11), (4096, 4096, 12), (8192, 100, 13)]
    rnd = client.post(descs)
    assert daemon.slots == 8
    assert daemon.read_descs(3) == descs
    daemon.begin_round(rnd)
    for i, verdict in enumerate(("landed", "dup", "sent")):
        daemon.complete(i, PKG[completer].shm.RING_STATUS_BY_VERDICT[verdict],
                        i + 1)
    assert client.completion() == (rnd, 3)
    assert [PKG[poster].shm.RING_VERDICTS[s]
            for s in client.statuses(3)] == ["landed", "dup", "sent"]


# ---- each package's client against the other package's daemons ---------------


@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("client_pkg,daemon_pkg", [("torch", "jax"),
                                                   ("jax", "torch")])
def test_client_drives_the_other_packages_daemons(client_pkg, daemon_pkg,
                                                  lane, tmp_path,
                                                  monkeypatch):
    _lane_env(monkeypatch, lane)
    da, db = _daemons(daemon_pkg, tmp_path)
    C = PKG[client_pkg]
    try:
        with C.client.ResilientDcnXferClient(da.uds_dir,
                                             retry=C.retry) as ca, \
                C.client.ResilientDcnXferClient(db.uds_dir,
                                                retry=C.retry) as cb:
            ports = {"a": da.data_port, "b": db.data_port}
            proof = LANES[lane][1]
            series = None
            if proof is not None:
                side = PKG[client_pkg if proof[0] == "client"
                           else daemon_pkg]
                series = side.ts
                before = series.gauges().get(proof[1], 0.0)
            pay_a = _payload(1, 5 * CHUNK + 123)
            pay_b = _payload(2, 5 * CHUNK + 123)
            got_a, got_b = _exchange(client_pkg, (ca, cb), ports, pay_a,
                                     pay_b, pipelined=lane != "serial")
            assert got_a == pay_b and got_b == pay_a
            if series is not None:
                moved = series.gauges().get(proof[1], 0.0) - before
                assert moved >= 2 * len(pay_a), (proof, moved)
            assert ca.stats()["active_flows"] == 0
    finally:
        da.stop()
        db.stop()


# ---- daemon to daemon across packages ------------------------------------------


@pytest.mark.parametrize("direct", [False, True], ids=["tcp", "shm_direct"])
@pytest.mark.parametrize("src,dst", [("torch", "jax"), ("jax", "torch")])
def test_daemon_sends_into_the_other_packages_daemon(src, dst, direct,
                                                     tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DCN_SHM_DIRECT", "1" if direct else "0")
    monkeypatch.setenv("TPU_DCN_SHM", "1")
    (sender,) = _daemons(src, tmp_path, ("s",))
    (receiver,) = _daemons(dst, tmp_path, ("r",))
    S, R = PKG[src], PKG[dst]
    payload = _payload(7, 3 * CHUNK + 17)
    lane = "shm_direct" if direct else "socket"
    before = S.ts.gauges().get(f"dcn.lane.{lane}.total_bytes", 0.0)
    try:
        with S.client.DcnXferClient(sender.uds_dir) as cs, \
                R.client.DcnXferClient(receiver.uds_dir) as cr:
            cr.register_flow("land", bytes=len(payload))
            cs.register_flow("land", peer="127.0.0.1", bytes=len(payload))
            if direct:
                # The receiving flow must hold a segment for the sender
                # to attach it (the lane's precondition).
                cr.shm_attach("land", len(payload))
            cs.put("land", payload)
            S.dcn.wait_flow_rx(cs, "land", len(payload), timeout_s=10)
            cs.send("land", "127.0.0.1", receiver.data_port, len(payload))
            R.dcn.wait_flow_rx(cr, "land", len(payload), timeout_s=10)
            assert cr.read("land", len(payload)) == payload
    finally:
        sender.stop()
        receiver.stop()
    moved = S.ts.gauges().get(f"dcn.lane.{lane}.total_bytes", 0.0) - before
    assert moved >= len(payload), (lane, moved)


# ---- the port's client against the native daemon -------------------------------


@pytest.mark.skipif(not os.path.exists(XFERD_BIN),
                    reason="dcnxferd not built (make native)")
def test_port_client_runs_a_leg_between_native_daemons(tmp_path):
    procs, ports, clients = [], {}, []
    try:
        for name in ("a", "b"):
            uds = str(tmp_path / f"n{name}")
            proc = subprocess.Popen(
                [XFERD_BIN, "--uds_path", uds, "--pool_bytes",
                 str(8 << 20), "--max_flows", "8", "--data_port", "0"],
                stderr=subprocess.PIPE, text=True)
            procs.append(proc)
            deadline = time.time() + 10
            while not os.path.exists(os.path.join(uds, "xferd.sock")):
                assert proc.poll() is None, proc.stderr.read()
                assert time.time() < deadline
                time.sleep(0.02)
            c = dcn_client.ResilientDcnXferClient(uds,
                                                  retry=PKG["torch"].retry)
            clients.append(c)
            ports[name] = c.data_port()
        # The native daemon has no wait op: the leg takes the poll path.
        with pytest.raises(dcn_client.DcnWaitUnsupported):
            clients[0].wait_rx("nothing", 1, timeout_s=0.1)
        assert not dcn_pipeline.should_pipeline(clients[0], 1 << 30)
        pay_a, pay_b = _payload(3, 65_537), _payload(4, 65_537)
        for _ in range(2):  # the same flow names twice: no leak
            got_a, got_b = _exchange("torch", clients, ports, pay_a, pay_b)
            assert got_a == pay_b and got_b == pay_a
        assert all(c.stats()["active_flows"] == 0 for c in clients)
    finally:
        for c in clients:
            c.close()
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
                p.wait(timeout=10)


# ---- the same scripted transfers leave the same obs -----------------------------


def _reset_obs(side):
    side.counters.reset()
    side.trace.reset()
    side.histo.reset()
    side.ts.reset()


def _scripted(pkg, tmp_path):
    """Serial and socket-pipelined legs between two daemons of ``pkg``
    by ``pkg``'s clients; returns (counters, span names, histograms)."""
    P = PKG[pkg]
    da, db = _daemons(pkg, tmp_path)
    try:
        with P.client.DcnXferClient(da.uds_dir) as ca, \
                P.client.DcnXferClient(db.uds_dir) as cb:
            ports = {"a": da.data_port, "b": db.data_port}
            for i, pipelined in enumerate((False, True, False)):
                pay_a = _payload(10 + i, 4 * CHUNK)
                pay_b = _payload(20 + i, 4 * CHUNK)
                got = _exchange(pkg, (ca, cb), ports, pay_a, pay_b,
                                pipelined=pipelined)
                assert got == (pay_b, pay_a)
    finally:
        da.stop()
        db.stop()
    names = sorted(s["name"] for s in P.trace.tail())
    return (P.counters.snapshot(), names,
            sorted(P.histo.snapshot()))


def test_scripted_transfers_leave_the_same_obs(tmp_path, monkeypatch):
    _lane_env(monkeypatch, "pipelined")
    monkeypatch.setenv("TPU_DCN_STRIPES", "1")
    got = {}
    for pkg in PKG:
        _reset_obs(PKG[pkg])
        try:
            got[pkg] = _scripted(pkg, tmp_path / pkg)
        finally:
            _reset_obs(PKG[pkg])
    assert got["torch"][0] == got["jax"][0]
    assert got["torch"][1] == got["jax"][1]
    assert got["torch"][2] == got["jax"][2]
    assert any(n.startswith("dcn.exchange") for n in got["torch"][1])
    assert any(n.startswith("xferd.") for n in got["torch"][1])


# ---- the same observations give the same tuner decisions ------------------------


@pytest.mark.parametrize("seed", range(3))
def test_same_observations_same_tuner_decisions(seed, monkeypatch):
    monkeypatch.setenv("TPU_DCN_TUNE", "1")
    rng = np.random.default_rng(seed)
    trace_obs = []
    for _ in range(120):
        kind = rng.choice(["clean", "clean", "clean", "lossy", "transfer",
                           "fail", "shm"])
        attempted = int(rng.integers(1, 16))
        trace_obs.append((str(kind), attempted,
                          int(rng.integers(0, attempted + 1)),
                          int(rng.integers(1000, 1 << 24)),
                          float(rng.uniform(0.01, 2.0)),
                          float(rng.uniform(0.0, 1.0))))
    decisions = {}
    for pkg, P in PKG.items():
        P.tune.reset()
        t = P.tune.tuner_for("10.0.0.2:4242",
                             P.tune.TuneConfig(min_chunk_bytes=4096))
        out = []
        for kind, att, failed, nbytes, secs, exposed in trace_obs:
            if kind == "transfer":
                t.on_transfer(True, exposed_ratio=exposed)
                d = None
            elif kind == "fail":
                d = t.on_transfer(False)
            else:
                d = t.on_round(attempted=att,
                               failed=0 if kind == "clean" else failed,
                               bytes_confirmed=nbytes, elapsed_s=secs,
                               lane="shm" if kind == "shm" else "socket")
            out.append((d, t.plan(1 << 20, 2), t.stripes_now()))
        decisions[pkg] = (out, t.history(),
                          sorted(P.tune.decision_history()))
        P.tune.reset()
    assert decisions["torch"] == decisions["jax"]
    assert any(d for d, _, _ in decisions["torch"][0])


# ---- the same lock scenarios give the same lockwatch findings ---------------------


def _abba():
    # One line a lock: a site (file:line) is a lock class.
    a = threading.Lock()
    b = threading.Lock()

    def t1():
        with a:
            with b:
                pass

    def t2():
        with b:
            with a:
                pass

    for i, fn in enumerate((t1, t2)):
        t = threading.Thread(target=fn, name=f"abba-{i}")
        t.start()
        t.join()


def _gated_and_blocking():
    gate = threading.Lock()
    x = threading.Lock()
    y = threading.RLock()

    def t1():
        with gate:
            with x:
                with y:
                    with y:
                        pass

    def t2():
        with gate:
            with y:
                with x:
                    time.sleep(0.02)

    for i, fn in enumerate((t1, t2)):
        t = threading.Thread(target=fn, name=f"gated-{i}")
        t.start()
        t.join()


def _allowed_and_condition(lw):
    lock = threading.Lock()
    cond = threading.Condition(threading.RLock())
    box = []

    def waiter():
        with cond:
            while not box:
                cond.wait(timeout=5)

    t = threading.Thread(target=waiter, name="cond-0")
    t.start()
    with cond:
        box.append(1)
        cond.notify_all()
    t.join()
    with lock:
        with lw.blocking_ok("serialize one stream"):
            time.sleep(0.02)


@pytest.mark.parametrize("scenario", ["abba", "gated_blocking",
                                      "allowed_condition"])
def test_same_lock_scenarios_same_findings(scenario, monkeypatch):
    monkeypatch.setenv("TPU_LOCKWATCH_SLEEP_MS", "10")
    found = {}
    for pkg in ("jax", "torch"):
        lw = PKG[pkg].lockwatch
        assert lw.install()
        lw.reset()
        try:
            if scenario == "abba":
                _abba()
            elif scenario == "gated_blocking":
                _gated_and_blocking()
            else:
                _allowed_and_condition(lw)
            found[pkg] = lw.findings()
        finally:
            lw.reset()
            lw.uninstall()
    assert found["torch"] == found["jax"]
    if scenario == "abba":
        assert len(found["torch"]["inversions"]) == 1
    elif scenario == "gated_blocking":
        assert found["torch"]["suppressed"] and found["torch"]["blocking"]
    else:
        assert found["torch"]["allowed"] and not found["torch"]["blocking"]
