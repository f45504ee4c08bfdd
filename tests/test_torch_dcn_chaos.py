"""Chaos suite of the port's DCN transfer plane: the DCN parts of
tests/test_chaos.py against the port's client, ``exchange_shard`` and
the same daemons (the control-plane stub, the native daemon).

The fault sites ``dcn.connect`` / ``dcn.send`` (``TPU_FAULT_SPEC``)
and the kill/restart doubles drive the self-healing contract:
ResilientDcnXferClient reconnects, replays its flow table, restages,
and the transfer completes, with zero manual intervention; a spent
budget latches terminal and leaves a flight record.  Tests that need
exact fault accounting arm a private injector via ``faults.armed``
rather than reading the process env.
"""

import json
import os
import queue
import signal
import subprocess
import threading
import time

import pytest

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import flight, histo, trace
from container_engine_accelerators_tpu_torch.parallel import dcn
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferClient,
    DcnXferError,
    ResilientDcnXferClient,
)
from container_engine_accelerators_tpu_torch.utils import faults
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy
from tests.xferd_stub import XferdStub

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XFERD_BIN = os.environ.get(
    "DCNXFERD_BIN",
    os.path.join(REPO, "native", "dcnxferd", "build", "dcnxferd"),
)

# Fast budget for tests: same shape as production, millisecond scale.
FAST_RETRY = RetryPolicy(
    max_attempts=8, initial_backoff_s=0.01, max_backoff_s=0.1, deadline_s=15.0
)



@pytest.fixture
def xstub(tmp_path):
    stub = XferdStub(str(tmp_path / "tpu-dcn")).start()
    yield stub
    stub.stop()


class TestDcnFaultSites:
    def test_base_client_stays_fail_fast_under_injection(self, xstub):
        """The seed contract is unchanged: one transport fault poisons a
        plain DcnXferClient; only ResilientDcnXferClient recovers."""
        with faults.armed("dcn.send:fail@1"):
            c = DcnXferClient(xstub.uds_dir)
            with pytest.raises(DcnXferError, match="connection failed"):
                c.ping()
            with pytest.raises(DcnXferError, match="reconnect"):
                c.ping()  # poisoned for good
            c.close()

    def test_base_client_connect_fault(self, xstub):
        with faults.armed("dcn.connect:drop@1"):
            with pytest.raises(OSError):
                DcnXferClient(xstub.uds_dir)

    def test_resilient_client_absorbs_send_fault(self, xstub):
        with faults.armed("dcn.send:fail@2") as inj:
            with ResilientDcnXferClient(xstub.uds_dir,
                                        retry=FAST_RETRY) as c:
                c.register_flow("f0", bytes=4096)
                # This call eats the injected fault: reconnect, replay
                # f0 (daemon released it on disconnect, so accounting
                # restarts at zero), then the retried op lands.
                assert c.record_transfer("f0", 100) == 100
                assert c.record_transfer("f0", 100) == 200
            assert inj.fired("dcn.send") == 1

    def test_resilient_client_absorbs_connect_faults(self, xstub):
        with faults.armed("dcn.connect:drop@1x2") as inj:
            with ResilientDcnXferClient(xstub.uds_dir,
                                        retry=FAST_RETRY) as c:
                c.ping()
            assert inj.fired("dcn.connect") == 2

    def test_empty_exchange_shard_never_touches_the_data_plane(
            self, xstub):
        """The empty-shard short-circuit, proved the hard way: the
        stub daemon has NO data plane (no data_port/put/send), so an
        exchange of zero bytes only completes if the leg really is
        register + barrier + release and nothing else."""
        from container_engine_accelerators_tpu_torch.parallel import dcn

        hit = []
        with ResilientDcnXferClient(xstub.uds_dir,
                                    retry=FAST_RETRY) as c:
            got = dcn.exchange_shard(
                c, local_flow="empty.tx", peer_flow="empty.rx",
                data=b"", peer_host="127.0.0.1", peer_port=1,
                barrier=lambda: hit.append(1), timeout_s=5)
            assert got == b"" and hit == [1]
            assert c.stats()["active_flows"] == 0  # released on exit

    def test_daemon_level_errors_still_fail_fast(self, xstub):
        """Only transport loss retries; an ok:false reply must surface
        immediately (retrying a rejected request is wrong).  Private
        empty injector: exact reconnect accounting must not absorb a
        global spec's injected faults."""
        with faults.armed(""):
            with ResilientDcnXferClient(xstub.uds_dir,
                                        retry=FAST_RETRY) as c:
                c.register_flow("dup", bytes=4096)
                before = counters.get("dcn.reconnect.attempts")
                with pytest.raises(DcnXferError, match="already exists"):
                    c.register_flow("dup", bytes=4096)
                assert counters.get("dcn.reconnect.attempts") == before


@pytest.mark.chaos
class TestDcnDaemonChaos:
    def test_stub_restart_mid_flow_replays_and_completes(self, xstub):
        """Scenario 1 (stub form): daemon dies mid-flow, comes back;
        the client reconnects, replays the flow table, and finishes
        accounting — zero manual intervention."""
        with ResilientDcnXferClient(xstub.uds_dir, retry=FAST_RETRY) as c:
            c.register_flow("g0", peer="peer-a", bytes=8192)
            c.register_flow("g1", peer="peer-b", bytes=8192)
            assert c.record_transfer("g0", 4096) == 4096

            xstub.stop(crash=True)  # SIGKILL analog: socket path lingers
            xstub.start()

            # Daemon restart lost all state; the op rides a reconnect
            # that re-registers BOTH flows first (accounting restarts
            # from zero on the fresh daemon — connection == lifetime).
            assert c.record_transfer("g0", 4096) == 4096
            stats = c.stats()
            assert stats["generation"] == 2
            assert {f["flow"] for f in stats["flows"]} == {"g0", "g1"}
            assert c.record_transfer("g1", 1) == 1

    def test_restart_while_daemon_down_rides_backoff(self, xstub):
        """The daemon stays down across several backoff rounds; the call
        blocks, retries, and completes once it returns."""
        with ResilientDcnXferClient(xstub.uds_dir, retry=FAST_RETRY) as c:
            c.register_flow("g0", bytes=4096)
            xstub.stop(crash=True)

            def restart_later():
                time.sleep(0.25)
                xstub.start()

            t = threading.Thread(target=restart_later)
            t.start()
            try:
                assert c.record_transfer("g0", 7) == 7  # blocks + recovers
            finally:
                t.join()

    def test_budget_exhaustion_turns_terminal(self, xstub):
        """Graceful degradation: past the budget the client raises a
        clear terminal error immediately instead of hammering."""
        tiny = RetryPolicy(max_attempts=3, initial_backoff_s=0.01,
                           max_backoff_s=0.02)
        c = ResilientDcnXferClient(xstub.uds_dir, retry=tiny)
        c.register_flow("g0", bytes=4096)
        xstub.stop(crash=True)
        with pytest.raises(DcnXferError, match="unreachable after 3"):
            c.ping()
        with pytest.raises(DcnXferError, match="terminal"):
            c.ping()  # no further reconnect attempts

    def test_release_drops_flow_from_replay_table(self, xstub):
        with ResilientDcnXferClient(xstub.uds_dir, retry=FAST_RETRY) as c:
            c.register_flow("keep", bytes=4096)
            c.register_flow("gone", bytes=4096)
            c.release_flow("gone")
            xstub.stop(crash=True)
            xstub.start()
            c.ping()  # forces reconnect + replay
            assert {f["flow"] for f in c.stats()["flows"]} == {"keep"}


@pytest.mark.chaos
@pytest.mark.skipif(not os.path.exists(XFERD_BIN),
                    reason="dcnxferd not built (make native)")
class TestRealDaemonChaos:
    """Scenario 1 against the REAL native daemon, data plane included:
    SIGKILL mid-flow, restart on the same UDS path, transfer completes."""

    def _spawn(self, uds):
        proc = subprocess.Popen(
            [XFERD_BIN, "--uds_path", uds, "--pool_bytes", str(8 << 20),
             "--max_flows", "4", "--data_port", "0"],
            stderr=subprocess.PIPE, text=True,
        )
        sock = os.path.join(uds, "xferd.sock")
        deadline = time.time() + 10
        while not os.path.exists(sock):
            assert proc.poll() is None, proc.stderr.read()
            assert time.time() < deadline, "daemon never created its socket"
            time.sleep(0.02)
        return proc

    def test_exchange_shard_legs_repeat_without_flow_leak(self, tmp_path):
        """The production transfer path (dcn.exchange_shard) releases its
        flows per leg: a second leg with the same names must not hit the
        daemon's duplicate-flow rejection, and flow count returns to 0."""
        uds_a = str(tmp_path / "dcn-a")
        uds_b = str(tmp_path / "dcn-b")
        pa, pb_ = self._spawn(uds_a), self._spawn(uds_b)
        try:
            with ResilientDcnXferClient(uds_a, retry=FAST_RETRY) as ca, \
                    ResilientDcnXferClient(uds_b, retry=FAST_RETRY) as cb:
                ports = {"a": ca.data_port(), "b": cb.data_port()}
                for leg in range(2):  # same flow names both legs
                    barrier = threading.Barrier(2, timeout=30)
                    results = {}

                    def side(name, client, peer, payload):
                        results[name] = dcn.exchange_shard(
                            client,
                            local_flow=f"shard-{name}",
                            peer_flow=f"shard-{peer}",
                            data=payload,
                            peer_host="127.0.0.1",
                            peer_port=ports[peer],
                            barrier=barrier.wait,
                            timeout_s=30,
                        )

                    pay_a = bytes([leg]) * 8192
                    pay_b = bytes([leg + 128]) * 8192
                    ta = threading.Thread(
                        target=side, args=("a", ca, "b", pay_a))
                    tb = threading.Thread(
                        target=side, args=("b", cb, "a", pay_b))
                    ta.start(), tb.start()
                    ta.join(timeout=60), tb.join(timeout=60)
                    assert results["a"] == pay_b  # A read B's shard
                    assert results["b"] == pay_a
                assert ca.stats()["active_flows"] == 0
                assert cb.stats()["active_flows"] == 0
        finally:
            for p in (pa, pb_):
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
                    p.wait(timeout=10)

    def test_kill9_restart_mid_flow_transfer_completes(self, tmp_path):
        uds = str(tmp_path / "tpu-dcn")
        payload = bytes(range(256)) * 64  # 16 KiB
        proc = self._spawn(uds)
        try:
            with ResilientDcnXferClient(uds, retry=FAST_RETRY) as c:
                c.register_flow("stage", bytes=len(payload))
                c.put("stage", payload)
                dcn.wait_flow_rx(c, "stage", len(payload))
                assert c.read("stage", len(payload)) == payload

                proc.send_signal(signal.SIGKILL)  # mid-flow crash
                proc.wait(timeout=10)
                proc = self._spawn(uds)

                # Same client, zero manual intervention — and no
                # caller-side put-again workaround: read itself notices
                # the restarted daemon's blank staging, restages the
                # cached payload through the data plane (re-resolving
                # the NEW data port via the reconnected control plane),
                # waits for it to land, and returns the bytes.
                restaged0 = counters.get("dcn.read.restaged")
                assert c.read("stage", len(payload)) == payload
                assert counters.get("dcn.read.restaged") == restaged0 + 1
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                proc.wait(timeout=10)


@pytest.mark.chaos
class TestChaosObservability:
    def test_daemon_kill_trace_covers_connect_fault_reconnect_replay(
            self, xstub, tmp_path, monkeypatch):
        """A daemon-kill chaos run with
        TPU_TRACE_FILE set leaves a parseable JSONL whose spans tell
        the whole story — connect, the injected fault, the reconnect,
        the flow replay — and the replay hangs off the same trace as
        the op that triggered it."""
        path = str(tmp_path / "chaos-trace.jsonl")
        monkeypatch.setenv(trace.TRACE_FILE_ENV, path)
        trace.reset()  # pick up the env, as a fresh agent process would
        try:
            with faults.armed("dcn.send:fail@3"):
                with ResilientDcnXferClient(xstub.uds_dir,
                                            retry=FAST_RETRY) as c:
                    c.register_flow("f0", bytes=4096)
                    # Injected fault on this op's send -> reconnect +
                    # replay of f0 -> retried op lands.
                    assert c.record_transfer("f0", 64) == 64
                    # Then a REAL daemon kill/restart mid-flow.
                    xstub.stop(crash=True)
                    xstub.start()
                    assert c.record_transfer("f0", 64) == 64
        finally:
            trace.reset()  # close the sink before reading it

        spans = [json.loads(line) for line in open(path)]  # parseable
        by_name = {}
        for s in spans:
            by_name.setdefault(s["name"], []).append(s)
        assert {"dcn.connect", "dcn.send", "dcn.replay"} <= set(by_name)
        # The injected fault is stamped on the span it killed.
        faulted = [s for s in spans
                   if (s.get("attrs") or {}).get("fault") == "dcn.send"]
        assert faulted and faulted[0]["status"] == "error"
        # Replay is a child of the reconnect machinery on the SAME
        # trace as the faulted op (one story, not three fragments), and
        # wraps a fresh connect.
        replays = by_name["dcn.replay"]
        assert any(r["trace"] == faulted[0]["trace"] for r in replays)
        replay_ids = {r["span"] for r in replays}
        assert any(s["parent"] in replay_ids
                   for s in by_name["dcn.connect"])
        # Latency histograms populated for the hot path ops the
        # MetricServer will export (export itself: test_metrics.py).
        snap = histo.snapshot()
        assert snap["dcn.send"]["count"] > 0
        assert snap["dcn.replay"]["count"] > 0

    def test_terminal_failure_emits_flight_record(self, xstub, tmp_path,
                                                  monkeypatch):
        """A resilient client latching terminal must leave the evidence
        behind: one JSON blob with the last spans and the counter
        snapshot (the flight-recorder bar)."""
        path = str(tmp_path / "flight.jsonl")
        monkeypatch.setenv(flight.FLIGHT_FILE_ENV, path)
        tiny = RetryPolicy(max_attempts=2, initial_backoff_s=0.01,
                           max_backoff_s=0.02)
        c = ResilientDcnXferClient(xstub.uds_dir, retry=tiny)
        c.register_flow("f0", bytes=4096)
        xstub.stop(crash=True)
        with pytest.raises(DcnXferError, match="unreachable"):
            c.ping()
        blobs = [json.loads(line) for line in open(path)]
        terminal = [b for b in blobs if "latched terminal" in b["reason"]]
        assert terminal, [b["reason"] for b in blobs]
        blob = terminal[-1]
        assert blob["spans"], "flight dump carried no spans"
        assert "counters" in blob and "histograms" in blob
        assert blob["counters"].get("dcn.retry.exhausted", 0) >= 1
