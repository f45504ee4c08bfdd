"""dcnxferd daemon tests: spawn the real native binary, drive the real
UDS protocol (the role nccl-test pods play against tcpgpudmarxd)."""

import os
import signal
import socket
import subprocess
import time

import pytest

from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnXferClient,
    DcnXferError,
)

BIN = os.path.join(os.path.dirname(__file__), "..",
                   "native", "dcnxferd", "build", "dcnxferd")
# Sanitizer builds point DCNXFERD_BIN at the instrumented binary
# (an ASan build), the `go test -race` analog for our native surface.
BIN = os.environ.get("DCNXFERD_BIN", BIN)

pytestmark = pytest.mark.skipif(
    not os.path.exists(BIN), reason="dcnxferd not built (run `make native`)"
)


@pytest.fixture
def daemon(tmp_path):
    uds = str(tmp_path / "tpu-dcn")
    proc = subprocess.Popen(
        [BIN, "--uds_path", uds, "--pool_bytes", str(8 << 20),
         "--max_flows", "4", "--verbose", "2"],
        stderr=subprocess.PIPE, text=True,
    )
    sock_path = os.path.join(uds, "xferd.sock")
    deadline = time.time() + 10
    while not os.path.exists(sock_path):
        assert proc.poll() is None, proc.stderr.read()
        assert time.time() < deadline, "daemon never created its socket"
        time.sleep(0.02)
    yield uds
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=10)


def test_version_and_ping(daemon):
    with DcnXferClient(daemon) as c:
        assert c.version() == "dcnxferd/1.2"
        c.ping()


def test_register_transfer_release_flow(daemon):
    with DcnXferClient(daemon) as c:
        resp = c.register_flow("g0", peer="slice1-h0", bytes=1 << 20)
        assert resp["buffer_bytes"] >= 1 << 20
        assert c.record_transfer("g0", 4096) == 4096
        assert c.record_transfer("g0", 4096) == 8192
        stats = c.stats()
        assert stats["active_flows"] == 1
        assert stats["total_transferred"] == 8192
        assert stats["flows"][0]["peer"] == "slice1-h0"
        c.release_flow("g0")
        assert c.stats()["active_flows"] == 0
        assert c.stats()["pool_used"] == 0


def test_pool_exhaustion_and_duplicate_flow(daemon):
    with DcnXferClient(daemon) as c:
        c.register_flow("big", bytes=6 << 20)
        with pytest.raises(DcnXferError, match="pool exhausted"):
            c.register_flow("too-big", bytes=4 << 20)
        with pytest.raises(DcnXferError, match="already exists"):
            c.register_flow("big")
        # Released memory is reusable.
        c.release_flow("big")
        c.register_flow("big2", bytes=6 << 20)


def test_max_flows(daemon):
    with DcnXferClient(daemon) as c:
        for i in range(4):
            c.register_flow(f"f{i}", bytes=4096)
        with pytest.raises(DcnXferError, match="max flows"):
            c.register_flow("f4", bytes=4096)


def test_client_disconnect_releases_its_flows(daemon):
    c1 = DcnXferClient(daemon)
    c1.register_flow("orphan", bytes=1 << 20)
    with DcnXferClient(daemon) as c2:
        assert c2.stats()["active_flows"] == 1
        # Another client cannot touch c1's flow.
        with pytest.raises(DcnXferError, match="another client"):
            c2.release_flow("orphan")
        c1.close()
        deadline = time.time() + 5
        while c2.stats()["active_flows"] != 0:
            assert time.time() < deadline, "orphaned flow never released"
            time.sleep(0.02)
        assert c2.stats()["pool_used"] == 0


def test_rejects_hostile_input(daemon):
    with DcnXferClient(daemon) as c:
        with pytest.raises(DcnXferError, match="invalid flow name"):
            c.register_flow('evil"name')
        with pytest.raises(DcnXferError, match="invalid flow name"):
            c.register_flow("x" * 100)
        c.register_flow("ok", bytes=4096)
        with pytest.raises(DcnXferError, match="invalid 'bytes'"):
            c.record_transfer("ok", -1)
        with pytest.raises(DcnXferError, match="invalid 'bytes'"):
            c._call(op="record_transfer", flow="ok", bytes="abc")
        assert c.stats()["total_transferred"] == 0


def test_slow_reader_does_not_block_other_clients(daemon):
    # A client that pipelines requests without reading responses must not
    # stall the event loop for everyone else.
    stuck = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stuck.connect(os.path.join(daemon, "xferd.sock"))
    stuck.sendall(b'{"op":"stats"}\n' * 2000)  # never reads
    with DcnXferClient(daemon, timeout_s=5) as c:
        for i in range(10):
            c.ping()  # would time out if the daemon were blocked
    stuck.close()


def test_bad_json_and_unknown_op(daemon):
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(os.path.join(daemon, "xferd.sock"))
    f = sock.makefile("r")
    sock.sendall(b"this is not json\n")
    assert '"ok":false' in f.readline()
    sock.sendall(b'{"op":"frobnicate"}\n')
    assert "unknown op" in f.readline()
    sock.close()


@pytest.fixture
def daemon_pair(tmp_path):
    """Two daemons on one host — the two-node DCN data-plane rig."""
    procs, dirs = [], []
    for name in ("a", "b"):
        uds = str(tmp_path / f"dcn-{name}")
        proc = subprocess.Popen(
            [BIN, "--uds_path", uds, "--pool_bytes", str(16 << 20),
             "--max_flows", "4", "--data_port", "0", "--verbose", "2"],
            stderr=subprocess.PIPE, text=True,
        )
        procs.append(proc)
        dirs.append(uds)
    for proc, uds in zip(procs, dirs):
        sock_path = os.path.join(uds, "xferd.sock")
        deadline = time.time() + 10
        while not os.path.exists(sock_path):
            assert proc.poll() is None, proc.stderr.read()
            assert time.time() < deadline
            time.sleep(0.02)
    yield dirs
    for proc in procs:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=10)


class TestDataPlane:
    """Cross-daemon TCP transfers (the rxdm RX-datapath analog)."""

    def test_data_port_reported(self, daemon_pair):
        with DcnXferClient(daemon_pair[0]) as c:
            assert 0 < c.data_port() < 65536

    def test_send_lands_in_peer_flow(self, daemon_pair):
        uds_a, uds_b = daemon_pair
        nbytes = 6 << 20
        with DcnXferClient(uds_a) as a, DcnXferClient(uds_b) as b:
            a.register_flow("g0", peer="b", bytes=1 << 20)
            b.register_flow("g0", peer="a", bytes=1 << 20)
            port = b.data_port()
            res = a.send("g0", "127.0.0.1", port, nbytes)
            assert res["bytes"] == nbytes
            assert res["gbps"] > 0

            # Receive side accounts asynchronously; poll for arrival.
            deadline = time.time() + 10
            while time.time() < deadline:
                stats = b.stats()
                if stats["total_rx"] >= nbytes:
                    break
                time.sleep(0.05)
            assert stats["total_rx"] == nbytes
            flow = next(f for f in stats["flows"] if f["flow"] == "g0")
            assert flow["rx_bytes"] == nbytes
            assert stats["rx_unmatched"] == 0
            # Sender accounted the transfer on its own flow too.
            a_flow = next(f for f in a.stats()["flows"] if f["flow"] == "g0")
            assert a_flow["transferred"] == nbytes

    def test_send_to_unregistered_peer_flow_counts_unmatched(
            self, daemon_pair):
        uds_a, uds_b = daemon_pair
        with DcnXferClient(uds_a) as a, DcnXferClient(uds_b) as b:
            a.register_flow("lonely", bytes=1 << 20)
            port = b.data_port()
            a.send("lonely", "127.0.0.1", port, 1 << 20)
            deadline = time.time() + 10
            while time.time() < deadline:
                stats = b.stats()
                if stats["rx_unmatched"] >= (1 << 20):
                    break
                time.sleep(0.05)
            assert stats["rx_unmatched"] == 1 << 20

    def test_send_unknown_flow_rejected(self, daemon_pair):
        with DcnXferClient(daemon_pair[0]) as a:
            with pytest.raises(DcnXferError, match="unknown flow"):
                a.send("nope", "127.0.0.1", 1, 1)

    def test_send_connect_refused_reported(self, daemon_pair):
        with DcnXferClient(daemon_pair[0]) as a:
            a.register_flow("g1", bytes=1 << 20)
            with pytest.raises(DcnXferError, match="connect"):
                a.send("g1", "127.0.0.1", 1, 1 << 20)

    def test_default_data_port_is_ephemeral(self, daemon):
        # The plain fixture passes no --data_port; the default (0) binds
        # an ephemeral port rather than disabling the data plane.
        with DcnXferClient(daemon) as c:
            assert 0 < c.data_port() < 65536

    def test_put_then_read_roundtrip(self, daemon):
        """Local staging via the data plane, read back via control op."""
        payload = bytes(range(256)) * 64  # 16 KiB, non-trivial content
        with DcnXferClient(daemon) as c:
            c.register_flow("stage", bytes=len(payload))
            c.put("stage", payload)
            deadline = time.time() + 10
            while time.time() < deadline:
                flow = next(f for f in c.stats()["flows"]
                            if f["flow"] == "stage")
                if flow["rx_bytes"] >= len(payload):
                    break
                time.sleep(0.02)
            assert c.read("stage", len(payload)) == payload
            # Offset reads window into the staging buffer.
            assert c.read("stage", 256, offset=256) == payload[256:512]

    def test_payload_survives_daemon_to_daemon_transfer(self, daemon_pair):
        """Content (not just byte counts) crosses the two-daemon path:
        put -> send -> peer read, the full rxdm-analog datapath."""
        uds_a, uds_b = daemon_pair
        payload = os.urandom(1 << 20)
        with DcnXferClient(uds_a) as a, DcnXferClient(uds_b) as b:
            a.register_flow("x", bytes=len(payload))
            b.register_flow("x", bytes=len(payload))
            a.put("x", payload)
            _wait_rx(a, "x", len(payload))
            a.send("x", "127.0.0.1", b.data_port(), len(payload))
            _wait_rx(b, "x", len(payload))
            assert b.read("x", len(payload)) == payload

    def test_read_before_any_frame_is_an_error(self, daemon):
        """ADVICE r03: reading an empty staging buffer must not return
        zeros with ok=true — there is no data, say so."""
        with DcnXferClient(daemon) as c:
            c.register_flow("empty", bytes=4096)
            with pytest.raises(DcnXferError, match="no completed frame"):
                c.read("empty", 16)

    def test_shorter_second_frame_clamps_stale_tail(self, daemon):
        """After a shorter second frame, the first frame's tail beyond
        frame_bytes is stale and must not be readable."""
        big = bytes(range(256)) * 16     # 4096
        small = b"\xaa" * 512
        with DcnXferClient(daemon) as c:
            c.register_flow("clamp", bytes=len(big))
            c.put("clamp", big)
            _wait_rx(c, "clamp", len(big))
            assert c.read("clamp", len(big)) == big
            c.put("clamp", small)
            _wait_rx(c, "clamp", len(big) + len(small))
            # Full-size read comes back clamped to the new frame.
            assert c.read("clamp", len(big)) == small
            flow = next(f for f in c.stats()["flows"]
                        if f["flow"] == "clamp")
            assert flow["frame_bytes"] == len(small)
            # Offsets past the staged frame error instead of returning
            # the stale first-frame tail.
            with pytest.raises(DcnXferError, match="beyond staged data"):
                c.read("clamp", 16, offset=len(small))

    def test_read_frame_exact_chunk_multiple(self, daemon):
        """A frame that is an exact multiple of the client's READ_CHUNK
        must read back fully — the chunk loop has to stop AT the frame
        boundary rather than issue one more call the daemon rejects."""
        payload = os.urandom(1 << 20)  # exactly 2 x READ_CHUNK
        with DcnXferClient(daemon) as c:
            c.register_flow("exact", bytes=len(payload))
            c.put("exact", payload)
            _wait_rx(c, "exact", len(payload))
            assert c.read("exact", len(payload)) == payload
            # Asking for MORE than staged also returns short, not error.
            assert c.read("exact", len(payload) + 4096) == payload

    def test_read_respects_ownership_and_bounds(self, daemon):
        c1 = DcnXferClient(daemon)
        c1.register_flow("own", bytes=4096)
        with DcnXferClient(daemon) as c2:
            with pytest.raises(DcnXferError, match="another client"):
                c2.read("own", 16)
        with pytest.raises(DcnXferError, match="offset"):
            c1.read("own", 16, offset=4096)
        c1.close()


def _wait_rx(client, flow, nbytes, timeout=10):
    deadline = time.time() + timeout
    while time.time() < deadline:
        f = next(x for x in client.stats()["flows"] if x["flow"] == flow)
        if f["rx_bytes"] >= nbytes:
            return
        time.sleep(0.02)
    raise AssertionError(f"flow {flow} never received {nbytes} bytes")
