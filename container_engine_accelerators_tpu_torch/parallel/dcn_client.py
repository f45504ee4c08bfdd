"""Client for the dcnxferd DCN transfer daemon (native/dcnxferd/).

The role the NCCL GPUDirect plugin plays against tcpgpudmarxd's UDS
control socket (SURVEY.md §2.2): workers doing cross-slice DCN transfers
register flows with the per-node daemon, which owns the pinned staging
buffers; accounting rides the same socket.  Newline-delimited JSON.

Two clients, two contracts:

- :class:`DcnXferClient` is fail-fast: the first transport failure
  poisons it (a buffered partial response must never satisfy a retry).
- :class:`ResilientDcnXferClient` layers reconnect-with-backoff and
  flow-table replay on top, for callers that must survive the daemon
  restarting underneath them (the self-healing node-agent contract;
  see tests/test_torch_dcn_chaos.py).

The port's own copy of the JAX package's ``parallel/dcn_client.py`` (host
code: no torch): the control ops, the env contract and the ``dcn.*``
series are the same, so it drives either package's daemon and the
native one.
"""

import base64
import json
import logging
import socket
import struct
import time
from typing import Dict, Optional

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import flight, timeseries, trace
from container_engine_accelerators_tpu_torch.utils import faults, netio
from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

log = logging.getLogger(__name__)

DEFAULT_UDS_DIR = "/run/tpu-dcn"
SOCKET_NAME = "xferd.sock"


class DcnXferError(Exception):
    pass


class DcnWaitUnsupported(DcnXferError):
    """The daemon has no blocking ``wait`` op (the native daemon, the
    test stub) — callers fall back to adaptive polling."""


class DcnXferClient:
    def __init__(self, uds_dir: str = DEFAULT_UDS_DIR, timeout_s: float = 10.0):
        self._uds_dir = uds_dir.rstrip("/")
        self._timeout_s = timeout_s
        self._sock: Optional[socket.socket] = None
        self._rfile = None
        self._broken = False
        # Per-flow monotonic frame sequence for `send` (client-owned:
        # it must survive daemon restarts, which reset daemon state).
        self._send_seq: Dict[str, int] = {}
        # Daemon capability cache (version-op response), valid for ONE
        # connection — _connect() resets it so a daemon restart is
        # re-probed, never trusted stale; tri-state for the wait op so
        # the unsupported path is probed exactly once per connection.
        self._caps: Optional[dict] = None
        self._wait_supported: Optional[bool] = None
        self._connect()

    def _connect(self) -> None:
        """(Re)establish the control connection.  Fault site
        ``dcn.connect`` fires here, before the real connect."""
        with trace.span("dcn.connect", histogram="dcn.connect",
                        uds=self._uds_dir):
            faults.check("dcn.connect")
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            sock.settimeout(self._timeout_s)
            try:
                sock.connect(f"{self._uds_dir}/{SOCKET_NAME}")
            except OSError:
                sock.close()
                raise
        self._sock = sock
        self._rfile = sock.makefile("r")
        self._broken = False
        # Capabilities are a property of the CONNECTION, not the
        # client: the daemon on the other end of a reconnect may be a
        # different binary (a restart downgraded/upgraded it), so every
        # cached handshake answer is re-probed on the next use instead
        # of trusted stale — the shm/pipeline lane selection depends
        # on this.
        self._caps = None
        self._wait_supported = None

    def close(self) -> None:
        """Closing releases every flow this client registered (the daemon
        ties buffer lifetime to the connection, like rxdm)."""
        if self._rfile is not None:
            self._rfile.close()
        if self._sock is not None:
            self._sock.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _call(self, **req) -> dict:
        with trace.span("dcn.send", histogram="dcn.send",
                        op=req.get("op")):
            if self._broken:
                raise DcnXferError(
                    "connection broken by earlier timeout; reconnect"
                )
            try:
                faults.check("dcn.send")
                # Stamp the active trace on the request: daemons that
                # understand it (fleet/xferd.py) join their spans to
                # this trace, so one cross-node transfer reads as ONE
                # story across processes.  The native daemon ignores
                # unknown fields.
                ctx = trace.context()
                if ctx is not None:
                    req.setdefault("trace", ctx["trace"])
                    req.setdefault("span", ctx["span"])
                netio.sendall(self._sock,
                              (json.dumps(req) + "\n").encode())
                line = self._rfile.readline()
            except (socket.timeout, OSError) as e:
                # After a timeout the buffered reader may hold a partial
                # line; any retry would consume a stale response.  Poison
                # the client.
                self._broken = True
                raise DcnXferError(f"daemon connection failed: {e}")
            if not line:
                self._broken = True
                raise DcnXferError("daemon closed the connection")
            resp = json.loads(line)
            if not resp.get("ok"):
                raise DcnXferError(resp.get("error", "unknown daemon error"))
            return resp

    # ---- operations --------------------------------------------------------

    def version(self) -> str:
        return self._call(op="version")["version"]

    def capabilities(self) -> dict:
        """The version-op response, cached PER CONNECTION: daemons
        advertise protocol extensions here (``frame_version``,
        ``pipeline``, and the shm lane's ``shm``/``shm_dir``/
        ``host_id`` triple); absent keys mean the native DXF1-only
        daemon.  The cache dies with the connection — after a
        reconnect the next call re-probes, so a daemon that restarted
        into a different capability set is never trusted stale."""
        if self._caps is None:
            self._caps = self._call(op="version")
        return self._caps

    def frame_version(self) -> int:
        return int(self.capabilities().get("frame_version", 1))

    def supports_pipeline(self) -> bool:
        return bool(self.capabilities().get("pipeline", 0))

    def supports_shm(self) -> bool:
        """The daemon OFFERS the shm lane.  Whether this client can
        take it also needs the same-host identity check — that lives
        in ``parallel.dcn_pipeline.shm_same_host`` next to the lane
        selection."""
        return bool(self.capabilities().get("shm", 0))

    def supports_forward(self) -> bool:
        """The daemon serves the ``forward`` op (daemon-routed
        schedule legs).  False for the native daemon and forward-less
        daemons — the routed collective runner's signal to downgrade
        that node's legs to coordinator-routed sends mid-schedule."""
        return bool(self.capabilities().get("forward", 0))

    def supports_ring(self) -> bool:
        """The daemon OFFERS the universal submission ring (descriptor
        posting + doorbell on ANY lane).  Whether this client can take
        it also needs the same-host identity check — that lives in
        ``parallel.dcn_pipeline.ring_same_host`` next to the lane
        selection."""
        return bool(self.capabilities().get("ring", 0))

    # -- shm lane ops (zero-copy same-host staging; fleet/xferd.py) ----------

    def shm_attach(self, flow: str, nbytes: int,
                   ring: bool = False) -> dict:
        """Ask the daemon for the flow's mmap segment; returns
        ``{path, bytes, frame_bytes}``.  Idempotent, grows in place.
        ``ring=True`` additionally asks for the flow's descriptor-ring
        file (``ring_path``/``ring_slots`` in the response); a daemon
        that predates the handoff just omits them — the caller's
        signal to run per-chunk sends instead."""
        req = {"op": "shm_attach", "flow": flow, "bytes": int(nbytes)}
        if ring:
            req["ring"] = 1
        return self._call(**req)

    def shm_post(self, flow: str, count: int, rnd: int, xid: str,
                 total: int, host: str, port: int,
                 direct: Optional[int] = None,
                 stage_wait_ms: Optional[int] = None) -> dict:
        """The descriptor-ring doorbell: tell the daemon that ``count``
        chunk descriptors for round ``rnd`` are posted in the flow's
        ring, to be completed toward the peer at (host, port).  ONE
        control round trip replaces ``count`` per-chunk send ops; the
        daemon publishes per-slot verdicts and a completion cursor
        into the ring itself, which the caller polls out of its own
        mapping — no further control traffic."""
        req = {"op": "shm_post", "flow": flow, "count": int(count),
               "round": int(rnd), "xid": xid, "total": int(total),
               "host": host, "port": str(port)}
        if direct is not None:
            req["direct"] = int(direct)
        if stage_wait_ms is not None:
            req["stage_wait_ms"] = int(stage_wait_ms)
        return self._call(**req)

    def ring_attach(self, flow: str) -> dict:
        """Map the flow's descriptor ring WITHOUT a data segment —
        the universal ring's socket-lane entry point.  Returns
        ``{ring_path, ring_slots}``; a daemon that predates the op
        (or has the ring disabled) errors, the caller's signal to
        run the classic per-chunk path."""
        return self._call(op="ring_attach", flow=flow)

    def shm_commit(self, flow: str, nbytes: int, xid: str = "",
                   offset: Optional[int] = None,
                   total: Optional[int] = None) -> dict:
        """Declare ``[0, nbytes)`` of the attached segment a completed
        staged frame (in-place landing; dedup-exempt like any other
        staging, idempotent by construction).  With ``offset`` +
        ``total``, declare just ``[offset, offset+nbytes)`` of a
        ``total``-byte frame staged — the producer-fed overlap path's
        per-chunk commit."""
        req = {"op": "shm_commit", "flow": flow, "bytes": int(nbytes),
               "xid": xid}
        if offset is not None:
            req["offset"] = int(offset)
            req["total"] = int(total or 0)
        return self._call(**req)

    def shm_read(self, flow: str, nbytes: int) -> dict:
        """Make the flow's completed frame visible in its segment and
        return ``{path, bytes, frame_bytes}`` for the caller to map —
        the read-back that never puts payload bytes on a socket."""
        return self._call(op="shm_read", flow=flow, bytes=int(nbytes))

    def ping(self) -> None:
        self._call(op="ping")

    def register_flow(self, flow: str, peer: str = "",
                      bytes: Optional[int] = None) -> dict:
        req = {"op": "register_flow", "flow": flow, "peer": peer}
        if bytes is not None:
            req["bytes"] = bytes
        return self._call(**req)

    def record_transfer(self, flow: str, nbytes: int) -> int:
        return self._call(op="record_transfer", flow=flow,
                          bytes=nbytes)["flow_bytes"]

    def release_flow(self, flow: str) -> None:
        self._call(op="release_flow", flow=flow)
        # A re-registered flow is a fresh incarnation on both ends:
        # its frame numbering restarts with it.
        self._send_seq.pop(flow, None)

    def data_port(self) -> int:
        """TCP port of the daemon's data-plane listener."""
        return int(self._call(op="data_port")["port"])

    def send(self, flow: str, host: str, port: int,
             nbytes: Optional[int] = None,
             direct: Optional[int] = None) -> dict:
        """Stream the flow's staging buffer to a peer daemon's data port.

        Returns {bytes, micros, gbps}.  This is the DCN data path the
        reference drives through its NCCL plugin; here the daemon itself
        moves the bytes and reports achieved throughput.

        Each call stamps the frame with a per-flow monotonic ``seq`` —
        assigned ONCE per send() invocation, so a transport-level replay
        of the same op (the resilient client retrying after a connection
        loss) re-sends the SAME seq and a dedup-aware receiver
        (fleet/xferd.py) lands the frame exactly once.  A caller-level
        retry of a whole leg is a new send() and a new frame.

        ``direct=0`` pins the daemon's peer leg to TCP (the bench's
        serial series must measure the TCP path, not the daemon↔daemon
        segment lane); None leaves the daemon's own probe in charge.
        """
        seq = self._send_seq.get(flow, 0) + 1
        self._send_seq[flow] = seq
        req = {"op": "send", "flow": flow, "host": host, "port": str(port),
               "seq": seq}
        if nbytes is not None:
            req["bytes"] = nbytes
        if direct is not None:
            req["direct"] = int(direct)
        resp = self._call(**req)
        timeseries.record("dcn.tx.bytes", resp.get("bytes", 0))
        return resp

    def forward(self, flow: str, host: str, port: int, nbytes: int,
                offset: int = 0, seq: int = 0, total: int = 0,
                reduce: bool = False,
                attempts: Optional[int] = None,
                stage_wait_ms: Optional[int] = None) -> dict:
        """Post one routed schedule leg: the daemon re-sends its
        staged ``[offset, offset+nbytes)`` of ``flow`` straight to
        the peer daemon at (host, port) — a daemon→daemon hop.  This
        round trip is CONTROL-ONLY: zero payload bytes cross this
        socket (no ``dcn.tx/rx.bytes`` movement; the daemon accounts
        the hop under ``dcn.lane.forward.*``), which is the lane-level
        proof the routed collective runner leans on.

        ``seq`` is CALLER-ASSIGNED (required > 0, unlike ``send``):
        the destination flow's dedup window is shared by every source
        daemon forwarding into it, so only the schedule's author can
        hand out non-colliding numbers — and a caller-level re-post
        of a failed leg reuses the seq it burned, landing exactly
        once.  Returns the daemon's response (bytes/micros/lane/
        verdict/attempts); raises :class:`DcnXferError` when the hop
        stayed undelivered after the daemon's bounded per-hop retry.
        """
        req = {"op": "forward", "flow": flow, "host": host,
               "port": str(port), "bytes": int(nbytes),
               "offset": int(offset), "seq": int(seq)}
        if total:
            req["total"] = int(total)
        if reduce:
            req["reduce"] = 1
        if attempts is not None:
            req["attempts"] = int(attempts)
        if stage_wait_ms is not None:
            req["stage_wait_ms"] = int(stage_wait_ms)
        return self._call(**req)

    def put_range(self, flow: str, data: bytes, offset: int, seq: int,
                  host: str, port: int, reduce: bool = False,
                  total: int = 0) -> None:
        """Coordinator-routed fallback for one forward leg: frame
        ``data`` exactly as a peer daemon's forward would — same
        forward meta, same caller-assigned seq, so landing, reduce
        combining and dedup on the destination are indistinguishable
        from the daemon→daemon hop (a leg downgraded mid-schedule
        composes with forwarded replays of itself) — and write it to
        the DESTINATION daemon's data port.  Payload bytes DO cross
        this client, which is the point of the downgrade accounting:
        ``dcn.stage.bytes`` moves, the forward lane does not."""
        name = flow.encode()
        meta = {"fwd": 1, "off": int(offset), "tot": int(total),
                "red": 1 if reduce else 0}
        ctx = trace.context()
        if ctx is not None:
            meta.update(ctx)
        meta_b = json.dumps(meta).encode()
        hdr = (b"DXF2" + struct.pack("<I", len(name))
               + struct.pack("<Q", len(data))
               + struct.pack("<Q", int(seq))
               + struct.pack("<I", len(meta_b)))
        with socket.create_connection((host, port), timeout=30) as s:
            netio.sendall_parts(s, (hdr, name, meta_b, data))
        timeseries.record("dcn.stage.bytes", len(data))

    READ_CHUNK = 512 << 10  # daemon caps per-call reads (outbuf bound)

    def read(self, flow: str, nbytes: int, offset: int = 0) -> bytes:
        """Read back staged bytes (what a peer daemon landed into the
        flow, or what ``put`` staged locally).  Base64 over the control
        socket; reads larger than the daemon's 512 KiB per-call cap are
        chunked by offset.  The daemon bounds reads by the last
        completed frame's length (``frame_bytes`` in each response), so
        a read past the staged payload returns short rather than stale
        buffer tail."""
        with trace.span("dcn.read", histogram="dcn.read", flow=flow,
                        bytes=nbytes) as s:
            out = bytearray()
            while len(out) < nbytes:
                chunk = min(nbytes - len(out), self.READ_CHUNK)
                resp = self._call(op="read", flow=flow, bytes=chunk,
                                  offset=offset + len(out))
                data = base64.b64decode(resp["data"])
                if not data:
                    break
                out.extend(data)
                if len(data) < chunk:
                    break  # clamped at the staged frame's end
                frame = int(resp.get("frame_bytes", 0))
                if frame and offset + len(out) >= frame:
                    # Exactly at the frame boundary: the next chunk's
                    # offset would be rejected by the daemon, so stop here
                    # (a frame that is an exact multiple of READ_CHUNK
                    # otherwise turns a legitimate short read into an
                    # error).
                    break
            s.annotate(read=len(out))
            timeseries.record("dcn.rx.bytes", len(out))
            return bytes(out)

    def put(self, flow: str, data: bytes, host: str = "127.0.0.1",
            port: Optional[int] = None) -> None:
        """Stage ``data`` into a flow's buffer via the data plane.

        Frames the payload exactly as a peer daemon's ``send`` would
        ("DXF1" magic, u32 LE name length, u64 LE payload length), so
        local staging and remote landing exercise the same RX path.
        """
        if port is None:
            port = self.data_port()
        name = flow.encode()
        hdr = b"DXF1" + struct.pack("<I", len(name)) + struct.pack(
            "<Q", len(data)
        )
        with socket.create_connection((host, port), timeout=30) as s:
            # Separate buffers (no concat copy of the payload) through
            # the short-write-proof capped sender — multi-MiB frames
            # must survive platforms whose sendmsg truncates.
            netio.sendall_parts(s, (hdr, name, data))
        timeseries.record("dcn.stage.bytes", len(data))

    def stats(self, flow: Optional[str] = None) -> dict:
        """Daemon stats.  ``flow`` asks a filter-aware daemon
        (PyXferd) for just that flow's entry; daemons that predate the
        filter ignore the key and return everything — callers must
        still select their flow from the list."""
        req = {"op": "stats"}
        if flow is not None:
            req["flow"] = flow
        return self._call(**req)

    # Wait-op slice: short enough that a daemon thread is never parked
    # long on a dead client, long enough that slicing costs nothing.
    WAIT_SLICE_S = 1.0

    def wait_rx(self, flow: str, nbytes: int, timeout_s: float = 60.0,
                mode: str = "rx") -> dict:
        """Block INSIDE the daemon until ``flow`` has ``nbytes`` of rx
        accounting (mode ``rx``) or a completed frame of at least
        ``nbytes`` (mode ``frame``).

        This replaces the 20 ms client-side poll quantum with a
        condition-variable wakeup: small transfers stop paying up to a
        full quantum of idle tax per phase.  The wait is sliced so the
        daemon never holds a thread past :data:`WAIT_SLICE_S` per
        round trip.  Raises :class:`DcnWaitUnsupported` (once probed,
        instantly) for daemons without the op, and ``TimeoutError``
        past the deadline — the same contract as the polling fallback
        in ``parallel.dcn.wait_flow_rx``.
        """
        if self._wait_supported is False:
            raise DcnWaitUnsupported("daemon has no wait op")
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"flow {flow!r} never reached {nbytes} bytes "
                    f"({mode})"
                )
            try:
                resp = self._call(
                    op="wait", flow=flow, bytes=nbytes, mode=mode,
                    timeout_ms=int(min(remaining, self.WAIT_SLICE_S)
                                   * 1e3),
                )
            except DcnXferError as e:
                if "unknown op" in str(e):
                    self._wait_supported = False
                    raise DcnWaitUnsupported(str(e))
                if "unknown flow" in str(e):
                    # Same contract as the polling fallback: a flow
                    # that is not registered YET (mid-restart replay on
                    # the other side of a race) is "zero bytes so far",
                    # not an error — keep waiting until the deadline.
                    self._wait_supported = True
                    time.sleep(0.005)
                    continue
                raise
            self._wait_supported = True
            if resp.get("done"):
                return resp


# Reconnect budget tuned to ride out a daemon restart (the DaemonSet's
# CrashLoopBackOff floor is 10s) without masking a genuinely dead node:
# connect refusals fail instantly, so coverage is the SUM of the sleeps —
# 0.05+0.1+0.2+0.4+0.8+1.6+3+3+3+3+3 ≈ 18s (> the 10s floor), with the
# 30s deadline as the hard wall-clock cap.
DEFAULT_DCN_RETRY = RetryPolicy(
    max_attempts=12,
    initial_backoff_s=0.05,
    max_backoff_s=3.0,
    deadline_s=30.0,
)


class ResilientDcnXferClient(DcnXferClient):
    """A :class:`DcnXferClient` that survives daemon churn.

    The base client is deliberately fail-fast: one connection failure
    poisons it, because the buffered reader may hold a stale partial
    response and the daemon has already released its flows (buffer
    lifetime is tied to the connection, like rxdm).  That is the right
    *transport* semantic — but a node agent or bench that dies because
    the sidecar daemon restarted is a robustness hole.  This subclass
    closes the loop:

    - connection failures trigger reconnect with exponential backoff
      under a bounded :class:`RetryPolicy` budget;
    - a client-side **flow table** (flow → register args) is replayed
      after every reconnect — mandatory for correctness, not a
      convenience: the restarted/reconnected daemon has no memory of
      this client's flows, so any op on an unreplayed flow would fail
      with ``unknown flow``;
    - daemon-level errors (``ok:false`` responses) still fail fast:
      retrying a rejected request is wrong, only transport loss is
      retried;
    - once the budget is exhausted the client turns terminal: every
      further call raises a clear ``DcnXferError`` immediately
      (graceful degradation instead of hammering a dead socket).

    Retrying an op whose response was lost cannot double-account on the
    daemon: the connection's death released the server-side flow, so
    the replayed registration starts from zero and the retried op runs
    against fresh state.
    """

    def __init__(
        self,
        uds_dir: str = DEFAULT_UDS_DIR,
        timeout_s: float = 10.0,
        retry: Optional[RetryPolicy] = None,
    ):
        self._retry = retry or DEFAULT_DCN_RETRY
        self._flows: Dict[str, dict] = {}
        # Last payload this client staged per flow (via put): the daemon
        # loses its staging buffers on restart, so a post-restart read
        # transparently restages from here instead of surfacing an empty
        # frame to the caller.  Dropped on release_flow.
        self._staged: Dict[str, bytes] = {}
        self._exhausted = False
        # The initial connect rides the same budget: the client may come
        # up before its node sidecar does.
        self._retry.call(
            super().__init__, uds_dir, timeout_s, retry_on=(OSError,)
        )

    # -- reconnect machinery -------------------------------------------------

    def _reconnect_and_replay(self) -> None:
        with trace.span("dcn.replay", histogram="dcn.replay",
                        flows=len(self._flows)):
            try:
                self.close()
            except OSError:  # a half-dead socket may refuse even close()
                pass
            counters.inc("dcn.reconnect.attempts")
            self._connect()  # OSError propagates to the retry loop
            counters.inc("dcn.reconnect.success")
            for flow, kw in list(self._flows.items()):
                try:
                    DcnXferClient._call(
                        self, op="register_flow", flow=flow, **kw
                    )
                    counters.inc("dcn.replayed_flows")
                except DcnXferError as e:
                    if self._broken:
                        raise  # transport died again: retry loop handles it
                    if "exist" in str(e).lower():
                        # An alive-but-slow daemon may not have processed
                        # the old connection's EOF yet, so our own previous
                        # registration still holds the name.  Mark broken
                        # and surface as transport-level: the outer retry's
                        # backoff gives the daemon time to release it.
                        self._broken = True
                        raise DcnXferError(
                            f"flow replay raced old-connection cleanup: {e}"
                        )
                    # Other daemon-level rejection (e.g. another client
                    # took the name): keep replaying the rest; ops on this
                    # flow will surface the daemon's own error.
                    log.error("replay of flow %r failed: %s", flow, e)
        log.warning(
            "dcn control connection re-established; %d flow(s) replayed",
            len(self._flows),
        )

    def _with_budget(self, attempt, what: str, latch: bool,
                     op: Optional[str] = None):
        """Run ``attempt`` under the retry budget; daemon-level errors
        (ok:false with an intact transport) fail fast, transport loss
        retries.  ``latch=True`` turns the client terminal on
        exhaustion; the data plane passes False so a data-port-only
        outage cannot poison still-healthy control-plane ops.

        The whole budget runs inside ONE ``dcn.op`` span, so every
        attempt's send/connect/replay span hangs off the same trace —
        a recovered op reads as one story in the JSONL, not as
        disconnected fragments."""
        if self._exhausted:
            raise DcnXferError(
                "dcn retry budget exhausted; client is terminal "
                "(daemon stayed unreachable through "
                f"{self._retry.max_attempts} attempts)"
            )
        with trace.span("dcn.op", target=what, op=op) as span:
            return self._budget_loop(attempt, what, latch, span)

    def _budget_loop(self, attempt, what: str, latch: bool, span):
        last: Optional[BaseException] = None
        attempts = 0
        for _attempt in self._retry.attempts():
            attempts = _attempt + 1
            try:
                result = attempt()
                span.annotate(attempts=attempts)
                return result
            except DcnXferError as e:
                if not self._broken or self._exhausted:
                    # Daemon-level error, or a nested control-plane call
                    # already latched terminal: fail fast — looping a
                    # second budget over a terminal client only doubles
                    # the hang.
                    raise
                last = e  # transport loss: reconnect on the next attempt
            except OSError as e:  # reconnect/data-plane connect failed
                last = e
        span.annotate(attempts=attempts)
        if latch:
            self._exhausted = True
        counters.inc("dcn.retry.exhausted")
        if latch:
            # The client just went terminal: capture the evidence while
            # it still exists (the pod is usually deleted minutes later).
            flight.on_terminal(f"dcn {what} client latched terminal")
        raise DcnXferError(
            f"dcn {what} unreachable after "
            f"{self._retry.max_attempts} attempts: {last}"
        )

    def _call(self, **req) -> dict:
        def attempt():
            if self._broken or self._sock is None:
                self._reconnect_and_replay()
            return DcnXferClient._call(self, **req)

        return self._with_budget(attempt, "transfer daemon", latch=True,
                                 op=req.get("op"))

    # -- flow-table bookkeeping ----------------------------------------------

    def register_flow(self, flow: str, peer: str = "",
                      bytes: Optional[int] = None) -> dict:
        resp = super().register_flow(flow, peer, bytes)
        kw = {"peer": peer}
        if bytes is not None:
            kw["bytes"] = bytes
        self._flows[flow] = kw
        return resp

    def release_flow(self, flow: str) -> None:
        super().release_flow(flow)
        self._flows.pop(flow, None)
        self._staged.pop(flow, None)

    def put(self, flow: str, data: bytes, host: str = "127.0.0.1",
            port: Optional[int] = None) -> None:
        """Data-plane staging with the same budget.  After a failure the
        port is re-resolved via the (self-healing) control plane: a
        restarted daemon binds a fresh ephemeral data port, so a cached
        one dials a dead listener."""
        state = {"port": port}

        def attempt():
            try:
                return DcnXferClient.put(self, flow, data, host,
                                         state["port"])
            except OSError:
                state["port"] = None
                raise

        result = self._with_budget(attempt, "data plane", latch=False,
                                   op="put")
        self._staged[flow] = bytes(data)
        return result

    def put_range(self, flow: str, data: bytes, offset: int, seq: int,
                  host: str, port: int, reduce: bool = False,
                  total: int = 0) -> None:
        """Downgraded-leg staging under the data-plane budget.  No
        port re-resolution on failure (the destination is a REMOTE
        daemon — only the routed runner can re-resolve its port), and
        no restage cache: a replay of the same leg carries the same
        seq, so the destination's dedup window makes the retry safe
        whether or not the first frame landed."""
        def attempt():
            return DcnXferClient.put_range(self, flow, data, offset,
                                           seq, host, port, reduce,
                                           total)

        return self._with_budget(attempt, "data plane", latch=False,
                                 op="put_range")

    # How long a restage waits for its own payload to finish landing
    # through the local data plane before re-reading/re-sending.
    RESTAGE_RX_TIMEOUT_S = 30.0

    def send(self, flow: str, host: str, port: int,
             nbytes: Optional[int] = None,
             direct: Optional[int] = None) -> dict:
        """`send` that survives the daemon losing the staged payload.

        A send issued (or retried) after a connection loss lands on a
        daemon whose flow table was replayed but whose staging buffers
        are gone (a restarted daemon, or the old one releasing the flow
        with the dead connection).  The native daemon would silently
        stream the blank buffer — zero-filled bytes to the peer — so
        when this client staged the payload itself it FIRST checks the
        flow's ``frame_bytes`` and restages on blank; a daemon that
        instead answers "nothing staged" (fleet/xferd.py) is healed
        reactively the same way.  The re-send reuses the frame seq the
        failed attempt burned: if that attempt actually delivered
        before its response was lost, the receiver's dedup window drops
        the replay — exactly-once either way."""
        data = self._staged.get(flow)
        if data is not None:
            st = next((f for f in self.stats(flow=flow)["flows"]
                       if f["flow"] == flow), None)
            if st is not None and not st.get("frame_bytes", len(data)):
                self._restage(flow, data)
        try:
            return super().send(flow, host, port, nbytes, direct)
        except DcnXferError as e:
            if "nothing staged" not in str(e) or data is None:
                raise
            self._restage(flow, data)
            # Re-issue under the seq the failed attempt burned.
            self._send_seq[flow] -= 1
            return super().send(flow, host, port, nbytes, direct)

    def _restage(self, flow: str, data: bytes,
                 op: str = "send") -> None:
        counters.inc(f"dcn.{op}.restaged")
        with trace.span("dcn.restage", histogram="dcn.restage",
                        flow=flow, bytes=len(data), op=op):
            self.put(flow, data)
            self._wait_rx(flow, len(data), self.RESTAGE_RX_TIMEOUT_S)

    def forward(self, flow: str, host: str, port: int, nbytes: int,
                offset: int = 0, seq: int = 0, total: int = 0,
                reduce: bool = False,
                attempts: Optional[int] = None,
                stage_wait_ms: Optional[int] = None) -> dict:
        """``forward`` that survives the daemon-side flow dying with
        the control connection (a daemon releases a flow when the
        conn that registered it breaks, and this client's reconnect
        replays the registration EMPTY).  When this client staged the
        flow itself, a "not staged"/"unknown flow" answer restages
        from the local cache and re-issues the SAME caller-assigned
        seq — if the lost attempt actually delivered before its
        answer vanished, the destination's dedup window drops the
        replay: exactly-once either way.  Peer contributions landed
        into the flow mid-round have no local cache and cannot be
        healed here; the routed runner's verification phase is the
        backstop that fails such a round."""
        try:
            return super().forward(flow, host, port, nbytes,
                                   offset=offset, seq=seq,
                                   total=total, reduce=reduce,
                                   attempts=attempts,
                                   stage_wait_ms=stage_wait_ms)
        except DcnXferError as e:
            data = self._staged.get(flow)
            msg = str(e)
            if data is None or ("not staged" not in msg
                                and "unknown flow" not in msg):
                raise
            self._restage(flow, data, op="forward")
            return super().forward(flow, host, port, nbytes,
                                   offset=offset, seq=seq,
                                   total=total, reduce=reduce,
                                   attempts=attempts,
                                   stage_wait_ms=stage_wait_ms)

    def read(self, flow: str, nbytes: int, offset: int = 0) -> bytes:
        """`read` that survives a daemon restart eating the staged
        frame: an EMPTY read of a flow this client itself staged means
        the daemon came back with fresh (blank) buffers — replaying the
        flow table restored the registration but not the bytes.  The
        client restages the cached payload through the data plane, waits
        for it to land, and reads again, so callers never see the
        daemon's "nothing staged" for payloads they already handed us.
        (Reads of peer-landed flows have no local cache and still
        surface the blank — only the peer can re-send those bytes.)"""
        data = self._staged.get(flow)
        try:
            out = super().read(flow, nbytes, offset)
            if out or nbytes <= 0 or data is None:
                return out
        except DcnXferError as e:
            # The native daemon answers a blank flow with an explicit
            # "no completed frame" error; PyXferd and the stub with an
            # empty read.  Both mean the same thing: the staging went
            # with the old process.
            if data is None or "no completed frame" not in str(e):
                raise
        counters.inc("dcn.read.restaged")
        with trace.span("dcn.restage", histogram="dcn.restage",
                        flow=flow, bytes=len(data)):
            self.put(flow, data)
            self._wait_rx(flow, len(data), self.RESTAGE_RX_TIMEOUT_S)
        return super().read(flow, nbytes, offset)

    def _wait_rx(self, flow: str, nbytes: int, timeout_s: float) -> None:
        """parallel.dcn.wait_flow_rx under this client's error contract
        (lazy import mirrors dcn.py's own lazy import of this module)."""
        from container_engine_accelerators_tpu_torch.parallel import dcn

        try:
            dcn.wait_flow_rx(self, flow, nbytes, timeout_s=timeout_s)
        except TimeoutError as e:
            raise DcnXferError(f"restage failed: {e}")

