"""PyXferd — a protocol-faithful Python dcnxferd with a real data plane.

The port's own copy of ``container_engine_accelerators_tpu/fleet/xferd.py``
(host code: no torch).  The frames, the control ops, the env variables
and the ``dcn.*`` / ``xferd.*`` series are the same byte for byte, so
this daemon serves the JAX package's client and streams to the JAX
package's daemon and to the native one.  The ``net=`` hook stays; the
port's fleet link table is not ported yet.

tests/xferd_stub.py models only the control plane: enough to kill and
restart "a daemon" under a single resilient client, useless for a
fleet.  PyXferd is the fleet's per-node daemon double, faithful to the
native daemon's whole contract (native/dcnxferd/dcnxferd.cc):

- newline-JSON control ops over a UDS (register/record/release/stats/
  ping/version/data_port/send/read), flows owned by their registering
  connection (buffer lifetime == connection lifetime, like rxdm);
- a real TCP data plane: ``put`` frames land over it byte-identical to
  the native daemon's framing, and ``send`` streams a staged flow to a
  peer daemon — directly over TCP when standalone (cross-process
  rigs), or through the :class:`~…fleet.links.FleetNet` link table
  when part of a fleet (per-link faults + accounting);

plus the two protocol extensions this stack adds (ROADMAP "DCN
data-plane idempotence", "trace context across processes"):

- **frame sequencing + dedup**: ``send`` frames carry the client's
  per-flow monotonic ``seq`` in a v2 frame header; the receiver keeps a
  per-flow window of seqs that actually LANDED and drops replays, so a
  retried send after a connection loss cannot double-land a frame —
  while a retransmit of a frame that was genuinely lost (never landed)
  passes.  Dups count as ``dcn.frames.deduped``.
- **trace propagation**: control requests carry the client's active
  (trace, span); data frames carry the sender's — every daemon-side
  span joins the trace of the op that caused it, so one cross-node
  transfer is ONE trace across every process it touched.

Plus the pipelined data-plane extensions (the chunked/striped DCN hot
path):

- **chunk assembly**: a v2 frame whose meta carries ``off``/``tot``
  (and a transfer id ``xid``) lands at its offset into a per-flow
  assembly buffer instead of replacing the staging buffer wholesale;
  the flow's completed frame becomes visible (``frame_bytes``) only
  once every byte of ``tot`` has landed.  Each chunk carries its own
  seq, so the dedup window gives exactly-once PER CHUNK.
- **offset send**: the ``send`` control op takes ``offset``/``bytes``
  and streams just that chunk to the peer (waiting briefly for the
  chunk to finish landing locally — this is what lets a client stage
  chunk *k+1* while chunk *k* is in flight).
- **wait op**: a blocking control op (``op:wait``) parks the
  connection thread on a condition variable until a flow's
  ``rx_bytes`` (mode ``rx``) or ``frame_bytes`` (mode ``frame``)
  reaches a target — no more 20 ms poll quantum on the land path.
- **stats flow filter**: ``stats`` with a ``flow`` key returns only
  that flow's entry (O(1) per poll instead of O(flows)).
- **binary read-back**: a ``DXR1`` request on the data plane streams
  staged bytes back raw — the striped reader's escape from base64 on
  the control socket.

Plus the zero-copy same-host staging lane (client half in
``parallel/dcn_shm.py`` + ``parallel/dcn_pipeline.py``):

- the daemon advertises ``shm``/``shm_dir``/``host_id`` in the
  ``version`` handshake and hands out per-flow ``mmap``-backed
  segment files under ``shm_dir`` (``shm_attach``); a same-host
  client (exact ``host_id`` match) writes payload memoryviews
  straight into the segment and declares them staged with one
  ``shm_commit`` control op — the whole-frame landing happens **in
  place**, no payload bytes on any socket;
- a flow with a segment keeps ALL its staging storage there: remote
  chunks landing over the data plane assemble directly into the
  mmap, so the local reader's ``shm_read`` op (which migrates any
  heap-staged content into the segment first) is a buffer reference,
  not a copy stream;
- control semantics are untouched: commits are seq-less staging
  (dedup-exempt, like seq-0 frames), sends/waits/stats behave
  identically whether the bytes arrived by socket or by segment, and
  a daemon restart takes the segments with it — clients re-probe the
  handshake on reconnect and transparently drop back to the socket
  lane.

Plus the memcpy-speed same-host plane:

- **recv-into-mmap**: a chunk frame's payload is received DIRECTLY
  into the flow's assembly buffer at its offset — a segment view for
  shm-attached flows, the heap assembly otherwise — deleting the
  per-chunk heap bounce the old read-then-copy path paid.  Dedup is
  pre-checked before the receive and re-checked (and only then
  marked) at landing; a torn receive (connection died mid-chunk)
  leaves the chunk unrecorded, so partial-assembly invisibility holds
  byte-for-byte (``dcn.chunks.torn``); a landing whose assembly was
  reset mid-receive drops instead of corrupting the live transfer
  (``dcn.chunks.stale_drop``, guarded by a per-assembly generation).
- **daemon↔daemon shm (the ``shm_direct`` lane)**: when the peer
  daemon's data-plane handshake (``DXH1``) returns OUR boot identity,
  sends skip the TCP payload stream entirely — the sender asks the
  peer to attach the flow's segment (``DXA1``), memcpys staged bytes
  segment→segment through its own mapping of the peer's file, and
  lands them with a descriptor-only commit (``DXC1``) that carries
  seq/off/tot/xid but zero payload bytes.  Dedup, accounting, wait
  wakeups all ride the same ``land_frame``; an inode check makes a
  stale mapping (peer released/recreated the segment) a loud
  ``rejected`` instead of silent corruption; ANY lane trouble —
  handshake mismatch, mapping failure, mid-transfer peer restart —
  falls back to the TCP stream inside the same send
  (``dcn.shm_direct.fallback``).  Per-lane movement is accounted as
  ``dcn.lane.{shm_direct,shm,socket}.bytes`` (+ cumulative
  ``.total_bytes`` gauges); ``xferd.tx.bytes`` stays a SOCKET-lane
  series, which is the counter-level proof co-hosted transfers moved
  zero bytes over TCP.
- **descriptor-ring handoff**: ``shm_attach`` with ``ring`` hands the
  client a per-flow ring file (``parallel/dcn_shm.py`` owns the
  layout); the client posts (off, len, seq) descriptors and issues
  ONE ``shm_post`` doorbell per round instead of per-chunk control
  ops.  A dedicated completer thread drives each descriptor through
  the normal send path (stage-wait, link shim, lane selection,
  verdicts included) and publishes per-slot status + a completion
  cursor the client polls lock-free from shared memory.

Frame wire format (data plane):

    v1 (native-compatible): "DXF1" | u32 LE name_len | u64 LE
        payload_len | name | payload
    v2 (seq + meta):        "DXF2" | u32 LE name_len | u64 LE
        payload_len | u64 LE seq | u32 LE meta_len | name |
        meta (JSON: trace/span/src[/off/tot/xid]) | payload
    read request:           "DXR1" | u32 LE name_len | u64 LE offset |
        u64 LE nbytes | name  →  u64 LE avail | bytes
    peer shm ops:           "DXH1"/"DXA1"/"DXC1" | u32 LE json_len |
        json  →  u32 LE json_len | json  (handshake / segment attach /
        descriptor commit — control-sized JSON both ways, never
        payload bytes)

Receivers accept all of them; v1 frames (the native daemon, local
``put`` staging) have no seq and bypass dedup — exactly what a restage
wants.  A v2 frame with seq 0 (the striped writer staging chunks into
its OWN daemon) also bypasses dedup: local staging is idempotent by
construction, and a restage must be able to overwrite.
"""

import base64
import collections
import hashlib
import itertools
import json
import logging
import mmap
import os
import queue
import shutil
import socket
import struct
import threading
import time
from typing import Dict, Optional, Tuple

from container_engine_accelerators_tpu_torch.analysis import lockwatch
from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import histo, timeseries, trace
from container_engine_accelerators_tpu_torch.parallel import dcn_shm
from container_engine_accelerators_tpu_torch.utils import netio

# The forward op's reduce landing byte-adds payloads mod 256 — the
# same commutative combine collectives/synth.py simulates, duplicated
# here (like the wire constants) so the daemon stays importable
# without the collectives stack.  numpy when present: routed
# all_reduce legs land O(payload) combines on the daemon's data
# threads, and the byte loop would dominate the measured window.
try:
    import numpy as _np
except ImportError:  # pragma: no cover - baked into the image
    _np = None

log = logging.getLogger(__name__)

VERSION = "pyxferd/3"
SOCKET_NAME = "xferd.sock"
READ_CAP = 512 << 10  # per-call read cap, like the native daemon
# Landed-seq memory per flow.  Sized so one full chunked transfer's
# worth of seqs (a replay re-sends ALL of them under the same numbers)
# fits with 2x headroom: the striped writer caps itself at
# MAX_CHUNKS_PER_TRANSFER = 128 chunks (parallel/dcn_pipeline.py, with
# a cross-test pinning 2 * cap <= window).
DEDUP_WINDOW = 256
# How long an offset-send waits for its chunk to finish landing through
# the local data plane (the stage->send pipeline race is normally
# microseconds; the bound only matters when staging genuinely died).
CHUNK_STAGE_WAIT_S = 5.0
# Per-call cap on the blocking wait op: the client re-issues slices, so
# a daemon thread is never parked longer than this on one request.
MAX_WAIT_SLICE_S = 30.0
# Bounded per-hop retry for the forward op (daemon-routed schedule
# legs): attempts are per forward REQUEST — the coordinator's own
# engine-level retry re-posts the leg under the same seq, so the two
# layers compose without double-landing (the dedup window is the
# exactly-once guarantee either way).
FORWARD_ATTEMPTS = 3
FORWARD_RETRY_BACKOFF_S = 0.05

# Link-shim latency cap, mirroring fleet.links.MAX_INJECT_LATENCY_S
# (deliberately duplicated — the daemon must stay importable without
# the link table): a typo'd delay models relative slowness, not WAN.
LINK_SHIM_MAX_LATENCY_S = 0.25

_MAGIC_V1 = b"DXF1"
_MAGIC_V2 = b"DXF2"
_MAGIC_READ = b"DXR1"
# Daemon↔daemon shm lane: JSON request/response ops riding
# the data-plane stream — handshake, peer segment attach, descriptor
# commit.  Control-sized both ways; payload bytes move through the
# segment, never this socket.
_MAGIC_PEER_HELLO = b"DXH1"
_MAGIC_PEER_ATTACH = b"DXA1"
_MAGIC_PEER_COMMIT = b"DXC1"
_PEER_OPS = (_MAGIC_PEER_HELLO, _MAGIC_PEER_ATTACH, _MAGIC_PEER_COMMIT)

# Segment files are at least a page so a 1-byte flow still maps.
SHM_MIN_SEGMENT = 4096

# Process-global assembly-generation source (see _Flow.asm_gen):
# every assembly-identity change anywhere in the daemon gets a value
# no other assembly — past, present, or same-named successor flow —
# has ever carried.
_ASM_GEN = itertools.count(1)

# Descriptor-ring capacity per flow.  Matches the striped writer's
# MAX_CHUNKS_PER_TRANSFER (parallel/dcn_pipeline.py) — deliberately
# duplicated, like the wire constants: the daemon must stay importable
# without the pipeline module, and a cross-test pins the two.
RING_SLOTS = 128


class _Flow:
    __slots__ = ("owner", "peer", "buffer_bytes", "transferred",
                 "rx_bytes", "frame_bytes", "staged", "seen_seqs",
                 "max_seq", "asm_xid", "asm_total", "asm_buf",
                 "asm_chunks", "asm_seqs", "asm_gen", "retired_xids",
                 "seg_path", "seg_map", "seg_size", "seg_ino",
                 "ring_path", "ring_map")

    def __init__(self, owner: int, peer: str, buffer_bytes: int):
        self.owner = owner
        self.peer = peer
        self.buffer_bytes = buffer_bytes
        self.transferred = 0
        self.rx_bytes = 0
        self.frame_bytes = 0
        self.staged = b""
        self.seen_seqs = set()
        self.max_seq = 0
        # Chunk-assembly state (pipelined transfers): one in-progress
        # logical payload, keyed by the sender's transfer id.
        self.asm_xid = None
        self.asm_total = 0
        self.asm_buf = None  # bytearray(asm_total) while assembling
        self.asm_chunks: Dict[int, int] = {}  # landed off -> len
        self.asm_seqs = set()  # seqs whose bytes live in THIS assembly
        # Assembly generation: re-stamped whenever the assembly
        # buffer's identity changes (reset, fresh xid, heap→segment
        # migration).  The recv-into-mmap path captures it with the
        # target view and re-verifies at landing, so bytes received
        # into a buffer the flow no longer assembles into are DROPPED,
        # never recorded.  Values come from a PROCESS-GLOBAL monotonic
        # counter, never a per-flow one: a flow released and
        # re-registered under the same name mid-receive must not be
        # able to repeat a gen the stale receive captured.
        self.asm_gen = next(_ASM_GEN)
        # Transfers this flow has moved PAST: once a new xid starts
        # assembling (or a whole frame replaces staging), the previous
        # xid is retired and its straggler chunks — a ring completer's
        # late send, a delayed retransmit — are dropped as stale
        # instead of discarding the LIVE assembly and re-landing dead
        # bytes.  Abandoning an xid is always caller-intentional (a
        # caller-level retry is a NEW send_pipelined and a NEW xid),
        # so nothing legitimate ever returns under a retired one.
        self.retired_xids = collections.deque(maxlen=8)
        # Shared-memory segment (same-host zero-copy lane).  When set,
        # the flow's staging storage lives IN the mmap: ``staged`` and
        # ``asm_buf`` become memoryviews of ``seg_map``.
        self.seg_path: Optional[str] = None
        self.seg_map = None  # mmap.mmap while attached
        self.seg_size = 0
        # Inode of the segment file at creation: a peer daemon's DXC1
        # commit quotes the inode IT mapped, so a sender holding a
        # mapping of a released-and-recreated segment gets "rejected"
        # instead of marking garbage bytes landed.
        self.seg_ino = 0
        # Descriptor ring (the shm_post handoff): its own file next to
        # the segment, daemon-side mapping kept for status publishing.
        self.ring_path: Optional[str] = None
        self.ring_map = None

    def discard_assembly(self) -> None:
        """Drop the in-progress assembly AND un-see its seqs: a seq is
        only exactly-once while its bytes are retained — keeping seqs
        of discarded chunks would dedup-drop their retransmits and
        wedge the transfer."""
        self.seen_seqs -= self.asm_seqs
        self.asm_seqs = set()
        self.asm_xid = None
        self.asm_buf = None
        self.asm_chunks = {}
        self.asm_gen = next(_ASM_GEN)

    def seg_view(self, nbytes: int) -> memoryview:
        """A writable view of the segment's first ``nbytes``."""
        return memoryview(self.seg_map)[:nbytes]

    def close_segment(self, unlink: bool = True) -> None:
        """Detach the flow's shm segment (and its descriptor ring):
        drop view-backed staging (the bytes die with the flow/daemon,
        same as heap staging), close the mmaps, and unlink the files
        unless this is a crash (SIGKILL leaves files behind; the next
        start() wipes the directory)."""
        path, m = self.seg_path, self.seg_map
        rpath, rm = self.ring_path, self.ring_map
        self.seg_path, self.seg_map, self.seg_size = None, None, 0
        self.seg_ino = 0
        self.ring_path, self.ring_map = None, None
        if isinstance(self.staged, memoryview):
            self.staged = b""
            self.frame_bytes = 0
        if isinstance(self.asm_buf, memoryview):
            self.discard_assembly()
        for mm in (m, rm):
            if mm is None:
                continue
            try:
                mm.close()
            except (BufferError, ValueError):
                pass  # an exported slice keeps it alive until GC
        if m is not None:
            timeseries.gauge_add("dcn.shm.segments", -1)
        if unlink:
            for p in (path, rpath):
                if p:
                    try:
                        os.unlink(p)
                    except OSError:
                        pass

    def range_staged(self, offset: int, nbytes: int,
                     xid: Optional[str] = None) -> bool:
        """True when bytes [offset, offset+nbytes) are readable — from
        the completed frame, or covered by landed assembly chunks.

        With ``xid`` set (a chunked send), only bytes belonging to
        THAT transfer count: a stale completed frame from a previous
        transfer on a reused flow must make the send WAIT for the new
        staging, not silently re-send last transfer's bytes."""
        if (self.frame_bytes and offset + nbytes <= len(self.staged)
                and (xid is None or self.asm_xid == xid)):
            return True
        if self.asm_buf is None or (xid is not None
                                    and self.asm_xid != xid):
            return False
        pos = offset
        for off in sorted(self.asm_chunks):
            if pos >= offset + nbytes:
                break
            if off <= pos < off + self.asm_chunks[off]:
                pos = off + self.asm_chunks[off]
        return pos >= offset + nbytes

    def read_range(self, offset: int, nbytes: int,
                   xid: Optional[str] = None) -> bytes:
        if (self.frame_bytes and offset + nbytes <= len(self.staged)
                and (xid is None or self.asm_xid == xid)):
            # bytes() either way: a memoryview (shm-backed staging)
            # must not escape the lock — the segment can be remapped
            # or closed the moment the caller lets go.
            return bytes(self.staged[offset:offset + nbytes])
        return bytes(self.asm_buf[offset:offset + nbytes])


# Exact reads and capped, short-write-proof sends live in utils/netio
# (the rig's stack truncates very large single-syscall payloads).
_recv_exact = netio.recv_exact


def _combine_into(dst, offset: int, payload) -> None:
    """``dst[offset+i] = (dst[offset+i] + payload[i]) % 256`` in place
    — the forward op's reduce landing.  ``dst`` is the flow's staging
    bytearray or a writable segment view; semantics mirror
    ``collectives.synth.combine`` byte-for-byte (a cross-test pins
    the two)."""
    n = len(payload)
    if _np is not None and n >= 64:
        view = _np.frombuffer(dst, dtype=_np.uint8, count=n,
                              offset=offset)
        view += _np.frombuffer(payload, dtype=_np.uint8, count=n)
        return
    for i in range(n):
        dst[offset + i] = (dst[offset + i] + payload[i]) & 0xFF


def _set_nodelay(sock: socket.socket) -> None:
    """Chunked frames are header+payload pairs and DXR1 replies are
    header+data pairs: Nagle coalescing against delayed ACKs costs
    milliseconds per chunk, which is the whole pipelining budget."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass  # not a TCP socket (UDS in tests)


def encode_frame(flow: str, payload: bytes, seq: Optional[int] = None,
                 meta: Optional[dict] = None) -> bytes:
    """Build a wire frame: v1 when there is neither seq nor meta
    (native-compatible), v2 otherwise.  A v2 frame with meta but no seq
    carries seq 0 on the wire — "no dedup", the staging-chunk case."""
    if seq is None and meta is None:
        name = flow.encode()
        return (_MAGIC_V1 + struct.pack("<I", len(name))
                + struct.pack("<Q", len(payload)) + name + payload)
    return encode_frame_header(flow, len(payload), seq, meta) + payload


def encode_frame_header(flow: str, payload_len: int,
                        seq: Optional[int] = None,
                        meta: Optional[dict] = None) -> bytes:
    """The v2 frame minus its payload — senders pass the payload as a
    separate ``sendmsg`` buffer and skip one full-chunk copy."""
    name = flow.encode()
    meta_b = json.dumps(meta or {}).encode()
    return (_MAGIC_V2 + struct.pack("<I", len(name))
            + struct.pack("<Q", payload_len)
            + struct.pack("<Q", seq or 0)
            + struct.pack("<I", len(meta_b)) + name + meta_b)


def encode_read_request(flow: str, offset: int, nbytes: int) -> bytes:
    """Build a DXR1 data-plane read request (the striped reader's
    binary read-back; the daemon answers u64 LE length + raw bytes)."""
    name = flow.encode()
    return (_MAGIC_READ + struct.pack("<I", len(name))
            + struct.pack("<Q", offset) + struct.pack("<Q", nbytes)
            + name)


class _PeerConn:
    """One cached outbound data-plane stream.  Sends hold the lock for
    the whole frame so concurrent users can never interleave bytes."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None

    def send_frame(self, host: str, port: int, parts) -> None:
        # Serializing the whole frame under the lock IS the contract
        # (concurrent stripes interleaving bytes would corrupt the
        # stream) — a deliberate blocking-under-lock, annotated so
        # a lockwatch run books it under `allowed` instead of failing.
        with self.lock, lockwatch.blocking_ok(
                "xferd.peer: frames on one stream must not interleave"):
            if self.sock is None:
                s = socket.create_connection((host, port), timeout=30)
                _set_nodelay(s)
                self.sock = s
            try:
                netio.sendall_parts(self.sock, parts)
            except OSError:
                self.close_locked()
                raise

    def close_locked(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None

    def close(self) -> None:
        with self.lock:
            self.close_locked()


class _PeerSeg:
    """One sender-side mapping of a PEER daemon's segment file."""

    __slots__ = ("path", "size", "ino", "map")

    def __init__(self, path: str, size: int):
        self.path = path
        self.size = int(size)
        fd = os.open(path, os.O_RDWR)
        try:
            self.ino = os.fstat(fd).st_ino
            self.map = mmap.mmap(fd, self.size)
        except ValueError as e:
            raise OSError(f"peer segment {path!r} unmappable: {e}")
        finally:
            os.close(fd)

    def close(self) -> None:
        try:
            self.map.close()
        except (BufferError, ValueError):
            pass


class _PeerShmLane:
    """Cached daemon↔daemon shm state toward one peer data endpoint.

    One control TCP stream (handshake / attach / descriptor commits —
    tiny JSON, never payload) plus per-flow mappings of the peer's
    segment files.  ``usable`` is tri-state: None = not probed yet,
    False = probed and refused (host mismatch, shm off — cached so
    every send doesn't re-handshake a cross-host peer), True = live.
    A transport error resets to None: the next send re-dials and
    re-probes, which is how a peer restart (fresh port, wiped
    segments) is survived — the caller falls back to TCP for the
    frame that hit the error."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sock: Optional[socket.socket] = None
        self.usable: Optional[bool] = None
        self.segs: Dict[str, _PeerSeg] = {}

    def reset_locked(self, usable: Optional[bool]) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None
        for seg in self.segs.values():
            seg.close()
        self.segs.clear()
        self.usable = usable

    def close(self) -> None:
        with self.lock:
            self.reset_locked(None)

    def request(self, host: str, port: int, magic: bytes,
                req: dict, timeout_s: float = 30.0) -> dict:
        """One JSON round trip on the cached stream (dialing it on
        first use).  Caller holds ``self.lock``."""
        if self.sock is None:
            s = socket.create_connection((host, port),
                                         timeout=timeout_s)
            _set_nodelay(s)
            self.sock = s
        body = json.dumps(req).encode()
        netio.sendall_parts(self.sock,
                            (magic + struct.pack("<I", len(body)),
                             body))
        n = struct.unpack("<I", _recv_exact(self.sock, 4))[0]
        if n > 65536:
            raise OSError("peer shm response out of bounds")
        return json.loads(_recv_exact(self.sock, n))


class PyXferd:
    """One emulated node's transfer daemon."""

    def __init__(self, uds_dir: str, node: str = "", net=None,
                 data_host: str = "127.0.0.1",
                 shm: Optional[bool] = None,
                 host_id: Optional[str] = None,
                 shm_direct: Optional[bool] = None,
                 forward: Optional[bool] = None,
                 ring: Optional[bool] = None):
        self.uds_dir = uds_dir
        self.node = node
        self.net = net
        self.data_host = data_host
        self.sock_path = os.path.join(uds_dir, SOCKET_NAME)
        # Zero-copy same-host lane: per-flow mmap segments under
        # shm_dir, advertised with this daemon's host identity so a
        # client can tell "same address" from "same machine".
        # ``shm``/``host_id`` overrides are the cross-host and
        # capability-less test handles.
        self.shm_enabled = (dcn_shm.shm_enabled() if shm is None
                            else bool(shm))
        self.shm_dir = os.path.join(uds_dir, "shm")
        self.host_id = host_id or dcn_shm.host_identity()
        # Daemon↔daemon same-host lane: this daemon's willingness to
        # SEND through a co-hosted peer's segments (the receive half
        # rides shm_enabled).  Fleet-fabric daemons never take it —
        # with a link table, TCP-or-fabric is the single fault
        # surface the scenarios interpose on.
        self.shm_direct = (dcn_shm.shm_direct_enabled()
                           if shm_direct is None else bool(shm_direct))
        # Daemon-routed forwarding (the collective engine's routed
        # execution mode): willingness to serve ``forward`` ops —
        # re-sending a staged flow range straight to a peer daemon.
        # ``forward=False`` is the capability-less test handle: the
        # op vanishes from the version handshake AND the dispatch
        # table ("unknown op"), which is the client's mid-schedule
        # downgrade signal.
        self.forward_enabled = (True if forward is None
                                else bool(forward))
        # Universal submission ring: willingness to serve descriptor
        # rings on ANY lane (ring_attach + shm_post doorbells whose
        # descriptors the completer drives through the normal
        # lane-selection send path).  Independent of shm_enabled —
        # a socket-only daemon still mmaps the ring file (descriptors
        # and cursors, not payload) so the client's hot path stays
        # lock-free.  ``ring=False`` is the capability-less handle.
        self.ring_enabled = (dcn_shm.shm_ring_enabled() if ring is None
                             else bool(ring))
        # Grey-fault hook (soak "slow_ring"): per-descriptor delay the
        # completer sleeps before driving each posted descriptor — a
        # completer that is slow, not dead.
        self._ring_delay_s = 0.0
        # Grey-fault hook (soak "slow_shm"): per-frame delay the shm
        # commit path pays before landing — a throttled staging
        # memcpy, the shm lane's slow-not-dead sibling.
        self._shm_delay_s = 0.0
        self.data_port = 0
        self.generation = 0
        self._flows: Dict[str, _Flow] = {}
        self._total_transferred = 0
        self._unmatched = 0
        self._lock = threading.Lock()
        # Landing notifications: wait ops and offset-sends park here
        # until land_frame advances the flow they watch.
        self._landed = threading.Condition(self._lock)
        self._server: Optional[socket.socket] = None
        self._data_server: Optional[socket.socket] = None
        self._conns = set()
        # Persistent outbound data-plane connections, keyed by
        # (control conn, host, port): chunked sends reuse one TCP
        # stream per stripe instead of dialing per chunk, and distinct
        # stripes (distinct control connections) get distinct streams
        # — the FlexLink point of striping one logical transfer.
        self._peer_conns: Dict[tuple, "_PeerConn"] = {}
        # Daemon↔daemon shm lane state per peer data endpoint.  Lock
        # order: a lane's lock is ALWAYS taken before self._lock
        # (the copy step), never after — _peer_lane() releases
        # self._lock before the caller enters the lane.
        self._peer_lanes: Dict[Tuple[str, int], _PeerShmLane] = {}
        # Descriptor-ring doorbells (shm_post) queue here; a dedicated
        # completer thread (one per daemon incarnation, joined on
        # stop) drives each descriptor through the normal send path
        # and publishes status into the flow's ring.
        self._ring_q: Optional[queue.Queue] = None
        self._ring_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        # SIGKILL modeling: stop(crash=True) raises this BEFORE
        # severing connections, so the conn threads' release path
        # leaves segment files behind exactly like a real process
        # death would (the next start() wipes them).
        self._crashing = False
        # Test hook: {op: n} — process the next n requests of `op`, then
        # sever the connection BEFORE responding (a daemon that did the
        # work but whose answer was lost: the replay-dedup scenario).
        self._drop_response: Dict[str, int] = {}
        # Proc-mode link-fault shim (netem analog): per-destination
        # (host, port) fault state consulted by the SEND path when
        # there is no in-process fabric to interpose (net is None).
        # Armed over the worker RPC by the fleet controller, so
        # `sel<->sel` link faults work against real OS-process nodes
        # too.  Keyed by the peer's CURRENT data port: a respawned
        # peer binds a fresh port and starts with a clean link —
        # the same reset its flows and dedup windows get.
        self._link_faults: Dict[Tuple[str, int], dict] = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "PyXferd":
        os.makedirs(self.uds_dir, exist_ok=True)
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)  # the real daemon unlinks-then-binds
        # Crash-lingering segment files belong to the dead incarnation;
        # wipe them the same way the socket path is unlinked.
        shutil.rmtree(self.shm_dir, ignore_errors=True)
        if self.shm_enabled or self.ring_enabled:
            os.makedirs(self.shm_dir, exist_ok=True)
        self._stopping.clear()
        self._crashing = False
        # A fresh incarnation starts with clean links, like its flows.
        with self._lock:
            self._link_faults.clear()
        self._ring_q = queue.Queue()
        self._ring_thread = threading.Thread(
            target=self._ring_completer, args=(self._ring_q,),
            name=f"pyxferd-ring-{self.node}", daemon=True)
        self._ring_thread.start()
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.sock_path)
        srv.listen(16)
        self._server = srv
        dsrv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        dsrv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        dsrv.bind((self.data_host, 0))
        dsrv.listen(16)
        self._data_server = dsrv
        self.data_port = dsrv.getsockname()[1]
        self.generation += 1
        for target, name in ((self._accept_loop, "pyxferd-ctl"),
                             (self._data_accept_loop, "pyxferd-data")):
            threading.Thread(target=target, name=f"{name}-{self.node}",
                             daemon=True).start()
        return self

    def stop(self, *, crash: bool = False) -> None:
        """``crash=True`` models SIGKILL: connections die, the socket
        path AND segment files linger until the next start() unlinks
        them (the flag below keeps the conn threads' release path from
        cleaning up on the dead incarnation's behalf)."""
        self._stopping.set()
        self._crashing = crash
        q, t = self._ring_q, self._ring_thread
        self._ring_q, self._ring_thread = None, None
        if q is not None:
            q.put(None)  # completer sentinel
        for attr in ("_server", "_data_server"):
            srv = getattr(self, attr)
            if srv is not None:
                try:
                    try:
                        srv.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    srv.close()
                finally:
                    setattr(self, attr, None)
        with self._lock:
            conns = list(self._conns)
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        if not crash and os.path.exists(self.sock_path):
            os.unlink(self.sock_path)
        # Process death: all staging buffers, seqs windows, accounting
        # die with it — exactly what the restart chaos scenarios need.
        # Segments go too: on a clean stop the files are unlinked, on a
        # crash they linger (like the socket path) until the next
        # start() wipes the directory — either way a client holding a
        # stale mapping writes into an orphaned inode the next daemon
        # can never see, which is why the client remaps per transfer.
        with self._lock:
            for f in self._flows.values():
                f.close_segment(unlink=not crash)
            self._flows.clear()
            self._total_transferred = 0
            self._unmatched = 0
            self._publish_flow_gauges_locked()
            self._landed.notify_all()  # unpark any blocked wait op
            peer_conns = list(self._peer_conns.values())
            self._peer_conns.clear()
            peer_lanes = list(self._peer_lanes.values())
            self._peer_lanes.clear()
        for pc in peer_conns:
            pc.close()
        for lane in peer_lanes:
            lane.close()
        if t is not None:
            t.join(timeout=5.0)

    # -- control plane -------------------------------------------------------

    def _accept_loop(self) -> None:
        srv = self._server
        while not self._stopping.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            if self._stopping.is_set():
                conn.close()
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name=f"pyxferd-conn-{self.node}",
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        conn_id = id(conn)
        with self._lock:
            self._conns.add(conn)
        rfile = conn.makefile("r")
        try:
            for line in rfile:
                req = None
                try:
                    req = json.loads(line)
                    resp = self._handle(conn_id, req)
                except (ValueError, KeyError, TypeError) as e:
                    resp = {"ok": False, "error": f"bad request: {e}"}
                op = req.get("op") if isinstance(req, dict) else None
                if op and self._drop_response.get(op, 0) > 0:
                    # The work is DONE; the answer is lost.  Sever so
                    # the client's retry exercises the dedup window.
                    self._drop_response[op] -= 1
                    try:
                        conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    break
                try:
                    netio.sendall(conn,
                                  (json.dumps(resp) + "\n").encode())
                except OSError:
                    break
        finally:
            rfile.close()
            conn.close()
            with self._lock:
                self._conns.discard(conn)
            self._release_owned(conn_id)

    def drop_response_once(self, op: str, times: int = 1) -> None:
        """Arm the lost-response hook for the next ``times`` ``op``
        requests (chaos tests)."""
        self._drop_response[op] = self._drop_response.get(op, 0) + times

    # -- link-fault shim (proc-mode netem analog) ----------------------------

    def set_link_fault(self, host: str, port: int, action: str,
                       param: float = 0.0) -> int:
        """Arm one outbound link fault toward ``(host, port)`` —
        ``partition`` (sends fail like a null route), ``heal`` (clear
        everything), ``latency`` (per-frame one-way delay, seconds,
        capped), ``drop`` (eat the next ``param`` frames in flight:
        the sender believes they left, the peer never sees them).
        Consulted by the send path only when this daemon has no
        in-process fabric (``net is None``) — with a fabric the
        LinkTable is the single fault surface."""
        key = (host, int(port))
        with self._lock:
            st = self._link_faults.get(key)
            if st is None:
                st = self._link_faults[key] = {
                    "up": True, "latency_s": 0.0, "drop_next": 0}
            if action == "partition":
                st["up"] = False
            elif action == "heal":
                self._link_faults.pop(key, None)
            elif action == "latency":
                st["latency_s"] = min(max(float(param), 0.0),
                                      LINK_SHIM_MAX_LATENCY_S)
            elif action == "drop":
                st["drop_next"] += max(1, int(param or 1))
            else:
                raise ValueError(f"unknown link-fault action "
                                 f"{action!r}")
        log.warning("link shim: %s toward %s:%d armed on node %s",
                    action, host, port, self.node or "?")
        return 1

    def set_ring_delay(self, seconds: float) -> float:
        """Grey-fault handle (soak "slow_ring"): make the ring
        completer sleep this long before driving EACH posted
        descriptor — a completer that is slow, not dead.  Partial
        progress keeps publishing into the cursor, so clients see a
        crawling round rather than a wedged one.  0 disarms."""
        self._ring_delay_s = min(max(float(seconds), 0.0), 2.0)
        log.warning("ring completer delay %.3fs armed on node %s",
                    self._ring_delay_s, self.node or "?")
        return self._ring_delay_s

    def set_shm_delay(self, seconds: float) -> float:
        """Grey-fault handle (soak "slow_shm"): make every shm commit
        pay this delay before landing — a throttled per-frame staging
        memcpy on the zero-copy lane, slow, not dead.  Commits still
        land and account normally, so no health check fires; only the
        ``xferd.shm.commit`` latency histogram carries the evidence.
        0 disarms."""
        self._shm_delay_s = min(max(float(seconds), 0.0), 2.0)
        log.warning("shm commit delay %.3fs armed on node %s",
                    self._shm_delay_s, self.node or "?")
        return self._shm_delay_s

    def _shim_consult(self, host: str, port: int):
        """One frame's verdict from the shim: (action, delay_s) where
        action is None / "blocked" / "dropped".  The latency sleep
        happens in the CALLER, outside the lock."""
        with self._lock:
            st = self._link_faults.get((host, int(port)))
            if st is None:
                return None, 0.0
            if not st["up"]:
                return "blocked", 0.0
            if st["drop_next"] > 0:
                st["drop_next"] -= 1
                return "dropped", st["latency_s"]
            return None, st["latency_s"]

    def _publish_flow_gauges_locked(self) -> None:
        """Flow accounting as gauges (caller holds the lock): what the
        in-process aggregator reads via ``_stats()``, the process-mode
        HTTP aggregator scrapes as ``agent_gauge`` — same numbers,
        different transport."""
        timeseries.gauge("xferd.active_flows", float(len(self._flows)))
        timeseries.gauge("xferd.total_transferred",
                         float(self._total_transferred))

    def _release_owned(self, conn_id: int) -> None:
        with self._lock:
            released = [n for n, f in self._flows.items()
                        if f.owner == conn_id]
            for name in released:
                # On a crash-stop the conn threads race the stop():
                # SIGKILL runs zero cleanup lines, so neither may this
                # path unlink the dead incarnation's segment files.
                self._flows[name].close_segment(
                    unlink=not self._crashing)
                del self._flows[name]
            self._publish_flow_gauges_locked()
            self._landed.notify_all()  # waiters re-check released flows
            # Ring completer and forward-op streams are keyed by flow
            # (pseudo conn ids), not by the owning control connection
            # — release them with the flows they served.
            flow_ids = ({f"ring:{n}" for n in released}
                        | {f"fwd:{n}" for n in released})
            stale = [k for k in self._peer_conns
                     if k[0] == conn_id or k[0] in flow_ids]
            conns = [self._peer_conns.pop(k) for k in stale]
            lanes = list(self._peer_lanes.values()) if released else []
        for pc in conns:
            pc.close()
        # Drop this side's mappings of the released flows' PEER
        # segments too (outside self._lock — lane.lock comes first in
        # the documented order): a released flow's segment is about to
        # be unlinked on the peer, and a cached mapping of the orphan
        # inode would pin 4 MiB of dead pages per transfer.
        for lane in lanes:
            with lane.lock:
                for name in released:
                    seg = lane.segs.pop(name, None)
                    if seg is not None:
                        seg.close()

    def _handle(self, conn_id: int, req: dict) -> dict:
        op = req.get("op")
        # Join the client's trace: daemon-side work hangs off the
        # control round trip that asked for it, across the process
        # boundary.
        with trace.attach(req.get("trace"), req.get("span")):
            with trace.span("xferd.op", op=op, node=self.node):
                return self._dispatch(conn_id, op, req)

    def _dispatch(self, conn_id: int, op: str, req: dict) -> dict:
        if op == "version":
            resp = {"ok": True, "version": VERSION, "frame_version": 2,
                    "pipeline": 1}
            if self.forward_enabled:
                # Daemon-routed forwarding: coordinators only post
                # forwarding programs to daemons that advertise it and
                # downgrade legs on daemons that do not.
                resp["forward"] = 1
            if self.shm_enabled:
                # The zero-copy lane's capability triple: clients take
                # it only on an exact host_id match (boot identity —
                # same ADDRESS is not same MACHINE), and only if the
                # advertised segment paths actually map.
                resp.update(shm=1, shm_dir=self.shm_dir,
                            host_id=self.host_id)
            if self.ring_enabled:
                # Universal-ring capability: advertised independently
                # of shm (a socket-lane daemon still serves descriptor
                # rings).  host_id rides along because ring files are
                # mmapped — same-MACHINE is the gate, as for shm.
                resp.update(ring=1, host_id=self.host_id)
            return resp
        if op == "ping":
            return {"ok": True}
        if op == "data_port":
            return {"ok": True, "port": self.data_port}
        if op == "register_flow":
            flow = req["flow"]
            with self._lock:
                if flow in self._flows:
                    return {"ok": False,
                            "error": f"flow already exists: {flow}"}
                nbytes = int(req.get("bytes") or 4096)
                self._flows[flow] = _Flow(conn_id, req.get("peer", ""),
                                          nbytes)
                self._publish_flow_gauges_locked()
            return {"ok": True, "flow": flow, "buffer_bytes": nbytes}
        if op == "record_transfer":
            nbytes = req.get("bytes")
            if not isinstance(nbytes, int) or nbytes < 0:
                return {"ok": False, "error": "invalid 'bytes'"}
            with self._lock:
                f = self._flows.get(req["flow"])
                if f is None:
                    return {"ok": False, "error": "unknown flow"}
                if f.owner != conn_id:
                    return {"ok": False,
                            "error": "flow owned by another client"}
                f.transferred += nbytes
                self._total_transferred += nbytes
                self._publish_flow_gauges_locked()
                return {"ok": True, "flow_bytes": f.transferred}
        if op == "release_flow":
            with self._lock:
                f = self._flows.get(req["flow"])
                if f is None:
                    return {"ok": False, "error": "unknown flow"}
                if f.owner != conn_id:
                    return {"ok": False,
                            "error": "flow owned by another client"}
                f.close_segment()
                del self._flows[req["flow"]]
                self._publish_flow_gauges_locked()
                flow_ids = (f"ring:{req['flow']}",
                            f"fwd:{req['flow']}")
                stale = [k for k in self._peer_conns
                         if k[0] in flow_ids]
                conns = [self._peer_conns.pop(k) for k in stale]
                lanes = list(self._peer_lanes.values())
            for pc in conns:
                pc.close()
            for lane in lanes:  # drop mappings of the peer's segment
                with lane.lock:
                    seg = lane.segs.pop(req["flow"], None)
                    if seg is not None:
                        seg.close()
            return {"ok": True}
        if op == "read":
            return self._read(req)
        if op == "send":
            return self._send(conn_id, req)
        if op == "wait":
            return self._wait(req)
        if op == "stats":
            return self._stats(req.get("flow"))
        if op == "shm_attach":
            return self._shm_attach(req)
        if op == "shm_commit":
            return self._shm_commit(req)
        if op == "shm_read":
            return self._shm_read(req)
        if op == "shm_post":
            return self._shm_post(req)
        if op == "ring_attach":
            return self._ring_attach(req)
        if op == "forward" and self.forward_enabled:
            # Gated on the capability flag so a forward-less daemon
            # answers "unknown op" — byte-identical to a daemon that
            # predates the op, which is what the client's downgrade
            # path keys on.
            return self._forward(req)
        return {"ok": False, "error": f"unknown op: {op}"}

    def _wait(self, req: dict) -> dict:
        """Blocking wait: park this connection's thread until the flow
        reaches ``bytes`` of rx (mode ``rx``) or a completed frame of
        at least ``bytes`` (mode ``frame``), or the slice times out.
        The client loops slices against its own deadline, so a daemon
        thread is never held hostage by a dead client's deadline."""
        flow = req["flow"]
        nbytes = int(req.get("bytes") or 0)
        mode = req.get("mode", "rx")
        if mode not in ("rx", "frame"):
            return {"ok": False, "error": f"unknown wait mode: {mode}"}
        timeout_ms = req.get("timeout_ms")
        if timeout_ms is None:
            timeout_ms = 1000
        timeout_s = min(max(float(timeout_ms), 0.0) / 1e3,
                        MAX_WAIT_SLICE_S)

        def done() -> bool:
            f = self._flows.get(flow)
            if f is None:
                return True  # released/never registered: report, don't hang
            have = f.frame_bytes if mode == "frame" else f.rx_bytes
            return have >= nbytes

        with self._landed:
            reached = self._landed.wait_for(done, timeout=timeout_s)
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            return {"ok": True, "done": bool(reached),
                    "rx_bytes": f.rx_bytes, "frame_bytes": f.frame_bytes}

    def _read(self, req: dict) -> dict:
        nbytes = int(req.get("bytes") or 0)
        offset = int(req.get("offset") or 0)
        with self._lock:
            f = self._flows.get(req["flow"])
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            frame_bytes = f.frame_bytes
            if offset > len(f.staged):
                return {"ok": False,
                        "error": f"'offset' beyond staged data "
                                 f"(frame_bytes={frame_bytes})"}
            # Copy under the lock: shm-backed staging is a memoryview
            # whose mapping must not outlive this critical section.
            chunk = bytes(f.staged[offset:offset + min(nbytes, READ_CAP)])
        return {"ok": True, "data": base64.b64encode(chunk).decode(),
                "frame_bytes": frame_bytes}

    def _send(self, conn_id: int, req: dict) -> dict:
        flow = req["flow"]
        host = req.get("host", "127.0.0.1")
        port = int(req["port"])
        seq = req.get("seq")
        seq = int(seq) if seq is not None else None
        offset = req.get("offset")
        xid = None
        tot = 0
        payload = None  # materialized lazily: the direct lane never needs it
        if offset is None:
            with self._lock:
                f = self._flows.get(flow)
                if f is None:
                    return {"ok": False, "error": "unknown flow"}
                # bytes() under the lock: shm-backed staging is a view
                # of a mapping that may be remapped once we let go.
                nbytes = int(req.get("bytes") or len(f.staged))
                payload = bytes(f.staged[:nbytes])
            if not payload:
                return {"ok": False,
                        "error": f"nothing staged for flow {flow!r}"}
            nbytes = len(payload)
            meta_extra = {}
        else:
            # Chunked send: stream staged[offset:offset+bytes] as one
            # chunk frame.  The chunk may still be in flight on the
            # local data plane (the stage->send pipeline), so wait
            # briefly for it to land rather than racing it.
            offset = int(offset)
            nbytes = int(req.get("bytes") or 0)
            if offset < 0 or nbytes <= 0:
                return {"ok": False,
                        "error": "chunked send needs offset >= 0 and "
                                 "bytes > 0"}
            stage_wait_s = min(
                float(req.get("stage_wait_ms")
                      or CHUNK_STAGE_WAIT_S * 1e3) / 1e3,
                CHUNK_STAGE_WAIT_S,
            )
            xid = req.get("xid") or ""
            tot = int(req.get("total") or 0)
            with self._landed:
                staged = self._landed.wait_for(
                    lambda: (self._flows.get(flow) is None
                             or self._flows[flow].range_staged(
                                 offset, nbytes, xid)),
                    timeout=stage_wait_s,
                )
                f = self._flows.get(flow)
                if f is None:
                    return {"ok": False, "error": "unknown flow"}
                if not staged:
                    return {"ok": False,
                            "error": f"chunk not staged for flow "
                                     f"{flow!r} [{offset}:"
                                     f"{offset + nbytes}]"}
            meta_extra = {"off": offset, "tot": tot, "xid": xid}
        # The daemon↔daemon segment lane is in play when there is no
        # fleet fabric (the fabric IS the fault surface then), the env
        # kill switch is on, and the client did not pin the frame to
        # TCP (the bench's socket series, the parity scenarios).
        direct_ok = (self.net is None and self.shm_direct
                     and req.get("direct") not in (0, "0", False))
        # Proc-mode link shim: when there is no in-process fabric, the
        # armed per-destination faults interpose here — the one point
        # every outbound frame passes, like FleetNet.deliver.
        shim = None
        if self.net is None:
            shim, shim_delay_s = self._shim_consult(host, port)
            if shim == "blocked":
                counters.inc("fleet.link.blocked")
                return {"ok": False,
                        "error": f"send failed: link to {host}:{port} "
                                 f"partitioned (injected)"}
            if shim_delay_s > 0:
                time.sleep(shim_delay_s)
        t0 = time.monotonic()
        with trace.span("xferd.send", histogram="xferd.send", flow=flow,
                        node=self.node, dst=f"{host}:{port}", seq=seq,
                        bytes=nbytes) as span:
            meta = {"src": self.node}
            meta.update(meta_extra)
            ctx = trace.context()
            if ctx is not None:
                meta.update(ctx)
            verdict = None
            lane = "socket"
            try:
                if shim == "dropped":
                    # Loss injection: the sender believes the frame
                    # left; the peer never sees it.  The verdict lets
                    # the striped writer retransmit without a timeout,
                    # exactly like the fleet fabric's answer.
                    counters.inc("fleet.link.dropped")
                    verdict = "dropped"
                    span.annotate(verdict=verdict)
                elif self.net is not None:
                    # Fleet mode: EVERY frame goes through the link
                    # table — a port the fabric doesn't know (stale
                    # after a peer restart, node down) is a dead link,
                    # never a raw TCP dial around the fault surface.
                    payload = self._materialize(flow, offset, nbytes,
                                                xid, payload)
                    if payload is None:
                        return {"ok": False,
                                "error": f"chunk not staged for flow "
                                         f"{flow!r}"}
                    verdict = self.net.deliver(self.node, host, port,
                                               flow, payload, seq, meta)
                    span.annotate(verdict=verdict)
                else:
                    if direct_ok:
                        verdict = self._shm_direct_try(
                            flow, host, port, offset, nbytes, tot,
                            xid, seq, meta, payload)
                        if verdict is not None:
                            lane = "shm_direct"
                            span.annotate(verdict=verdict, lane=lane)
                    if verdict is None:
                        # TCP fallback (or the plain socket lane).
                        payload = self._materialize(
                            flow, offset, nbytes, xid, payload)
                        if payload is None:
                            return {"ok": False,
                                    "error": f"chunk not staged for "
                                             f"flow {flow!r}"}
                        if offset is None:
                            # Whole-payload send: a fresh dial per
                            # send, so a dead peer surfaces as an
                            # immediate error (the serial contract).
                            self._tcp_send(host, port, flow, payload,
                                           seq, meta)
                        else:
                            # Chunked send: a persistent stream per
                            # (control connection, peer) — dialing per
                            # chunk costs more than the chunk.  A frame
                            # lost in a stale stream's buffer when the
                            # peer dies is re-sent by the striped
                            # writer's retry round (same seq, dedup).
                            self._peer_conn(conn_id, host,
                                            port).send_frame(
                                host, port,
                                [encode_frame_header(
                                    flow, len(payload), seq, meta),
                                 payload],
                            )
            except OSError as e:
                return {"ok": False, "error": f"send failed: {e}"}
        micros = max(1.0, (time.monotonic() - t0) * 1e6)
        # Per-lane movement accounting.  ``xferd.tx.bytes`` is the
        # SOCKET lane's series on purpose: "co-hosted transfers move
        # zero bytes over the peer TCP stream" is provable exactly
        # because the direct lane never touches it.
        timeseries.record(f"dcn.lane.{lane}.bytes", nbytes)
        timeseries.gauge_add(f"dcn.lane.{lane}.total_bytes", nbytes)
        if lane == "socket":
            timeseries.record("xferd.tx.bytes", nbytes)
        with self._lock:
            f = self._flows.get(flow)
            if f is not None:
                f.transferred += nbytes
                self._total_transferred += nbytes
                self._publish_flow_gauges_locked()
        resp = {"ok": True, "bytes": nbytes,
                "micros": round(micros, 1),
                "gbps": round(nbytes * 8 / micros / 1e3, 3),
                "lane": lane}
        if verdict is not None:
            # The striped sender uses this to retransmit chunks the
            # link ate without waiting for a timeout.
            resp["verdict"] = verdict
        return resp

    def _forward(self, req: dict) -> dict:
        """One routed schedule leg: re-send staged bytes
        ``[offset, offset+bytes)`` of ``flow`` straight to the peer
        daemon at (host, port) as a forward frame — the coordinator
        posts the program and collects this verdict; the payload never
        crosses its clients.

        The frame's seq is COORDINATOR-ASSIGNED (required, > 0): the
        destination flow's dedup window is shared by every source
        daemon forwarding into it, so only the schedule's author can
        hand out non-colliding numbers.  A re-post of the same leg
        re-sends the same seq and lands exactly once — the "dup"
        verdict IS success (the bytes are already there), and the
        chaos tests scrape it as the dedup evidence.  Retries here are
        PER-HOP and bounded (link drops, a redialed peer stream);
        terminal verdicts surface to the coordinator, whose
        engine-level retry re-posts the leg or downgrades it."""
        flow = req["flow"]
        host = req.get("host", "127.0.0.1")
        port = int(req["port"])
        seq = int(req.get("seq") or 0)
        offset = int(req.get("offset") or 0)
        nbytes = int(req.get("bytes") or 0)
        total = int(req.get("total") or 0)
        red = 1 if req.get("reduce") else 0
        attempts = max(1, int(req.get("attempts")
                              or FORWARD_ATTEMPTS))
        if seq <= 0 or offset < 0 or nbytes <= 0:
            return {"ok": False,
                    "error": "forward needs seq > 0, offset >= 0 "
                             "and bytes > 0"}
        stage_wait_s = min(
            float(req.get("stage_wait_ms")
                  or CHUNK_STAGE_WAIT_S * 1e3) / 1e3,
            CHUNK_STAGE_WAIT_S)
        # The source range may still be landing (an earlier leg of
        # the same round targets this daemon): park on the landing CV
        # like an offset send, then copy under the lock.
        with self._landed:
            staged = self._landed.wait_for(
                lambda: (self._flows.get(flow) is None
                         or self._flows[flow].range_staged(offset,
                                                           nbytes)),
                timeout=stage_wait_s)
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            if not staged:
                return {"ok": False,
                        "error": f"range not staged for flow "
                                 f"{flow!r} [{offset}:"
                                 f"{offset + nbytes}]"}
            payload = f.read_range(offset, nbytes)
        meta = {"src": self.node, "fwd": 1, "off": offset,
                "tot": total, "red": red}
        ctx = trace.context()
        if ctx is not None:
            meta.update(ctx)
        t0 = time.monotonic()
        verdict = None
        used = 0
        last_err = None
        with trace.span("xferd.forward", histogram="xferd.forward",
                        flow=flow, node=self.node,
                        dst=f"{host}:{port}", seq=seq,
                        bytes=nbytes) as span:
            for attempt in range(attempts):
                used = attempt + 1
                if attempt:
                    counters.inc("xferd.forward.retries")
                    time.sleep(FORWARD_RETRY_BACKOFF_S * attempt)
                try:
                    if self.net is not None:
                        # Fleet mode: through the link table, the
                        # landing verdict coming straight back.  Only
                        # "dropped" is retryable — the retransmit
                        # carries the SAME seq, so a frame that
                        # actually landed cannot double-land.
                        verdict = self.net.deliver(
                            self.node, host, port, flow, payload,
                            seq, meta)
                        if verdict != "dropped":
                            break
                    else:
                        # Proc mode: the link shim interposes per
                        # attempt, then the frame rides a persistent
                        # peer stream keyed by the SOURCE flow
                        # (shared by every leg this daemon forwards
                        # for it; _PeerConn redials after a break).
                        shim, delay_s = self._shim_consult(host,
                                                           port)
                        if shim == "blocked":
                            counters.inc("fleet.link.blocked")
                            span.annotate(verdict="blocked")
                            return {"ok": False,
                                    "verdict": "blocked",
                                    "error": f"forward failed: link "
                                             f"to {host}:{port} "
                                             f"partitioned "
                                             f"(injected)"}
                        if delay_s > 0:
                            time.sleep(delay_s)
                        if shim == "dropped":
                            counters.inc("fleet.link.dropped")
                            verdict = "dropped"
                            continue  # retransmit under the same seq
                        self._peer_conn(f"fwd:{flow}", host,
                                        port).send_frame(
                            host, port,
                            [encode_frame_header(flow, len(payload),
                                                 seq, meta),
                             payload])
                        verdict = "sent"
                        break
                except OSError as e:
                    # Peer stream died (or the fabric reports the
                    # link down): _PeerConn already reset itself, so
                    # the next attempt redials.  LinkPartitioned is
                    # an OSError too — one more look costs nothing
                    # and heals a mid-schedule repartition race.
                    last_err = e
                    verdict = None
            span.annotate(verdict=verdict or "error", attempts=used)
        if verdict not in ("landed", "dup", "sent"):
            # Terminal for THIS hop: the coordinator re-posts the leg
            # (same seq — dedup keeps it exactly-once) or downgrades
            # it to a coordinator-routed leg.
            detail = verdict or last_err or "undeliverable"
            return {"ok": False, "verdict": verdict,
                    "attempts": used,
                    "error": f"forward not landed: {detail}"}
        micros = max(1.0, (time.monotonic() - t0) * 1e6)
        # Forwarded legs are their own lane: never ``xferd.tx.bytes``
        # (the socket-lane proof series) and never a coordinator
        # client's dcn.tx/rx — which is exactly how the routed runner
        # PROVES zero payload bytes crossed the coordinator.
        counters.inc("xferd.forward.frames")
        timeseries.record("dcn.lane.forward.bytes", nbytes)
        timeseries.gauge_add("dcn.lane.forward.total_bytes", nbytes)
        with self._lock:
            f = self._flows.get(flow)
            if f is not None:
                f.transferred += nbytes
                self._total_transferred += nbytes
                self._publish_flow_gauges_locked()
        resp = {"ok": True, "bytes": nbytes,
                "micros": round(micros, 1),
                "gbps": round(nbytes * 8 / micros / 1e3, 3),
                "lane": "forward", "verdict": verdict,
                "attempts": used}
        return resp

    def _materialize(self, flow: str, offset: Optional[int],
                     nbytes: int, xid: Optional[str],
                     payload: Optional[bytes]) -> Optional[bytes]:
        """The staged bytes for a send that is about to ride a socket
        — copied under the lock (shm staging is a view of a mapping
        that may be remapped once we let go).  None when the flow or
        its staged range vanished since the stage-wait."""
        if payload is not None:
            return payload
        with self._lock:
            f = self._flows.get(flow)
            if f is None or not f.range_staged(offset or 0, nbytes,
                                               xid):
                return None
            return f.read_range(offset or 0, nbytes, xid)

    def _tcp_send(self, host: str, port: int, flow: str, payload: bytes,
                  seq: Optional[int], meta: dict) -> None:
        with socket.create_connection((host, port), timeout=30) as s:
            _set_nodelay(s)
            netio.sendall_parts(
                s, (encode_frame_header(flow, len(payload), seq, meta),
                    payload))

    def _peer_conn(self, conn_id: int, host: str, port: int) -> _PeerConn:
        key = (conn_id, host, port)
        with self._lock:
            pc = self._peer_conns.get(key)
            if pc is None:
                pc = self._peer_conns[key] = _PeerConn()
            return pc

    def _peer_lane(self, host: str, port: int) -> _PeerShmLane:
        key = (host, int(port))
        with self._lock:
            lane = self._peer_lanes.get(key)
            if lane is None:
                lane = self._peer_lanes[key] = _PeerShmLane()
            return lane

    def _range_view_locked(self, f: _Flow, offset: int, nbytes: int,
                           xid: Optional[str]):
        """A zero-copy view of staged bytes [offset, offset+nbytes)
        for the direct lane's segment→segment copy; None when not
        staged.  Caller holds the lock and must not let the view
        escape it — the backing mapping can be remapped the moment
        the lock is released."""
        if not f.range_staged(offset, nbytes, xid):
            return None
        if (f.frame_bytes and offset + nbytes <= len(f.staged)
                and (xid is None or not xid or f.asm_xid == xid)):
            return memoryview(f.staged)[offset:offset + nbytes]
        if f.asm_buf is None:
            return None
        return memoryview(f.asm_buf)[offset:offset + nbytes]

    def _lane_attach_locked(self, lane: _PeerShmLane, host: str,
                            port: int, flow: str,
                            need: int) -> Optional[_PeerSeg]:
        """The daemon↔daemon lane's shared preamble — one for BOTH
        handoff shapes, so the single-frame and batched paths can
        never diverge: probe the peer's co-hosted-ness once per
        endpoint (``DXH1``, cached tri-state), then hand back a mapped
        ``_PeerSeg`` of at least ``need`` bytes for the flow,
        attaching/re-attaching (``DXA1``) as required.  Returns None
        on refusals (cross-host peer cached un-counted; flow-level
        refusals counted as fallbacks); raises ``OSError`` upward for
        transport trouble — the caller owns the lane reset.  Caller
        holds ``lane.lock``."""
        if lane.usable is False:
            return None  # probed: cross-host or shm-less peer
        if lane.usable is None:
            resp = lane.request(host, port, _MAGIC_PEER_HELLO,
                                {"host_id": self.host_id,
                                 "node": self.node})
            if not (resp.get("ok") and resp.get("shm")
                    and resp.get("host_id") == self.host_id):
                # Not an error: the peer is simply not co-hosted (or
                # opted out).  Cache the verdict so every send does
                # not re-ask; a transport break later resets to
                # unprobed.
                lane.reset_locked(False)
                return None
            lane.usable = True
        seg = lane.segs.get(flow)
        if seg is None or seg.size < need:
            if seg is not None:
                seg.close()
                lane.segs.pop(flow, None)
            resp = lane.request(host, port, _MAGIC_PEER_ATTACH,
                                {"flow": flow, "bytes": need})
            if not resp.get("ok"):
                # Flow-level refusal (peer has no such flow yet, shm
                # disabled for it): this frame rides TCP and earns
                # its "unmatched" there.
                counters.inc("dcn.shm_direct.fallback")
                return None
            seg = _PeerSeg(resp.get("path", ""),
                           int(resp.get("bytes") or 0))
            if seg.size < need:
                seg.close()
                counters.inc("dcn.shm_direct.fallback")
                return None
            lane.segs[flow] = seg
        return seg

    def _shm_direct_try(self, flow: str, host: str, port: int,
                        offset: Optional[int], nbytes: int, tot: int,
                        xid: Optional[str], seq: Optional[int],
                        meta: dict,
                        payload: Optional[bytes] = None
                        ) -> Optional[str]:
        """One frame over the daemon↔daemon segment lane: memcpy the
        staged bytes into the co-hosted peer's segment through our own
        mapping of its file, then land them with a descriptor-only
        ``DXC1`` commit — zero payload bytes on any socket.  Returns
        the peer's landing verdict, or None when the lane is not
        available / broke, which is the caller's signal to ride TCP
        for THIS frame (transparent fallback; next frame re-probes
        when the failure was transport-shaped)."""
        lane = self._peer_lane(host, port)
        # Serializing the peer control stream is the contract, same as
        # _PeerConn: request/response pairs must not interleave.
        with lane.lock, lockwatch.blocking_ok(
                "xferd.shm_direct: peer control ops on one stream "
                "must not interleave"):
            verdict = None
            try:
                seg = self._lane_attach_locked(lane, host, port, flow,
                                               tot if tot else nbytes)
                if seg is None:
                    return None
                dst_off = offset or 0
                if payload is not None:
                    seg.map[dst_off:dst_off + nbytes] = payload
                else:
                    with self._lock:
                        f = self._flows.get(flow)
                        src = (None if f is None else
                               self._range_view_locked(f, dst_off,
                                                       nbytes, xid))
                        if src is None:
                            return None  # vanished since stage-wait
                        # Segment→segment memcpy, under the lock so
                        # the source view cannot be remapped mid-copy.
                        seg.map[dst_off:dst_off + nbytes] = src
                resp = lane.request(host, port, _MAGIC_PEER_COMMIT,
                                    {"flow": flow, "len": nbytes,
                                     "seq": seq, "ino": seg.ino,
                                     "meta": meta})
                if not resp.get("ok"):
                    counters.inc("dcn.shm_direct.fallback")
                    return None
                verdict = resp.get("verdict", "landed")
                if verdict == "rejected":
                    # Stale mapping (the peer released/recreated the
                    # segment — the inode check refused the landing)
                    # or refused geometry: drop the cached segment so
                    # the next attempt re-attaches, ride TCP now.
                    seg.close()
                    lane.segs.pop(flow, None)
                    counters.inc("dcn.shm_direct.fallback")
                    return None
            except (OSError, ConnectionError, ValueError) as e:
                # Transport or mapping trouble — the peer died, its
                # respawn wiped the segments, the stream broke.  Reset
                # to unprobed (the next send re-dials and re-probes;
                # a respawned peer binds a fresh port anyway) and let
                # THIS frame ride TCP.
                lane.reset_locked(None)
                counters.inc("dcn.shm_direct.fallback")
                log.warning("shm_direct lane to %s:%d failed (%s); "
                            "falling back to TCP", host, port, e)
                return None
        counters.inc("dcn.shm_direct.frames")
        return verdict

    def _stats(self, flow: Optional[str] = None) -> dict:
        """Daemon stats.  With ``flow`` set, the flows list holds just
        that flow's entry (one dict lookup) — the rx-wait poll path
        stops paying O(flows) per poll."""
        with self._lock:
            if flow is not None:
                f = self._flows.get(flow)
                items = [(flow, f)] if f is not None else []
            else:
                items = list(self._flows.items())
            return {
                "ok": True,
                "active_flows": len(self._flows),
                "total_transferred": self._total_transferred,
                "unmatched_frames": self._unmatched,
                "generation": self.generation,
                "node": self.node,
                "flows": [
                    {"flow": name, "peer": f.peer,
                     "transferred": f.transferred,
                     "rx_bytes": f.rx_bytes,
                     "frame_bytes": f.frame_bytes,
                     "max_seq": f.max_seq,
                     "shm": f.seg_map is not None}
                    for name, f in items
                ],
            }

    # -- shm lane (zero-copy same-host staging) ------------------------------

    def _ensure_segment_locked(self, flow: str, f: _Flow,
                               nbytes: int) -> None:
        """Create (or grow) ``flow``'s mmap segment to >= ``nbytes``
        and move every live staging buffer into the current mapping —
        heap content is copied once, old-mapping views are repointed
        (same inode, same bytes).  After this, "the flow has a
        segment" always implies "the flow's bytes are readable through
        it".  Caller holds the lock; raises ``OSError`` on filesystem
        trouble (the client's fallback signal)."""
        need = max(int(nbytes), SHM_MIN_SEGMENT)
        old_map = None
        remapped = False
        if f.seg_map is None or f.seg_size < need:
            os.makedirs(self.shm_dir, exist_ok=True)
            path = f.seg_path or os.path.join(
                self.shm_dir,
                hashlib.sha1(flow.encode()).hexdigest()[:16] + ".seg")
            size = max(need, f.seg_size)
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
            try:
                os.ftruncate(fd, size)
                ino = os.fstat(fd).st_ino
                new_map = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            f.seg_ino = ino
            if f.seg_map is None:
                timeseries.gauge_add("dcn.shm.segments", 1)
            old_map = f.seg_map
            f.seg_map, f.seg_path, f.seg_size = new_map, path, size
            remapped = True
        view = memoryview(f.seg_map)
        if f.asm_buf is not None and f.asm_total <= f.seg_size:
            staged_is_asm = f.staged is f.asm_buf
            if isinstance(f.asm_buf, bytearray):
                view[:f.asm_total] = f.asm_buf  # heap -> segment, once
                f.asm_buf = view[:f.asm_total]
                # The buffer identity changed: in-flight recv-into
                # landings against the heap buffer must drop as stale
                # (their bytes moved out from under them).
                f.asm_gen = next(_ASM_GEN)
            elif remapped:  # old-mapping view: repoint, no copy
                f.asm_buf = view[:f.asm_total]
                f.asm_gen = next(_ASM_GEN)
            if staged_is_asm:
                f.staged = f.asm_buf
        if isinstance(f.staged, (bytes, bytearray)) and f.frame_bytes \
                and f.frame_bytes <= f.seg_size:
            view[:f.frame_bytes] = f.staged
            f.staged = view[:f.frame_bytes]
        elif (isinstance(f.staged, memoryview) and remapped
                and f.staged is not f.asm_buf):
            f.staged = view[:len(f.staged)]
        if old_map is not None:
            try:
                old_map.close()
            except (BufferError, ValueError):
                pass  # an exported slice keeps it alive until GC

    def _shm_attach(self, req: dict) -> dict:
        """Hand the client a per-flow segment (path + mapped size).
        Idempotent; growing re-truncates the same inode so existing
        content — and existing client mappings of the old range —
        stay valid.  ``ring: 1`` additionally creates (or reuses) the
        flow's descriptor-ring file for the shm_post handoff; daemons
        that predate the ring simply never return ``ring_path``, which
        is the client's signal to fall back to per-chunk sends."""
        if not self.shm_enabled:
            return {"ok": False, "error": "shm lane disabled"}
        flow = req["flow"]
        nbytes = int(req.get("bytes") or 0)
        if nbytes < 0:
            return {"ok": False, "error": "invalid 'bytes'"}
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            try:
                self._ensure_segment_locked(flow, f, nbytes)
            except OSError as e:
                return {"ok": False, "error": f"shm attach failed: {e}"}
            resp = {"ok": True, "path": f.seg_path,
                    "bytes": f.seg_size, "frame_bytes": f.frame_bytes}
            if req.get("ring") and self.ring_enabled:
                try:
                    self._ensure_ring_locked(flow, f)
                except OSError as e:
                    # The segment is fine — only the handoff is not.
                    # The client runs per-chunk control ops instead.
                    log.warning("ring for flow %r unavailable: %s",
                                flow, e)
                else:
                    resp.update(ring_path=f.ring_path,
                                ring_slots=RING_SLOTS)
            return resp

    def _ring_attach(self, req: dict) -> dict:
        """Universal-ring attach: the descriptor ring WITHOUT a data
        segment — the socket lane's entry point, where payload bytes
        still ride the data plane but submission and completion ride
        the mmapped ring.  Daemons that predate the op answer
        "unknown op", the client's classic-path downgrade signal."""
        if not self.ring_enabled:
            return {"ok": False, "error": "ring disabled"}
        flow = req["flow"]
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            try:
                self._ensure_ring_locked(flow, f)
            except OSError as e:
                return {"ok": False, "error": f"ring attach failed: {e}"}
            return {"ok": True, "ring_path": f.ring_path,
                    "ring_slots": RING_SLOTS}

    def _ensure_ring_locked(self, flow: str, f: _Flow) -> None:
        """Create and map the flow's descriptor-ring file under
        shm_dir (RING_SLOTS slots).  The path is derived from the
        flow name, NOT the segment path — the universal ring exists
        on lanes that never attach a segment.  Caller holds the
        lock."""
        if f.ring_map is not None:
            return
        os.makedirs(self.shm_dir, exist_ok=True)
        path = os.path.join(
            self.shm_dir,
            hashlib.sha1(flow.encode()).hexdigest()[:16] + ".ring")
        size = dcn_shm.ring_bytes(RING_SLOTS)
        fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o600)
        try:
            os.ftruncate(fd, size)
            m = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        dcn_shm.RingView(m).init(RING_SLOTS)
        f.ring_path, f.ring_map = path, m

    def _shm_commit(self, req: dict) -> dict:
        """Declare ``[0, bytes)`` of the flow's segment a completed
        staged frame — the zero-copy analog of a whole-payload ``put``.
        The landing happens IN PLACE: no payload bytes cross a socket,
        but the bookkeeping (rx accounting, wait wakeups, assembly
        invalidation) is the same ``land_frame`` every other staging
        path uses.  Commits are seq-less staging, dedup-exempt and
        idempotent by construction — a restage after a failed round
        simply commits again.

        Range mode (``offset`` + ``total``): declare just
        ``[offset, offset+bytes)`` staged — the producer-fed overlap
        path commits each chunk as it is produced, and the chunk
        lands through the same in-place assembly bookkeeping the
        daemon↔daemon DXC1 lane uses."""
        if not self.shm_enabled:
            return {"ok": False, "error": "shm lane disabled"}
        flow = req["flow"]
        nbytes = int(req.get("bytes") or 0)
        xid = req.get("xid") or ""
        offset = req.get("offset")
        if nbytes <= 0:
            return {"ok": False, "error": "shm commit needs bytes > 0"}
        if offset is not None:
            offset = int(offset)
            total = int(req.get("total") or 0)
            if offset < 0 or total <= 0 or offset + nbytes > total:
                return {"ok": False,
                        "error": f"commit range out of bounds: "
                                 f"[{offset}:{offset + nbytes}) "
                                 f"of {total}"}
            need = total
        else:
            need = nbytes
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            if f.seg_map is None or f.seg_size < need:
                return {"ok": False,
                        "error": "no shm segment attached for "
                                 f"{need} bytes; shm_attach first"}
            view = f.seg_view(need)
        # The per-node attribution histogram the grey-failure detector
        # compares across peers (obs/anomaly.py) — the commit INCLUDING
        # any armed slow_shm throttle, so a throttled node's windowed
        # p99 separates from its peers' while every health check stays
        # green.
        commit_t0 = time.monotonic()
        delay_s = min(max(self._shm_delay_s, 0.0), 2.0)
        if delay_s:
            time.sleep(delay_s)
        if offset is not None:
            meta = {"off": offset, "tot": need}
            if xid:
                meta["xid"] = xid
            verdict = self.land_frame(
                flow, view[offset:offset + nbytes], None, meta,
                in_place=True)
            ok = verdict in ("landed", "dup")
        else:
            verdict = self.land_frame(flow, view, None,
                                      {"xid": xid} if xid else {},
                                      in_place=True)
            ok = verdict == "landed"
        histo.observe("xferd.shm.commit",
                      time.monotonic() - commit_t0)
        if not ok:
            return {"ok": False,
                    "error": f"shm commit not landed: {verdict}"}
        counters.inc("dcn.shm.commits")
        return {"ok": True, "bytes": nbytes, "verdict": verdict}

    def _shm_read(self, req: dict) -> dict:
        """Make the flow's completed frame readable through its
        segment and say where: frames that landed into heap buffers
        (the flow was never attached, or the segment was too small)
        are migrated in with one copy — still one copy fewer than any
        socket read-back.  The client maps the returned path and
        slices; no payload bytes cross the control socket."""
        if not self.shm_enabled:
            return {"ok": False, "error": "shm lane disabled"}
        flow = req["flow"]
        nbytes = int(req.get("bytes") or 0)
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            if not f.frame_bytes:
                return {"ok": False,
                        "error": "no completed frame staged"}
            try:
                self._ensure_segment_locked(
                    flow, f, max(nbytes, f.frame_bytes))
            except OSError as e:
                return {"ok": False, "error": f"shm read failed: {e}"}
            return {"ok": True, "path": f.seg_path,
                    "bytes": f.seg_size, "frame_bytes": f.frame_bytes}

    def _shm_post(self, req: dict) -> dict:
        """The descriptor-ring doorbell: ONE control op per round
        instead of one per chunk.  Validates the posted descriptors
        out of the daemon's own ring mapping, hands them to the
        completer thread, and returns immediately — completion is
        published INTO the ring (per-slot verdict codes + a cursor)
        for the client to poll out of shared memory.  Gated on the
        UNIVERSAL ring capability, not shm: socket-lane rounds post
        through the same doorbell."""
        if not self.ring_enabled:
            return {"ok": False, "error": "ring disabled"}
        flow = req["flow"]
        count = int(req.get("count") or 0)
        rnd = int(req.get("round") or 0)
        total = int(req.get("total") or 0)
        if count <= 0 or count > RING_SLOTS or total <= 0:
            return {"ok": False, "error": "invalid ring post geometry"}
        q = self._ring_q
        if q is None:
            return {"ok": False, "error": "daemon stopping"}
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            if f.ring_map is None:
                return {"ok": False,
                        "error": "no ring attached; shm_attach with "
                                 "ring first"}
            try:
                descs = dcn_shm.RingView(f.ring_map).read_descs(count)
            except (OSError, struct.error) as e:
                return {"ok": False, "error": f"bad ring: {e}"}
            for off, ln, _seq in descs:
                if ln <= 0 or off + ln > total:
                    return {"ok": False,
                            "error": f"descriptor out of bounds: "
                                     f"[{off}:{off + ln}) of {total}"}
        post = {
            "flow": flow, "descs": descs, "round": rnd,
            "total": total, "xid": req.get("xid") or "",
            "host": req.get("host", "127.0.0.1"),
            "port": int(req["port"]),
            "direct": req.get("direct"),
            "stage_wait_ms": req.get("stage_wait_ms"),
            "ctx": trace.context(),
        }
        q.put(post)
        counters.inc("dcn.shm.ring.posts")
        return {"ok": True, "accepted": count, "round": rnd}

    def _ring_completer(self, q: "queue.Queue") -> None:
        """The handoff's work loop: drain posted rounds, drive every
        descriptor through the NORMAL send path — stage-wait, link
        shim, lane selection (shm_direct included), verdicts — and
        publish per-slot status + the completion cursor into the
        flow's ring.  Ring writes are lock-free by layout contract
        (single writer per field); flow state is only ever touched
        through _send's own locking."""
        while True:
            post = q.get()
            if post is None or self._stopping.is_set():
                return
            ctx = post["ctx"] or {}
            with trace.attach(ctx.get("trace"), ctx.get("span")):
                self._complete_post(post)

    def _complete_post(self, post: dict) -> None:
        flow = post["flow"]
        with self._lock:
            f = self._flows.get(flow)
            ring = f.ring_map if f is not None else None
        if ring is None:
            return  # flow released between doorbell and completion
        view = dcn_shm.RingView(ring)
        try:
            view.begin_round(post["round"])
        except (ValueError, struct.error):
            return  # ring unmapped under us (release/stop race)
        # ONE stage-wait budget for the whole round, batch attempt
        # included: a dead stager must cost this thread at most one
        # budget, never batch-budget + fallback-budget (every other
        # flow's posted rounds queue behind this one).
        budget_s = min(float(post.get("stage_wait_ms")
                             or CHUNK_STAGE_WAIT_S * 1e3) / 1e3,
                       CHUNK_STAGE_WAIT_S)
        deadline = time.monotonic() + budget_s
        # Grey-fault hook: a SLOW completer (soak "slow_ring") pays
        # the delay per descriptor on the serial path — partial
        # progress stays visible in the cursor, which is exactly what
        # the sentinels must distinguish from a dead completer.  The
        # batch fast path is skipped while armed (a busy completer
        # does not get the one-copy shortcut).
        delay_s = min(max(self._ring_delay_s, 0.0), 2.0)
        # Whole-round fast path: when the peer is co-hosted, the round
        # completes as ONE segment→segment copy plus ONE batched DXC1
        # — zero per-chunk round trips end to end, which is the
        # descriptor-handoff promise kept on the daemon→daemon leg
        # too.  Any trouble falls through to the per-descriptor path.
        verdicts = (None if delay_s
                    else self._ring_batch_direct(post, deadline))
        if verdicts is not None:
            done = 0
            for i, verdict in enumerate(verdicts):
                done += 1
                status = dcn_shm.RING_STATUS_BY_VERDICT.get(
                    verdict, dcn_shm.RING_ERROR)
                try:
                    view.complete(i, status, done)
                except (ValueError, struct.error):
                    return
            return
        # Per-descriptor fallback, still under the SAME deadline: once
        # the budget is spent, every remaining descriptor fails fast
        # instead of re-paying the wait serially.
        done = 0
        for i, (off, ln, seq) in enumerate(post["descs"]):
            if self._stopping.is_set():
                return
            # Per-descriptor drive latency, slow_ring throttle
            # included: the ring plane's attribution histogram for the
            # grey-failure detector — a crawling completer's p99
            # separates from its peers' while the cursor stays green.
            drive_t0 = time.monotonic()
            if delay_s:
                time.sleep(delay_s)
            remaining_ms = max(1, int((deadline - time.monotonic())
                                      * 1e3))
            req = {"op": "send", "flow": flow, "host": post["host"],
                   "port": post["port"], "seq": seq, "offset": off,
                   "bytes": ln, "total": post["total"],
                   "xid": post["xid"],
                   "stage_wait_ms": remaining_ms}
            if post.get("direct") is not None:
                req["direct"] = post["direct"]
            try:
                resp = self._send(f"ring:{flow}", req)
            except Exception:  # noqa: BLE001 — status must publish
                log.exception("ring send failed (flow %r chunk %d)",
                              flow, i)
                resp = {"ok": False}
            histo.observe("xferd.ring.drive",
                          time.monotonic() - drive_t0)
            if resp.get("ok"):
                status = dcn_shm.RING_STATUS_BY_VERDICT.get(
                    resp.get("verdict", "sent"), dcn_shm.RING_ERROR)
            else:
                status = dcn_shm.RING_ERROR
            done += 1
            try:
                view.complete(i, status, done)
            except (ValueError, struct.error):
                return  # ring unmapped (flow released mid-round)

    def _ring_batch_direct(self, post: dict, deadline: float):
        """Complete one posted round over the daemon↔daemon lane as a
        single unit: wait once for the whole frame to stage, memcpy
        every descriptor's range segment→segment, and land them all
        with ONE multi-descriptor DXC1.  Returns the per-descriptor
        verdict list (aligned with the post), or None when the batch
        path does not apply — no direct lane, link faults armed (the
        shim is per-frame; the per-descriptor path owns that), the
        staging never completed — in which case the caller runs the
        per-descriptor completion instead (under the SAME deadline:
        the two paths share one stage-wait budget)."""
        if self.net is not None or not self.shm_direct \
                or post.get("direct") in (0, "0", False):
            return None
        flow, total, xid = post["flow"], post["total"], post["xid"]
        host, port = post["host"], post["port"]
        with self._lock:
            if self._link_faults:
                return None  # injected faults are per-frame territory
        with self._landed:
            staged = self._landed.wait_for(
                lambda: (self._flows.get(flow) is None
                         or self._flows[flow].range_staged(0, total,
                                                           xid)),
                timeout=max(0.0, deadline - time.monotonic()),
            )
            if self._flows.get(flow) is None or not staged:
                return None
        meta = {"src": self.node, "tot": total, "xid": xid}
        ctx = trace.context()
        if ctx is not None:
            meta.update(ctx)
        descs = post["descs"]
        nbytes = sum(ln for _off, ln, _seq in descs)
        t0 = time.monotonic()
        with trace.span("xferd.send", histogram="xferd.send",
                        flow=flow, node=self.node,
                        dst=f"{host}:{port}", bytes=nbytes,
                        chunks=len(descs)) as span:
            verdicts = self._shm_direct_try_batch(flow, host, port,
                                                  descs, total, xid,
                                                  meta)
            if verdicts is None:
                return None
            span.annotate(lane="shm_direct")
        micros = max(1.0, (time.monotonic() - t0) * 1e6)
        timeseries.record("dcn.lane.shm_direct.bytes", nbytes)
        timeseries.gauge_add("dcn.lane.shm_direct.total_bytes", nbytes)
        with self._lock:
            f = self._flows.get(flow)
            if f is not None:
                f.transferred += nbytes
                self._total_transferred += nbytes
                self._publish_flow_gauges_locked()
        log.debug("ring batch of %d chunks (%d bytes) completed in "
                  "%.0f us", len(descs), nbytes, micros)
        return verdicts

    def _shm_direct_try_batch(self, flow: str, host: str, port: int,
                              descs, total: int, xid: str,
                              meta: dict):
        """The batched sibling of _shm_direct_try: one handshake/
        attach (cached), one copy pass over every descriptor range,
        ONE DXC1 carrying the descriptor list.  Returns the verdict
        list or None (caller falls back per-descriptor)."""
        lane = self._peer_lane(host, port)
        with lane.lock, lockwatch.blocking_ok(
                "xferd.shm_direct: peer control ops on one stream "
                "must not interleave"):
            try:
                seg = self._lane_attach_locked(lane, host, port, flow,
                                               total)
                if seg is None:
                    return None
                with self._lock:
                    f = self._flows.get(flow)
                    if f is None:
                        return None
                    for off, ln, _seq in descs:
                        src = self._range_view_locked(f, off, ln, xid)
                        if src is None:
                            return None
                        seg.map[off:off + ln] = src
                resp = lane.request(
                    host, port, _MAGIC_PEER_COMMIT,
                    {"flow": flow, "ino": seg.ino, "meta": meta,
                     "descs": [{"off": off, "len": ln, "seq": seq}
                               for off, ln, seq in descs]})
                if not resp.get("ok"):
                    counters.inc("dcn.shm_direct.fallback")
                    return None
                verdicts = resp.get("verdicts")
                if (not isinstance(verdicts, list)
                        or len(verdicts) != len(descs)):
                    counters.inc("dcn.shm_direct.fallback")
                    return None
                if all(v == "rejected" for v in verdicts):
                    # Stale mapping: drop the cached segment, let the
                    # per-descriptor path re-attach and retry.
                    seg.close()
                    lane.segs.pop(flow, None)
                    counters.inc("dcn.shm_direct.fallback")
                    return None
            except (OSError, ConnectionError, ValueError) as e:
                lane.reset_locked(None)
                counters.inc("dcn.shm_direct.fallback")
                log.warning("shm_direct batch to %s:%d failed (%s); "
                            "falling back", host, port, e)
                return None
        counters.inc("dcn.shm_direct.frames", len(descs))
        return verdicts

    # -- data plane ----------------------------------------------------------

    def _data_accept_loop(self) -> None:
        srv = self._data_server
        while not self._stopping.is_set():
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            if self._stopping.is_set():
                conn.close()
                return
            threading.Thread(target=self._serve_data_conn, args=(conn,),
                             name=f"pyxferd-dconn-{self.node}",
                             daemon=True).start()

    def _serve_data_conn(self, conn: socket.socket) -> None:
        _set_nodelay(conn)
        with self._lock:
            self._conns.add(conn)
        try:
            while not self._stopping.is_set():
                try:
                    magic = _recv_exact(conn, 4)
                except (ConnectionError, OSError):
                    return
                if magic == _MAGIC_READ:
                    if not self._serve_data_read(conn):
                        return
                    continue
                if magic in _PEER_OPS:
                    if not self._serve_peer_op(conn, magic):
                        return
                    continue
                try:
                    hdr = self._read_frame_header(conn, magic)
                except (ConnectionError, OSError, ValueError) as e:
                    log.error("bad data-plane frame: %s", e)
                    return
                try:
                    self._recv_and_land(conn, *hdr)
                except (ConnectionError, OSError):
                    # Died mid-payload: the chunk was never recorded,
                    # so partial bytes stay invisible (see
                    # _recv_and_land).
                    return
        finally:
            conn.close()
            with self._lock:
                self._conns.discard(conn)

    def _serve_data_read(self, conn: socket.socket) -> bool:
        """Answer one DXR1 read request: u64 LE length + raw staged
        bytes (bounded by the last COMPLETED frame — an assembling flow
        reads empty, exactly like the control-plane read's contract).
        Raw TCP instead of base64-over-JSON is what makes the striped
        reader's read-back leg cheap.  Returns False on a dead conn."""
        try:
            name_len = struct.unpack("<I", _recv_exact(conn, 4))[0]
            offset = struct.unpack("<Q", _recv_exact(conn, 8))[0]
            nbytes = struct.unpack("<Q", _recv_exact(conn, 8))[0]
            if name_len > 4096 or nbytes > (1 << 31):
                raise ValueError("read request out of bounds")
            flow = _recv_exact(conn, name_len).decode()
        except (ConnectionError, OSError, ValueError) as e:
            log.error("bad data-plane read request: %s", e)
            return False
        with self._lock:
            f = self._flows.get(flow)
            if f is None or not f.frame_bytes:
                data = b""
            else:
                end = min(offset + nbytes, f.frame_bytes,
                          len(f.staged))
                # bytes() under the lock — shm staging is a view.
                data = bytes(f.staged[offset:end]) if offset < end \
                    else b""
        try:
            netio.sendall_parts(conn, (struct.pack("<Q", len(data)),
                                       data))
        except OSError:
            return False
        return True

    def _serve_peer_op(self, conn: socket.socket, magic: bytes) -> bool:
        """One daemon↔daemon shm-lane request/response pair (DXH1 /
        DXA1 / DXC1): u32 LE length + JSON both ways, control-sized —
        the payload bytes these ops are ABOUT move through the shared
        segment, never this socket.  Returns False on a dead conn."""
        try:
            n = struct.unpack("<I", _recv_exact(conn, 4))[0]
            if n > 65536:
                raise ValueError("peer op request out of bounds")
            req = json.loads(_recv_exact(conn, n))
        except (ConnectionError, OSError, ValueError) as e:
            log.error("bad peer shm op: %s", e)
            return False
        try:
            if magic == _MAGIC_PEER_HELLO:
                resp = {"ok": True, "host_id": self.host_id,
                        "shm": 1 if self.shm_enabled else 0}
            elif magic == _MAGIC_PEER_ATTACH:
                resp = self._peer_attach(req)
            else:
                resp = self._peer_commit(req)
        except (KeyError, TypeError, ValueError) as e:
            resp = {"ok": False, "error": f"bad peer request: {e}"}
        body = json.dumps(resp).encode()
        try:
            netio.sendall_parts(conn, (struct.pack("<I", len(body)),
                                       body))
        except OSError:
            return False
        return True

    def _peer_attach(self, req: dict) -> dict:
        """A co-hosted peer daemon asks for the flow's segment so it
        can land frames by memcpy.  Same machinery as the client-side
        shm_attach, plus the segment's inode — the commit-time
        staleness check that makes a released-and-recreated segment a
        loud ``rejected`` instead of silent corruption."""
        if not self.shm_enabled:
            return {"ok": False, "error": "shm lane disabled"}
        flow = req["flow"]
        nbytes = int(req.get("bytes") or 0)
        if nbytes <= 0:
            return {"ok": False, "error": "invalid 'bytes'"}
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                return {"ok": False, "error": "unknown flow"}
            try:
                self._ensure_segment_locked(flow, f, nbytes)
            except OSError as e:
                return {"ok": False,
                        "error": f"peer attach failed: {e}"}
            return {"ok": True, "path": f.seg_path,
                    "bytes": f.seg_size, "ino": f.seg_ino}

    def _peer_commit(self, req: dict) -> dict:
        """Land frame(s) whose bytes a co-hosted peer daemon already
        memcpy'd into this flow's segment.  All the authority —
        dedup, geometry checks, accounting, wait wakeups — is the
        same ``land_frame`` every other path uses; only the payload
        copy is skipped.  The quoted inode must match the segment the
        flow currently owns.  A ``descs`` list lands a whole posted
        round in one request — per-descriptor verdicts come back as
        ``verdicts`` (aligned), so exactly-once stays chunk-granular
        while the control cost is one round trip."""
        if not self.shm_enabled:
            return {"ok": False, "error": "shm lane disabled"}
        flow = req["flow"]
        meta = req.get("meta") or {}
        ino = int(req.get("ino") or 0)
        descs = req.get("descs")
        if descs is not None:
            tot = int(meta.get("tot") or 0)
            xid = meta.get("xid") or ""
            verdicts = []
            for d in descs:
                seq = d.get("seq")
                verdicts.append(self._peer_commit_chunk(
                    flow, int(d.get("off", -1)),
                    int(d.get("len") or 0),
                    int(seq) if seq is not None else None,
                    tot, xid, meta, ino))
            return {"ok": True, "verdicts": verdicts}
        nbytes = int(req.get("len") or 0)
        seq = req.get("seq")
        seq = int(seq) if seq is not None else None
        if nbytes <= 0:
            return {"ok": False, "error": "invalid 'len'"}
        off = meta.get("off")
        if off is not None:
            verdict = self._peer_commit_chunk(
                flow, int(off), nbytes, seq,
                int(meta.get("tot") or 0), meta.get("xid") or "",
                meta, ino)
            return {"ok": True, "verdict": verdict}
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                # land_frame would also answer unmatched, but without
                # a flow there is no segment to have written into.
                self._unmatched += 1
                return {"ok": True, "verdict": "unmatched"}
            if (f.seg_map is None or ino != f.seg_ino
                    or f.seg_size < nbytes):
                return {"ok": True, "verdict": "rejected"}
            payload = f.seg_view(nbytes)
        verdict = self.land_frame(flow, payload, seq, meta,
                                  in_place=True)
        return {"ok": True, "verdict": verdict}

    def _peer_commit_chunk(self, flow: str, off: int, nbytes: int,
                           seq: Optional[int], tot: int, xid: str,
                           meta: dict, ino: int) -> str:
        """One chunk's descriptor-only landing (bytes already in the
        segment): verify inode + geometry, make the assembly
        segment-backed under the SAME lock hold that captures the
        generation, then let land_frame referee dedup and record."""
        if nbytes <= 0:
            return "rejected"
        with self._lock:
            f = self._flows.get(flow)
            if f is None:
                self._unmatched += 1
                return "unmatched"
            if f.seg_map is None or ino != f.seg_ino:
                return "rejected"
            if (tot <= 0 or off < 0 or off + nbytes > tot
                    or f.seg_size < tot):
                return "rejected"
            if xid in f.retired_xids:
                # Straggler commit for a transfer this flow moved
                # past: refuse before it can reset the live assembly.
                return "rejected"
            buf = self._ensure_assembly_locked(f, xid, tot)
            if not isinstance(buf, memoryview):
                return "rejected"
            payload = buf[off:off + nbytes]
            gen = f.asm_gen
        meta_d = dict(meta, off=off, tot=tot, xid=xid)
        return self.land_frame(flow, payload, seq, meta_d,
                               preloaded_gen=gen)

    def _read_frame_header(self, conn: socket.socket, magic: bytes
                           ) -> Tuple[str, int, Optional[int], dict]:
        """Everything BEFORE the payload: (flow, payload_len, seq,
        meta).  The payload itself is received by _recv_and_land —
        straight into the flow's assembly buffer when it can be."""
        if magic == _MAGIC_V1:
            name_len, payload_len = struct.unpack(
                "<IQ", _recv_exact(conn, 12))
            seq, meta_len = None, 0
        elif magic == _MAGIC_V2:
            name_len, payload_len, seq, meta_len = struct.unpack(
                "<IQQI", _recv_exact(conn, 24))
        else:
            raise ValueError(f"unknown frame magic {magic!r}")
        if name_len > 4096 or payload_len > (1 << 31) or meta_len > 65536:
            raise ValueError("frame header out of bounds")
        flow = _recv_exact(conn, name_len).decode()
        meta = {}
        if meta_len:
            try:
                meta = json.loads(_recv_exact(conn, meta_len))
            except ValueError:
                meta = {}
        return flow, payload_len, seq, meta

    def _recv_and_land(self, conn: socket.socket, flow: str,
                       payload_len: int, seq: Optional[int],
                       meta: dict) -> None:
        """Receive one frame's payload and land it.

        The recv-into-mmap path: a chunk frame whose flow
        can assemble it is received DIRECTLY into the assembly buffer
        at its offset — a segment view for shm-attached flows, the
        heap bytearray otherwise — deleting the per-chunk heap bounce.
        Safety is two-phase: the dedup window is pre-checked (without
        marking) when the target view is carved out, and re-checked —
        then marked — when the landing is recorded, so two streams
        racing the same seq still land exactly once (both writes carry
        identical bytes).  A receive that DIES mid-chunk leaves the
        chunk unrecorded: its partial bytes sit in a region
        ``range_staged`` does not count, so the frame can never
        complete around them and the retransmit overwrites them — the
        same partial-assembly invisibility the copy path had
        (``dcn.chunks.torn``).  A landing whose assembly was reset
        mid-receive (new xid, segment migration) is dropped via the
        generation check, never recorded into the wrong transfer
        (``dcn.chunks.stale_drop``).

        Everything that can't target an assembly — v1 frames, whole-
        payload frames, unknown flows (which must still drain the
        stream), dup-in-advance chunks, bad geometry — takes the old
        receive-then-land path unchanged."""
        target = None
        gen = None
        off = meta.get("off")
        # Forward frames carry off/tot too, but they land into the
        # flow's COMPLETED staging (possibly combining), never into an
        # assembly — the copy path below is their only correct route.
        if off is not None and seq is not None and not meta.get("fwd"):
            try:
                off = int(off)
                tot = int(meta.get("tot") or 0)
            except (TypeError, ValueError):
                off, tot = -1, 0
            xid = meta.get("xid") or ""
            with self._lock:
                f = self._flows.get(flow)
                if (f is not None and tot > 0 and 0 <= off
                        and off + payload_len <= tot
                        and xid not in f.retired_xids
                        and not (seq and (seq in f.seen_seqs
                                          or (f.max_seq - seq)
                                          >= DEDUP_WINDOW))):
                    buf = self._ensure_assembly_locked(f, xid, tot)
                    target = memoryview(buf)[off:off + payload_len]
                    gen = f.asm_gen
        if target is None:
            payload = _recv_exact(conn, payload_len)
            self.land_frame(flow, payload, seq, meta)
            return
        try:
            netio.recv_exact_into(conn, target)
        except (ConnectionError, OSError):
            counters.inc("dcn.chunks.torn")
            raise
        self.land_frame(flow, target, seq, meta, preloaded_gen=gen)

    def land_frame(self, flow: str, payload,
                   seq: Optional[int] = None, meta: Optional[dict] = None,
                   link: Optional[Tuple[str, str]] = None,
                   in_place: bool = False,
                   preloaded_gen: Optional[int] = None) -> str:
        """Land one frame into a flow's staging buffer.

        Returns "landed", "dup" (seq already landed — dropped without
        touching accounting, the exactly-once half of frame
        sequencing), "rejected" (malformed chunk geometry), or
        "unmatched" (no such flow registered here).  A frame whose meta
        carries ``off``/``tot`` is a CHUNK: it lands at its offset into
        the flow's assembly buffer, and the completed frame becomes
        visible only once every byte of ``tot`` has landed — a reader
        can never observe a half-assembled payload.  Seq 0 (or a v1
        frame) bypasses dedup: that is local staging, idempotent by
        construction.  Landing joins the SENDER's trace via the frame
        meta.

        ``in_place=True`` (the shm commit path) means the payload
        bytes already live in the flow's segment: the landing does all
        the bookkeeping — accounting, wait wakeups, assembly
        invalidation — without ever copying the payload.

        ``preloaded_gen`` (the recv-into-mmap and DXC1 paths) means a
        CHUNK's bytes were already written into the assembly buffer of
        generation ``preloaded_gen``: the landing skips the copy and,
        when the assembly has moved on since (reset, new xid, buffer
        migration), DROPS the record instead of attributing foreign
        bytes to the live transfer ("stale").
        """
        meta = meta or {}
        # Waiters are woken AFTER the span context closes (the finally
        # below, a second short lock hold): the span's JSONL record is
        # written at context exit, so anything a wait-op client does
        # after its wakeup — including scraping this daemon's trace
        # file — happens-after the record exists.  Notifying inside
        # the span (the old shape) let a woken reader race the flush,
        # the cross-process trace test's flake.
        notify = False
        try:
            with trace.attach(meta.get("trace"), meta.get("span")):
                with trace.span("xferd.land", histogram="xferd.land",
                                flow=flow, node=self.node, seq=seq,
                                bytes=len(payload),
                                src=meta.get("src", "")) as span:
                    with self._lock:
                        f = self._flows.get(flow)
                        if f is None:
                            self._unmatched += 1
                            span.annotate(verdict="unmatched")
                            return "unmatched"
                        if preloaded_gen is not None \
                                and (f.asm_gen != preloaded_gen
                                     or f.asm_buf is None):
                            # The assembly this chunk was received
                            # into no longer exists (reset, new xid,
                            # migration): drop BEFORE the seq is
                            # marked seen, so the retransmit of these
                            # bytes can still land.
                            counters.inc("dcn.chunks.stale_drop")
                            span.annotate(verdict="stale")
                            return "stale"
                        if (meta.get("off") is not None
                                and not meta.get("fwd")
                                and (meta.get("xid") or "")
                                in f.retired_xids):
                            # A straggler from a transfer this flow
                            # moved past (a ring completer's late
                            # send, a slow retransmit): dropping it —
                            # seq unmarked — keeps the LIVE assembly
                            # intact instead of letting the dead xid
                            # reset it.
                            counters.inc("dcn.chunks.stale_drop")
                            span.annotate(verdict="stale")
                            return "stale"
                        if seq:  # seq 0 == staging, dedup-exempt
                            if (seq in f.seen_seqs
                                    or (f.max_seq - seq)
                                    >= DEDUP_WINDOW):
                                span.annotate(verdict="dup")
                                counters.inc("dcn.frames.deduped")
                                return "dup"
                            f.seen_seqs.add(seq)
                            f.max_seq = max(f.max_seq, seq)
                            # Bound the window: forget fallen-out
                            # seqs.
                            if len(f.seen_seqs) > 2 * DEDUP_WINDOW:
                                floor = f.max_seq - DEDUP_WINDOW
                                f.seen_seqs = {s for s in f.seen_seqs
                                               if s >= floor}
                        verdict = self._land_locked(flow, f, payload,
                                                    meta, seq,
                                                    in_place,
                                                    preloaded_gen)
                        notify = True
                    span.annotate(verdict=verdict)
                    if verdict == "landed":
                        # Goodput = bytes that landed USEFULLY: dups
                        # and link-eaten frames never reach here.  A
                        # frame is remote-origin when it rode the
                        # fleet fabric or carries a sender's node
                        # stamp; everything else is local staging,
                        # tracked as its own series so the stage rate
                        # never inflates goodput.
                        remote = (link is not None
                                  or bool(meta.get("src")))
                        if remote:
                            # Cumulative landed-frame count: the
                            # scrapeable denominator for fleet
                            # dedup/retransmit ratios when there is no
                            # link table to read (the process-mode
                            # aggregator's HTTP path).
                            counters.inc("xferd.frames.landed")
                            timeseries.record("xferd.rx.bytes",
                                              len(payload))
                            timeseries.record(f"goodput.flow.{flow}",
                                              len(payload))
                            if self.node:
                                timeseries.record(
                                    f"goodput.node.{self.node}",
                                    len(payload))
                            if link is not None:
                                timeseries.record(
                                    f"goodput.link."
                                    f"{link[0]}->{link[1]}",
                                    len(payload))
                        else:
                            timeseries.record("xferd.stage.bytes",
                                              len(payload))
                    return verdict
        finally:
            if notify:
                with self._lock:
                    self._landed.notify_all()

    def _ensure_assembly_locked(self, f: _Flow, xid: str,
                                tot: int):
        """The flow's assembly buffer for transfer ``xid`` of ``tot``
        bytes, creating it (and discarding a stale one — un-seeing its
        seqs, invalidating the completed frame, bumping the
        generation) when the flow is not already assembling exactly
        that.  Caller holds the lock."""
        if f.asm_xid != xid or f.asm_total != tot or f.asm_buf is None:
            # First chunk of a new logical transfer (or a retry under a
            # fresh xid): discard the old assembly — un-seeing its seqs
            # so that retransmits of the discarded bytes can land again
            # (a stale straggler frame must not be able to wedge the
            # live transfer) — and start clean.  The completed frame is
            # invalidated too: on a reused flow, a reader waiting for
            # THIS transfer must block until it assembles, never be
            # satisfied by last transfer's bytes.  A replaced xid
            # whose frame COMPLETED is RETIRED: the transfer finished,
            # so anything still arriving under it (a ring completer's
            # late send, a slow retransmit) is a straggler that must
            # not reset the new live assembly.  An INCOMPLETE xid is
            # not retired — its displacement may itself be the work
            # of a straggler, and the live transfer's retransmits
            # must be able to land again (the un-seen seqs below).
            if (f.asm_xid and f.asm_xid != xid and f.frame_bytes
                    and f.frame_bytes == f.asm_total):
                f.retired_xids.append(f.asm_xid)
            f.discard_assembly()
            f.staged = b""
            f.frame_bytes = 0
            f.asm_xid = xid
            f.asm_total = tot
            if f.seg_map is not None and f.seg_size >= tot:
                # shm-attached flow: assemble straight into the mmap,
                # so the local reader's shm_read is a buffer reference
                # with no migration copy.
                f.asm_buf = f.seg_view(tot)
            else:
                f.asm_buf = bytearray(tot)
        return f.asm_buf

    def _land_locked(self, flow: str, f: _Flow, payload,
                     meta: dict, seq, in_place: bool = False,
                     preloaded_gen: Optional[int] = None) -> str:
        """Write one (deduped) frame into flow state; caller holds the
        lock."""
        off = meta.get("off")
        if meta.get("fwd"):
            # Forward frame (a routed schedule leg): lands INTO the
            # flow's completed staging at its offset — combining when
            # the leg reduces, overwriting when it gathers — never
            # into an assembly.  The baseline frame (the coordinator's
            # setup put) must already be staged: schedule legs write
            # regions of a buffer whose geometry the schedule fixed
            # up front, so a missing baseline is a protocol error the
            # source daemon surfaces for the coordinator to re-post.
            off = int(off or 0)
            n = len(payload)
            if (not f.frame_bytes or off < 0
                    or off + n > len(f.staged)):
                counters.inc("dcn.chunks.rejected")
                log.error("rejecting forward frame with bad geometry:"
                          " flow=%s off=%d len=%d staged=%d", flow,
                          off, n, len(f.staged))
                return "rejected"
            if not isinstance(f.staged, (bytearray, memoryview)):
                # First forward into this flow: staging becomes
                # writable in place (segment-backed staging already
                # is).
                f.staged = bytearray(f.staged)
            if meta.get("red"):
                _combine_into(f.staged, off, payload)
            else:
                f.staged[off:off + n] = payload
            f.rx_bytes += n
            counters.inc("xferd.forward.landed")
            return "landed"
        if off is None:
            # Whole-payload frame: replaces staging wholesale and
            # cancels any in-progress assembly (the serial fallback
            # after a pipelined attempt must win outright).
            if in_place:
                # shm commit: the bytes are already in the segment.
                # Re-take the view under THIS lock hold — the segment
                # could have been remapped since the caller sliced it.
                if f.seg_map is None or f.seg_size < len(payload):
                    return "rejected"
                f.staged = f.seg_view(len(payload))
            else:
                f.staged = bytes(payload)
            f.frame_bytes = len(payload)
            f.rx_bytes += len(payload)
            new_xid = meta.get("xid") or None
            if f.asm_xid and f.asm_xid != new_xid:
                f.retired_xids.append(f.asm_xid)
            f.discard_assembly()
            if in_place:
                # Stamp the committing transfer's xid so offset-sends
                # of the same transfer match this frame (the sender's
                # stale-frame guard on reused flows).
                f.asm_xid = new_xid
                f.asm_total = len(payload)
            return "landed"
        off = int(off)
        tot = int(meta.get("tot") or 0)
        xid = meta.get("xid") or ""
        if tot <= 0 or off < 0 or off + len(payload) > tot:
            counters.inc("dcn.chunks.rejected")
            log.error("rejecting chunk with bad geometry: flow=%s "
                      "off=%d len=%d tot=%d", flow, off,
                      len(payload), tot)
            return "rejected"
        self._ensure_assembly_locked(f, xid, tot)
        if preloaded_gen is not None or in_place:
            # The bytes are already where they belong: received
            # straight into the assembly buffer (recv-into-mmap; the
            # generation was verified by the caller under THIS lock
            # hold), or memcpy'd into the segment by a co-hosted peer
            # daemon (DXC1).  For the latter the assembly must
            # actually be segment-backed, or the "already there"
            # premise is false — refuse, the sender retries over TCP.
            if in_place and not isinstance(f.asm_buf, memoryview):
                counters.inc("dcn.chunks.rejected")
                return "rejected"
        else:
            f.asm_buf[off:off + len(payload)] = payload
        f.asm_chunks[off] = len(payload)
        if seq:
            f.asm_seqs.add(seq)
        f.rx_bytes += len(payload)
        counters.inc("dcn.chunks.landed")
        if (f.range_staged(0, tot, xid)
                and f.staged is not f.asm_buf):
            # Completion = every byte of [0, tot) covered by landed
            # chunks (interval walk, not a length sum: overlapping
            # chunks from an off-grid sender must not mark a gapped
            # buffer complete).  Adopt the assembly buffer as the
            # completed frame without a copy; a same-xid restage keeps
            # writing into it (same bytes), a new xid starts a fresh
            # buffer.  The identity check makes completion fire once
            # per assembly, not once per straggler/replayed chunk
            # after completion.
            f.staged = f.asm_buf
            f.frame_bytes = tot
            counters.inc("dcn.chunks.assembled")
        return "landed"
