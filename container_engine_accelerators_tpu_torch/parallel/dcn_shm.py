"""Client half of the zero-copy same-host staging lane.

Every local stage/send/read used to cross a TCP socket even when the
client and its daemon share a host — the analog of the CPU-proxy hop
GPU-Initiated Networking removes from the transfer path (PAPERS.md).
The shm lane removes ours: a daemon that advertises ``shm`` in its
``version`` handshake owns per-flow ``mmap``-backed segments under
``shm_dir``; a same-host client writes chunk ``memoryview``s straight
into the segment and reads landed frames back out of it, so the two
client↔daemon payload passes become memcpys while the daemon→peer
leg (the actual network) and EVERY control op — seq assignment,
dedup, ``wait``, fabric verdicts — stay exactly where they were.
Exactly-once semantics are therefore unchanged: the shm lane moves
bytes, never authority.

Same-host detection compares **boot identity**, not addresses: two
containers can share ``127.0.0.1`` across a netns boundary without
sharing a filesystem, and a daemon behind a forwarded UDS may be on
another machine entirely.  ``host_identity()`` is the kernel boot id
plus hostname (override: ``TPU_DCN_HOST_ID``, which is also how tests
fake a cross-host daemon); the daemon stamps its own into the
handshake and the client only takes the lane on an exact match — and
even then, a segment that fails to map falls back to the socket lane
(``dcn.shm.fallback``) rather than failing the transfer.

This module owns host identity, the client-side segment mapping, and
the **descriptor-ring** layout both halves of the handoff protocol
share: instead of one control round trip per chunk, the
client writes (off, len, seq) descriptors into a per-flow ring file,
rings ONE ``shm_post`` doorbell, and the daemon completes the
descriptors in place — per-slot verdict codes plus a completion
cursor the client polls lock-free out of its own mapping.  Lane
*selection* and the transfer logic live in
``parallel/dcn_pipeline.py``, the daemon half in ``fleet/xferd.py``.

The port's own copy of the JAX package's ``parallel/dcn_shm.py`` (host
code: no torch): host identity, the segment files and the ring layout are
the same byte for byte, so a client of one package posts into a ring
of the other package's daemon.
"""

import mmap
import os
import socket
import struct
from typing import List, Optional, Tuple

HOST_ID_ENV = "TPU_DCN_HOST_ID"
SHM_ENV = "TPU_DCN_SHM"
SHM_DIRECT_ENV = "TPU_DCN_SHM_DIRECT"
SHM_RING_ENV = "TPU_DCN_SHM_RING"

_BOOT_ID_PATH = "/proc/sys/kernel/random/boot_id"
_host_id_cache: Optional[str] = None


def host_identity(env=None) -> str:
    """This process's host identity: ``<boot_id>:<hostname>``, with
    ``TPU_DCN_HOST_ID`` as the explicit override (tests, and operators
    whose mounts make the default ambiguous)."""
    env = env if env is not None else os.environ
    override = env.get(HOST_ID_ENV)
    if override:
        return override
    global _host_id_cache
    if _host_id_cache is None:
        try:
            with open(_BOOT_ID_PATH) as f:
                boot = f.read().strip()
        except OSError:
            boot = "no-boot-id"
        _host_id_cache = f"{boot}:{socket.gethostname()}"
    return _host_id_cache


def shm_enabled(env=None) -> bool:
    """The env kill switch, same grammar as ``TPU_DCN_PIPELINE``."""
    env = env if env is not None else os.environ
    return env.get(SHM_ENV, "1") not in ("0", "false", "off")


def shm_direct_enabled(env=None) -> bool:
    """Kill switch for the daemon↔daemon same-host lane (segments
    instead of the peer TCP stream).  Same grammar as the other data-
    plane switches; consulted by BOTH halves — the sending daemon's
    env gates the lane, and a client can pin it off per transfer
    (``PipelineConfig.shm_direct`` → the send op's ``direct`` key)."""
    env = env if env is not None else os.environ
    return env.get(SHM_DIRECT_ENV, "1") not in ("0", "false", "off")


def shm_ring_enabled(env=None) -> bool:
    """Kill switch for the descriptor-ring handoff (client side:
    whether shm rounds request a ring and post descriptors, or fall
    back to per-chunk control ops).  Same grammar as the rest."""
    env = env if env is not None else os.environ
    return env.get(SHM_RING_ENV, "1") not in ("0", "false", "off")


class Segment:
    """One client-side mapping of a daemon-owned segment file.  The
    daemon owns creation, sizing, and unlinking; the client only maps
    what the ``shm_attach`` / ``shm_read`` response named — a path it
    cannot open or map is a lane fallback, never an error surface."""

    def __init__(self, path: str, size: int):
        self.path = path
        self.size = int(size)
        f = open(path, "r+b")
        try:
            self.map = mmap.mmap(f.fileno(), self.size)
        except ValueError as e:
            # mmap says ValueError when the file is smaller than the
            # advertised size (a crash-restarted daemon recreated the
            # segment at minimum size); normalize to the documented
            # OSError so the lane-fallback handlers catch it.
            raise OSError(f"segment {path!r} unmappable: {e}") from e
        finally:
            f.close()
        self.view = memoryview(self.map)

    def close(self) -> None:
        try:
            self.view.release()
        except (BufferError, AttributeError):
            pass
        try:
            self.map.close()
        except (BufferError, ValueError):
            pass  # an exported slice keeps the map alive until GC


def map_segment(path: str, size: int) -> Segment:
    """Map a daemon-advertised segment; raises ``OSError`` (the
    caller's fallback signal) when the path is gone or undersized."""
    if size <= 0:
        raise OSError(f"segment {path!r} has no size")
    return Segment(path, size)


# ---------------------------------------------------------------------------
# Descriptor ring: the shared-memory work queue of the
# handoff protocol.  One ring per flow, living in its own file next to
# the data segment so payload offsets never shift.  All fields are
# little-endian at fixed offsets; the client owns `round`/`posted` and
# the descriptor slots, the daemon owns `completed_round`/`completed`
# and the per-slot status bytes — single-writer per field, so neither
# side ever takes a lock to touch the ring (the poll/wait paths the
# race gate runs under lockwatch are lock-free by construction).
#
#    0  u32  magic "DRG1"
#    4  u32  slots (capacity)
#    8  u64  round            client: bumped once per shm_post
#   16  u64  posted           client: descriptor count for `round`
#   24  u64  completed_round  daemon: the round `completed` refers to
#   32  u64  completed        daemon: descriptors completed so far
#   40  slot[i] (32 bytes):  u64 off | u64 len | u64 seq | u32 status
#                            | u32 pad
#
# Publication order is the contract: the daemon writes a slot's status
# BEFORE advancing `completed`, and writes `completed = 0` BEFORE
# echoing `completed_round` — a client that observes
# (completed_round == round and completed >= n) can trust every status
# it then reads.  Status codes mirror send verdicts.
# ---------------------------------------------------------------------------

RING_MAGIC = 0x31475244  # "DRG1" little-endian
RING_HDR_BYTES = 40
RING_SLOT_BYTES = 32

RING_PENDING = 0
RING_SENT = 1
RING_LANDED = 2
RING_DUP = 3
RING_DROPPED = 4
RING_UNMATCHED = 5
RING_REJECTED = 6
RING_ERROR = 7
RING_STALE = 8

# Status code <-> the verdict strings the scoreboard already speaks
# (one mapping, derived both ways: the ring lane must never report a
# different status than the per-chunk lane for the same verdict).
RING_VERDICTS = {
    RING_SENT: "sent", RING_LANDED: "landed", RING_DUP: "dup",
    RING_DROPPED: "dropped", RING_UNMATCHED: "unmatched",
    RING_REJECTED: "rejected", RING_ERROR: "error",
    RING_STALE: "stale",
}
RING_STATUS_BY_VERDICT = {v: k for k, v in RING_VERDICTS.items()}


def ring_bytes(slots: int) -> int:
    return RING_HDR_BYTES + RING_SLOT_BYTES * int(slots)


class RingView:
    """Typed accessors over one mapping of a ring file.  Works on any
    writable buffer (the daemon's ``mmap``, the client's
    :class:`Segment` view); does no locking — see the layout note."""

    def __init__(self, buf):
        self.buf = buf

    def init(self, slots: int) -> None:
        struct.pack_into("<II", self.buf, 0, RING_MAGIC, slots)
        struct.pack_into("<QQQQ", self.buf, 8, 0, 0, 0, 0)

    @property
    def slots(self) -> int:
        magic, slots = struct.unpack_from("<II", self.buf, 0)
        if magic != RING_MAGIC:
            raise OSError("ring magic mismatch (stale or torn file)")
        return slots

    # -- client half ---------------------------------------------------------

    def post(self, descs: List[Tuple[int, int, int]]) -> int:
        """Write one round's descriptors and bump ``round``; returns
        the round number the doorbell op must quote.  Descriptor order
        is completion order — the daemon walks slots [0, n)."""
        if len(descs) > self.slots:
            raise OSError(f"{len(descs)} descriptors > "
                          f"{self.slots} ring slots")
        for i, (off, ln, seq) in enumerate(descs):
            struct.pack_into("<QQQII", self.buf,
                             RING_HDR_BYTES + i * RING_SLOT_BYTES,
                             off, ln, seq, RING_PENDING, 0)
        rnd = struct.unpack_from("<Q", self.buf, 8)[0] + 1
        struct.pack_into("<Q", self.buf, 16, len(descs))
        struct.pack_into("<Q", self.buf, 8, rnd)
        return rnd

    def completion(self) -> Tuple[int, int]:
        """(completed_round, completed) — the daemon's published
        cursor."""
        return struct.unpack_from("<QQ", self.buf, 24)

    def statuses(self, n: int) -> List[int]:
        return [struct.unpack_from(
                    "<I", self.buf,
                    RING_HDR_BYTES + i * RING_SLOT_BYTES + 24)[0]
                for i in range(n)]

    # -- daemon half ---------------------------------------------------------

    def read_descs(self, n: int) -> List[Tuple[int, int, int]]:
        return [struct.unpack_from(
                    "<QQQ", self.buf,
                    RING_HDR_BYTES + i * RING_SLOT_BYTES)[:3]
                for i in range(n)]

    def begin_round(self, rnd: int) -> None:
        """Publish "working on `rnd`, nothing done yet" — ``completed``
        first, then the round echo (the order the client trusts)."""
        struct.pack_into("<Q", self.buf, 32, 0)
        struct.pack_into("<Q", self.buf, 24, rnd)

    def complete(self, i: int, status: int, done: int) -> None:
        """Publish slot ``i``'s verdict, then advance the cursor."""
        struct.pack_into("<I", self.buf,
                         RING_HDR_BYTES + i * RING_SLOT_BYTES + 24,
                         status)
        struct.pack_into("<Q", self.buf, 32, done)
