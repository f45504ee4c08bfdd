"""Pipelined DCN transfers: chunked phase overlap + striped streams.

The serial ``exchange_shard`` hot path pays the SUM of its phases:
stage the whole payload, wait, send the whole payload, wait, read —
even though stage/send/land are independent per chunk.  This module is
the client half of the pipelined mode (the daemon half lives in
``fleet/xferd.py``): payloads above a threshold are split into chunks
and striped across N concurrent data-plane/control connections, so
chunk *k+1* is being staged into the local daemon while chunk *k* is
in flight to the peer — the FlexLink striping + T3 phase-overlap
result (PAPERS.md) applied to the daemon protocol this stack already
has.

Anatomy of one pipelined transfer (``send_pipelined``):

- the payload is cut on a fixed chunk grid (``TPU_DCN_CHUNK_BYTES``);
- a dedicated STAGER thread streams chunks into the LOCAL daemon over
  one persistent data-plane socket (v2 frames with
  ``off``/``tot``/``xid`` meta and seq 0 — dedup-exempt staging),
  while N STRIPE senders, each owning its own control connection,
  issue offset-``send`` ops — the daemon parks each op until its chunk
  finishes landing locally, so chunk *k+1* is staging while chunk *k*
  streams to the peer, and each stripe's sends ride a distinct
  persistent daemon→peer TCP stream;
- every chunk carries its own client-assigned per-flow seq, so the
  receiver's dedup window gives exactly-once PER CHUNK: a retransmit
  round re-sends under the SAME seqs and only genuinely-lost chunks
  land;
- retry rounds: chunks whose send failed transport-level, or whose
  fleet-link verdict came back ``dropped``, are re-staged and re-sent
  (the primary resilient client heals the control plane between
  rounds); chunks that landed dedup away.

The defaults (1 MiB chunks, 2 stripes) are tuned for the loopback
rig, where per-chunk thread handoffs cost more than bandwidth and
wide fan-out loses to scheduling; on real cross-slice NICs smaller
chunks and more stripes is the FlexLink +27% — that is exactly what
the env knobs are for.  With ``TPU_DCN_TUNE`` on, the static grid is
only the BASE: a per-destination closed-loop controller
(``parallel/dcn_tune.py``) adapts chunk size and stripe count from
the transfer's own telemetry — chunk moves latch at transfer
boundaries (the seq/dedup contract pins the grid mid-transfer),
stripe moves also apply between retry rounds.

``read_pipelined`` is the stripe reader: it waits for the peer's frame
to finish assembling (the daemon's blocking ``wait`` op), then fetches
contiguous slabs in parallel over raw data-plane ``DXR1`` requests —
no base64, no 512 KiB control-socket chunking.

On top of both sits the **memcpy-speed same-host plane**: when the
daemon advertises ``shm`` in its handshake AND its ``host_id`` matches
this process's boot identity, staging becomes
memoryview writes into the flow's mmap segment plus one
``shm_commit`` control op, and read-back becomes ``shm_read`` + a
client-side mapping instead of DXR1 socket copies.  Per-chunk control
ops collapse too: the client posts the round's (off, len, seq)
descriptors into the flow's ring file and fires ONE ``shm_post``
doorbell — deliberately BEFORE the staging memcpy, so the daemon's
completer (parked on the descriptors' stage-waits) finishes the round
behind the memcpy and the lane's exposed-comm ratio drops instead of
sitting serial-shaped — then polls the completion cursor lock-free
out of its own mapping.  The daemon→peer leg takes the daemon↔daemon
segment lane on its own handshake when the PEER is co-hosted too
(fleet/xferd.py), and every control decision (seq assignment, dedup,
``wait``, fabric verdicts) is untouched, so exactly-once semantics
are identical on every lane.  Lane selection happens PER RETRY ROUND:
a daemon that restarts without the capability mid-transfer downgrades
the remaining rounds to the socket lane (``dcn.shm.fallback``) under
the same chunk seqs — cross-host peers and capability-less daemons
simply never leave it; ring trouble falls back to per-chunk control
ops (``dcn.shm.ring.fallback``) without leaving the shm lane.

All of it falls back loudly (``DcnXferError``) rather than silently:
the callers (``dcn.exchange_shard``, the fleet ring workload) own the
serial fallback and the leg-level retry.

The port's own copy of the JAX package's ``parallel/dcn_pipeline.py`` (host
code: no torch): the frames, the lanes, ``TPU_DCN_*`` and the ``dcn.*``
series are the same, so it drives either package's daemon.
"""

import json
import logging
import os
import socket
import struct
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from container_engine_accelerators_tpu_torch.metrics import counters
from container_engine_accelerators_tpu_torch.obs import critpath, histo, timeseries, trace
from container_engine_accelerators_tpu_torch.parallel import dcn_shm, dcn_tune
from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
    DcnWaitUnsupported,
    DcnXferClient,
    DcnXferError,
)
from container_engine_accelerators_tpu_torch.utils import netio

log = logging.getLogger(__name__)

CHUNK_BYTES_ENV = "TPU_DCN_CHUNK_BYTES"
STRIPES_ENV = "TPU_DCN_STRIPES"
PIPELINE_ENV = "TPU_DCN_PIPELINE"
SHM_ENV = dcn_shm.SHM_ENV

DEFAULT_CHUNK_BYTES = 1 << 20
DEFAULT_STRIPES = 2
DEFAULT_MAX_ROUNDS = 3

# Hard cap on chunks per transfer: a retransmit must be able to re-send
# chunk 1 after every other chunk landed, so the whole transfer's seq
# span has to fit inside the receiver's dedup window with headroom
# (fleet/xferd.py DEDUP_WINDOW = 256; the cross-test in
# tests/test_torch_dcn_pipeline.py pins 2 * MAX_CHUNKS <= DEDUP_WINDOW).
# Oversized payloads get their chunk size raised, not their tail cut.
MAX_CHUNKS_PER_TRANSFER = 128

# Wire constants — deliberately duplicated from fleet/xferd.py, the
# same way DcnXferClient.put duplicates the DXF1 header: the client
# must be importable without the fleet package, and the cross-test in
# tests/test_torch_dcn_pipeline.py pins both sides to the same bytes.
_MAGIC_V2 = b"DXF2"
_MAGIC_READ = b"DXR1"


class PipelineConfig:
    """Chunk/stripe knobs, resolved env-first (the Job manifest
    contract, like DCN_UDS_DIR)."""

    def __init__(self, chunk_bytes: Optional[int] = None,
                 stripes: Optional[int] = None,
                 max_rounds: int = DEFAULT_MAX_ROUNDS,
                 env=None, shm: Optional[bool] = None,
                 tuned: Optional[bool] = None,
                 shm_direct: Optional[bool] = None,
                 ring: Optional[bool] = None):
        env = env if env is not None else os.environ
        if chunk_bytes is None:
            chunk_bytes = int(env.get(CHUNK_BYTES_ENV,
                                      DEFAULT_CHUNK_BYTES))
        if stripes is None:
            stripes = int(env.get(STRIPES_ENV, DEFAULT_STRIPES))
        self.chunk_bytes = max(1, int(chunk_bytes))
        self.stripes = max(1, int(stripes))
        self.max_rounds = max(1, int(max_rounds))
        self.enabled = env.get(PIPELINE_ENV, "1") not in ("0", "false",
                                                          "off")
        # Zero-copy same-host lane kill switch (TPU_DCN_SHM): ``shm``
        # here means "MAY take the lane" — the daemon capability and
        # the host-identity match still gate each transfer.
        self.shm = (dcn_shm.shm_enabled(env) if shm is None
                    else bool(shm))
        # Daemon↔daemon segment lane pin (TPU_DCN_SHM_DIRECT): False
        # stamps ``direct: 0`` on every send op, pinning the daemon's
        # peer leg to TCP — how the bench keeps its socket series
        # honest and the parity scenarios choose their lane.  True
        # leaves the daemon's own probe-and-fallback in charge.
        self.shm_direct = (dcn_shm.shm_direct_enabled(env)
                           if shm_direct is None else bool(shm_direct))
        # Descriptor-ring handoff pin (TPU_DCN_SHM_RING): False keeps
        # shm rounds on per-chunk control ops — the legacy-shape
        # chaos tests' handle, and the escape hatch if a ring
        # regression ever ships.
        self.ring = (dcn_shm.shm_ring_enabled(env)
                     if ring is None else bool(ring))
        # Closed-loop grid control (parallel/dcn_tune.py): the
        # configured chunk/stripe grid becomes the controller's BASE,
        # adapted per destination from its own telemetry.  ON by
        # default (the soak world gates the loop); TPU_DCN_TUNE=0 is
        # the kill switch pinning the static grid byte-for-byte.
        self.tuned = (dcn_tune.tune_enabled(env) if tuned is None
                      else bool(tuned))

    def __repr__(self):
        return (f"PipelineConfig(chunk_bytes={self.chunk_bytes}, "
                f"stripes={self.stripes}, shm={self.shm}, "
                f"shm_direct={self.shm_direct}, "
                f"tuned={self.tuned})")


def plan_chunks(nbytes: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    """The fixed chunk grid for one payload: (offset, length) pairs
    covering [0, nbytes) exactly, every chunk ``chunk_bytes`` long
    except a shorter tail."""
    return [(off, min(chunk_bytes, nbytes - off))
            for off in range(0, nbytes, chunk_bytes)]


def should_pipeline(client, nbytes: int,
                    cfg: Optional[PipelineConfig] = None) -> bool:
    """Pipeline iff it can help AND the daemon speaks the protocol:
    more than one chunk's worth of payload, a v2-frame daemon with the
    pipeline extensions (PyXferd; the native daemon is DXF1-only until
    its DXF2 port lands — ROADMAP), and no env kill switch."""
    cfg = cfg or PipelineConfig()
    if not cfg.enabled or nbytes <= cfg.chunk_bytes:
        return False
    try:
        return (client.frame_version() >= 2
                and client.supports_pipeline())
    except (DcnXferError, OSError, AttributeError):
        return False


def shm_same_host(client) -> bool:
    """The daemon offers the shm lane AND lives on this machine.
    Identity is the handshake's ``host_id`` (boot id + hostname)
    compared to ours — never the socket address: a forwarded UDS or a
    shared loopback across a netns boundary is "same address" without
    being "same filesystem"."""
    try:
        caps = client.capabilities()
    except (DcnXferError, OSError, AttributeError):
        return False
    return (bool(caps.get("shm"))
            and caps.get("host_id") == dcn_shm.host_identity())


def ring_same_host(client) -> bool:
    """The daemon offers the UNIVERSAL submission ring AND lives on
    this machine — the socket lane's descriptor-handoff gate.  The
    ring file is mmapped (descriptors and cursors, not payload), so
    the same host-identity rule as the shm lane applies: never the
    socket address."""
    try:
        caps = client.capabilities()
    except (DcnXferError, OSError, AttributeError):
        return False
    return (bool(caps.get("ring"))
            and caps.get("host_id") == dcn_shm.host_identity())


def _chunk_frame_header(flow: str, payload_len: int,
                        meta: dict) -> bytes:
    """v2 frame header for a seq-0 staging chunk (the payload follows
    separately so large chunks need no concat copy)."""
    name = flow.encode()
    meta_b = json.dumps(meta).encode()
    return (_MAGIC_V2 + struct.pack("<I", len(name))
            + struct.pack("<Q", payload_len) + struct.pack("<Q", 0)
            + struct.pack("<I", len(meta_b)) + name + meta_b)


def _read_request(flow: str, offset: int, nbytes: int) -> bytes:
    """One DXR1 request — same deliberate duplication as
    `_chunk_frame_header` (pinned against fleet/xferd's
    ``encode_read_request`` in tests/test_torch_dcn_pipeline.py)."""
    name = flow.encode()
    return (_MAGIC_READ + struct.pack("<I", len(name))
            + struct.pack("<Q", offset) + struct.pack("<Q", nbytes)
            + name)


def fetch_range(host: str, port: int, flow: str, offset: int,
                nbytes: int, sock: Optional[socket.socket] = None,
                timeout_s: float = 30.0) -> bytes:
    """One DXR1 binary read-back: staged bytes [offset, offset+nbytes)
    of ``flow`` from the daemon's data port, raw over TCP.  Returns
    short (possibly empty) when the flow has no completed frame there.
    """
    req = _read_request(flow, offset, nbytes)
    own = sock is None
    if own:
        sock = socket.create_connection((host, port), timeout=timeout_s)
        _set_nodelay(sock)
    try:
        netio.sendall(sock, req)
        hdr = _recv_exact(sock, 8)
        avail = struct.unpack("<Q", hdr)[0]
        return _recv_exact(sock, avail)
    finally:
        if own:
            sock.close()


def _set_nodelay(sock: socket.socket) -> None:
    """Header+payload write pairs lose milliseconds per chunk to
    Nagle/delayed-ACK coupling; the pipeline's win lives there."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


# Exact reads and capped short-write-proof sends live in utils/netio
# (this rig's stack truncates very large single-syscall payloads).
_recv_exact = netio.recv_exact


class _StripeResult:
    """Shared per-transfer scoreboard: chunk index -> verdict, plus
    the monotonic phase intervals the exposed-communication accounting
    needs (``stage`` = local staging, ``comm`` = daemon round trips
    that move/settle bytes toward the peer)."""

    def __init__(self):
        self.verdicts: Dict[int, str] = {}
        self.errors: List[BaseException] = []
        self.phases: Dict[str, List[Tuple[float, float]]] = {}
        self._lock = threading.Lock()

    def record(self, idx: int, verdict: str) -> None:
        with self._lock:
            self.verdicts[idx] = verdict

    def fail(self, exc: BaseException) -> None:
        with self._lock:
            self.errors.append(exc)

    def phase(self, kind: str, t0: float, t1: float) -> None:
        with self._lock:
            self.phases.setdefault(kind, []).append((t0, t1))


def _stage_worker(data_host: str, data_port: int, flow: str, data,
                  chunks, idxs, xid: str, total: int,
                  timeout_s: float, result: _StripeResult,
                  ctx: Optional[dict]) -> None:
    """The stager: stream chunks into the LOCAL daemon over one
    persistent data socket, as fast as the kernel takes them.  The
    stripe senders' offset-sends park daemon-side until each chunk has
    landed, so staging chunk *k+1* genuinely overlaps sending chunk
    *k* — the phase-overlap half of the pipeline."""
    view = memoryview(data)
    dsock = None
    try:
        with trace.attach(ctx.get("trace") if ctx else None,
                          ctx.get("span") if ctx else None):
            dsock = socket.create_connection((data_host, data_port),
                                             timeout=timeout_s)
            _set_nodelay(dsock)
            for idx in idxs:
                off, ln = chunks[idx]
                t0 = time.monotonic()
                try:
                    with trace.span("dcn.chunk.stage",
                                    histogram="dcn.chunk.stage",
                                    flow=flow, off=off, bytes=ln):
                        netio.sendall_parts(dsock, (
                            _chunk_frame_header(flow, ln, {
                                "off": off, "tot": total, "xid": xid,
                            }),
                            view[off:off + ln],
                        ))
                finally:
                    result.phase("stage", t0, time.monotonic())
    except (DcnXferError, OSError) as e:
        result.fail(e)
    finally:
        if dsock is not None:
            try:
                dsock.close()
            except OSError:
                pass


def _send_chunk(ctl, flow: str, chunks, seqs, idx: int, xid: str,
                host: str, port: int, total: int, timeout_s: float,
                result: _StripeResult,
                lane: Optional[str] = None,
                direct: Optional[int] = None) -> None:
    """Issue one offset-send and score its verdict — shared by the
    stripe workers and the shm round, so the settled-verdict set and
    the confirmed-chunk accounting can never diverge between lanes.
    ``direct=0`` pins the daemon's peer leg to TCP (the socket
    series' honesty guarantee); None leaves the daemon's own
    shm_direct probe in charge.  Raises on control-connection
    trouble; the caller owns what the unrecorded chunks mean then."""
    off, ln = chunks[idx]
    span_attrs = {"lane": lane} if lane else {}
    req = dict(
        op="send", flow=flow, host=host, port=str(port),
        seq=seqs[idx], offset=off, bytes=ln, total=total, xid=xid,
        stage_wait_ms=int(min(timeout_s, 5.0) * 1e3),
    )
    if direct is not None:
        req["direct"] = direct
    timeseries.gauge_add("dcn.chunks.inflight", 1)
    t0 = time.monotonic()
    try:
        with trace.span("dcn.chunk.send", histogram="dcn.chunk.send",
                        flow=flow, off=off, bytes=ln, seq=seqs[idx],
                        **span_attrs):
            resp = ctl._call(**req)
    finally:
        timeseries.gauge_add("dcn.chunks.inflight", -1)
        result.phase("comm", t0, time.monotonic())
    verdict = resp.get("verdict", "sent")
    if verdict in ("sent", "landed", "dup"):
        # Count CONFIRMED chunks only (the README table's contract);
        # dropped/unmatched retransmit attempts show up in
        # dcn.pipeline.retry_rounds instead.
        counters.inc("dcn.pipeline.chunks")
        timeseries.record("dcn.pipeline.tx.bytes", ln)
    result.record(idx, verdict)


def _send_worker(uds_dir: str, flow: str, chunks, seqs, idxs,
                 xid: str, host: str, port: int, total: int,
                 timeout_s: float, result: _StripeResult,
                 ctx: Optional[dict],
                 direct: Optional[int] = None) -> None:
    """One stripe sender: its own control connection, issuing
    offset-sends for its share of the chunk grid.  Each stripe's
    chunks ride a distinct persistent daemon→peer stream (the daemon
    keys outbound connections by control connection), which is the
    striping half of the pipeline."""
    ctl = None
    timeseries.gauge_add("dcn.stripes.active", 1)
    try:
        with trace.attach(ctx.get("trace") if ctx else None,
                          ctx.get("span") if ctx else None):
            ctl = DcnXferClient(uds_dir, timeout_s=max(timeout_s, 10.0))
            for idx in idxs:
                _send_chunk(ctl, flow, chunks, seqs, idx, xid, host,
                            port, total, timeout_s, result,
                            direct=direct)
    except (DcnXferError, OSError) as e:
        # The scoreboard decides what to retry; this stripe's remaining
        # chunks simply stay unrecorded.
        result.fail(e)
    finally:
        timeseries.gauge_add("dcn.stripes.active", -1)
        if ctl is not None:
            try:
                ctl.close()
            except OSError:
                pass


def _shm_stage(ctl, flow: str, data, chunks, attach_resp: dict,
               xid: str, result: _StripeResult) -> None:
    """Memcpy the payload into the flow's segment and declare it
    staged with ONE in-place ``shm_commit``.  Raises on any shortfall
    (segment unmappable, commit refused) — the caller owns what that
    means for the round."""
    nbytes = len(data)
    seg = None
    t0 = time.monotonic()
    try:
        with trace.span("dcn.shm.stage", histogram="dcn.shm.stage",
                        flow=flow, bytes=nbytes, xid=xid):
            seg = dcn_shm.map_segment(
                attach_resp.get("path", ""),
                int(attach_resp.get("bytes") or 0))
            if seg.size < nbytes:
                raise OSError("segment smaller than payload")
            src = memoryview(data)
            for off, ln in chunks:
                seg.view[off:off + ln] = src[off:off + ln]
            ctl.shm_commit(flow, nbytes, xid)
    finally:
        if seg is not None:
            seg.close()
        result.phase("stage", t0, time.monotonic())
    timeseries.record("dcn.shm.tx.bytes", nbytes)
    timeseries.record("dcn.lane.shm.bytes", nbytes)
    timeseries.gauge_add("dcn.lane.shm.total_bytes", nbytes)


# Completion-poll backoff: the cursor lives in shared memory, so each
# read is effectively free — but on an in-process rig (the bench, the
# unit suites) the daemon needs the GIL to make progress, so the poll
# yields from the very first iteration (sleep(0) = GIL release) and
# backs off to 50 µs / 500 µs — still far below one control round
# trip per chunk, which is the whole point of the handoff.
_RING_SPIN_FAST = 50
_RING_SPIN_SLOW = 400


def _score_ring_slots(batch, chunks, statuses, scored,
                      result: _StripeResult) -> None:
    """Score the first ``scored`` slots of one posted batch.  The
    ring's publication order (slot status BEFORE cursor advance)
    makes every slot below the cursor valid even when the round
    timed out mid-completion — partial credit, so a SIGKILLed
    completer costs only the genuinely unconfirmed chunks."""
    for slot in range(scored):
        idx = batch[slot]
        verdict = dcn_shm.RING_VERDICTS.get(statuses[slot], "error")
        if verdict in ("sent", "landed", "dup"):
            # Same confirmed-chunk accounting as _send_chunk — the
            # two handoff shapes must never diverge in the books.
            counters.inc("dcn.pipeline.chunks")
            timeseries.record("dcn.pipeline.tx.bytes", chunks[idx][1])
        result.record(idx, verdict)


def _ring_round(ctl, ring, flow: str, data, chunks, seqs, idxs,
                xid: str, host: str, port: int, timeout_s: float,
                result: _StripeResult, attach_resp: dict,
                staged_already: bool, direct_pin: Optional[int],
                stage=None) -> Optional[bool]:
    """One descriptor-ring round: post (off, len, seq) descriptors
    into the flow's ring, fire ONE ``shm_post`` doorbell, stage the
    payload while the daemon's completer parks on the descriptors'
    stage-waits, then poll the completion cursor lock-free out of the
    client's own mapping and score the per-slot verdicts.

    The doorbell deliberately precedes the staging memcpy: the
    daemon-side completion window then COVERS the staging interval,
    so the exposed-communication accounting shows the handoff hiding
    control time behind the memcpy — the GPU-initiated-networking
    shape (post work once, let the data plane complete it).

    ``stage`` overrides the whole-payload memcpy+commit with a
    caller-supplied per-batch callback ``stage(ctl, attach_resp,
    batch_idxs)`` — the producer-fed overlap path stages each chunk
    as it is produced, AFTER the doorbell, so production itself
    hides the DCN leg.

    Rounds larger than the ring post in ring-sized batches: the
    poster BLOCKS until the previous batch's cursor caught up
    (``dcn.ring.backpressure`` per extra doorbell) — descriptors are
    never dropped.

    Returns True (round ran; scoreboard holds the verdicts — possibly
    with chunks left pending for the next round), False (the shm
    staging itself broke: caller downgrades to the socket lane), or
    None (the ring handoff is unusable while shm staging may still
    be fine: caller falls back to per-chunk control ops)."""
    nbytes = len(data)
    try:
        slots = ring.slots
    except (OSError, struct.error):
        return None
    deadline = time.monotonic() + timeout_s
    staged = staged_already
    for bstart in range(0, len(idxs), slots):
        batch = idxs[bstart:bstart + slots]
        n = len(batch)
        if bstart:
            # Only reachable after the previous batch's completion
            # poll drained — the blocked-poster half of the
            # backpressure contract.
            counters.inc("dcn.ring.backpressure")
        try:
            rnd = ring.post([(chunks[i][0], chunks[i][1], seqs[i])
                             for i in batch])
        except (OSError, ValueError, struct.error):
            return None if not bstart else True
        t0 = time.monotonic()
        timeseries.gauge_add("dcn.chunks.inflight", n)
        timed_out = False
        scored = 0
        try:
            # ONE span from doorbell to completion: this is the ring
            # lane's whole DCN leg as the client sees it, so injected
            # link latency (and any daemon-side stall) attributes HERE
            # in a critical-path walk — the `dcn.chunk.send` analog.
            # The staging memcpy nests under it as a child, which is
            # exactly the overlap story the exposed-comm accounting
            # tells.
            with trace.span("dcn.shm.post", histogram="dcn.shm.post",
                            flow=flow, chunks=n, xid=xid):
                try:
                    ctl.shm_post(flow, n, rnd, xid, nbytes, host,
                                 port, direct=direct_pin,
                                 stage_wait_ms=int(min(timeout_s, 5.0)
                                                   * 1e3))
                except (DcnXferError, OSError) as e:
                    result.fail(e)
                    return None if not bstart else True
                if not staged or stage is not None:
                    try:
                        if stage is not None:
                            stage(ctl, attach_resp, batch)
                        else:
                            _shm_stage(ctl, flow, data, chunks,
                                       attach_resp, xid, result)
                            staged = True
                    except (DcnXferError, OSError) as e:
                        # The posted descriptors' stage-waits expire
                        # on the daemon side; nothing lands under
                        # their seqs.
                        result.fail(e)
                        return False
                spins = 0
                while True:
                    try:
                        crnd, done = ring.completion()
                    except (ValueError, struct.error):
                        return None if not bstart else True
                    cur = done if crnd == rnd else 0
                    if cur >= n:
                        scored = n
                        break
                    if time.monotonic() >= deadline:
                        timed_out = True
                        scored = cur
                        break
                    spins += 1
                    if spins > _RING_SPIN_SLOW:
                        time.sleep(0.0005)
                    elif spins > _RING_SPIN_FAST:
                        time.sleep(0.00005)
                    else:
                        time.sleep(0)  # GIL yield: daemon may BE us
                try:
                    statuses = ring.statuses(n)
                except (ValueError, struct.error):
                    return None if not bstart else True
        finally:
            timeseries.gauge_add("dcn.chunks.inflight", -n)
            result.phase("comm", t0, time.monotonic())
        _score_ring_slots(batch, chunks, statuses, scored, result)
        if timed_out:
            # Unfinished handoff: unscored chunks stay pending; the
            # next retry round re-sends them under the SAME seqs
            # (the completer's late sends dedup away).
            result.fail(DcnXferError(
                f"ring round for {flow!r} timed out at "
                f"{scored}/{n}"))
            return True
    return True


def _shm_round(uds_dir: str, flow: str, data, chunks, seqs, idxs,
               xid: str, host: str, port: int, timeout_s: float,
               result: _StripeResult, ctx: Optional[dict],
               already_staged: bool = False,
               direct_pin: Optional[int] = None,
               use_ring: bool = True,
               stage=None, prepare=None) -> bool:
    """One zero-copy-lane round: descriptor-ring handoff when the
    daemon offers it (one doorbell per round, completion polled out
    of shared memory), per-chunk offset-sends on a dedicated
    fail-fast control connection otherwise — either way no stager
    thread and no stripe fan-out: staging is a memcpy, and this rig's
    thread handoffs cost more than they buy.

    ``already_staged`` means an earlier round of THIS transfer staged
    and committed the whole frame; when the daemon still holds it
    (``shm_attach`` reports the full ``frame_bytes`` — a restart would
    have reset that to 0 through flow replay), the memcpy and the
    re-commit are skipped and the round pays only for the chunks it
    re-sends.

    ``stage``/``prepare`` are the producer-overlap hooks: ``stage``
    replaces the whole-payload memcpy inside a ring round with a
    per-batch producer-fed callback; ``prepare`` (materialize the
    producer fully) runs before any NON-ring staging, whose
    whole-payload memcpy needs every byte present.

    Returns False when the shm machinery itself is unusable (attach
    rejected, segment unmappable, daemon gone) — the caller's signal
    to run the socket lane instead.  Send failures after a successful
    stage return True with the chunks left pending: the normal retry
    round re-sends them under the SAME seqs, on whichever lane is
    alive then."""
    nbytes = len(data)
    ctl = None
    ring_seg = None
    try:
        with trace.attach(ctx.get("trace") if ctx else None,
                          ctx.get("span") if ctx else None):
            try:
                ctl = DcnXferClient(uds_dir,
                                    timeout_s=max(timeout_s, 10.0))
                resp = ctl.shm_attach(flow, nbytes, ring=use_ring)
            except (DcnXferError, OSError) as e:
                result.fail(e)
                return False
            staged_already = (already_staged
                              and int(resp.get("frame_bytes") or 0)
                              >= nbytes)
            ring = None
            if use_ring and resp.get("ring_path"):
                try:
                    ring_seg = dcn_shm.map_segment(
                        resp["ring_path"],
                        dcn_shm.ring_bytes(
                            int(resp.get("ring_slots") or 0)))
                    ring = dcn_shm.RingView(ring_seg.view)
                except OSError:
                    ring = None
            if ring is not None:
                ran = _ring_round(ctl, ring, flow, data, chunks,
                                  seqs, idxs, xid, host, port,
                                  timeout_s, result, resp,
                                  staged_already, direct_pin,
                                  stage=stage)
                if ran is not None:
                    return ran
                counters.inc("dcn.shm.ring.fallback")
            # Per-chunk handoff (ring-less daemons, broken rings):
            # stage first, then serial offset-sends.
            if not staged_already:
                try:
                    if prepare is not None:
                        prepare()
                    _shm_stage(ctl, flow, data, chunks, resp, xid,
                               result)
                except (DcnXferError, OSError) as e:
                    result.fail(e)
                    return False
            for idx in idxs:
                try:
                    _send_chunk(ctl, flow, chunks, seqs, idx, xid,
                                host, port, nbytes, timeout_s, result,
                                lane="shm", direct=direct_pin)
                except (DcnXferError, OSError) as e:
                    # Staged fine; these chunks simply stay pending
                    # for the next round (same seqs, any lane).
                    result.fail(e)
                    return True
            return True
    finally:
        if ring_seg is not None:
            ring_seg.close()
        if ctl is not None:
            try:
                ctl.close()
            except OSError:
                pass


def _ring_socket_round(uds_dir: str, data_port: int, flow: str, data,
                       chunks, seqs, idxs, xid: str, host: str,
                       port: int, timeout_s: float,
                       result: _StripeResult, ctx: Optional[dict],
                       direct_pin: Optional[int],
                       fill_to=None) -> Optional[bool]:
    """The socket lane's descriptor-ring round: ``ring_attach`` maps
    the flow's ring WITHOUT a data segment, descriptors post + ONE
    ``shm_post`` doorbell, then the batch's chunk frames stream to
    the LOCAL daemon over one data socket while its completer drives
    the descriptors through the normal send machinery — the client
    never issues a per-chunk control op, and completion is polled
    lock-free out of the mmapped cursor.  Payload bytes still ride
    TCP; only submission/completion moved into shared memory, which
    is where the socket lane's exposed-comm time lived.

    ``fill_to`` is the producer hook: when set, each chunk is pulled
    from the producer right before its staging frame — production
    happens INSIDE the completion window, the overlap the T3 shape
    wants.

    Rounds larger than the ring post in ring-sized batches under
    backpressure, like :func:`_ring_round`.  Returns None when the
    ring handoff is unusable (no capability, attach refused, doorbell
    lost before any batch completed) — the caller falls back to the
    classic threaded round (``dcn.ring.fallback``) and re-sends the
    SAME seqs, which the receiver's dedup window referees.  True
    means the round ran; unconfirmed chunks stay pending."""
    nbytes = len(data)
    ctl = None
    ring_seg = None
    dsock = None
    try:
        with trace.attach(ctx.get("trace") if ctx else None,
                          ctx.get("span") if ctx else None):
            try:
                ctl = DcnXferClient(uds_dir,
                                    timeout_s=max(timeout_s, 10.0))
                resp = ctl.ring_attach(flow)
            except (DcnXferError, OSError) as e:
                result.fail(e)
                return None
            if not resp.get("ring_path"):
                return None
            try:
                ring_seg = dcn_shm.map_segment(
                    resp["ring_path"],
                    dcn_shm.ring_bytes(
                        int(resp.get("ring_slots") or 0)))
                ring = dcn_shm.RingView(ring_seg.view)
                slots = ring.slots
            except (OSError, ValueError, struct.error):
                return None
            try:
                dsock = socket.create_connection(
                    ("127.0.0.1", data_port), timeout=timeout_s)
                _set_nodelay(dsock)
            except OSError as e:
                result.fail(e)
                return None
            src = memoryview(data)
            deadline = time.monotonic() + timeout_s
            for bstart in range(0, len(idxs), slots):
                batch = idxs[bstart:bstart + slots]
                n = len(batch)
                if bstart:
                    # Blocked-poster backpressure: reached only after
                    # the previous batch's cursor drained.
                    counters.inc("dcn.ring.backpressure")
                try:
                    rnd = ring.post(
                        [(chunks[i][0], chunks[i][1], seqs[i])
                         for i in batch])
                except (OSError, ValueError, struct.error):
                    return None if not bstart else True
                t0 = time.monotonic()
                timeseries.gauge_add("dcn.chunks.inflight", n)
                timed_out = False
                scored = 0
                try:
                    with trace.span("dcn.ring.post",
                                    histogram="dcn.ring.post",
                                    flow=flow, chunks=n, xid=xid):
                        try:
                            ctl.shm_post(
                                flow, n, rnd, xid, nbytes, host, port,
                                direct=direct_pin,
                                stage_wait_ms=int(min(timeout_s, 5.0)
                                                  * 1e3))
                        except (DcnXferError, OSError) as e:
                            result.fail(e)
                            return None if not bstart else True
                        # Stage the batch AFTER the doorbell: frames
                        # stream while the completer parks on their
                        # stage-waits, so staging (and production)
                        # time hides inside the completion window.
                        try:
                            for i in batch:
                                off, ln = chunks[i]
                                ts0 = time.monotonic()
                                try:
                                    with trace.span(
                                            "dcn.chunk.stage",
                                            histogram="dcn.chunk.stage",
                                            flow=flow, off=off,
                                            bytes=ln):
                                        if fill_to is not None:
                                            fill_to(off + ln)
                                        netio.sendall_parts(dsock, (
                                            _chunk_frame_header(
                                                flow, ln, {
                                                    "off": off,
                                                    "tot": nbytes,
                                                    "xid": xid,
                                                }),
                                            src[off:off + ln],
                                        ))
                                finally:
                                    result.phase(
                                        "stage", ts0,
                                        time.monotonic())
                        except (DcnXferError, OSError) as e:
                            # Staging died mid-batch: the unstaged
                            # descriptors' stage-waits expire daemon-
                            # side; poll out whatever completed.
                            result.fail(e)
                        spins = 0
                        while True:
                            try:
                                crnd, done = ring.completion()
                            except (ValueError, struct.error):
                                return None if not bstart else True
                            cur = done if crnd == rnd else 0
                            if cur >= n:
                                scored = n
                                break
                            if time.monotonic() >= deadline:
                                timed_out = True
                                scored = cur
                                break
                            spins += 1
                            if spins > _RING_SPIN_SLOW:
                                time.sleep(0.0005)
                            elif spins > _RING_SPIN_FAST:
                                time.sleep(0.00005)
                            else:
                                time.sleep(0)  # GIL yield
                        try:
                            statuses = ring.statuses(n)
                        except (ValueError, struct.error):
                            return None if not bstart else True
                finally:
                    timeseries.gauge_add("dcn.chunks.inflight", -n)
                    result.phase("comm", t0, time.monotonic())
                _score_ring_slots(batch, chunks, statuses, scored,
                                  result)
                if timed_out:
                    result.fail(DcnXferError(
                        f"ring round for {flow!r} timed out at "
                        f"{scored}/{n}"))
                    return True
            return True
    finally:
        if dsock is not None:
            try:
                dsock.close()
            except OSError:
                pass
        if ring_seg is not None:
            ring_seg.close()
        if ctl is not None:
            try:
                ctl.close()
            except OSError:
                pass


def _observe_exposed(span, comm_iv, stage_iv) -> Optional[float]:
    """Exposed-communication time for one completed transfer: DCN
    round-trip time NOT overlapped by local staging (obs/critpath's
    interval algebra — the same math the offline analyzer applies to
    span trees).  Feeds the ``dcn.exposed`` / ``dcn.comm`` histogram
    pair (their run-delta sums are the ``max_exposed_comm_ratio`` SLO
    input) and the live ``dcn.exposed_ratio`` gauge: 1.0 = nothing
    hidden (the serial shape), 0.0 = the whole DCN leg rode behind
    staging (the T3 goal)."""
    comm_s = critpath.covered_s(comm_iv)
    if comm_s <= 0:
        return None
    exp_s = critpath.exposed_s(comm_iv, stage_iv)
    histo.observe("dcn.exposed", exp_s, trace_id=span.trace_id)
    histo.observe("dcn.comm", comm_s, trace_id=span.trace_id)
    ratio = exp_s / comm_s
    timeseries.gauge("dcn.exposed_ratio", ratio)
    span.annotate(exposed_ms=round(exp_s * 1e3, 3),
                  exposed_ratio=round(ratio, 4))
    return ratio


def _producer_buffer(producer, nbytes: int):
    """Materialize-on-demand buffer over a producer: a bytearray the
    transfer sends from, plus ``fill_to(end)`` pulling the iterator
    until ``[0, end)`` is filled.  The buffer doubles as the
    retransmit source — retry rounds re-send the SAME bytes under the
    SAME seqs out of it, so the exactly-once contract survives a
    producer that can only be consumed once."""
    it = iter(producer() if callable(producer) else producer)
    buf = bytearray(nbytes)
    state = {"filled": 0}

    def fill_to(end: int) -> None:
        end = min(int(end), nbytes)
        while state["filled"] < end:
            try:
                piece = next(it)
            except StopIteration:
                raise DcnXferError(
                    f"producer ended early at {state['filled']}/"
                    f"{nbytes} bytes") from None
            take = len(piece)
            if state["filled"] + take > nbytes:
                raise DcnXferError(
                    f"producer overran {nbytes} bytes")
            buf[state["filled"]:state["filled"] + take] = piece
            state["filled"] += take

    return buf, fill_to


def _producer_shm_stage(fill_to, flow: str, data, chunks, xid: str,
                        nbytes: int, result: _StripeResult):
    """Per-batch shm staging for the producer-fed ring round: pull
    each chunk from the producer, memcpy it into the segment, and
    declare just that range staged with a range ``shm_commit`` — the
    completer's stage-wait for that descriptor unblocks the moment
    the chunk exists, never waiting on the whole shard."""
    src = memoryview(data)

    def stage(ctl, attach_resp, batch) -> None:
        seg = dcn_shm.map_segment(
            attach_resp.get("path", ""),
            int(attach_resp.get("bytes") or 0))
        staged_bytes = 0
        try:
            if seg.size < nbytes:
                raise OSError("segment smaller than payload")
            for i in batch:
                off, ln = chunks[i]
                t0 = time.monotonic()
                try:
                    with trace.span("dcn.chunk.stage",
                                    histogram="dcn.chunk.stage",
                                    flow=flow, off=off, bytes=ln):
                        fill_to(off + ln)
                        seg.view[off:off + ln] = src[off:off + ln]
                        ctl.shm_commit(flow, ln, xid, offset=off,
                                       total=nbytes)
                finally:
                    result.phase("stage", t0, time.monotonic())
                staged_bytes += ln
        finally:
            seg.close()
            if staged_bytes:
                timeseries.record("dcn.shm.tx.bytes", staged_bytes)
                timeseries.record("dcn.lane.shm.bytes", staged_bytes)
                timeseries.gauge_add("dcn.lane.shm.total_bytes",
                                     staged_bytes)

    return stage


def send_pipelined(client, flow: str, data, host: str,
                   port: int, cfg: Optional[PipelineConfig] = None,
                   timeout_s: float = 60.0,
                   producer=None, nbytes: Optional[int] = None
                   ) -> dict:
    """Stage + send ``data`` on ``flow`` to the peer daemon at
    (host, port), chunked and striped, with chunk-granular retransmit.

    ``client`` is the primary (usually resilient) control client: it
    owns the flow registration, the per-flow seq counter, and the
    control-plane healing between retry rounds.  Returns
    ``{bytes, chunks, stripes, rounds, lane}`` (``lane`` is ``shm``,
    ``socket``, or ``shm+socket`` when a mid-transfer downgrade mixed
    them); raises :class:`DcnXferError` once the round budget is spent
    (callers own the serial fallback / leg retry).

    Lane selection is per retry round: a same-host daemon advertising
    ``shm`` gets the zero-copy staging round (no threads, one commit,
    serial sends); everything else — cross-host, capability-less,
    kill-switched, or a lane that broke mid-transfer
    (``dcn.shm.fallback``) — gets the threaded socket round.  Chunk
    seqs are fixed up front, so retransmits are exactly-once no matter
    which lane a round ran on.

    Producer mode (``producer`` + ``nbytes``, ``data=None``): the
    payload is pulled from an iterable of byte chunks AS THE FIRST
    ROUND STAGES, after the round's ONE doorbell — production
    overlaps the DCN leg instead of preceding it (the stage-then-send
    baseline).  A ring-less first round materializes the producer
    fully (``dcn.ring.fallback``) and runs the classic path; retry
    rounds always send from the materialized buffer under the SAME
    seqs.
    """
    cfg = cfg or PipelineConfig()
    fill_to = None
    if producer is not None:
        if data is not None:
            raise ValueError("pass data OR producer, not both")
        if not nbytes or int(nbytes) <= 0:
            raise ValueError("producer mode needs nbytes > 0")
        data, fill_to = _producer_buffer(producer, int(nbytes))
        counters.inc("dcn.ring.producer.transfers")
    nbytes = len(data)
    # Closed-loop grid control: the tuner (one per destination daemon)
    # turns the configured grid into this transfer's plan.  The chunk
    # grid LATCHES here for the whole transfer — it pins the seq block
    # the dedup window referees — while stripe moves also apply
    # between retry rounds below.  Kill switch off: tuner is None and
    # the static grid runs byte-for-byte.
    tuner = (dcn_tune.tuner_for(f"{host}:{port}")
             if cfg.tuned else None)
    if tuner is not None:
        chunk_bytes, planned_stripes = tuner.plan(cfg.chunk_bytes,
                                                  cfg.stripes)
    else:
        chunk_bytes, planned_stripes = cfg.chunk_bytes, cfg.stripes
    if nbytes > chunk_bytes * MAX_CHUNKS_PER_TRANSFER:
        # More chunks than the dedup window can referee would turn a
        # late retransmit into a silent 'dup' drop; grow the chunks.
        # For a tuned plan this is the protocol floor the shrink lever
        # cannot pass (nbytes/128 beats any learned grid), so the plan
        # gauge is republished with the EFFECTIVE chunk — the wire and
        # the dashboard must not disagree.
        grid = chunk_bytes
        chunk_bytes = -(-nbytes // MAX_CHUNKS_PER_TRANSFER)
        if tuner is not None:
            timeseries.gauge("dcn.tune.chunk_bytes",
                             float(chunk_bytes))
        log.warning(
            "chunk size raised %d -> %d for a %d-byte transfer "
            "(dedup-window cap of %d chunks)", grid,
            chunk_bytes, nbytes, MAX_CHUNKS_PER_TRANSFER,
        )
    chunks = plan_chunks(nbytes, chunk_bytes)
    if not chunks:
        # Empty payloads never reach here through should_pipeline, but
        # the public contract must not divide by the chunk count.
        return {"bytes": 0, "chunks": 0, "stripes": 0, "rounds": 0,
                "lane": "none"}
    stripes = min(planned_stripes, len(chunks))
    # One logical transfer = one xid (the receiver's assembly key) and
    # one contiguous block of per-flow seqs.  A retransmit round reuses
    # BOTH: that is what lets the dedup window kill replays per chunk.
    xid = uuid.uuid4().hex[:12]
    base = client._send_seq.get(flow, 0)
    client._send_seq[flow] = base + len(chunks)
    seqs = [base + 1 + i for i in range(len(chunks))]
    counters.inc("dcn.pipeline.transfers")
    # Stripe utilization = dcn.stripes.active / dcn.stripes.configured
    # on the scrape; configured reflects the most recent transfer.
    timeseries.gauge("dcn.stripes.configured", stripes)
    uds_dir = client._uds_dir
    # Daemon↔daemon lane pin for every send op of this transfer:
    # ``0`` forces the peer leg onto TCP, None defers to the sending
    # daemon's own probe (host-identity handshake + env switch).
    direct_pin = None if cfg.shm_direct else 0
    pending = list(range(len(chunks)))
    resent = 0  # chunk-sends beyond the first round (retransmits)
    lanes = set()  # lanes that actually ran a round
    shm_broken = False  # shm machinery failed once: stay on sockets
    ring_broken = False  # socket-ring handoff failed once: classic
    # Exposed-communication accounting across ALL rounds: staging
    # intervals vs daemon-round-trip intervals, unioned per transfer —
    # retransmit rounds are honest cost, not excluded noise.
    stage_iv: List[Tuple[float, float]] = []
    comm_iv: List[Tuple[float, float]] = []
    with trace.span("dcn.pipeline", histogram="dcn.pipeline",
                    flow=flow, bytes=nbytes, chunks=len(chunks),
                    stripes=stripes, xid=xid) as span:
        ctx = trace.context()
        last_errors: List[BaseException] = []
        # One wall-clock budget for the WHOLE transfer, rounds and
        # joins included — not timeout_s per join per round, which
        # would multiply a wedged daemon's stall by rounds * stripes.
        deadline = time.monotonic() + timeout_s
        for rnd in range(cfg.max_rounds):
            if time.monotonic() >= deadline:
                break
            if rnd:
                counters.inc("dcn.pipeline.retry_rounds")
                resent += len(pending)
                if fill_to is not None:
                    # Retry rounds send from the materialized buffer:
                    # a first round that died mid-production must not
                    # retransmit half-filled chunks.
                    fill_to(nbytes)
                # Heal before retrying: a resilient primary reconnects
                # and replays the flow table here, so the fresh stripe
                # connections below land on a daemon that knows `flow`
                # — and re-probes capabilities, which is how a daemon
                # that restarted WITHOUT shm downgrades the remaining
                # rounds to the socket lane.
                client.ping()
                if tuner is not None:
                    # Stripe moves apply BETWEEN retry rounds too:
                    # re-striping pending chunk indices is seq-safe
                    # (the chunk grid and its seqs stay latched).
                    stripes = min(max(1, tuner.stripes_now()),
                                  len(pending))
                    timeseries.gauge("dcn.stripes.configured",
                                     stripes)
            attempted = len(pending)
            round_t0 = time.monotonic()
            result = _StripeResult()
            # Zero-copy lane, decided per round: kill switch off, the
            # machinery has not failed this transfer, and the daemon
            # both offers shm and shares our boot identity.
            ran_shm = False
            producer_round = fill_to is not None and rnd == 0
            if cfg.shm and not shm_broken and shm_same_host(client):
                stage_cb = (_producer_shm_stage(fill_to, flow, data,
                                                chunks, xid, nbytes,
                                                result)
                            if producer_round and cfg.ring else None)
                prepare_cb = ((lambda: fill_to(nbytes))
                              if producer_round else None)
                ran_shm = _shm_round(uds_dir, flow, data, chunks,
                                     seqs, list(pending), xid, host,
                                     port, timeout_s, result, ctx,
                                     already_staged="shm" in lanes,
                                     direct_pin=direct_pin,
                                     use_ring=cfg.ring,
                                     stage=stage_cb,
                                     prepare=prepare_cb)
                if ran_shm:
                    if "shm" not in lanes:
                        counters.inc("dcn.shm.transfers")
                    lanes.add("shm")
                else:
                    shm_broken = True
                    counters.inc("dcn.shm.fallback")
                    log.warning(
                        "shm staging of %r unavailable (%s); falling "
                        "back to the socket lane", flow,
                        result.errors[-1] if result.errors else "?",
                    )
            ran_ring = False
            if (not ran_shm and cfg.ring and not ring_broken
                    and ring_same_host(client)):
                # Descriptor-driven socket lane: same universal ring,
                # payload over TCP — no per-chunk control op on the
                # hot path.
                ran = _ring_socket_round(
                    uds_dir, client.data_port(), flow, data, chunks,
                    seqs, list(pending), xid, host, port, timeout_s,
                    result, ctx, direct_pin,
                    fill_to=fill_to if producer_round else None)
                if ran is None:
                    # Completer/capability gone (daemon death, ring
                    # refused): transparent downgrade to the classic
                    # per-chunk path — the SAME seqs re-send below,
                    # so late completer sends dedup away.
                    ring_broken = True
                    counters.inc("dcn.ring.fallback")
                    log.warning(
                        "socket-ring handoff of %r unavailable (%s); "
                        "falling back to the classic socket round",
                        flow,
                        result.errors[-1] if result.errors else "?",
                    )
                else:
                    ran_ring = True
                    lanes.add("socket")
                    counters.inc("dcn.ring.socket.rounds")
            if not ran_shm and not ran_ring:
                if fill_to is not None:
                    # Ring-less classic round: the stage worker
                    # memcpys from the buffer, so materialize first.
                    fill_to(nbytes)
                lanes.add("socket")
                data_port = client.data_port()
                # The round's "wait" phase: the coordinator parked on
                # its stage/stripe workers.  The worker spans parent
                # UNDER it (wctx), so its SELF time is exactly the
                # un-attributed remainder — thread spawn + join tail —
                # and a critical-path walk descends through it into
                # whichever worker phase dominated.
                with trace.span("dcn.chunk.wait",
                                histogram="dcn.chunk.wait", flow=flow,
                                round=rnd, chunks=len(pending)):
                    wctx = trace.context()
                    workers = [threading.Thread(
                        target=_stage_worker,
                        args=("127.0.0.1", data_port, flow, data,
                              chunks, list(pending), xid, nbytes,
                              timeout_s, result, wctx),
                        name=f"dcn-stage-{flow}",
                        daemon=True,
                    )]
                    for s in range(stripes):
                        idxs = pending[s::stripes]
                        if not idxs:
                            continue
                        workers.append(threading.Thread(
                            target=_send_worker,
                            args=(uds_dir, flow, chunks, seqs, idxs,
                                  xid, host, port, nbytes, timeout_s,
                                  result, wctx, direct_pin),
                            name=f"dcn-stripe-{flow}-{s}",
                            daemon=True,
                        ))
                    for t in workers:
                        t.start()
                    for t in workers:
                        t.join(timeout=max(0.0,
                                           deadline
                                           - time.monotonic()))
                if any(t.is_alive() for t in workers):
                    # Budget spent with workers still wedged (daemon
                    # hung mid-op): surface now; the daemon-thread
                    # workers die with their sockets and later frames
                    # dedup away.
                    if tuner is not None:
                        tuner.on_transfer(False)
                    raise DcnXferError(
                        f"pipelined send of {flow!r} exceeded its "
                        f"{timeout_s:.1f}s budget with stripe workers "
                        "still blocked"
                    )
            # A chunk is settled ONLY on a verdict that means the peer
            # has (or had) the bytes: "sent" (standalone TCP, no
            # fabric verdict), "landed", or "dup".  Everything else —
            # "dropped" (link ate it), "unmatched" (receiver had no
            # flow yet), "rejected", a missing record, any future
            # verdict — goes again under the same seq.
            settled_bytes = sum(
                chunks[i][1] for i, v in result.verdicts.items()
                if v in ("sent", "landed", "dup"))
            pending = [i for i in pending
                       if result.verdicts.get(i)
                       not in ("sent", "landed", "dup")]
            last_errors = result.errors
            stage_iv.extend(result.phases.get("stage", ()))
            comm_iv.extend(result.phases.get("comm", ()))
            span.annotate(round=rnd, pending=len(pending),
                          lane="+".join(sorted(lanes)))
            # Published after EVERY round, with the chunks this round
            # just lost counted in: the tuner and the SLO judge see
            # mid-transfer loss the moment it is known, not once the
            # transfer completes — a controller steering on a
            # completion-time gauge would always be one transfer late.
            timeseries.gauge("dcn.pipeline.retransmit_ratio",
                             (resent + len(pending)) / len(chunks))
            if tuner is not None:
                tuner.on_round(
                    attempted=attempted, failed=len(pending),
                    bytes_confirmed=settled_bytes,
                    elapsed_s=time.monotonic() - round_t0,
                    lane="shm" if ran_shm else "socket",
                    # A partial retry round's B/s is overhead-bound —
                    # loss evidence, not capability evidence.
                    full_round=attempted == len(chunks))
            if not pending:
                ratio = _observe_exposed(span, comm_iv, stage_iv)
                if tuner is not None:
                    tuner.on_transfer(True, exposed_ratio=ratio)
                return {"bytes": nbytes, "chunks": len(chunks),
                        "stripes": stripes, "rounds": rnd + 1,
                        "lane": "+".join(sorted(lanes))}
        if tuner is not None:
            # Round budget spent with chunks still unconfirmed: the
            # strongest degradation signal the controller gets.
            tuner.on_transfer(False)
        raise DcnXferError(
            f"pipelined send of {flow!r} left {len(pending)}/"
            f"{len(chunks)} chunk(s) unconfirmed after "
            f"{cfg.max_rounds} round(s)"
            + (f": {last_errors[0]}" if last_errors else "")
        )


def read_pipelined(client, flow: str, nbytes: int,
                   cfg: Optional[PipelineConfig] = None,
                   timeout_s: float = 60.0) -> bytes:
    """Binary read-back of ``flow``'s completed frame: wait for
    assembly to finish (blocking wait op), then fetch chunk-sized
    slabs over ONE persistent DXR1 stream — raw TCP instead of
    base64-over-JSON, which is where the serial read's time goes.

    One stream, not one per stripe: on loopback (and anything short of
    a saturated NIC) parallel read connections lose to thread-schedule
    overhead — measured 17–32 ms against 12–15 ms for 4 MiB on the
    bench rig.  Chunk-sized requests keep the daemon's per-request
    copy bounded, so read-back still pipelines with the daemon's other
    work.  Falls back to the base64 control read for daemons without
    the wait op.

    A same-host daemon offering ``shm`` skips DXR1 entirely: one
    ``shm_read`` control op and the frame is read out of the client's
    own mapping of the flow's segment — a buffer reference, not a
    socket stream (``dcn.shm.reads``; any shm trouble falls back to
    DXR1 under ``dcn.shm.fallback``)."""
    if nbytes <= 0:
        return b""
    cfg = cfg or PipelineConfig()
    try:
        # The read side's "wait" phase gets its own span so a
        # critical-path walk separates "the peer was slow to finish
        # assembling" from "the read-back itself was slow".
        with trace.span("dcn.wait", histogram="dcn.wait", flow=flow,
                        bytes=nbytes):
            client.wait_rx(flow, nbytes, timeout_s=timeout_s,
                           mode="frame")
    except (DcnWaitUnsupported, AttributeError):
        # Wait-less daemon: land-wait by polling, then the base64
        # read — with the same short-read check as the DXR1 path, so
        # a not-yet-landed frame surfaces instead of returning b"".
        from container_engine_accelerators_tpu_torch.parallel import dcn

        dcn.wait_flow_rx(client, flow, nbytes, timeout_s=timeout_s)
        got = client.read(flow, nbytes)
        if len(got) != nbytes:
            raise DcnXferError(
                f"short read of {flow!r}: {len(got)} != {nbytes}"
            )
        return got
    if cfg.shm and shm_same_host(client):
        try:
            return _read_shm(client, flow, nbytes)
        except (DcnXferError, OSError) as e:
            counters.inc("dcn.shm.fallback")
            log.warning("shm read of %r failed (%s); falling back to "
                        "DXR1", flow, e)
    data_port = client.data_port()
    out = bytearray(nbytes)
    with trace.span("dcn.chunk.read", histogram="dcn.chunk.read",
                    flow=flow, bytes=nbytes):
        sock = socket.create_connection(("127.0.0.1", data_port),
                                        timeout=timeout_s)
        _set_nodelay(sock)
        try:
            for off, ln in plan_chunks(nbytes, cfg.chunk_bytes):
                got = fetch_range("127.0.0.1", data_port, flow, off,
                                  ln, sock=sock, timeout_s=timeout_s)
                if len(got) != ln:
                    raise DcnXferError(
                        f"short pipelined read of {flow!r} at {off}: "
                        f"{len(got)} != {ln}"
                    )
                out[off:off + ln] = got
        except ConnectionError as e:
            raise DcnXferError(f"pipelined read of {flow!r} failed: "
                               f"{e}")
        finally:
            sock.close()
    timeseries.record("dcn.pipeline.rx.bytes", nbytes)
    return bytes(out)


def _read_shm(client, flow: str, nbytes: int) -> bytes:
    """The zero-copy read-back: ask the daemon to surface the
    completed frame in the flow's segment, map it, copy the payload
    out of shared pages.  Raises on any shortfall — the caller owns
    the DXR1 fallback."""
    with trace.span("dcn.shm.read", histogram="dcn.shm.read",
                    flow=flow, bytes=nbytes):
        resp = client.shm_read(flow, nbytes)
        frame = int(resp.get("frame_bytes") or 0)
        if frame < nbytes:
            raise DcnXferError(
                f"short shm read of {flow!r}: {frame} != {nbytes}"
            )
        seg = dcn_shm.map_segment(resp.get("path", ""),
                                  int(resp.get("bytes") or 0))
        try:
            if seg.size < nbytes:
                raise OSError("segment smaller than frame")
            out = bytes(seg.view[:nbytes])
        finally:
            seg.close()
    counters.inc("dcn.shm.reads")
    timeseries.record("dcn.shm.rx.bytes", nbytes)
    return out
