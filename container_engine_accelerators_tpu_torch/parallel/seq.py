"""Sequence parallelism — PyTorch counterpart of
``container_engine_accelerators_tpu/parallel/seq.py``.

The sequence axis of q, k and v is split over the ranks of a process
group (a mesh's data group): each rank holds ``[B, T/n, H, D]``.

- :func:`dense_attention` — single-device attention with the JAX
  function's dtype rules (train mode's dense branch, and Ulysses' inner
  attention).
- :func:`ring_attention` — K/V blocks rotate around the ring, one send
  to the next rank and one receive from the previous per rotation
  (``dist.batch_isend_irecv``, k|v in one buffer), while each rank
  attends its resident Q shard to the block it holds; blocks merge by
  their logsumexp in f32.  A block is ONE flash-attention op call
  (``ops/flash_attention.py``: the hand-written kernels on the card,
  their plain versions on the CPU), causal on the diagonal block, full
  where every key lies in the past, skipped where every key lies in the
  future.  The backward is a second ring pass: k|v|dk|dv rotate together
  (dk/dv in f32) and come home after n rotations, each step handing the
  dQ and dK/dV ops the GLOBAL o and lse; dq accumulates locally.
  ``layout="zigzag"`` stores chunks i and 2n-1-i on rank i and attends
  each (Q half x K half) pair on its own, so every rank has about half a
  block of work at every step (:func:`ring_skip_stats`).  The per-step
  compute (:func:`ring_forward_step`, :func:`ring_backward_step`) does
  no communication, so the steps of all n ranks compose in one process.
- :func:`ulysses_attention` — ``dist.all_to_all_single`` turns the
  sequence shard into a head shard, dense attention runs over the whole
  sequence for H/n heads, and the reverse all-to-all restores the
  sequence shard (its own backward: the reverse all-to-all).
- :func:`make_sequence_parallel_attention` — ``fn(q, k, v)`` on local
  shards over a mesh's data group.
- The layout helpers (:func:`zigzag_permutation`, :func:`to_zigzag`,
  :func:`from_zigzag`, :func:`ring_positions`, :func:`ring_skip_stats`)
  are the JAX package's, on torch integer tensors.

At n == 1 nothing is sent (NCCL cannot send to a rank itself).
"""

import logging
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.ops import flash_attention as fa

log = logging.getLogger(__name__)

NEG_INF = -1e30
LAYOUTS = ("contiguous", "zigzag")


def dense_attention(q, k, v, causal=False, scale=None):
    """Scaled-dot-product attention on ``[B, T, H, D]`` with the JAX
    function's dtype rules, which differ from the flash kernel's: q is
    pre-scaled in the input dtype, the scores and the softmax are f32, and
    p stays f32 into the P.V product (f32 accumulation); the output is
    rounded once to q's dtype."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o.to(q.dtype)


# ---- layout helpers (the JAX package's, on torch integer tensors) ----------

# The JAX ring scores a K block RING_CHUNK columns at a time;
# ring_skip_stats replays its skip decisions at that granularity.
RING_CHUNK = 512


def _chunks_of(tk: int) -> Tuple[int, int]:
    """(chunk, nc) splitting a K block of tk columns into RING_CHUNK runs
    (a single chunk when ragged)."""
    chunk = min(tk, RING_CHUNK)
    if tk % chunk:
        chunk = tk
    return chunk, tk // chunk


def _fully_masked(q_pos: torch.Tensor, k_pos: torch.Tensor) -> bool:
    """True when every (q, k) pair is causally masked: every key lies in
    the queries' future."""
    return bool(k_pos.min() > q_pos.max())


def zigzag_permutation(t: int, n: int) -> torch.Tensor:
    """Global position -> zigzag storage order for n ring ranks: rank i
    holds chunks i and 2n-1-i of size t/(2n).  ``stored = x[..., perm]``;
    invert with ``torch.argsort(perm)``."""
    if t % (2 * n):
        raise ValueError(f"zigzag needs seq {t} divisible by 2*{n}")
    half = t // (2 * n)
    order = []
    for i in range(n):
        order.append(torch.arange(half) + i * half)
        order.append(torch.arange(half) + (2 * n - 1 - i) * half)
    return torch.cat(order)


def to_zigzag(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Reorder a GLOBAL sequence axis into zigzag storage order."""
    perm = zigzag_permutation(x.shape[axis], n)
    return x.index_select(axis, perm.to(x.device))


def from_zigzag(x: torch.Tensor, n: int, axis: int = 1) -> torch.Tensor:
    """Inverse of :func:`to_zigzag`."""
    perm = torch.argsort(zigzag_permutation(x.shape[axis], n))
    return x.index_select(axis, perm.to(x.device))


def ring_positions(layout: str, rank: int, tq: int, n: int) -> torch.Tensor:
    """Global token positions of the shard stored on ``rank``:
    contiguous, one run of tq; zigzag, halves from chunks rank and
    2n-1-rank."""
    if layout == "zigzag":
        half = tq // 2
        return torch.cat([rank * half + torch.arange(half),
                          (2 * n - 1 - rank) * half + torch.arange(half)])
    return rank * tq + torch.arange(tq)


def ring_skip_stats(t: int, n: int, layout: str = "contiguous",
                    ring_chunk: Optional[int] = None) -> dict:
    """The JAX package's critical-path accounting of the causal skip:
    every (rank, ring step) of a causal pass over ``t`` tokens on ``n``
    ranks, the JAX ring's skip decisions (zigzag Q-half split, K cut at
    the half boundary and then into RING_CHUNK runs), each executed
    (q rows x k chunk) product charged rows x cols.  ``{"per_step_max",
    "critical", "total"}`` in (q row x k col) pairs; ``critical`` sums the
    busiest rank of each step, and the contiguous / zigzag ratio of it
    tends to 4n/(2n+1)."""
    tq = tk = t // n

    def _k_chunks(k_pos):
        pieces = ([k_pos[: tk // 2], k_pos[tk // 2:]]
                  if layout == "zigzag" else [k_pos])
        out = []
        for piece in pieces:
            size = int(piece.shape[0])
            chunk, nc = _chunks_of(size)
            if ring_chunk is not None:
                chunk = ring_chunk if size % ring_chunk == 0 else size
                nc = size // chunk
            out.extend(piece[c * chunk:(c + 1) * chunk] for c in range(nc))
        return out

    per_step_max = []
    total = 0.0
    for s in range(n):
        worst = 0.0
        for r in range(n):
            src = (r - s) % n
            q_pos = ring_positions(layout, r, tq, n)
            k_pos = ring_positions(layout, src, tk, n)
            q_blocks = ([q_pos[: tq // 2], q_pos[tq // 2:]]
                        if layout == "zigzag" else [q_pos])
            cost = 0
            for qp in q_blocks:
                for kp in _k_chunks(k_pos):
                    if not _fully_masked(qp, kp):
                        cost += int(qp.shape[0]) * int(kp.shape[0])
            worst = max(worst, cost)
            total += cost
        per_step_max.append(float(worst))
    return {"per_step_max": per_step_max,
            "critical": float(sum(per_step_max)), "total": float(total)}


# ---- the ring ---------------------------------------------------------------


def ring_blocks(rank: int, src: int, n: int, tq: int,
                layout: str = "contiguous", causal: bool = True
                ) -> List[Tuple[slice, slice, bool]]:
    """The blocks rank ``rank`` computes against the K/V shard of rank
    ``src``: ``[(q rows, k rows, diagonal)]``, rows of the two shards.
    Not causal: the whole block.  Causal, contiguous: the whole block,
    diagonal if src == rank, nothing if src > rank.  Causal, zigzag:
    each (Q half x K half) pair of chunks whose K chunk does not follow
    the Q chunk, diagonal where they are the same chunk (the JAX ring's
    split; at most 3 of the 4 pairs survive)."""
    whole = slice(0, tq)
    if not causal:
        return [(whole, whole, False)]
    if layout == "contiguous":
        return [] if src > rank else [(whole, whole, src == rank)]
    half = tq // 2
    lo, hi = slice(0, half), slice(half, tq)
    out = []
    for rows, q_chunk in ((lo, rank), (hi, 2 * n - 1 - rank)):
        for cols, k_chunk in ((lo, src), (hi, 2 * n - 1 - src)):
            if k_chunk <= q_chunk:
                out.append((rows, cols, k_chunk == q_chunk))
    return out


def count_ring_blocks(n: int, layout: str = "contiguous",
                      causal: bool = True) -> int:
    """Blocks one ring pass computes over all n ranks: the flash forward
    op calls of a forward, and the dQ and the dK/dV op calls of a
    backward (contiguous causal n(n+1)/2, zigzag causal n(2n+1), not
    causal n^2)."""
    return sum(len(ring_blocks(r, (r - s) % n, n, 2, layout, causal))
               for r in range(n) for s in range(n))


_DECIDED = set()


def _kernel_blocks(q: torch.Tensor, causal: bool, layout: str) -> bool:
    """Whether the ring's blocks go to the flash op (the kernels, for a
    CUDA tensor) or to its plain per-block version: by shape alone, the
    op's tile gate on a block's rows and head dim.  Logged once a
    shape."""
    t = q.shape[1] // 2 if causal and layout == "zigzag" else q.shape[1]
    ok = fa.supports_flash(t, q.shape[-1])
    key = (t, q.shape[-1], q.device.type)
    if key not in _DECIDED:
        _DECIDED.add(key)
        log.info("ring attention: blocks of %d rows, head dim %d on %s -> %s",
                 t, q.shape[-1], q.device.type,
                 "the flash op" if ok else "the plain per-block version")
    return ok


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _block_forward(q, k, v, causal, kernel):
    q, k, v = (x.contiguous() for x in (q, k, v))
    if kernel:
        return fa.flash_forward(q, k, v, causal, 1.0)
    return fa.flash_attention_reference(q, k, v, causal, 1.0)


def _block_backward(q, k, v, o, lse, do, causal, kernel):
    args = [x.contiguous() for x in (q, k, v, o, lse, do)]
    if kernel:
        return fa.flash_backward(*args, causal, 1.0)
    return fa.flash_attention_bwd_reference(*args, causal, 1.0)


def ring_forward_step(q_s, k_blk, v_blk, o_acc, lse_acc, rank, src, n,
                      layout="contiguous", causal=True, kernel=True):
    """Attend the resident pre-scaled query shard ``q_s`` to the K/V shard
    of rank ``src``, one op call a block of :func:`ring_blocks`, and fold
    each block into the running ``o_acc`` ``[B, Tq, H, D]`` and ``lse_acc``
    ``[B*H, Tq]`` (f32, in place) by logsumexp.  No communication."""
    b, _, h, _ = q_s.shape
    for rows, cols, diagonal in ring_blocks(rank, src, n, q_s.shape[1],
                                            layout, causal):
        o_b, lse_b = _block_forward(q_s[:, rows], k_blk[:, cols],
                                    v_blk[:, cols], diagonal, kernel)
        old = lse_acc[:, rows]
        new = torch.logaddexp(old, lse_b)
        t = new.shape[1]

        def weight(x):  # [B*H, t] -> [B, t, H, 1]
            return torch.exp(x - new).view(b, h, t).transpose(1, 2)[..., None]

        o_acc[:, rows] = (o_acc[:, rows] * weight(old)
                          + o_b.to(o_acc.dtype) * weight(lse_b))
        lse_acc[:, rows] = new


def ring_backward_step(q_s, do, o, lse, k_blk, v_blk, dq_acc, dk_acc,
                       dv_acc, rank, src, n, layout="contiguous",
                       causal=True, kernel=True):
    """The gradient contributions of the K/V shard of rank ``src`` to the
    resident queries: per block of :func:`ring_blocks`, one dQ and one
    dK/dV op call on the GLOBAL ``o`` and ``lse`` rows (so the ops'
    delta = rowsum(dO.O) and P = exp(S - lse) are the global ones), each
    output added into the f32 ``dq_acc`` (w.r.t. ``q_s``), ``dk_acc`` and
    ``dv_acc`` in place.  No communication."""
    for rows, cols, diagonal in ring_blocks(rank, src, n, q_s.shape[1],
                                            layout, causal):
        dq_b, dk_b, dv_b = _block_backward(
            q_s[:, rows], k_blk[:, cols], v_blk[:, cols], o[:, rows],
            lse[:, rows], do[:, rows], diagonal, kernel)
        dq_acc[:, rows] += dq_b
        dk_acc[:, cols] += dk_b
        dv_acc[:, cols] += dv_b


def _size_rank(group) -> Tuple[int, int]:
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _pack(tensors):
    """One contiguous byte buffer holding ``tensors`` back to back ->
    (buffer, its views shaped and typed as each tensor)."""
    buf = torch.cat([t.contiguous().view(-1).view(torch.uint8)
                     for t in tensors])
    return buf, _views(buf, tensors)


def _views(buf, like):
    out, off = [], 0
    for t in like:
        size = t.numel() * t.element_size()
        out.append(buf[off:off + size].view(t.dtype).view(t.shape))
        off += size
    return out


def _rotate(buf, group, n, rank):
    """Start sending ``buf`` to the next rank and receiving the previous
    rank's into a new buffer -> (that buffer, the requests)."""
    group = group if group is not None else dist.group.WORLD
    recv = torch.empty_like(buf)
    ops = [dist.P2POp(dist.isend, buf,
                      dist.get_global_rank(group, (rank + 1) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (rank - 1) % n), group)]
    return recv, dist.batch_isend_irecv(ops)


def _ring_forward(q_s, k, v, group, causal, layout, kernel):
    """-> (o in q's dtype, lse [B*H, Tq] f32): n steps, n-1 rotations of
    k|v, each started before the step's compute."""
    n, rank = _size_rank(group)
    b, tq, h, d = q_s.shape
    acc = _acc_dtype(q_s)
    o_acc = torch.zeros(b, tq, h, d, dtype=acc, device=q_s.device)
    lse_acc = torch.full((b * h, tq), float("-inf"), dtype=acc,
                         device=q_s.device)
    buf, (k_blk, v_blk) = _pack((k, v))
    for s in range(n):
        reqs = ()
        if s < n - 1:
            recv, reqs = _rotate(buf, group, n, rank)
        ring_forward_step(q_s, k_blk, v_blk, o_acc, lse_acc, rank,
                          (rank - s) % n, n, layout, causal, kernel)
        for r in reqs:
            r.wait()
        if reqs:
            buf = recv
            k_blk, v_blk = _views(buf, (k, v))
    return o_acc.to(q_s.dtype), lse_acc


def _ring_backward(q_s, k, v, o, lse, do, group, causal, layout, kernel):
    """-> (dq w.r.t. q_s, dk, dv), f32: n steps, each followed by a
    rotation of k|v|dk|dv, after which each dk/dv shard is home with every
    rank's contribution."""
    n, rank = _size_rank(group)
    acc = _acc_dtype(q_s)
    dq = torch.zeros(q_s.shape, dtype=acc, device=q_s.device)
    zeros = torch.zeros(k.shape, dtype=acc, device=k.device)
    like = (k, v, zeros, zeros)
    buf, (k_blk, v_blk, dk, dv) = _pack(like)
    for s in range(n):
        ring_backward_step(q_s, do, o, lse, k_blk, v_blk, dq, dk, dv, rank,
                           (rank - s) % n, n, layout, causal, kernel)
        if n > 1:
            buf, reqs = _rotate(buf, group, n, rank)
            for r in reqs:
                r.wait()
            k_blk, v_blk, dk, dv = _views(buf, like)
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale, layout):
        # q pre-scaled in its own dtype, as the JAX ring's q * scale; the
        # ops then run at scale 1 and dq is scaled back.
        q_s = (q * scale).contiguous()
        k, v = k.contiguous(), v.contiguous()
        kernel = _kernel_blocks(q, causal, layout)
        o, lse = _ring_forward(q_s, k, v, group, causal, layout, kernel)
        ctx.save_for_backward(q_s, k, v, o, lse)
        ctx.conf = (group, causal, scale, layout, kernel)
        return o

    @staticmethod
    def backward(ctx, do):
        q_s, k, v, o, lse = ctx.saved_tensors
        group, causal, scale, layout, kernel = ctx.conf
        dq, dk, dv = _ring_backward(q_s, k, v, o, lse, do, group, causal,
                                    layout, kernel)
        return ((dq * scale).to(q_s.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None)


def ring_attention(q, k, v, group=None, causal=False, scale=None,
                   layout="contiguous"):
    """Ring self-attention over the sequence shards ``[B, T/n, H, D]`` of
    ``group`` (None: the default group; no group at all: one rank).
    Differentiable in q, k and v, with O(T/n) memory both ways.
    ``layout="zigzag"``: the shards are in zigzag storage order (reorder
    the GLOBAL sequence with :func:`to_zigzag` first), which needs an even
    shard."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    if layout not in LAYOUTS:
        raise ValueError(f"unknown ring layout {layout!r}")
    if layout == "zigzag" and q.shape[1] % 2:
        raise ValueError(
            f"zigzag needs an even per-device shard, got {q.shape[1]}")
    return _RingAttention.apply(q, k, v, group, bool(causal), scale, layout)


# ---- Ulysses ----------------------------------------------------------------


def _all_to_all(x, group, to_heads):
    """``to_heads``: ``[B, T/n, H, D]`` -> ``[B, T, H/n, D]`` (this rank's
    heads, every rank's rows in rank order); else the reverse."""
    n, _ = _size_rank(group)
    if n == 1:
        return x
    b, t, h, d = x.shape
    if to_heads:
        send = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
    else:
        send = x.reshape(b, n, t // n, h, d).permute(1, 0, 2, 3, 4)
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if to_heads:  # recv[j]: rank j's rows of this rank's heads
        return recv.permute(1, 0, 2, 3, 4).reshape(b, n * t, h // n, d)
    # recv[j]: this rank's rows of rank j's heads
    return recv.permute(1, 2, 0, 3, 4).reshape(b, t // n, n * h, d)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`, whose backward is the reverse all-to-all."""

    @staticmethod
    def forward(ctx, x, group, to_heads):
        ctx.group, ctx.to_heads = group, to_heads
        return _all_to_all(x, group, to_heads)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g.contiguous(), ctx.group, not ctx.to_heads),
                None, None)


def ulysses_attention(q, k, v, group=None, causal=False, scale=None):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism over the
    shards ``[B, T/n, H, D]`` of ``group``: H/n heads over the whole
    sequence through :func:`dense_attention` on each rank."""
    n, _ = _size_rank(group)
    if q.shape[2] % n:
        raise ValueError(
            f"ulysses needs num_heads ({q.shape[2]}) divisible by the "
            f"sequence-parallel degree ({n})")
    qh, kh, vh = (_AllToAll.apply(x, group, True) for x in (q, k, v))
    oh = dense_attention(qh, kh, vh, causal=causal, scale=scale)
    return _AllToAll.apply(oh, group, False)


def make_sequence_parallel_attention(mesh, kind="ring", causal=False,
                                     axis_name="data", layout="contiguous"):
    """``fn(q, k, v) -> out`` on this rank's sequence shards over the
    ``axis_name`` group of ``mesh`` (a ``DeviceMesh``; None: the default
    group).  ``layout`` (ring only): see :func:`ring_attention`."""
    kinds = {"ring": ring_attention, "ulysses": ulysses_attention}
    if kind not in kinds:
        raise ValueError(
            f"kind must be one of {'|'.join(sorted(kinds))}, got {kind!r}")
    inner = kinds[kind]
    extra = {"layout": layout} if kind == "ring" else {}
    group = mesh.get_group(axis_name) if mesh is not None else None

    def fn(q, k, v):
        return inner(q, k, v, group, causal=causal, **extra)

    return fn
