"""The tied LM head's training GEMMs on the tensor cores, in the f32
arithmetic of ``x.float() @ embedding.float().t()``.

The head multiplies bf16 operands (the final norm's output X and the
embedding E cast to bf16) and sums in f32.  The products of two bf16
values are exact in f32, so a bf16 GEMM that accumulates in f32 and
writes f32 is that arithmetic: the forward, ``logits = X.Eᵀ``, is such
a GEMM (``torch.mm(..., out_dtype=float32)``).  The backward's operand
G, the logits' f32 gradient, is not bf16.  Every f32 value splits
exactly into three bf16 parts (:func:`split3_reference`), so
``G.E = hi.E + mid.E + lo.E`` with every product still exact: each of
the two backward products becomes bf16 GEMMs with f32 sums.  The tensor
cores' f32 sums truncate where the CUDA cores round to nearest, so each
product's contracted dim is taken in pieces (:func:`gemm`, ``DEPTH_*``)
short enough that the sums err no more than the f32 GEMMs' do.

- :class:`TiedHead` is the differentiable op.  Its forward saves the
  bf16 X and E.  Its backward (:func:`head_grads`) walks G in blocks of
  rows (:func:`chunk_rows`: the block's split stays within
  ``SPLIT_BYTES``); each block is split into ``[rows, 3V]`` bf16,
  ``[hi | mid | lo]`` side by side, by the kernel
  ``torch.ops.cea_tpu_torch.lm_head_split`` (``csrc/lm_head_split.cu``,
  built with the port's other kernels by ``ops/build.py``) on the card
  and by the plain version on the CPU.  Against E stacked three times
  that block gives its rows of dX (depth 3V); viewed as ``[3 rows, V]``
  (rows hi_i, mid_i, lo_i) against X's rows repeated three times, it
  adds its share of dE (depth 3 rows) into one f32 sum.  dX is rounded to bf16 once, and dE once to bf16 (the
  gradient of the bf16 cast of E, which autograd brings back to f32),
  as autograd rounds the two gradients of the f32 expression.
- On the CPU the GEMMs multiply the bf16 values in f32 (the same exact
  products), so the tests reach every line but the kernel and cuBLAS.
- ``LAUNCHES`` counts the split kernel's launches.
"""

import torch

from container_engine_accelerators_tpu_torch.ops.build import load_ops
from container_engine_accelerators_tpu_torch.utils.profile import span

LAUNCHES = {"lm_head_split": 0}
# Bytes a block's bf16 split may take: 6 bytes a logit, so 8,192 rows of
# a 49,152-token vocabulary (2.4 GB).
SPLIT_BYTES = 2_500_000_000
_ROW_TILE = 128  # a block's rows are a multiple of this
# The most products one tensor-core GEMM sums into a term, for each of the
# head's three products (the forward over D, dX over 3V, dE over 3 rows).
# Hopper's tensor cores add in f32 but truncate the running sum at each
# step, so their error grows with the depth of the sum, where the CUDA
# cores' rounding to nearest grows with its square root; a deeper sum is
# taken in pieces (:func:`gemm`).  At these depths the three err no more
# than the f32 expression's CUDA-core GEMMs do (to within 2x; against f64
# at the 1.7B's head, ``tests/test_torch_cuda_kernels.py``).
DEPTH_LOGITS, DEPTH_DX, DEPTH_DE = 512, 3072, 1024
_K_ALIGN = 64  # pieces start on 128-byte boundaries of a bf16 row


def split3_reference(g: torch.Tensor) -> torch.Tensor:
    """Plain version of the split (any device): g ``[rows, V]`` f32 ->
    ``[rows, 3V]`` bf16, ``[hi | mid | lo]`` with ``hi + mid + lo == g``
    bit for bit wherever g's significant bits lie at or above 2^-133
    (bf16's finest step: every ``|g| >= 2**-110``, and zero).  Each part
    truncates the f32 bit pattern to its top 16 bits, which keeps every
    part finite next to f32's largest values; the differences are exact
    in f32.  A non-finite g goes whole into hi, with mid = lo = 0."""
    finite = torch.isfinite(g)
    gf = torch.where(finite, g, 0.0)
    hi = _top16(gf)
    r1 = gf - hi.float()
    mid = _top16(r1)
    lo = _top16(r1 - mid.float())
    hi = torch.where(finite, hi, g.to(torch.bfloat16))
    return torch.cat([hi, mid, lo], dim=-1)


def _top16(x):
    """The bf16 whose bits are the top 16 of f32 ``x`` (truncation)."""
    return (x.view(torch.int32) >> 16).to(torch.int16).view(torch.bfloat16)


def split3(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """Split g ``[rows, V]`` f32 into ``out`` ``[rows, 3V]`` bf16: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    if not g.is_cuda:
        return out.copy_(split3_reference(g))
    load_ops().lm_head_split(g.contiguous(), out)
    LAUNCHES["lm_head_split"] += 1
    return out


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def chunk_rows(m: int, v: int) -> int:
    """Rows of G a backward block takes: the fewest blocks whose split
    fits in ``SPLIT_BYTES``, made even and rounded up to whole tiles
    (8,192 for the SmolLM heads' 49,152 and 81,920 rows)."""
    most = max(_ROW_TILE, SPLIT_BYTES // (6 * v) // _ROW_TILE * _ROW_TILE)
    rows = _ceil(m, _ceil(m, most))
    return min(m, _ceil(rows, _ROW_TILE) * _ROW_TILE)


def _mm(a, b):
    """``a @ b`` of bf16 operands as an f32 GEMM: cuBLAS's bf16 GEMM with
    an f32 accumulator and output on the card, f32 products of the bf16
    values on the CPU."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def _mm_into(acc, a, b):
    """``acc += a @ b`` in f32, in place, for bf16 ``a`` and ``b``."""
    if a.is_cuda:
        return torch.addmm(acc, a, b, out_dtype=torch.float32, out=acc)
    return acc.addmm_(a.float(), b.float())


def gemm(a, b, depth, acc=None):
    """``a @ b`` (into ``acc``, added to it, when given) in f32 from bf16
    operands, the contracted dim taken at most ``depth`` (a multiple of
    64) at a time, in even pieces: one GEMM a piece, each piece's f32 result added to the sum by the GEMM's
    own epilogue (``beta = 1``), which rounds to nearest."""
    k = a.shape[1]
    step = _ceil(_ceil(k, _ceil(k, depth)), _K_ALIGN) * _K_ALIGN
    for i in range(0, k, step):
        if acc is None:
            acc = _mm(a[:, i:i + step], b[i:i + step])
        else:
            _mm_into(acc, a[:, i:i + step], b[i:i + step])
    return acc


def head_grads(g, x, e, rows, want_dx=True, want_de=True):
    """The head's two gradients from G ``[M, V]`` f32, X ``[M, D]`` and E
    ``[V, D]`` bf16, G taken ``rows`` rows at a time: ``(dX, dE)``, the
    f32 sums, not yet rounded, each None where not wanted."""
    m, v = g.shape
    d = e.shape[1]
    f32, dev = torch.float32, g.device
    dx = torch.empty(m, d, dtype=f32, device=dev) if want_dx else None
    de = torch.zeros(v, d, dtype=f32, device=dev) if want_de else None
    e3 = torch.cat([e, e, e]) if want_dx else None
    buf = torch.empty(min(rows, m), 3 * v, dtype=torch.bfloat16, device=dev)
    for i in range(0, m, rows):
        r = min(rows, m - i)
        s = split3(g[i:i + r], buf[:r])
        if want_dx:
            dx[i:i + r] = gemm(s, e3, DEPTH_DX)
        if want_de:
            gemm(s.view(3 * r, v).t(), x[i:i + r].repeat_interleave(3, dim=0),
                 DEPTH_DE, de)
    return dx, de


class TiedHead(torch.autograd.Function):
    """``x [..., D] bf16 @ e [V, D] bf16ᵀ -> f32 logits [..., V]``; the
    backward takes G ``rows`` rows at a time."""

    @staticmethod
    def forward(ctx, x, e, rows):
        with span("lm.train.head.forward"):
            logits = gemm(x.reshape(-1, x.shape[-1]), e.t(), DEPTH_LOGITS)
        ctx.save_for_backward(x, e)
        ctx.rows = rows
        return logits.view(*x.shape[:-1], e.shape[0])

    @staticmethod
    def backward(ctx, g):
        x, e = ctx.saved_tensors
        want_dx, want_de = ctx.needs_input_grad[:2]
        with span("lm.train.head.backward"):
            dx, de = head_grads(g.reshape(-1, e.shape[0]),
                                x.reshape(-1, x.shape[-1]), e, ctx.rows,
                                want_dx, want_de)
            return (None if dx is None else dx.to(x.dtype).view_as(x),
                    None if de is None else de.to(e.dtype), None)


def tied_head(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """The tied head of bf16 ``x`` and bf16 ``e``, differentiable in both
    through :class:`TiedHead`, G's blocks sized by :func:`chunk_rows`."""
    m = x.numel() // x.shape[-1]
    return TiedHead.apply(x, e, chunk_rows(m, e.shape[0]))
