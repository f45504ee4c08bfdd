"""Flash attention: the forward and backward of causal / non-causal
attention on ``[B, T, H, D]``, never materialising the ``[T, T]`` scores.

PyTorch counterpart of ``container_engine_accelerators_tpu/ops/
flash_attention.py``.

- :func:`flash_attention` is the differentiable op (the JAX package's
  ``jax.custom_vjp`` becomes a ``torch.autograd.Function``).  The forward
  saves ``(q, k, v, o, lse)``, ``lse`` as ``[B*H, T]`` f32; the backward
  runs the dQ and the dK/dV computations.  CUDA tensors go to the
  hand-written kernels, registered as
  ``torch.ops.cea_tpu_torch.flash_attention_{fwd,bwd_dq,bwd_dkv}`` by
  ``csrc/flash_attention_op.cpp`` and built with every other kernel of
  the port at first use (``ops/build.py``): bf16 forwards, and bf16 dQ
  and dK/dV at D 64/128, run on the tensor cores
  (``csrc/flash_attention_sm90.cu``; the dQ op runs the delta pre-pass
  and hands delta to the dK/dV op, so it runs once per backward), the
  rest on the CUDA cores (``csrc/flash_attention.cu``).  CPU tensors go
  to the plain versions.  A CUDA call whose kernel cannot be built or
  launched raises: there is no fallback.
- :func:`flash_attention_reference` and
  :func:`flash_attention_bwd_reference` are the plain versions, with the
  kernels' dtype rules: scores are f32 products of input-dtype operands
  and the scale multiplies the f32 scores (q is not pre-scaled); masked
  scores are -1e30; forward p is cast to V's dtype before P.V; backward
  P = exp(s - lse), delta = rowsum(dO * O) in f32, dS = P (dP - delta)
  scale, dS cast to K's dtype before dS.K and to Q's before dS^T.Q, P
  cast to dO's dtype before P^T.dO; every product accumulates in f32 and
  each output is rounded once to its input's dtype.  (f64 inputs stay
  f64 throughout, for ``torch.autograd.gradcheck``.)
- :func:`supports_flash` is the JAX package's tile gate.
- ``LAUNCHES`` counts kernel launches (and nothing else), one counter per
  kernel, so a run can show that its steps went through the kernels.
"""

import torch

from container_engine_accelerators_tpu_torch.ops.build import load_ops

NEG_INF = -1e30
BLOCK_Q = 128  # the JAX kernel's tile; T must be a multiple of it

LAUNCHES = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
            "flash_attention_bwd_dkv": 0}


def supports_flash(t: int, d: int) -> bool:
    """Tile-alignment gate used by callers choosing the kernel path."""
    return t % BLOCK_Q == 0 and t >= BLOCK_Q and d in (64, 128, 256)


def _acc_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _scores(q, k, causal, scale):
    """[B, H, Tq, Tk] scores in the accumulation dtype, scale applied to
    them, -1e30 above the diagonal under ``causal``."""
    acc = _acc_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), k.to(acc)) * scale
    if causal:
        t_q, t_k = q.shape[1], k.shape[1]
        keep = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, NEG_INF)
    return s


def flash_attention_reference(q, k, v, causal=False, scale=None):
    """Plain forward (any device): ``(o [B, T, H, D] in q's dtype, lse
    [B*H, T] f32)``, the kernel's arithmetic without its tiling."""
    b, t, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    acc = _acc_dtype(q)
    s = _scores(q, k, causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).to(acc), v.to(acc)) / l
    lse = (m + torch.log(l)).reshape(b * h, t)
    return (o.transpose(1, 2).contiguous().to(q.dtype),
            lse if acc == torch.float64 else lse.float())


def flash_attention_bwd_reference(q, k, v, o, lse, do, causal=False,
                                  scale=None):
    """Plain backward (any device): ``(dq, dk, dv)``, each in its input's
    dtype, from the forward's residuals and the output gradient ``do``."""
    b, t, h, d = q.shape
    scale = d ** -0.5 if scale is None else scale
    acc = _acc_dtype(q)
    s = _scores(q, k, causal, scale)
    p = torch.exp(s - lse.reshape(b, h, t, 1).to(acc))  # 0 where masked
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(acc), v.to(acc))
    delta = (do.to(acc) * o.to(acc)).sum(-1).transpose(1, 2)  # [B, H, T]
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(acc), k.to(acc))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(acc), q.to(acc))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(acc), do.to(acc))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _on_cuda(x):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {x.device}")
    return x.device.type == "cuda"


def flash_forward(q, k, v, causal, scale):
    """One forward op call: ``(o, lse [B*H, T] f32)``, the kernel for CUDA
    tensors (``causal`` masks keys past each query's own position, q, k
    and v of one shape), the plain version for CPU ones.  The ring's
    blocks call it too (``parallel/seq.py``)."""
    if not _on_cuda(q):
        return flash_attention_reference(q, k, v, causal, scale)
    o, lse = load_ops().flash_attention_fwd(q, k, v, causal, scale)
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_backward(q, k, v, o, lse, do, causal, scale):
    """One backward: ``(dq, dk, dv)`` from the forward's ``o`` and ``lse``,
    the dQ then the dK/dV kernel for CUDA tensors, the plain version for
    CPU ones."""
    if not _on_cuda(q):
        return flash_attention_bwd_reference(q, k, v, o, lse, do, causal,
                                             scale)
    ops = load_ops()
    do = do.contiguous()
    # delta = rowsum(dO * O) from the dQ op (None where its kernel computes
    # delta itself) goes on to the dK/dV op.
    dq, delta = ops.flash_attention_bwd_dq(q, k, v, o, do, lse, causal, scale)
    LAUNCHES["flash_attention_bwd_dq"] += 1
    dk, dv = ops.flash_attention_bwd_dkv(q, k, v, o, do, lse, causal, scale,
                                         delta)
    LAUNCHES["flash_attention_bwd_dkv"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """Flash attention on ``[B, T, H, D]`` (q, k and v of one shape), T a
    multiple of 128 and D in {64, 128, 256} on the card
    (:func:`supports_flash`).  Returns o in q's dtype; differentiable in
    q, k and v."""
    scale = float(q.shape[-1] ** -0.5 if scale is None else scale)
    return _FlashAttention.apply(q, k, v, bool(causal), scale)
