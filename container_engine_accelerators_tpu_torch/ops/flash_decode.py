"""Flash decode: single-query attention over a long KV cache.

PyTorch counterpart of ``container_engine_accelerators_tpu/ops/
flash_decode.py``.  The serving decode step attends ONE query token per
sequence over the whole cached context; the cache stays in its storage
layout ``[B, L, KVH, D]`` and GQA is handled in the kernel (query head
``kv*G + j`` reads KV head ``kv``).

- :func:`flash_decode` is the op.  A CUDA tensor goes to the hand-written
  kernel in ``csrc/flash_decode.cu``, registered with PyTorch as
  ``torch.ops.cea_tpu_torch.flash_decode`` by ``csrc/flash_decode_op.cpp``
  and built for ``sm_90a`` with every other kernel of the port at first
  use (``ops/build.py``); a CPU tensor
  goes to :func:`flash_decode_reference`.  A CUDA call whose kernel cannot
  be built or launched raises: there is no fallback.  One call is one
  kernel launch: the CTAs that split a sequence's visible keys merge their
  partials inside the kernel, through a thread-block cluster's distributed
  shared memory.  The kernel's launcher sizes the CTAs and the cluster
  from the shapes (:func:`plan` reports its choice).
- :func:`flash_decode_reference` is the plain version, with the kernel's
  dtype rules: the scale multiplies the f32 scores, ``p`` is cast to V's
  dtype before P.V (f32 accumulation), masked slots are -1e30 and never
  contribute, and the softmax denominator divides once at the end.
- ``LAUNCHES["flash_decode"]`` counts kernel launches (and nothing else),
  so a run can show that its decode steps went through the kernel.
"""

import torch

from container_engine_accelerators_tpu_torch.ops.build import load_ops

NEG_INF = -1e30
BLOCK_K = 512

LAUNCHES = {"flash_decode": 0}


def effective_block_k(cache_len: int, block_k: int = BLOCK_K) -> int:
    """Largest divisor of ``cache_len`` that is <= ``block_k``: the block
    the TPU kernel streams the cache in (any cache length works; a
    serving cache is bucket + max_new, not necessarily a multiple of
    512)."""
    for bk in range(min(block_k, cache_len), 0, -1):
        if cache_len % bk == 0:
            return bk
    return 1  # pragma: no cover — bk=1 always divides


def flash_decode_reference(q, k_cache, v_cache, lengths, scale=None):
    """Plain PyTorch flash decode (any device), the kernel's arithmetic
    without its tiling.  q [B, H, D]; k/v [B, L, KVH, D]; lengths [B]
    -> [B, H, D] in q's dtype.  Slots >= length are zeroed before use, so
    stale or NaN contents there never reach the output."""
    b, h, d = q.shape
    _, cache_len, kvh, _ = k_cache.shape
    if h % kvh:
        raise ValueError(f"H={h} not divisible by KVH={kvh}")
    scale = d ** -0.5 if scale is None else scale
    live = (torch.arange(cache_len, device=q.device)[None, :]
            < lengths.to(q.device)[:, None])  # [B, L]
    live_kv = live[:, :, None, None]
    k = torch.where(live_kv, k_cache, torch.zeros((), dtype=k_cache.dtype,
                                                  device=q.device))
    v = torch.where(live_kv, v_cache, torch.zeros((), dtype=v_cache.dtype,
                                                  device=q.device))
    qg = q.reshape(b, kvh, h // kvh, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    live_s = live[:, None, None, :]
    s = torch.where(live_s, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = torch.where(live_s, p, 0.0)  # an empty sequence gives 0/0, as the kernel
    denom = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p.to(v.dtype).float(), v.float())
    return (acc / denom).reshape(b, h, d).to(q.dtype)


def flash_decode(q, k_cache, v_cache, lengths, *, scale=None):
    """Single-token attention over a KV cache.

    q: [B, H, D]; k_cache/v_cache: [B, L, KVH, D] (H = KVH * G); lengths:
    [B] visible keys per sequence (slot j participates iff j <
    lengths[b]).  Returns [B, H, D] in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_reference(q, k_cache, v_cache, lengths, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    return _flash_decode_cuda(q, k_cache, v_cache, lengths, scale)


def _flash_decode_cuda(q, k_cache, v_cache, lengths, scale):
    """The kernel, one launch."""
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError("flash_decode: q must be [B, H, D] and the caches "
                         "[B, L, KVH, D]")
    op = build()
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    out = op(q, k_cache, v_cache, lengths, float(scale))
    LAUNCHES["flash_decode"] += 1
    return out


def plan(q, k_cache, v_cache):
    """(query rows a CTA, CTAs that share each row block's visible keys
    and form one cluster) that the kernel's launcher would use for these
    CUDA tensors on the current device (``make_plan`` in
    ``csrc/flash_decode_plan.h``); (0, 0) for shapes the kernel does not
    take."""
    rows, splits = load_ops().flash_decode_plan(q, k_cache, v_cache)
    return rows, splits


def build():
    """Build every kernel of the port (``ops/build.py``: one library,
    nvcc for sm_90a) at first use and return this op.  Raises on any
    build or load failure."""
    return load_ops().flash_decode
