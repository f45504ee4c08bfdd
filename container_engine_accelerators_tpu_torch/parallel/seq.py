"""Dense attention of the LM's train mode — PyTorch counterpart of
``container_engine_accelerators_tpu/parallel/seq.py::dense_attention``.

Only the single-device function is ported here.  Ring, ring-zigzag and
Ulysses attention, which shard the sequence across devices, come with the
next multi-GPU slice of the port (the first one ported the batch and
weight layouts: ``parallel/mesh.py``).
"""

import torch

NEG_INF = -1e30


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
