"""Decoder-only transformer LM, decode mode — PyTorch counterpart of
``container_engine_accelerators_tpu/models/transformer.py``.

Only the serving (KV-cache decode) forward is ported here; the train-mode
forward with the flash-attention kernels is the LM training slice.

Numerics follow the flax model under its ``dtype`` (the compute dtype):
params are f32, projections and the embedding run in the compute dtype
(flax casts kernel and input per call; here the weights are cast once, at
load, which gives the same values), RMSNorm computes in f32, and the tied
LM head multiplies compute-dtype operands with f32 accumulation.  Weights
keep the flax layouts (q ``[D, H, hd]``, out ``[H, hd, D]``, ...), so
``models/convert.py`` copies the flax tree without transposes.

The KV cache (``models/generate.py::init_cache``) is a dict of stacked
per-layer tensors, ``cached_key``/``cached_value`` ``[layers, B, L, KVH,
hd]`` and ``cache_index`` ``[layers, B]`` int32 — the flax cache tree's
leaves.  A forward updates it IN PLACE (flax returns a new tree), which
avoids copying the cache every token.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from container_engine_accelerators_tpu_torch.ops.flash_decode import (
    NEG_INF,
    flash_decode,
)

_TRAINING_SLICE = ("is part of the LM training slice of the PyTorch port "
                   "(flash-attention kernels 1-3); only decode mode is "
                   "ported so far")
_LATER_SERVING = "comes with a later serving slice of the PyTorch port"


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Apply RoPE to ``x`` [B, T, H, D] at absolute ``positions`` [T]
    (shared across the batch) or [B, T] (per sample)."""
    half = x.shape[-1] // 2
    freq = 1.0 / (10000.0 ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    theta = positions[..., None].to(torch.float32) * freq  # [..., T, half]
    if positions.dim() == 1:
        theta = theta[None]
    cos = torch.cos(theta)[:, :, None, :].to(x.dtype)  # [B|1, T, 1, half]
    sin = torch.sin(theta)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def lm_head(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Tied LM head: compute-dtype operands, f32 accumulation -> f32
    logits.  The products of two bf16 values are exact in f32, so
    upcasting the operands and multiplying in f32 is that arithmetic."""
    return x.float() @ embedding.to(x.dtype).float().t()


def _param(*shape, dtype, device):
    # Decode mode never trains: no autograd bookkeeping on the weights.
    return nn.Parameter(torch.empty(*shape, dtype=dtype, device=device),
                        requires_grad=False)


class RMSNorm(nn.Module):
    """f32 math, eps 1e-6, output in the compute dtype.  The scale stays
    f32 whatever the compute dtype (bf16 serving weights load exactly)."""

    def __init__(self, dim, dtype=torch.bfloat16, device=None):
        super().__init__()
        self.dtype = dtype
        self.scale = _param(dim, dtype=torch.float32, device=device)

    def forward(self, x):
        y = x.float()
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6)
        return (y * self.scale).to(self.dtype)


class Attention(nn.Module):
    """GQA attention in decode mode: append this call's K/V at the cache
    cursor, attend the queries over everything cached so far."""

    def __init__(self, dim, num_heads, head_dim, dtype=torch.bfloat16,
                 num_kv_heads=None, device=None):
        super().__init__()
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads={num_heads} not divisible by "
                             f"num_kv_heads={kv_heads}")
        self.num_heads, self.kv_heads, self.head_dim = (
            num_heads, kv_heads, head_dim)
        self.q = _param(dim, num_heads, head_dim, dtype=dtype, device=device)
        self.k = _param(dim, kv_heads, head_dim, dtype=dtype, device=device)
        self.v = _param(dim, kv_heads, head_dim, dtype=dtype, device=device)
        self.out = _param(num_heads, head_dim, dim, dtype=dtype,
                          device=device)

    def forward(self, x, positions, cache, use_flash_decode=False):
        b, t, _ = x.shape
        q = (x @ self.q.flatten(1)).view(b, t, self.num_heads, self.head_dim)
        k = (x @ self.k.flatten(1)).view(b, t, self.kv_heads, self.head_dim)
        v = (x @ self.v.flatten(1)).view(b, t, self.kv_heads, self.head_dim)
        q = rotary_embedding(q, positions)
        k = rotary_embedding(k, positions)
        o = self._decode_attend(q, k, v, positions, cache, use_flash_decode)
        return o.reshape(b, t, -1) @ self.out.flatten(0, 1)

    def _decode_attend(self, q, k, v, positions, cache, use_flash_decode):
        """The write cursor is per sample (``cache_index`` [B]) and
        ``positions`` may be [B, T]; key slot j is visible to a query at
        position p when j <= p.  Under GQA the cache keeps only the KV
        heads and the query heads are grouped over them."""
        b, t, h, d = q.shape
        ck, cv, idx = (cache["cached_key"], cache["cached_value"],
                       cache["cache_index"])
        # Per-sample writes at the cursor.  Advanced indexing bounds-checks
        # every slot, so a write past the buffer raises (a device assert
        # on CUDA) where flax's dynamic_update_slice would clamp.
        slots = idx.long()[:, None] + torch.arange(t, device=q.device)
        rows = torch.arange(b, device=q.device)[:, None]
        ck[rows, slots] = k
        cv[rows, slots] = v
        idx += t

        scale = self.head_dim ** -0.5
        if use_flash_decode and t == 1:
            pos_b = (positions[:, 0] if positions.dim() == 2
                     else positions[0].expand(b))
            o = flash_decode(q[:, 0].contiguous(), ck, cv,
                             (pos_b + 1).to(torch.int32).contiguous(),
                             scale=scale)
            return o[:, None].to(q.dtype)

        # Einsum path (prefill, and decode without the kernel): q is
        # pre-scaled in the compute dtype and p stays f32, as in flax.
        kvh = ck.shape[2]
        qg = q.reshape(b, t, kvh, h // kvh, d)
        s = torch.einsum("bqhgd,bkhd->bhgqk", (qg * scale).float(), ck.float())
        key_pos = torch.arange(ck.shape[1], device=q.device)
        pos_bt = positions if positions.dim() == 2 else positions[None]
        mask = key_pos[None, None, :] <= pos_bt[:, :, None]  # [b|1, t, L]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgqk,bkhd->bqhgd", p, cv.float())
        return o.reshape(b, t, h, d).to(q.dtype)


class Block(nn.Module):
    """Pre-norm block: attention, then a SwiGLU MLP."""

    def __init__(self, num_heads, head_dim, mlp_dim, dtype=torch.bfloat16,
                 num_kv_heads=None, device=None):
        super().__init__()
        dim = num_heads * head_dim
        self.ln_attn = RMSNorm(dim, dtype, device)
        self.attn = Attention(dim, num_heads, head_dim, dtype, num_kv_heads,
                              device)
        self.ln_mlp = RMSNorm(dim, dtype, device)
        self.gate = _param(dim, mlp_dim, dtype=dtype, device=device)
        self.up = _param(dim, mlp_dim, dtype=dtype, device=device)
        self.down = _param(mlp_dim, dim, dtype=dtype, device=device)

    def forward(self, x, positions, cache, use_flash_decode=False):
        x = x + self.attn(self.ln_attn(x), positions, cache, use_flash_decode)
        y = self.ln_mlp(x)
        return x + (F.silu(y @ self.gate) * (y @ self.up)) @ self.down


class TransformerLM(nn.Module):
    """Causal LM in decode mode: ``forward(tokens [B, T], positions,
    cache) -> f32 logits [B, T, V]`` (or the final-norm hidden states
    with ``project=False``), updating ``cache`` in place."""

    def __init__(self, vocab_size=32_000, num_layers=12, num_heads=8,
                 head_dim=64, mlp_dim=2048, dtype=torch.bfloat16,
                 num_kv_heads=None, decode=False, use_flash_decode=False,
                 num_experts=0, quant=False, device=None):
        super().__init__()
        if not decode:
            raise NotImplementedError(f"the train-mode forward {_TRAINING_SLICE}")
        if num_experts:
            raise NotImplementedError(f"MoE decode (num_experts > 0) "
                                      f"{_LATER_SERVING}")
        if quant:
            raise NotImplementedError(f"int8 weights (quant=True) "
                                      f"{_LATER_SERVING}")
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        self.dtype = dtype
        self.decode = True
        self.use_flash_decode = use_flash_decode
        self.embed = _param(vocab_size, num_heads * head_dim, dtype=dtype,
                            device=device)
        self.blocks = nn.ModuleList(
            Block(num_heads, head_dim, mlp_dim, dtype, num_kv_heads, device)
            for _ in range(num_layers))
        self.ln_f = RMSNorm(num_heads * head_dim, dtype, device)

    def forward(self, tokens, positions=None, cache=None, project=True):
        if cache is None:
            raise ValueError("decode mode needs a KV cache "
                             "(models/generate.py init_cache)")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = F.embedding(tokens, self.embed)
        for i, blk in enumerate(self.blocks):
            layer = {name: buf[i] for name, buf in cache.items()}
            x = blk(x, positions, layer, self.use_flash_decode)
        x = self.ln_f(x)
        if not project:
            return x
        return lm_head(x, self.embed)


def init_params(model: TransformerLM, generator: torch.Generator) -> dict:
    """Random f32 weights for ``model``'s shapes, drawn on the CPU from
    ``generator``: the flax initializers' law (truncated normal at two
    standard deviations, variance 1/fan_in — lecun_normal for the
    kernels, the embedding's fan-in being its vocab axis), norm scales
    1.  Load with ``model.load_state_dict``, which casts once."""
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            out[name] = torch.ones(p.shape)
            continue
        fan_in = p.shape[0] * (p.shape[1] if leaf == "out" else 1)
        # 0.8796... = stddev of a unit normal truncated to [-2, 2].
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.empty(p.shape)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        out[name] = w * std
    return out
