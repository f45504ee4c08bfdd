"""Decoder-only transformer LM — PyTorch counterpart of
``container_engine_accelerators_tpu/models/transformer.py``, in its two
modes:

- **train mode** (``decode=False``, the default): causal attention over
  the whole sequence, through the flash-attention kernels
  (``ops/flash_attention.py``) or dense attention
  (``parallel/seq.py::dense_attention``), each block under activation
  checkpointing when ``remat`` (the JAX model's ``nn.remat``); with
  ``seq_parallel``, over this rank's sequence shard through ring (its
  blocks on the flash kernels) or Ulysses attention
  (``parallel/seq.py``);
- **decode mode** (``decode=True``): the serving forward over a KV cache,
  optionally through the flash-decode kernel, and with ``quant=True`` on
  int8 projection kernels (``models/quant.py::QDense``, the JAX model's
  ``QDenseGeneral``).

Numerics follow the flax model under its ``dtype`` (the compute dtype):
projections and the embedding run in the compute dtype, RMSNorm computes
in f32, and the tied LM head multiplies compute-dtype operands with f32
accumulation (:func:`lm_head`): a training call on a plain CUDA bf16
tensor runs that arithmetic on the tensor cores, its backward splitting
the f32 gradient exactly into three bf16 parts (``ops/lm_head.py``);
every other call (decode mode, ``no_grad``, the CPU, a mesh, f32)
multiplies the upcast operands in f32.  flax keeps the params in f32
and casts kernel and input to the compute dtype at every call; train
mode does the same — its params are f32 leaves with ``requires_grad``
and every use casts them, so the f32 gradients flow back through the
cast.  Decode mode never trains: it
holds its weights already cast to the compute dtype (cast once, at load,
which gives the same values) and without autograd bookkeeping.  Both
modes have the same parameter names and shapes, so one state dict loads
into either.  Weights keep the flax layouts (q ``[D, H, hd]``, out ``[H,
hd, D]``, ...), so ``models/convert.py`` copies the flax tree without
transposes.

The KV cache (``models/generate.py::init_cache``) is a dict of stacked
per-layer tensors, ``cached_key``/``cached_value`` ``[layers, B, L, KVH,
hd]`` and ``cache_index`` ``[layers, B]`` int32 — the flax cache tree's
leaves.  A forward updates it IN PLACE (flax returns a new tree), which
avoids copying the cache every token.

On a mesh (``parallel/mesh.py::shard_params``), the weights are DTensors
laid out by the JAX rule and every projection, norm and the tied head run
through DTensor's sharding propagation, as GSPMD runs the flax model.
Attention is the one place that leaves it: q, k and v are redistributed
to this rank's batch rows and, when the model axis divides the KV heads,
its heads (``parallel/mesh.py::head_sharding``); rotary, the attention
(dense, or the flash kernel when the world is one rank, the JAX model's
auto rule) and the cache write run on those local tensors, and the
output joins the DTensor graph again.  The decode cache then holds this
rank's KV heads.  In decode mode the logits (or hidden rows) come back
whole on every rank, as plain tensors.  A projection whose weight the
layout splits over ranks on a contracted dim gives each rank a partial
sum; in bf16 those partials would be rounded and then summed in bf16,
where one device rounds its f32 accumulation once, which moves the
router's near-ties of the MoE-LM.  So there the product runs in f32 (the
products of bf16 values are exact in f32), the partials are summed in
f32, and the result is rounded once (:func:`_project`).
"""

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from container_engine_accelerators_tpu_torch.models.quant import QDense
from container_engine_accelerators_tpu_torch.ops.flash_attention import (
    flash_attention,
    supports_flash,
)
from container_engine_accelerators_tpu_torch.ops.flash_decode import (
    NEG_INF,
    flash_decode,
)
from container_engine_accelerators_tpu_torch.ops.lm_head import tied_head
from container_engine_accelerators_tpu_torch.ops.moe import MoEFFN
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    full,
    head_sharding,
    replicate,
    settle_partial,
    splits_contraction,
)
from container_engine_accelerators_tpu_torch.parallel.seq import (
    dense_attention,
    ring_attention,
    ulysses_attention,
)

SEQ_PARALLEL = (None, "ring", "ring-zigzag", "ulysses")


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


def head_on_tensor_cores(x, embedding) -> bool:
    """Whether :func:`lm_head` takes the tensor-core path: a training
    call (grad enabled, the embedding requiring grad) on a plain CUDA
    bf16 ``x`` and a plain ``embedding``, neither a DTensor.  Decode
    mode, ``no_grad``, the CPU, a mesh and f32 models keep the f32
    expression."""
    return (x.is_cuda and x.dtype == torch.bfloat16
            and torch.is_grad_enabled() and embedding.requires_grad
            and not isinstance(x, DTensor)
            and not isinstance(embedding, DTensor))


def lm_head(x: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
    """Tied LM head: compute-dtype operands, f32 accumulation -> f32
    logits, in one of two ways that give that arithmetic (the products
    of two bf16 values are exact in f32), picked by
    :func:`head_on_tensor_cores`:

    - a training call on a plain CUDA bf16 tensor runs its GEMMs on the
      tensor cores (``ops/lm_head.py::tied_head``): the forward is bf16
      GEMMs with f32 accumulators and output; the backward splits the
      logits' f32 gradient exactly into three bf16 parts and sums their
      bf16 GEMMs in f32, then rounds the two gradients as autograd
      rounds those of the f32 expression;
    - every other call upcasts the operands and multiplies in f32
      (``x.float() @ embedding.float().t()``), which on the card is
      cuBLAS's f32 GEMM on the CUDA cores."""
    e = embedding.to(x.dtype)
    if head_on_tensor_cores(x, embedding):
        return tied_head(x, e)
    return x.float() @ e.float().t()


def _param(*shape, dtype, device, train):
    """A weight: an f32 leaf with ``requires_grad`` in train mode; in
    decode mode already in ``dtype`` and without autograd bookkeeping."""
    return nn.Parameter(
        torch.empty(*shape, dtype=torch.float32 if train else dtype,
                    device=device),
        requires_grad=train)


def _kernel(shape, n_contract, quant, dtype, device, train):
    """A projection kernel: a float weight (:func:`_param`), or with
    ``quant`` an int8 ``QDense`` whose ``n_contract`` leading dims
    contract."""
    if quant:
        return QDense(shape, n_contract, device)
    return _param(*shape, dtype=dtype, device=device, train=train)


def _w(kernel, dtype):
    """The compute-dtype kernel a projection multiplies: a float weight
    cast, or an int8 one dequantized in f32 and then cast."""
    if isinstance(kernel, QDense):
        return kernel.weight(dtype)
    return kernel.to(dtype)


def _project(x, w, contract, dt):
    """``x @ w`` in the compute dtype ``dt``, with ``w`` a compute-dtype
    kernel whose leading ``contract`` dims x contracts (flattened here).
    On a mesh that splits one of those dims, below f32, the product and
    the sum of the ranks' partials run in f32 and round once, as one
    device's GEMM rounds its f32 accumulation."""
    w2 = w.flatten(0, len(contract) - 1).flatten(1)
    if dt.itemsize < 4 and splits_contraction(w, contract):
        return settle_partial(x.float() @ w2.float()).to(dt)
    return x @ w2


class RMSNorm(nn.Module):
    """f32 math, eps 1e-6, output in the compute dtype.  The scale stays
    f32 whatever the compute dtype (bf16 serving weights load exactly)."""

    def __init__(self, dim, dtype=torch.bfloat16, device=None, train=False):
        super().__init__()
        self.dtype = dtype
        self.scale = _param(dim, dtype=torch.float32, device=device,
                            train=train)

    def forward(self, x):
        y = x.float()
        y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + 1e-6)
        return (y * self.scale).to(self.dtype)


class Attention(nn.Module):
    """GQA attention.  With a KV cache (decode mode): append this call's
    K/V at the cache cursor, attend the queries over everything cached so
    far.  Without one (train mode): causal attention over the sequence,
    the K/V heads repeated up to the query heads."""

    def __init__(self, dim, num_heads, head_dim, dtype=torch.bfloat16,
                 num_kv_heads=None, device=None, train=False, quant=False,
                 seq_parallel=None):
        super().__init__()
        # Sequence parallelism (train mode): the scheme, and the process
        # group whose ranks hold the sequence shards (None: the default
        # group; ``TransformerLM.bind_seq_group`` sets it).
        self.seq_parallel, self.seq_group = seq_parallel, None
        kv_heads = num_kv_heads or num_heads
        if num_heads % kv_heads:
            raise ValueError(f"num_heads={num_heads} not divisible by "
                             f"num_kv_heads={kv_heads}")
        self.num_heads, self.kv_heads, self.head_dim = (
            num_heads, kv_heads, head_dim)
        self.dtype = dtype
        w = dict(quant=quant, dtype=dtype, device=device, train=train)
        self.q = _kernel((dim, num_heads, head_dim), 1, **w)
        self.k = _kernel((dim, kv_heads, head_dim), 1, **w)
        self.v = _kernel((dim, kv_heads, head_dim), 1, **w)
        self.out = _kernel((num_heads, head_dim, dim), 2, **w)

    def forward(self, x, positions, cache=None, use_flash_decode=False,
                use_flash=None):
        b, t, _ = x.shape
        dt = self.dtype
        q = _project(x, _w(self.q, dt), (0,), dt).view(
            b, t, self.num_heads, self.head_dim)
        k = _project(x, _w(self.k, dt), (0,), dt).view(
            b, t, self.kv_heads, self.head_dim)
        v = _project(x, _w(self.v, dt), (0,), dt).view(
            b, t, self.kv_heads, self.head_dim)
        mesh = q.device_mesh if isinstance(q, DTensor) else None
        if mesh is not None:
            # Leave the DTensor graph: this rank's rows and heads.
            heads = head_sharding(mesh, self.kv_heads)
            q, k, v = (a.redistribute(mesh, heads).to_local()
                       for a in (q, k, v))
        q = rotary_embedding(q, positions)
        k = rotary_embedding(k, positions)
        if cache is not None:
            o = self._decode_attend(q, k, v, positions, cache,
                                    use_flash_decode)
        else:
            o = self._train_attend(q, k, v, use_flash,
                                   one_rank=mesh is None or mesh.size() == 1)
        if mesh is not None:
            o = DTensor.from_local(o, mesh, heads, run_check=False)
        return _project(o.reshape(b, t, -1), _w(self.out, dt), (0, 1), dt)

    def _train_attend(self, q, k, v, use_flash, one_rank=True):
        """Causal attention over the whole sequence.  The kernels take
        equal Q and KV heads, so under GQA K/V are repeated up to the
        query heads (``jnp.repeat`` on the head axis).  ``use_flash``
        None (auto) takes the flash kernel on a CUDA tensor whose shape
        it supports, when the world is ``one_rank`` (the JAX model's
        rule: its kernel has no GSPMD partitioning rule, so a sharded
        run keeps XLA's attention), and dense attention otherwise (on
        the CPU too, as the JAX model does off the TPU); True takes
        ``flash_attention`` whatever the device (its plain version on
        the CPU).  Under ``seq_parallel``, q, k and v are this rank's
        sequence shard and the attention is the ring (its blocks through
        the flash op) or Ulysses over ``seq_group`` (``parallel/seq.py``),
        as the JAX model's train mode."""
        rep = self.num_heads // self.kv_heads
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        if self.seq_parallel in ("ring", "ring-zigzag"):
            layout = ("zigzag" if self.seq_parallel == "ring-zigzag"
                      else "contiguous")
            return ring_attention(q, k, v, self.seq_group, causal=True,
                                  layout=layout)
        if self.seq_parallel == "ulysses":
            return ulysses_attention(q, k, v, self.seq_group, causal=True)
        flash = use_flash
        if flash is None:
            flash = (q.is_cuda and one_rank
                     and supports_flash(q.shape[1], self.head_dim))
        if flash:
            return flash_attention(q, k, v, causal=True)
        return dense_attention(q, k, v, causal=True)

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
    """Pre-norm block: attention, then a SwiGLU MLP or, with
    ``num_experts > 0``, a Switch MoE FFN (``ops/moe.py``), drop-free in
    decode mode as in the JAX ``Block`` (train-style capacity depends on
    the token count, so a one-token step and a full forward would drop
    different tokens).  ``forward`` returns ``(x, moe)``: ``moe`` is None
    for a dense block, else the layer's ``(aux loss, share dropped)``."""

    def __init__(self, num_heads, head_dim, mlp_dim, dtype=torch.bfloat16,
                 num_kv_heads=None, device=None, train=False, quant=False,
                 num_experts=0, moe_capacity_factor=1.25, seq_parallel=None):
        super().__init__()
        dim = num_heads * head_dim
        self.dtype = dtype
        self.ln_attn = RMSNorm(dim, dtype, device, train)
        self.attn = Attention(dim, num_heads, head_dim, dtype, num_kv_heads,
                              device, train, quant, seq_parallel)
        self.ln_mlp = RMSNorm(dim, dtype, device, train)
        self.moe = None
        if num_experts > 0:
            # The expert FFNs keep their float path under quant, as the
            # JAX quantize_params leaves the moe subtree.
            self.moe = MoEFFN(
                dim, num_experts, mlp_dim, dtype,
                lambda *shape, dtype: _param(*shape, dtype=dtype,
                                             device=device, train=train),
                capacity_factor=moe_capacity_factor, no_drop=not train)
        else:
            w = dict(quant=quant, dtype=dtype, device=device, train=train)
            self.gate = _kernel((dim, mlp_dim), 1, **w)
            self.up = _kernel((dim, mlp_dim), 1, **w)
            self.down = _kernel((mlp_dim, dim), 1, **w)

    def forward(self, x, positions, cache=None, use_flash_decode=False,
                use_flash=None):
        dt = self.dtype
        x = x + self.attn(self.ln_attn(x), positions, cache, use_flash_decode,
                          use_flash)
        y = self.ln_mlp(x)
        if self.moe is not None:
            out, aux, dropped = self.moe(y)
            return x + out, (aux, dropped)
        h = (F.silu(_project(y, _w(self.gate, dt), (0,), dt))
             * _project(y, _w(self.up, dt), (0,), dt))
        return x + _project(h, _w(self.down, dt), (0,), dt), None


class MoEAux(NamedTuple):
    """What ``TransformerLM.forward(..., return_aux=True)`` returns beside
    its output: ``loss``, the Switch load-balance loss summed over the
    layers (f32, what the JAX model sows into ``losses``), and
    ``dropped``, the share of token routings that overflowed an expert's
    capacity, averaged over the layers (no gradient).  Both are zero for
    a dense model."""

    loss: torch.Tensor
    dropped: torch.Tensor


class TransformerLM(nn.Module):
    """Causal LM.  Train mode: ``forward(tokens [B, T], positions=None)
    -> f32 logits [B, T, V]``, positions defaulting to ``arange(T)``.
    Decode mode: ``forward(tokens, positions, cache)``, updating ``cache``
    in place.  Either returns the final-norm hidden states instead with
    ``project=False``, and with ``return_aux=True`` the pair ``(output,
    MoEAux)`` (the training loss reads the MoE aux term from it).

    ``use_flash`` (train mode) picks the attention: None = auto (the
    flash kernel on the card for the shapes it supports), True = flash,
    False = dense.  ``remat`` recomputes each block's activations in the
    backward instead of keeping them (``torch.utils.checkpoint``), as the
    JAX model's default ``nn.remat`` does: the flash forward then runs
    twice per layer and step.  ``num_experts > 0`` makes every block's FFN
    a Switch top-1 MoE (``ops/moe.py``) with ``moe_capacity_factor`` in
    train mode and drop-free routing in decode mode.  ``quant`` (decode
    mode only, as in JAX) holds every attention and dense-MLP projection
    as int8 + f32 scales (``models/quant.py``; MoE experts stay float);
    load ``serving_params(params, "int8")`` into it.

    ``seq_parallel`` ("ring", "ring-zigzag" or "ulysses"; train mode
    only, as in JAX) makes the attention sequence-parallel: the model then
    takes this rank's columns of the batch with their global positions,
    and ``make_lm_train_step`` binds the group (:meth:`bind_seq_group`)."""

    def __init__(self, vocab_size=32_000, num_layers=12, num_heads=8,
                 head_dim=64, mlp_dim=2048, dtype=torch.bfloat16,
                 num_kv_heads=None, decode=False, use_flash_decode=False,
                 use_flash=None, remat=True, num_experts=0, quant=False,
                 moe_capacity_factor=1.25, seq_parallel=None, device=None):
        super().__init__()
        if quant and not decode:
            raise ValueError("int8 weights (quant=True) serve only: build "
                             "the model with decode=True")
        if seq_parallel not in SEQ_PARALLEL:
            raise ValueError(f"unknown seq_parallel {seq_parallel!r}")
        if decode and seq_parallel:
            raise ValueError("decode mode is single-sequence; it does not "
                             "compose with sequence parallelism")
        self.seq_parallel = seq_parallel
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.num_heads, self.head_dim = num_heads, head_dim
        self.num_kv_heads = num_kv_heads or num_heads
        self.num_experts = num_experts
        self.dtype = dtype
        self.decode = decode
        self.use_flash_decode = use_flash_decode
        self.use_flash = use_flash
        self.remat = remat
        # Train mode: f32 leaves, cast at use.  Decode: cast once at load.
        train = not decode
        self.embed = _param(vocab_size, num_heads * head_dim, dtype=dtype,
                            device=device, train=train)
        self.quant = quant
        self.blocks = nn.ModuleList(
            Block(num_heads, head_dim, mlp_dim, dtype, num_kv_heads, device,
                  train, quant, num_experts, moe_capacity_factor,
                  seq_parallel)
            for _ in range(num_layers))
        self.ln_f = RMSNorm(num_heads * head_dim, dtype, device, train)

    def bind_seq_group(self, group) -> None:
        """Set the process group whose ranks hold the sequence shards in
        every attention layer."""
        for blk in self.blocks:
            blk.attn.seq_group = group

    @property
    def mesh(self):
        """The mesh the weights are sharded over, or None."""
        e = self.embed
        return e.device_mesh if isinstance(e, DTensor) else None

    def forward(self, tokens, positions=None, cache=None, project=True,
                return_aux=False):
        if self.decode and cache is None:
            raise ValueError("decode mode needs a KV cache "
                             "(models/generate.py init_cache)")
        if not self.decode and cache is not None:
            raise ValueError("train mode takes no KV cache; build the model "
                             "with decode=True to decode")
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        mesh = self.mesh
        if mesh is not None:
            tokens = replicate(tokens, mesh)
        x = F.embedding(tokens, self.embed.to(self.dtype))
        if mesh is not None:
            # A vocab-sharded table looks rows up as a masked partial
            # sum; settle it once (the rows are exact) rather than let
            # each later op that reads x reduce it.
            x = settle_partial(x)
        moe = []
        for i, blk in enumerate(self.blocks):
            if self.decode:
                layer = {name: buf[i] for name, buf in cache.items()}
                x, stats = blk(x, positions, layer, self.use_flash_decode)
            elif self.remat and torch.is_grad_enabled():
                x, stats = checkpoint(blk, x, positions, None, False,
                                      self.use_flash, use_reentrant=False)
            else:
                x, stats = blk(x, positions, None, False, self.use_flash)
            if stats is not None:
                moe.append(stats)
        x = self.ln_f(x)
        out = lm_head(x, self.embed) if project else x
        if mesh is not None and self.decode:
            out = full(out)
        if not return_aux:
            return out
        if not moe:
            zero = torch.zeros((), device=x.device)
            return out, MoEAux(zero, zero)
        return out, MoEAux(torch.stack([a for a, _ in moe]).sum(),
                           torch.stack([d for _, d in moe]).mean())


def init_params(model: TransformerLM, generator: torch.Generator) -> dict:
    """Random f32 weights for ``model``'s shapes, drawn on the CPU from
    ``generator``: the flax initializers' law — the kernels lecun_normal
    (truncated normal at two standard deviations, variance 1/fan_in),
    the embedding ``nn.Embed``'s default (a normal of variance 1/D: its
    fan-in is the feature axis, not the vocab), norm scales 1.  Load
    with ``model.load_state_dict``, which casts once.  A
    ``quant=True`` model takes ``quant.serving_params`` of a float
    model's weights instead."""
    if getattr(model, "quant", False):
        raise ValueError("init_params draws float weights: call it on the "
                         "float model and quantize (models/quant.py)")
    out = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            out[name] = torch.ones(p.shape)
            continue
        if name == "embed":
            # variance_scaling(1.0, "fan_in", "normal", out_axis=0) on
            # [V, D]: fan-in D, and "normal" is not truncated.
            out[name] = (torch.randn(p.shape, generator=generator)
                         / math.sqrt(p.shape[1]))
            continue
        if leaf in ("wi_gate", "wi_up", "wo"):
            # Stacked experts [E, in, out]: flax's lecun_normal with
            # batch_axis=(0,) takes the fan-in from the middle axis.
            fan_in = p.shape[1]
        else:
            fan_in = p.shape[0] * (p.shape[1] if leaf == "out" else 1)
        # 0.8796... = stddev of a unit normal truncated to [-2, 2].
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.empty(p.shape)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        out[name] = w * std
    return out
