"""Serving weight precision — counterpart of
``container_engine_accelerators_tpu/models/quant.py``.

Decode reads the whole parameter set for every generated token, so
weight precision is a lever on the bytes a token moves:

- ``serving_params(params, "bf16")``: every float tensor in bf16.
- ``serving_params(params, "int8")``: per-output-channel symmetric int8
  for every attention/MLP kernel (``QDense``: an int8 ``kernel_q`` and an
  f32 ``scale``), the embedding, norm scales and an MoE block's router
  and experts (``moe.*``, left float as the JAX walk leaves them) in
  bf16.  The kernels are quantized from their bf16 cast, as the JAX
  package does (``quantize_params(cast_floats(params))``): quantizing
  the f32 weights instead changes some int8 values.

A ``QDense`` projection dequantizes in f32, casts to the compute dtype
and multiplies — ``QDenseGeneral``'s arithmetic.  On a mesh
(``parallel/mesh.py::shard_params``) the int8 kernel and its scale are
laid out as JAX's rule lays out the quantized tree (``serving_params``,
then ``shard_params``): each by its own shape.  The dequantize then runs
on the kernel's local shard, with the scale brought to the kernel's
layout, and the projection goes on through DTensor as a float kernel's
does.  In eager PyTorch the
dequantized kernel is materialized at every call, so int8 saves memory
but no bytes a token moves (XLA fuses the dequantization into the
operand read); a fused int8 matmul is later work.  The exactness
contract is the JAX package's: the int8 model's greedy tokens equal a
float model's loaded with the *dequantized* weights.
"""

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

# Leaf names of the port's state dict that hold a projection kernel, and
# how many leading dims each contracts: ``attn.out`` [H, hd, D] contracts
# (H, hd), every other kernel its first dim.
_KERNELS = {"attn.q": 1, "attn.k": 1, "attn.v": 1, "attn.out": 2,
            "gate": 1, "up": 1, "down": 1}


def kernel_contract_dims(name: str):
    """Contraction dims of state-dict entry ``name`` if it is a projection
    kernel (``blocks.<i>.attn.q``, ...), else None (``moe.*`` among
    them: the MoE FFN is not quantized)."""
    parts = name.split(".")
    if parts[0] != "blocks" or len(parts) < 3:
        return None
    n = _KERNELS.get(".".join(parts[2:]))
    return None if n is None else tuple(range(n))


def quantize_kernel(w: torch.Tensor, contract_dims):
    """Per-output-channel symmetric int8 quantization -> (int8 kernel, f32
    scale over the remaining dims): ``scale = max|w| / 127`` over the
    contraction dims, in f32."""
    w = w.float()
    contract_dims = tuple(contract_dims)
    amax = w.abs().amax(dim=contract_dims, keepdim=True)
    scale_k = amax.clamp_min(1e-8) / 127.0
    q = torch.round(w / scale_k).clamp(-127, 127).to(torch.int8)
    return q, scale_k.squeeze(contract_dims)


def dequantize_kernel(q: torch.Tensor, scale: torch.Tensor, contract_dims):
    """f32 kernel carrying exactly the values the quantized matmul uses."""
    contract_dims = tuple(contract_dims)
    return q.float() * scale.reshape(
        (1,) * len(contract_dims) + tuple(scale.shape))


class QDense(nn.Module):
    """An int8 projection kernel of ``shape`` (the float kernel's layout)
    with one f32 scale per output channel; ``n_contract`` leading dims
    contract.  Its parameters come from :func:`quantize_params`."""

    def __init__(self, shape, n_contract: int, device=None):
        super().__init__()
        self.n_contract = n_contract
        self.kernel_q = nn.Parameter(
            torch.zeros(shape, dtype=torch.int8, device=device),
            requires_grad=False)
        self.scale = nn.Parameter(
            torch.ones(shape[n_contract:], dtype=torch.float32,
                       device=device), requires_grad=False)

    def weight(self, dtype) -> torch.Tensor:
        """The kernel the projection multiplies: dequantized in f32, then
        cast to the compute ``dtype``.  Sharded (DTensors), it is
        dequantized on this rank's shard and keeps the int8 kernel's
        layout."""
        q, n = self.kernel_q, self.n_contract
        if not isinstance(q, DTensor):
            return dequantize_kernel(q, self.scale, range(n)).to(dtype)
        # The scale spans the kernel's output dims: shard it where the
        # kernel is sharded on one of those, else take it whole.
        target = tuple(Shard(p.dim - n) if p.is_shard() and p.dim >= n
                       else Replicate() for p in q.placements)
        scale = self.scale.redistribute(q.device_mesh, target).to_local()
        w = dequantize_kernel(q.to_local(), scale, range(n)).to(dtype)
        return DTensor.from_local(w, q.device_mesh, q.placements,
                                  run_check=False, shape=q.shape,
                                  stride=q.stride())


def quantize_params(params: dict) -> dict:
    """Float state dict -> the matching ``quant=True`` state dict: every
    projection kernel ``<name>`` becomes ``<name>.kernel_q`` and
    ``<name>.scale``; the embedding and norm scales pass through."""
    out = {}
    for name, t in params.items():
        dims = kernel_contract_dims(name)
        if dims is None:
            out[name] = t
            continue
        out[f"{name}.kernel_q"], out[f"{name}.scale"] = quantize_kernel(
            t, dims)
    return out


def dequantize_params(params: dict) -> dict:
    """A ``quant=True`` state dict -> the float state dict whose kernels
    carry the int8 path's exact values (f32)."""
    out = {}
    for name, t in params.items():
        if name.endswith(".scale") and f"{name[:-6]}.kernel_q" in params:
            continue
        if name.endswith(".kernel_q"):
            base = name[:-len(".kernel_q")]
            out[base] = dequantize_kernel(t, params[f"{base}.scale"],
                                          kernel_contract_dims(base))
            continue
        out[name] = t
    return out


def _cast_floats(params: dict, dtype=torch.bfloat16) -> dict:
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in params.items()}


def serving_params(params: dict, weights: str) -> dict:
    """State dict -> serving weights (``f32`` | ``bf16`` | ``int8``).
    ``bf16`` casts every float tensor, norm scales included, as the JAX
    package does; ``int8`` quantizes the bf16 cast's kernels (scales f32)
    and keeps the rest in bf16 — load it into a ``quant=True`` model."""
    if weights == "f32":
        return params
    if weights == "bf16":
        return _cast_floats(params)
    if weights == "int8":
        return quantize_params(_cast_floats(params))
    raise ValueError(f"unknown weights mode {weights!r}")


def param_bytes(params: dict) -> int:
    return sum(t.numel() * t.element_size() for t in params.values())
