"""flax LM params <-> the port's ``TransformerLM`` state dict.

The flax tree (``container_engine_accelerators_tpu/models/transformer.py``
under ``nn.scan``) stacks every layer's leaves along a leading layer
axis; the port keeps one module per layer with the same per-layer
layouts, so conversion is an unstack and a copy:

    embed.embedding                    [V, D]        -> embed (tied head)
    blocks.block.attn.{q,k,v}.kernel   [L, D, H|KVH, hd] -> blocks.i.attn.{q,k,v}
    blocks.block.attn.out.kernel       [L, H, hd, D] -> blocks.i.attn.out
    blocks.block.{gate,up}.kernel      [L, D, mlp]   -> blocks.i.{gate,up}
    blocks.block.down.kernel           [L, mlp, D]   -> blocks.i.down
    blocks.block.ln_{attn,mlp}.scale   [L, D]        -> blocks.i.ln_{attn,mlp}.scale
    ln_f.scale                         [D]           -> ln_f.scale

The state dict is f32, the flax params' dtype: it loads as it is into a
train-mode model (f32 leaves) and, cast once, into a decode-mode one.
:func:`to_flax_params` is the inverse, for comparing the two packages'
params leaf by leaf (after a train step, say).

The int8 serving tree (``models/quant.py::quantize_params``) converts
too: a flax kernel's ``{kernel_q, scale}`` becomes the port's
``<name>.kernel_q`` (int8) and ``<name>.scale`` (f32), for a
``quant=True`` model.
"""

from collections.abc import Mapping

import numpy as np
import torch

_LAYER_LEAVES = {
    ("attn", "q", "kernel"): "attn.q",
    ("attn", "k", "kernel"): "attn.k",
    ("attn", "v", "kernel"): "attn.v",
    ("attn", "out", "kernel"): "attn.out",
    ("gate", "kernel"): "gate",
    ("up", "kernel"): "up",
    ("down", "kernel"): "down",
    ("ln_attn", "scale"): "ln_attn.scale",
    ("ln_mlp", "scale"): "ln_mlp.scale",
}


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _layer_leaves(quant: bool) -> dict:
    """Per-layer flax paths -> port names; with ``quant`` every kernel is
    its ``kernel_q`` and ``scale`` pair."""
    if not quant:
        return _LAYER_LEAVES
    out = {}
    for path, name in _LAYER_LEAVES.items():
        if path[-1] == "kernel":
            out[path[:-1] + ("kernel_q",)] = f"{name}.kernel_q"
            out[path[:-1] + ("scale",)] = f"{name}.scale"
        else:
            out[path] = name
    return out


def _tensor(x) -> torch.Tensor:
    """An int8 leaf as int8, any other as f32."""
    dtype = np.int8 if np.asarray(x).dtype == np.int8 else np.float32
    return torch.from_numpy(np.array(x, dtype=dtype))


def from_flax_params(params: Mapping) -> dict:
    """Convert a flax param tree (nested dicts of numpy arrays) to a state
    dict for ``TransformerLM``: f32 for a float tree (either mode), int8
    kernels and f32 elsewhere for an int8 tree (``quant=True``).  Raises
    ``ValueError`` on leaves the dense model does not have (MoE)."""
    got = dict(_leaves(params))
    layer_leaves = _layer_leaves(
        ("blocks", "block", "attn", "q", "kernel_q") in got)
    expected = ({("embed", "embedding"), ("ln_f", "scale")}
                | {("blocks", "block") + k for k in layer_leaves})
    if set(got) != expected:
        extra = sorted(".".join(k) for k in set(got) - expected)
        missing = sorted(".".join(k) for k in expected - set(got))
        raise ValueError(f"not a dense LM param tree: unexpected {extra}, "
                         f"missing {missing}")
    out = {"embed": _tensor(got["embed", "embedding"]),
           "ln_f.scale": _tensor(got["ln_f", "scale"])}
    num_layers = np.shape(got["blocks", "block", "ln_attn", "scale"])[0]
    for path, name in layer_leaves.items():
        stacked = np.asarray(got[("blocks", "block") + path])
        for i in range(num_layers):
            out[f"blocks.{i}.{name}"] = _tensor(stacked[i])
    return out


def to_flax_params(state_dict: Mapping) -> dict:
    """The port's state dict (any dtype, any device) -> the flax param
    tree as nested dicts of numpy arrays (int8 kernels as int8, every
    other leaf f32), per-layer leaves stacked along a leading layer axis
    as ``nn.scan`` keeps them."""
    def arr(t):
        t = t.detach().cpu()
        return (t if t.dtype == torch.int8 else t.float()).numpy()

    num_layers = 1 + max(int(name.split(".")[1]) for name in state_dict
                         if name.startswith("blocks."))
    block = {}
    for path, name in _layer_leaves(
            "blocks.0.attn.q.kernel_q" in state_dict).items():
        node = block
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([arr(state_dict[f"blocks.{i}.{name}"])
                                   for i in range(num_layers)])
    return {"embed": {"embedding": arr(state_dict["embed"])},
            "ln_f": {"scale": arr(state_dict["ln_f.scale"])},
            "blocks": {"block": block}}
