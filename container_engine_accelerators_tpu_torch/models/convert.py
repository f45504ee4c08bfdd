"""flax LM params -> the port's ``TransformerLM`` state dict.

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


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def from_flax_params(params: Mapping) -> dict:
    """Convert a flax param tree (nested dicts of numpy arrays) to an f32
    state dict for ``TransformerLM(decode=True)``.  Raises ``ValueError``
    on leaves the dense decode model does not have (MoE, int8 kernels)."""
    expected = ({("embed", "embedding"), ("ln_f", "scale")}
                | {("blocks", "block") + k for k in _LAYER_LEAVES})
    got = dict(_leaves(params))
    if set(got) != expected:
        extra = sorted(".".join(k) for k in set(got) - expected)
        missing = sorted(".".join(k) for k in expected - set(got))
        raise ValueError(f"not a dense LM param tree: unexpected {extra}, "
                         f"missing {missing}")
    out = {"embed": _tensor(got["embed", "embedding"]),
           "ln_f.scale": _tensor(got["ln_f", "scale"])}
    num_layers = np.shape(got["blocks", "block", "ln_attn", "scale"])[0]
    for path, name in _LAYER_LEAVES.items():
        stacked = np.asarray(got[("blocks", "block") + path])
        for i in range(num_layers):
            out[f"blocks.{i}.{name}"] = _tensor(stacked[i])
    return out
