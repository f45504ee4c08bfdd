"""flax param trees <-> the port's state dicts: the LM's
(``TransformerLM``) and, below, the image models' (``ResNet``,
``InceptionV3``, with their BatchNorm statistics).

The flax tree (``container_engine_accelerators_tpu/models/transformer.py``
under ``nn.scan``) stacks every layer's leaves along a leading layer
axis; the port keeps one module per layer with the same per-layer
layouts, so conversion is an unstack and a copy:

    embed.embedding                    [V, D]        -> embed (tied head)
    blocks.block.attn.{q,k,v}.kernel   [L, D, H|KVH, hd] -> blocks.i.attn.{q,k,v}
    blocks.block.attn.out.kernel       [L, H, hd, D] -> blocks.i.attn.out
    blocks.block.{gate,up}.kernel      [L, D, mlp]   -> blocks.i.{gate,up}
    blocks.block.down.kernel           [L, mlp, D]   -> blocks.i.down
  or, in an MoE-LM (``num_experts`` E), in their place:
    blocks.block.moe.router.kernel     [L, D, E]     -> blocks.i.moe.router
    blocks.block.moe.{wi_gate,wi_up}   [L, E, D, mlp] -> blocks.i.moe.{wi_gate,wi_up}
    blocks.block.moe.wo                [L, E, mlp, D] -> blocks.i.moe.wo
    blocks.block.ln_{attn,mlp}.scale   [L, D]        -> blocks.i.ln_{attn,mlp}.scale
    ln_f.scale                         [D]           -> ln_f.scale

The state dict is f32, the flax params' dtype: it loads as it is into a
train-mode model (f32 leaves) and, cast once, into a decode-mode one.
:func:`to_flax_params` is the inverse, for comparing the two packages'
params leaf by leaf (after a train step, say).

The int8 serving tree (``models/quant.py::quantize_params``) converts
too: a flax kernel's ``{kernel_q, scale}`` becomes the port's
``<name>.kernel_q`` (int8) and ``<name>.scale`` (f32), for a
``quant=True`` model; an MoE block's experts and router stay float in
it, as the JAX ``quantize_params`` leaves them.
"""

from collections.abc import Mapping

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.models import inception

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
_DENSE_MLP = ("gate", "up", "down")
# Float in either tree: quantization leaves the MoE subtree as it is.
_MOE_LEAVES = {
    ("moe", "router", "kernel"): "moe.router",
    ("moe", "wi_gate"): "moe.wi_gate",
    ("moe", "wi_up"): "moe.wi_up",
    ("moe", "wo"): "moe.wo",
}


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _layer_leaves(quant: bool, moe: bool) -> dict:
    """Per-layer flax paths -> port names, for a dense or an MoE block;
    with ``quant`` every attention and dense-MLP kernel is its
    ``kernel_q`` and ``scale`` pair."""
    leaves = {path: name for path, name in _LAYER_LEAVES.items()
              if not (moe and path[0] in _DENSE_MLP)}
    out = {}
    for path, name in leaves.items():
        if quant and path[-1] == "kernel":
            out[path[:-1] + ("kernel_q",)] = f"{name}.kernel_q"
            out[path[:-1] + ("scale",)] = f"{name}.scale"
        else:
            out[path] = name
    if moe:
        out.update(_MOE_LEAVES)
    return out


def _tensor(x) -> torch.Tensor:
    """An int8 leaf as int8, any other as f32."""
    dtype = np.int8 if np.asarray(x).dtype == np.int8 else np.float32
    return torch.from_numpy(np.array(x, dtype=dtype))


def from_flax_params(params: Mapping) -> dict:
    """Convert a flax param tree (nested dicts of numpy arrays) to a state
    dict for ``TransformerLM``: f32 for a float tree (either mode), int8
    kernels and f32 elsewhere for an int8 tree (``quant=True``); a dense
    LM's or an MoE-LM's (``num_experts > 0``).  Raises ``ValueError`` on a
    tree that is neither layout."""
    got = dict(_leaves(params))
    layer_leaves = _layer_leaves(
        ("blocks", "block", "attn", "q", "kernel_q") in got,
        any(k[:3] == ("blocks", "block", "moe") for k in got))
    expected = ({("embed", "embedding"), ("ln_f", "scale")}
                | {("blocks", "block") + k for k in layer_leaves})
    if set(got) != expected:
        extra = sorted(".".join(k) for k in set(got) - expected)
        missing = sorted(".".join(k) for k in expected - set(got))
        raise ValueError(f"neither a dense nor an MoE LM param tree: "
                         f"unexpected {extra}, missing {missing}")
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
            "blocks.0.attn.q.kernel_q" in state_dict,
            "blocks.0.moe.router" in state_dict).items():
        node = block
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([arr(state_dict[f"blocks.{i}.{name}"])
                                   for i in range(num_layers)])
    return {"embed": {"embedding": arr(state_dict["embed"])},
            "ln_f": {"scale": arr(state_dict["ln_f.scale"])},
            "blocks": {"block": block}}


# ---- image models: flax ResNet / Inception-v3 <-> the port's modules -------
#
# flax numbers its unnamed submodules in call order (``Conv_0``,
# ``BatchNorm_1``, ``BottleneckResNetBlock_12``, ``ConvBNAct_3``); the
# port names them (``conv0``, ``bn1``, ``blocks.12``, ``stem.3`` or a
# branch of ``models/inception.py``'s ``BRANCHES``).  Both directions
# parse the numbers: a sorted walk would put ``_10`` before ``_2``.
#
#   Conv       kernel [kh, kw, in, out] (HWIO)  <-> weight [out, in, kh, kw]
#   Dense      kernel [in, out], bias           <-> weight [out, in], bias
#   BatchNorm  params scale, bias               <-> weight, bias
#              batch_stats mean, var            <-> running_mean, running_var

_IMAGE_LEAVES = {
    "conv": {"weight": ("params", "kernel")},
    "dense": {"weight": ("params", "kernel"), "bias": ("params", "bias")},
    "bn": {"weight": ("params", "scale"), "bias": ("params", "bias"),
           "running_mean": ("batch_stats", "mean"),
           "running_var": ("batch_stats", "var")},
}


def _image_kind(module: str) -> str:
    """conv, dense or bn, from the last name of a module's path in either
    naming (``Conv_0`` / ``conv0`` / ``conv_init`` / ``conv_proj``,
    ``head``, anything else a BatchNorm)."""
    if module.lower().startswith("conv"):
        return "conv"
    return "dense" if module == "head" else "bn"


def _flax_leaf_to_torch(kind: str, x) -> torch.Tensor:
    x = np.asarray(x, dtype=np.float32)
    if kind == "conv" and x.ndim == 4:
        x = x.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif kind == "dense" and x.ndim == 2:
        x = x.T
    return torch.from_numpy(np.ascontiguousarray(x))


def _torch_leaf_to_flax(kind: str, t: torch.Tensor) -> np.ndarray:
    x = t.detach().cpu().float().numpy()
    if kind == "conv" and x.ndim == 4:
        x = x.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif kind == "dense" and x.ndim == 2:
        x = x.T
    return np.ascontiguousarray(x)


def _flax_modules(tree, path=()):
    """(module path, {leaf: array}) for each leaf module of a flax tree."""
    leaves = {k: v for k, v in tree.items() if not isinstance(v, Mapping)}
    if leaves:
        yield path, leaves
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _flax_modules(val, path + (key,))


def _image_from_flax(params, batch_stats, torch_name) -> dict:
    out = {}
    for coll, tree in (("params", params), ("batch_stats", batch_stats or {})):
        for path, leaves in _flax_modules(tree):
            kind = _image_kind(path[-1])
            name = torch_name(path)
            for leaf, (want_coll, flax_leaf) in _IMAGE_LEAVES[kind].items():
                if want_coll == coll and flax_leaf in leaves:
                    out[f"{name}.{leaf}"] = _flax_leaf_to_torch(
                        kind, leaves[flax_leaf])
    return out


def _image_to_flax(state, flax_path) -> tuple:
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    trees = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        module, leaf = key.rsplit(".", 1)
        path = flax_path(module)
        kind = _image_kind(path[-1])
        coll, flax_leaf = _IMAGE_LEAVES[kind][leaf]
        node = trees[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[flax_leaf] = _torch_leaf_to_flax(kind, t)
    return trees["params"], trees["batch_stats"]


def _split_index(name: str):
    """``"BottleneckResNetBlock_12"`` -> (``"BottleneckResNetBlock"``, 12)."""
    head, _, index = name.rpartition("_")
    return head, int(index)


_RESNET_SUB = {"Conv": "conv", "BatchNorm": "bn"}


def resnet_from_flax(params: Mapping, batch_stats: Mapping = None) -> dict:
    """A flax ``ResNet``'s ``params`` (and ``batch_stats``), nested dicts of
    arrays, -> a state dict for the port's ``ResNet`` of the same depth and
    widths (f32 CPU tensors; ``load_state_dict`` places and lays them out).
    Without ``batch_stats`` the running statistics are left out."""

    def torch_name(path):
        if len(path) == 1:  # conv_init, bn_init, head
            return path[0]
        block, sub = path
        _, n = _split_index(block)
        if sub in ("conv_proj", "norm_proj"):
            return f"blocks.{n}.{sub}"
        kind, i = _split_index(sub)
        return f"blocks.{n}.{_RESNET_SUB[kind]}{i}"

    return _image_from_flax(params, batch_stats, torch_name)


def resnet_to_flax(state) -> tuple:
    """The port's ``ResNet`` (or any mapping from its parameter and buffer
    names to tensors: gradients, momentum buffers) -> ``(params,
    batch_stats)`` in flax's layout, nested dicts of f32 numpy arrays."""
    if isinstance(state, torch.nn.Module):
        state = state.state_dict()
    bottleneck = any(k.startswith("blocks.") and ".conv2." in k
                     for k in state)
    block = "BottleneckResNetBlock" if bottleneck else "ResNetBlock"
    sub_of = {v: k for k, v in _RESNET_SUB.items()}

    def flax_path(module):
        parts = module.split(".")
        if parts[0] != "blocks":
            return (module,)
        _, n, sub = parts
        if sub not in ("conv_proj", "norm_proj"):
            sub = f"{sub_of[sub.rstrip('0123456789')]}_{sub[-1]}"
        return (f"{block}_{n}", sub)

    return _image_to_flax(state, flax_path)


# The port's InceptionV3 stages by attribute name, each block class with
# its BRANCHES in flax's call order.
_INCEPTION_BLOCKS = {"a": inception.InceptionA, "b": inception.InceptionB,
                     "c": inception.InceptionC, "d": inception.InceptionD,
                     "e": inception.InceptionE}


def inception_from_flax(params: Mapping, batch_stats: Mapping = None) -> dict:
    """``resnet_from_flax`` for a flax ``InceptionV3``: ``ConvBNAct_i`` at
    the top is ``stem.i``; ``InceptionA_i``'s ``ConvBNAct_j`` is
    ``a.i.<InceptionA.BRANCHES[j]>``, and so on for B-E."""
    inner = {"Conv_0": "conv", "BatchNorm_0": "bn"}

    def torch_name(path):
        if path == ("head",):
            return "head"
        if len(path) == 2:
            return f"stem.{_split_index(path[0])[1]}.{inner[path[1]]}"
        block, cba, leaf = path
        kind, i = _split_index(block)
        stage = kind[-1].lower()
        branch = _INCEPTION_BLOCKS[stage].BRANCHES[_split_index(cba)[1]]
        return f"{stage}.{i}.{branch}.{inner[leaf]}"

    return _image_from_flax(params, batch_stats, torch_name)


def inception_to_flax(state) -> tuple:
    """``resnet_to_flax`` for the port's ``InceptionV3``."""
    inner = {"conv": "Conv_0", "bn": "BatchNorm_0"}

    def flax_path(module):
        parts = module.split(".")
        if parts == ["head"]:
            return ("head",)
        if parts[0] == "stem":
            return (f"ConvBNAct_{parts[1]}", inner[parts[2]])
        stage, i, branch, leaf = parts
        j = _INCEPTION_BLOCKS[stage].BRANCHES.index(branch)
        return (f"Inception{stage.upper()}_{i}", f"ConvBNAct_{j}",
                inner[leaf])

    return _image_to_flax(state, flax_path)
