"""A cell's weights, drawn on the device from the seed.

The law is flax's initializers', which the port's ``init_params`` also
follows: projection kernels a normal truncated to two standard
deviations with variance 1/fan_in, the embedding a normal of variance
1/D, norm scales 1.  Each kind of leaf is drawn for every layer at once,
``[layers, *shape]``, in one call on the card from a generator seeded by
the seed and the kind, so the same seed gives the same weights to the
program and, after the window, to the reference, and a leaf can be drawn
again alone.

Names and layouts are the ones both sides use: ``embed`` [V, D],
``blocks.<i>.attn.q`` / ``k`` / ``v`` [D, heads, head_dim], ``attn.out``
[H, head_dim, D], ``gate`` / ``up`` [D, F], ``down`` [F, D],
``ln_attn.scale`` / ``ln_mlp.scale`` / ``ln_f.scale`` [D].
"""

import math

import torch

# Standard deviation of a unit normal truncated to [-2, 2].
TRUNC_STD = 0.87962566103423978

LAYER_KINDS = ("ln_attn.scale", "attn.q", "attn.k", "attn.v", "attn.out",
               "ln_mlp.scale", "gate", "up", "down")
GLOBAL_KINDS = ("embed", "ln_f.scale")


def sizes(cfg: dict) -> dict:
    """The sizes the equations read, from a configuration file."""
    d = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return {"D": d, "H": heads, "KVH": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim", d // heads),
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"], "eps": cfg["rms_norm_eps"],
            "theta": cfg["rope_theta"]}


def kind_shape(cfg: dict, kind: str):
    """(shape of one leaf of ``kind``, fan-in or None for ones/normal)."""
    s = sizes(cfg)
    d, h, kvh, hd, f = s["D"], s["H"], s["KVH"], s["hd"], s["F"]
    return {
        "embed": ((s["V"], d), None),
        "ln_f.scale": ((d,), None),
        "ln_attn.scale": ((d,), None),
        "ln_mlp.scale": ((d,), None),
        "attn.q": ((d, h, hd), d),
        "attn.k": ((d, kvh, hd), d),
        "attn.v": ((d, kvh, hd), d),
        "attn.out": ((h, hd, d), h * hd),
        "gate": ((d, f), d),
        "up": ((d, f), d),
        "down": ((f, d), f),
    }[kind]


def leaf_names(cfg: dict, kind: str):
    if kind in GLOBAL_KINDS:
        return [kind]
    return [f"blocks.{i}.{kind}" for i in range(sizes(cfg)["L"])]


def all_kinds():
    return GLOBAL_KINDS + LAYER_KINDS


def _generator(seed: int, salt: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + salt) % (2 ** 63))


def draw_kind(cfg: dict, kind: str, seed: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """Every layer's leaf of ``kind`` at once, ``[L, *shape]`` (a global
    kind: its one leaf), drawn in f32 and cast to ``dtype``."""
    shape, fan_in = kind_shape(cfg, kind)
    if kind not in GLOBAL_KINDS:
        shape = (sizes(cfg)["L"],) + shape
    salt = all_kinds().index(kind) + 1
    if kind.endswith("scale"):
        return torch.ones(shape, dtype=dtype, device=device)
    g = _generator(seed, salt, device)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    if kind == "embed":
        w.normal_(0.0, 1.0, generator=g).div_(math.sqrt(shape[-1]))
    else:
        # Inverse-CDF truncated normal, as torch.nn.init.trunc_normal_.
        lo, hi = (1 + math.erf(-2 / math.sqrt(2))) / 2, \
            (1 + math.erf(2 / math.sqrt(2))) / 2
        w.uniform_(2 * lo - 1, 2 * hi - 1, generator=g)
        w.erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        w.mul_(math.sqrt(1.0 / fan_in) / TRUNC_STD)
    return w.to(dtype)


def leaves(cfg: dict, kind: str, stacked: torch.Tensor):
    """(name, leaf) of a kind drawn by :func:`draw_kind`."""
    if kind in GLOBAL_KINDS:
        return [(kind, stacked)]
    return list(zip(leaf_names(cfg, kind), stacked.unbind(0)))


def draw(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Every leaf, name -> a tensor of its own in ``dtype``."""
    out = {}
    for kind in all_kinds():
        stacked = draw_kind(cfg, kind, seed, device, dtype)
        out.update((n, t.clone()) for n, t in leaves(cfg, kind, stacked))
        del stacked
    return out


@torch.no_grad()
def load_into(params: dict, cfg: dict, seed: int, device, dtype) -> None:
    """Copy the drawn weights into a model's parameters (``name ->
    tensor``, as ``named_parameters``), one kind at a time: the draw is
    in ``dtype``, the type the weights are served or trained in, and
    each copy casts to the parameter's own type."""
    for kind in all_kinds():
        stacked = draw_kind(cfg, kind, seed, device, dtype)
        for name, leaf in leaves(cfg, kind, stacked):
            params[name].copy_(leaf)
        del stacked
