"""The SmolLM architecture (HuggingFaceTB/SmolLM-*) as the harness runs
it: its sizes, its leaves, the program's model for each kind of traffic,
and its model FLOPs and K/V bytes.  Everything the harness knows of one
architecture is here; the plain reference of its equations is
``reference/smollm.py``.

Leaves, in the order that sets each kind's salt (``harness/weights.py``):
``embed`` [V, D], ``ln_f.scale`` [D], then in every block
``blocks.<i>.ln_attn.scale`` [D], ``attn.q`` / ``k`` / ``v`` [D, heads,
head_dim], ``attn.out`` [H, head_dim, D], ``ln_mlp.scale`` [D], ``gate``
/ ``up`` [D, F] and ``down`` [F, D].
"""

import torch

from harness.counts import BF16_BYTES
from harness.weights import Kind


def sizes(cfg: dict) -> dict:
    """The sizes the equations read, from a configuration file."""
    d = cfg["hidden_size"]
    heads = cfg["num_attention_heads"]
    return {"D": d, "H": heads, "KVH": cfg["num_key_value_heads"],
            "hd": cfg.get("head_dim", d // heads),
            "F": cfg["intermediate_size"], "V": cfg["vocab_size"],
            "L": cfg["num_hidden_layers"], "eps": cfg["rms_norm_eps"],
            "theta": cfg["rope_theta"]}


def kinds(cfg: dict) -> list:
    """The leaf kinds, globals first, each block's in every layer."""
    s = sizes(cfg)
    d, h, kvh, hd, f = s["D"], s["H"], s["KVH"], s["hd"], s["F"]
    every = tuple(range(s["L"]))

    def block(name, shape, law, fan_in=None):
        return Kind(f"blocks.{{}}.{name}", shape, law, fan_in, every)

    return [
        Kind("embed", (s["V"], d), "embed"),
        Kind("ln_f.scale", (d,), "ones"),
        block("ln_attn.scale", (d,), "ones"),
        block("attn.q", (d, h, hd), "trunc_normal", d),
        block("attn.k", (d, kvh, hd), "trunc_normal", d),
        block("attn.v", (d, kvh, hd), "trunc_normal", d),
        block("attn.out", (h, hd, d), "trunc_normal", h * hd),
        block("ln_mlp.scale", (d,), "ones"),
        block("gate", (d, f), "trunc_normal", d),
        block("up", (d, f), "trunc_normal", d),
        block("down", (f, d), "trunc_normal", f),
    ]


def build(cfg: dict, device, mode: str, quant: bool = False):
    """The program's model in bf16, the weights not yet drawn: for
    ``train`` on the flash kernels with remat, for ``serve`` in decode
    mode on flash decode (``quant``: the int8 weight path)."""
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    s = sizes(cfg)
    shape = dict(vocab_size=s["V"], num_layers=s["L"], num_heads=s["H"],
                 head_dim=s["hd"], mlp_dim=s["F"], num_kv_heads=s["KVH"],
                 dtype=torch.bfloat16)
    if mode == "train":
        return TransformerLM(**shape, decode=False, use_flash=True,
                             remat=True, device=device)
    if mode == "serve":
        return TransformerLM(**shape, decode=True, quant=quant,
                             use_flash_decode=True, device=device)
    raise ValueError(f"unknown mode {mode!r}")


def _matmul_params(cfg: dict) -> int:
    """Parameters that multiply in a forward: every block projection and
    the tied head (the embedding lookup is no product)."""
    s = sizes(cfg)
    d, h, kvh, hd, f = s["D"], s["H"], s["KVH"], s["hd"], s["F"]
    attn = d * h * hd * 2 + d * kvh * hd * 2  # q, out; k, v
    mlp = 3 * d * f
    return s["L"] * (attn + mlp) + s["V"] * d


def _attn_flops_per_key(cfg: dict) -> int:
    """Forward FLOPs a query spends on one visible key over all layers:
    QK and PV, 2 * head_dim each, for every query head."""
    s = sizes(cfg)
    return 4 * s["L"] * s["H"] * s["hd"]


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N a token for the products
    (forward and backward, tied head included) and 3 x the causal
    attention's forward, (T + 1) / 2 visible keys a query on average.
    Remat's recompute is not counted."""
    tokens = batch * seq
    return (6 * _matmul_params(cfg) * tokens
            + 3 * _attn_flops_per_key(cfg) * tokens * (seq + 1) / 2)


def forward_flops(cfg: dict, tokens: int, visible_keys: int) -> float:
    """Forward FLOPs of ``tokens`` processed tokens whose queries see
    ``visible_keys`` keys in all (bucket padding excluded)."""
    return (2 * _matmul_params(cfg) * tokens
            + _attn_flops_per_key(cfg) * visible_keys)


def kv_bytes_per_token(cfg: dict, elem: int = BF16_BYTES) -> int:
    """K and V of one token over all layers."""
    s = sizes(cfg)
    return 2 * s["L"] * s["KVH"] * s["hd"] * elem
