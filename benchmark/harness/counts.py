"""The yardstick's arithmetic: the card's peaks, the model FLOPs of a
training step and of served tokens, K/V bytes, and the bounds of the
flash kernels, all from shapes.

Peaks are NVIDIA's H100 SXM data sheet, dense (no sparsity), at the
card's full 700 W: a run prints the card's power limit beside them.
"""

from harness.weights import sizes

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


def matmul_params(cfg: dict) -> int:
    """Parameters that multiply in a forward: every block projection and
    the tied head (the embedding lookup is no product)."""
    s = sizes(cfg)
    d, h, kvh, hd, f = s["D"], s["H"], s["KVH"], s["hd"], s["F"]
    attn = d * h * hd * 2 + d * kvh * hd * 2  # q, out; k, v
    mlp = 3 * d * f
    return s["L"] * (attn + mlp) + s["V"] * d


def attn_flops_per_key(cfg: dict) -> int:
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
    return (6 * matmul_params(cfg) * tokens
            + 3 * attn_flops_per_key(cfg) * tokens * (seq + 1) / 2)


def forward_flops(cfg: dict, tokens: int, visible_keys: int) -> float:
    """Forward FLOPs of ``tokens`` processed tokens whose queries see
    ``visible_keys`` keys in all (bucket padding excluded)."""
    return (2 * matmul_params(cfg) * tokens
            + attn_flops_per_key(cfg) * visible_keys)


def kv_bytes_per_token(cfg: dict, elem: int = BF16_BYTES) -> int:
    """K and V of one token over all layers."""
    s = sizes(cfg)
    return 2 * s["L"] * s["KVH"] * s["hd"] * elem


# Products of head_dim-long vectors a causal pair costs in each flash
# kernel: forward QK and PV; dQ recomputes QK and forms dP, dQ; dK/dV
# recomputes QK and forms dP, dV, dK.
FLASH_PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def flash_attention_bound_s(kind: str, b: int, t: int, h: int,
                            d: int) -> float:
    """Least time of one causal flash-attention launch at the bf16 peak:
    2 d FLOPs a product over the B H T (T + 1) / 2 causal pairs."""
    pairs = b * h * t * (t + 1) / 2
    return FLASH_PRODUCTS[kind] * 2 * d * pairs / PEAK_BF16_FLOPS


def flash_decode_bytes(lengths, heads: int, kv_heads: int, d: int,
                       elem: int = BF16_BYTES) -> int:
    """Bytes one flash-decode launch needs: each lane's visible K and V
    rows, its query and its output, each read or written once."""
    kv = sum(int(n) for n in lengths) * kv_heads * d * elem * 2
    return kv + 2 * len(lengths) * heads * d * elem


def share(part: float, whole: float, name: str) -> float:
    """``part / whole`` in percent; a share of a peak or a roofline above
    100% means the work was counted too high or the time too low, and
    raises rather than being reported."""
    value = 100.0 * part / whole
    if value > 100.0:
        raise ValueError(f"{name} reads {value:.3f}% > 100%: the work is "
                         f"counted too high or the time leaves some out")
    return value
