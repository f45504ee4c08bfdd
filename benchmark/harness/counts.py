"""The yardstick's arithmetic that holds for any model: the card's
peaks, a share of one, and the bounds of the flash kernels from a
launch's shape.  A model's own FLOPs and K/V bytes are its
architecture's (``arch/<architecture>.py``).

Peaks are NVIDIA's H100 SXM data sheet, dense (no sparsity), at the
card's full 700 W: a run prints the card's power limit beside them.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


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
