"""Designed flash-decode inputs shared by the port's tests (numpy only,
no jax, so the card-only tests can use them too)."""

import numpy as np


def p_cast_inputs(b, cache_len, h, kvh, d):
    """Inputs on which the rule "p is rounded to V's dtype before P.V"
    moves the bf16 output by ~18%, far past its rounding.  Every score is
    exact in f32 whatever the summation order (q is a unit vector, the
    scale a power of two, k's first column bf16-exact), and slot 0 of
    every 32 keys holds the row's max (score 0), so a kernel's running
    max equals the global max in every tile and p is the same f32 number
    in any kernel.  Slot 1 of every 32 has p = exp(-0.01001) = 0.99004,
    which bf16 rounds to 0.98828; its V is -1 against slot 0's +1, so the
    output (1 - p) / (1 + p) is 0.00589 with p rounded and 0.00500
    without.  Every other slot scores -64 (p ~ 1.6e-28)."""
    rng = np.random.default_rng(7)
    scale = d ** -0.5
    q = np.zeros((b, h, d), np.float32)
    q[..., 0] = 1.0
    k = rng.standard_normal((b, cache_len, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, cache_len, kvh, d)).astype(np.float32)
    slot = np.arange(cache_len) % 32
    k[:, :, :, 0] = np.where(slot == 0, 0.0,
                             np.where(slot == 1, -41 / 4096 / scale,
                                      -64 / scale))[None, :, None]
    v[:, slot == 0] = 1.0
    v[:, slot == 1] = -1.0
    return q, k, v
