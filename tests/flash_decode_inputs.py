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


def bwd_cast_inputs(b, t, h, d):
    """Flash-attention backward inputs (q, k, v, o, lse [B*H, T], do; f32
    numpy, every value bf16-exact) on which the rules "P is rounded to dO's
    dtype before P^T.dO" and "dS is rounded to Q's dtype before dS^T.Q"
    move dV and dK by far more than one bf16 step.  Non-causal, scale
    d**-0.5 = 1/8 at d = 64.  Query rows come in four kinds by i % 4:
    kinds 0 and 1 ("A") have q = e0, kinds 2 and 3 ("B") q = e1; k's first
    two columns make every score exact: 0 for A rows and -41/4096 for B
    rows at every key.  lse is 0 (the backward takes it as given), so P is
    1 on A rows and exp(-41/4096) = 0.99004 on B rows, which bf16 rounds
    to 0.98828.  dO is +1 on A rows and -1 on B rows, so every element of
    dV is (T/2)(1 - P_B): 0.01172 T/2 with the cast, 0.00996 T/2 without.
    V is 0, so dS = -P delta scale with delta = rowsum(dO * O) set by O:
    1 on kind 0, -(253/256 + 2**-10) on kind 1, 0 on B rows, all exact;
    dS on kind 1 rows is 0.12366, which bf16 rounds to 0.12354, and
    dK[:, :, :, 0] = (T/4)(dS_1 - 1/8) is -0.0014648 T/4 with the cast and
    -0.0013428 T/4 without (its other columns are 0).  Every product and
    sum is exact in f32 in any order."""
    rng = np.random.default_rng(8)
    scale = d ** -0.5
    kind = np.arange(t) % 4
    a_rows = kind < 2
    q = np.zeros((b, t, h, d), np.float32)
    q[:, a_rows, :, 0] = 1.0
    q[:, ~a_rows, :, 1] = 1.0
    # Random elsewhere (only dQ reads them), on a 1/32 grid: bf16-exact.
    k = np.round(rng.standard_normal((b, t, h, d)) * 32).astype(np.float32) / 32
    k[..., 0] = 0.0
    k[..., 1] = -41 / 4096 / scale
    v = np.zeros((b, t, h, d), np.float32)
    o = np.zeros((b, t, h, d), np.float32)
    o[:, kind == 0, :, 0] = 1.0
    o[:, kind == 1, :, 0] = -253 / 256
    o[:, kind == 1, :, 1] = -2.0 ** -10
    do = np.where(a_rows[None, :, None, None], 1.0, -1.0) * np.ones(
        (b, t, h, d), np.float32)
    lse = np.zeros((b * h, t), np.float32)
    return q, k, v, o, lse, do.astype(np.float32)


def dq_cast_inputs(b, t, h, d):
    """Flash-attention backward inputs (q, k, v, o, lse [B*H, T], do; f32
    numpy, every value bf16-exact) on which the rule "dS is rounded to K's
    dtype before dS.K" moves dQ's second column by 18%.  Non-causal, scale
    d**-0.5 = 1/8 at d = 64.  Every query row has q = e0 and every key one
    of two kinds by index parity: k[0] = 0 (score 0) on even keys and
    -41/4096 / scale (score -41/4096) on odd ones, k[1] = +1 and -1, 0
    elsewhere.  lse is 0 (the backward takes it as given), so P is 1 on
    even keys and exp(-41/4096) = 0.99004 on odd ones.  V is 0, so dP = 0
    and dS = -P delta scale, and O = -e0 with dO = 1 makes delta = -1: dS is
    1/8 exactly on even keys and 0.123755 on odd ones, which bf16 rounds to
    0.123535.  dQ[..., 1] = (T/2)(1/8 - dS_odd) is 0.0014648 T/2 with the
    cast and 0.0012450 T/2 without; dQ[..., 2:] is 0.  Every product and
    sum is exact in f32 in any order."""
    scale = d ** -0.5
    odd = np.arange(t) % 2 == 1
    q = np.zeros((b, t, h, d), np.float32)
    q[..., 0] = 1.0
    k = np.zeros((b, t, h, d), np.float32)
    k[:, odd, :, 0] = -41 / 4096 / scale
    k[..., 1] = np.where(odd, -1.0, 1.0)[None, :, None]
    v = np.zeros((b, t, h, d), np.float32)
    o = np.zeros((b, t, h, d), np.float32)
    o[..., 0] = -1.0
    do = np.ones((b, t, h, d), np.float32)
    lse = np.zeros((b * h, t), np.float32)
    return q, k, v, o, lse, do
