"""The PyTorch port's flash attention against the JAX package's Pallas
kernels.

On the CPU the port's ``flash_attention`` runs its plain versions
(``flash_attention_reference`` / ``flash_attention_bwd_reference``)
behind the same ``torch.autograd.Function`` the kernels use on the card;
the JAX side runs ``_fa_kernel`` and the two backward kernels in
interpret mode, as tests/test_flash_attention.py does.  Same inputs
(numpy, seeded) on both sides.  Tolerances are the JAX kernels' own
(atol and rtol): forward 2e-5 in f32 (f32 accumulation in another
order) and 2e-2 in bf16 (p rounded to bf16 against another running max,
output rounded to bf16); backward 2e-4 in f32 and 1e-1 in bf16 (dS and P
rounded to bf16 before their products, gradients rounded to bf16).

The CUDA kernels themselves run only on the card: their tests are in
tests/test_torch_cuda_kernels.py, marked ``cuda``, and skip here.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.parallel import seq as jseq
from container_engine_accelerators_tpu_torch.ops import flash_attention as fa
from container_engine_accelerators_tpu_torch.parallel.seq import (
    dense_attention,
)
from flash_decode_inputs import bwd_cast_inputs, dq_cast_inputs, p_cast_inputs

# The JAX ops package re-exports the function under the module's name.
jfa = importlib.import_module("container_engine_accelerators_tpu.ops."
                              "flash_attention")

FWD_TOL = {"f32": 2e-5, "bf16": 2e-2}
BWD_TOL = {"f32": 2e-4, "bf16": 1e-1}
JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
CASES = [(causal, dtype, d, t) for causal in (False, True)
         for dtype in ("f32", "bf16") for d in (64, 128, 256)
         for t in (128, 384)]  # T = 128: one block; 384: three
IDS = [f"{'causal' if c else 'full'}-{dt}-d{d}-t{t}" for c, dt, d, t in CASES]


def _inputs(t, d, b=1, h=2, seed=0):
    """q, k, v and the output gradient, [B, T, H, D] f32 numpy."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d), dtype=np.float32)
                 for _ in range(4))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax(causal, dtype, d, t):
    """JAX interpret-mode kernels: (o, lse [B*H, T], dq, dk, dv), f32
    numpy; shared by the forward and backward tests."""
    q, k, v, g = (jnp.asarray(x, JAX_DTYPE[dtype]) for x in _inputs(t, d))
    _, lse = jfa._fa_forward(q, k, v, causal, d ** -0.5, True, jfa.BLOCK_Q,
                             jfa.BLOCK_K)
    o, vjp = jax.vjp(
        lambda a, b, c: jfa.flash_attention(a, b, c, causal, None, True),
        q, k, v)
    return (_f32(o), _f32(lse[..., 0])) + tuple(_f32(x) for x in vjp(g))


def _port(causal, dtype, d, t):
    """The port through its autograd Function: (o, lse, dq, dk, dv)."""
    td = TORCH_DTYPE[dtype]
    q, k, v, g = (torch.from_numpy(x).to(td) for x in _inputs(t, d))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    _, lse = fa.flash_attention_reference(q.detach(), k.detach(), v.detach(),
                                          causal)
    o = fa.flash_attention(q, k, v, causal)
    assert o.dtype == td and lse.dtype == torch.float32
    o.backward(g)
    assert q.grad.dtype == k.grad.dtype == v.grad.dtype == td
    return tuple(x.detach().float().numpy()
                 for x in (o, lse, q.grad, k.grad, v.grad))


@pytest.mark.parametrize("causal,dtype,d,t", CASES, ids=IDS)
def test_forward_matches_jax_kernel(causal, dtype, d, t):
    want = _jax(causal, dtype, d, t)
    got = _port(causal, dtype, d, t)
    tol = FWD_TOL[dtype]
    for name, a, b in zip(("o", "lse"), got[:2], want[:2]):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("causal,dtype,d,t", CASES, ids=IDS)
def test_backward_matches_jax_vjp(causal, dtype, d, t):
    want = _jax(causal, dtype, d, t)
    got = _port(causal, dtype, d, t)
    tol = BWD_TOL[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got[2:], want[2:]):
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


def test_p_is_cast_to_v_dtype_like_the_jax_kernel():
    """Random inputs cannot see the forward's p cast (it moves an output
    less than bf16 rounds it); tests/flash_decode_inputs.py's designed
    inputs can, with every query row the decode query: each 32 keys hold
    the row's max, so every tile's running max is the row's and p is the
    same f32 number in any kernel, and the output is (1 - p) / (1 + p)
    with p = 0.99004, 0.00589 with the cast and 0.00500 without.  The
    plain version agrees with the JAX kernel to one bf16 step; the same
    math with p kept in f32 does not."""
    q, k, v = p_cast_inputs(1, 256, 2, 2, 64)
    q = np.repeat(q[:, None], 256, axis=1)  # [1, T, H, D]
    want = np.asarray(jfa.flash_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), False, None,
        True).astype(jnp.float32))
    args = [torch.from_numpy(x) for x in (q, k, v)]
    got = fa.flash_attention(*(x.bfloat16() for x in args)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    p_in_f32 = fa.flash_attention(*args).bfloat16().float().numpy()
    assert not np.allclose(p_in_f32, want, rtol=2 ** -7, atol=0)
    assert abs(float(want.max()) - 0.00589) < 2e-4


def test_p_and_ds_are_cast_like_the_jax_kernels():
    """Random inputs cannot see the backward's casts either (P and dS kept
    in f32 stay under the bf16 bound); tests/flash_decode_inputs.py's
    designed backward inputs can: there rounding P to dO's dtype moves
    every element of dV by 18%, and rounding dS to Q's dtype moves dK's
    first column by 9%.  The port's backward agrees with the JAX kernels
    to one bf16 step; the same math with P and dS kept in f32 does not."""
    q, k, v, o, lse, do = bwd_cast_inputs(1, 256, 2, 64)
    lanes = np.repeat(lse[..., None], jfa.LSE_LANES, axis=-1)
    _, jdk, jdv = jfa._fa_backward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, o)),
        jnp.asarray(lanes), jnp.asarray(do, jnp.bfloat16), False, 0.125, True,
        jfa.BLOCK_Q, jfa.BLOCK_K)
    want = {"dk": _f32(jdk)[..., 0], "dv": _f32(jdv)}
    f32 = [torch.from_numpy(x) for x in (q, k, v, o, lse, do)]
    bf16 = [x if i == 4 else x.bfloat16() for i, x in enumerate(f32)]
    _, dk, dv = fa.flash_backward(*bf16, False, 0.125)
    _, ctrl_dk, ctrl_dv = fa.flash_backward(*f32, False, 0.125)
    got = {"dk": dk.float().numpy()[..., 0], "dv": dv.float().numpy()}
    ctrl = {"dk": ctrl_dk.bfloat16().float().numpy()[..., 0],
            "dv": ctrl_dv.bfloat16().float().numpy()}
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=2 ** -7, atol=0,
                                   err_msg=name)
        assert not np.allclose(ctrl[name], want[name], rtol=2 ** -7, atol=0), \
            name
    assert np.all(want["dv"] == 1.5) and np.all(want["dk"] == -0.09375)
    assert not dk.float()[..., 1:].any()


def test_ds_is_cast_to_k_dtype_before_dq_like_the_jax_kernel():
    """tests/flash_decode_inputs.py's designed dQ inputs: rounding dS to
    K's dtype before dS.K moves dQ's second column by 18% (0.0014648 T/2
    with the cast, 0.0012450 T/2 without), every sum exact in f32.  The
    port's backward agrees with the JAX dQ kernel to one bf16 step; the
    same math with dS kept in f32 does not."""
    q, k, v, o, lse, do = dq_cast_inputs(1, 256, 2, 64)
    lanes = np.repeat(lse[..., None], jfa.LSE_LANES, axis=-1)
    jdq, _, _ = jfa._fa_backward(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, o)),
        jnp.asarray(lanes), jnp.asarray(do, jnp.bfloat16), False, 0.125, True,
        jfa.BLOCK_Q, jfa.BLOCK_K)
    want = _f32(jdq)
    f32 = [torch.from_numpy(x) for x in (q, k, v, o, lse, do)]
    bf16 = [x if i == 4 else x.bfloat16() for i, x in enumerate(f32)]
    dq = fa.flash_backward(*bf16, False, 0.125)[0].float().numpy()
    ctrl = fa.flash_backward(*f32, False, 0.125)[0].bfloat16().float().numpy()
    np.testing.assert_allclose(dq[..., 1], want[..., 1], rtol=2 ** -7, atol=0)
    assert not np.allclose(ctrl[..., 1], want[..., 1], rtol=2 ** -7, atol=0)
    assert np.all(want[..., 1] == 128 * 3 / 2048)  # (T/2)(1/8 - 0.123535)
    assert not dq[..., 2:].any() and not want[..., 2:].any()


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_gradcheck_in_f64(causal):
    """The backward's formulas are the exact gradient of the forward:
    ``torch.autograd.gradcheck`` in f64 on the plain path (any shape goes
    on the CPU)."""
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 8, 2, 4, dtype=torch.float64, generator=gen,
                           requires_grad=True) for _ in range(3))
    assert torch.autograd.gradcheck(
        lambda a, b, c: fa.flash_attention(a, b, c, causal), (q, k, v))


@pytest.mark.parametrize("d", [32, 64, 96, 128, 192, 256, 512])
def test_supports_flash_matches_jax(d):
    for t in range(0, 2049, 32):
        assert fa.supports_flash(t, d) == jfa.supports_flash(t, d), (t, d)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_dense_attention_matches_jax(causal, dtype):
    """Dense attention keeps the JAX function's own rules (q pre-scaled in
    the input dtype, p in f32 into P.V); tolerances as the forward's."""
    q, k, v, _ = _inputs(48, 16, b=2, h=3, seed=5)
    want = jseq.dense_attention(*(jnp.asarray(x, JAX_DTYPE[dtype])
                                  for x in (q, k, v)), causal=causal)
    got = dense_attention(*(torch.from_numpy(x).to(TORCH_DTYPE[dtype])
                            for x in (q, k, v)), causal=causal)
    assert got.dtype == TORCH_DTYPE[dtype]
    np.testing.assert_allclose(got.float().numpy(), _f32(want),
                               atol=FWD_TOL[dtype], rtol=FWD_TOL[dtype])


def test_flash_and_dense_agree_in_f32():
    """Two dtype rules, one function: in f32 the kernel path's plain
    version and dense attention differ only by rounding."""
    q, k, v, _ = _inputs(128, 64, seed=6)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    torch.testing.assert_close(fa.flash_attention(*args, causal=True),
                               dense_attention(*args, causal=True),
                               atol=2e-5, rtol=2e-5)


def test_cpu_calls_launch_no_kernel():
    """The launch counters count kernel launches only: CPU calls, forward
    and backward, leave them as they were."""
    before = dict(fa.LAUNCHES)
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(128, 64)[:3])
    fa.flash_attention(q, k, v, True).sum().backward()
    assert fa.LAUNCHES == before


def test_unsupported_device_raises():
    q = torch.zeros(1, 128, 1, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention(q, q, q, True)
