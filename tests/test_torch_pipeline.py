"""The port's pipeline parallelism (``parallel/pipeline.py``) against the
JAX package's, mirroring ``tests/test_pipeline.py``.

Eight stacked ``tanh(h @ w + b)`` layers (D 16; w and b from a numpy
seed, as JAX's test scales them) run as an S-stage GPipe schedule over
a (pipe, data) mesh of gloo ranks at (pipe, data, M) = (2, 2, 4) and
(4, 1, 2), and through JAX's ``make_pipeline_apply`` over the same mesh
shape of host devices, on the same batch of 8.  Forward within 1e-5 of
JAX's and of the sequential layers (f32: the same products in the same
order, one rounding apart at most); the gradients of the mean squared
error — every layer's w and b and the input's — within JAX's own test
bound against its sequential scan, rtol 1e-4 and atol 1e-5.  The stage
axis really lives on ``pipe``, the stage round trip is exact, and the
rejections are JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as H
import torch_par_helpers as P
from container_engine_accelerators_tpu.parallel import pipeline as jpp
from container_engine_accelerators_tpu_torch.parallel import pipeline as pp

L, D, B = 8, 16, 8
CASES = [(2, 2, 4), (4, 1, 2)]


def _inputs():
    rng = np.random.default_rng(0)
    params = {"w": (0.3 * rng.standard_normal((L, D, D))).astype(np.float32),
              "b": (0.1 * rng.standard_normal((L, D))).astype(np.float32)}
    x = rng.standard_normal((B, D)).astype(np.float32)
    tgt = rng.standard_normal((B, D)).astype(np.float32)
    return params, x, tgt


def _jax_layer(p, h):
    return jnp.tanh(h @ p["w"] + p["b"])


@functools.lru_cache(maxsize=None)
def _jax(pipe, data, mb):
    """JAX's pipeline over a (pipe, data) mesh of host devices -> (y,
    unstaged w/b grads, x grad), numpy."""
    params, x, tgt = _inputs()
    mesh = jpp.create_pipeline_mesh(pipe, data,
                                    jax.devices()[:pipe * data])
    staged = jax.device_put(jpp.stage_params(params, pipe),
                            jpp.staged_sharding(
                                mesh, jpp.stage_params(params, pipe)))
    apply = jpp.make_pipeline_apply(_jax_layer, mesh, mb)

    def loss(s, xx):
        return jnp.mean((apply(s, xx) - tgt) ** 2)

    y = np.asarray(jax.jit(apply)(staged, x))
    gs, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(staged, x)
    return y, jax.tree_util.tree_map(np.asarray,
                                     jpp.unstage_params(gs)), np.asarray(gx)


def _sequential(params, x):
    h = torch.from_numpy(x)
    for i in range(L):
        h = torch.tanh(h @ torch.from_numpy(params["w"][i])
                       + torch.from_numpy(params["b"][i]))
    return h.numpy()


@functools.lru_cache(maxsize=None)
def _port(pipe, data, mb, tmp):
    params, x, tgt = _inputs()
    return H.spawn(P.pipeline_case, pipe * data, tmp, pipe, data, mb,
                   params, x, tgt)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("pipeline"))


@pytest.mark.parametrize("pipe,data,mb", CASES)
def test_forward_equals_jax_and_sequential(pipe, data, mb, tmp):
    want, _, _ = _jax(pipe, data, mb)
    seq = _sequential(*_inputs()[:2])
    for y, *_ in _port(pipe, data, mb, tmp):
        np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(y, seq, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pipe,data,mb", CASES)
def test_gradients_equal_jax(pipe, data, mb, tmp):
    _, want, want_x = _jax(pipe, data, mb)
    for _, grads, gx, _, _ in _port(pipe, data, mb, tmp):
        for k in ("w", "b"):
            np.testing.assert_allclose(grads[k], want[k], rtol=1e-4,
                                       atol=1e-5)
        np.testing.assert_allclose(gx, want_x, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pipe,data,mb", CASES)
def test_stage_axis_on_pipe_and_rejections(pipe, data, mb, tmp):
    for _, _, _, placements, rejected in _port(pipe, data, mb, tmp):
        assert placements == ["S(0)", "R"], placements
        assert "not divisible by 3 microbatches" in rejected[0]
        assert f"mesh {pipe + 1}x{data} != {pipe * data} ranks" in \
            rejected[1]


def test_stage_params_roundtrip_and_validation():
    params = {k: torch.from_numpy(v) for k, v in _inputs()[0].items()}
    staged = pp.stage_params(params, 4)
    assert staged["w"].shape == (4, 2, D, D)
    back = pp.unstage_params(staged)
    assert torch.equal(back["w"], params["w"])
    assert torch.equal(back["b"], params["b"])
    with pytest.raises(ValueError, match="not divisible"):
        pp.stage_params(params, 3)
    # Nested dicts, as JAX's tree_map takes them.
    nested = pp.stage_params({"blk": params}, 2)
    assert nested["blk"]["b"].shape == (2, 4, D)
