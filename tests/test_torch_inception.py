"""The PyTorch port's Inception-v3 (``models/inception.py``) and its flax
converter against the JAX package's, on the 1/1/1 block plan at 35x35
(as ``tests/test_models.py`` runs it): one block of each kind, so every
branch, SAME (1, 7) / (7, 1) kernel, SAME average pool (padded zeros
counted) and stride-2 reduction is exercised.

flax variables (init, every BatchNorm value drawn from a seed) are
converted with ``inception_from_flax``.  Tolerances: eval logits in f32
1e-4 (atol and rtol); two ``train_step``s (the first at lr 0) in f64 on
both sides, because the f32 train-mode gradients over 2 images are as
ill-conditioned as ResNet's (``tests/test_torch_resnet_train.py``; in f32
the params after the two steps sit 0.016 of a leaf's max apart): loss
1e-6 relative, accuracy equal, params and batch statistics within 1e-5
of each leaf's largest |x|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from container_engine_accelerators_tpu.models import inception_v3
from container_engine_accelerators_tpu.models import train as jtrain
from container_engine_accelerators_tpu_torch.models import inception as pinc
from container_engine_accelerators_tpu_torch.models import train as ptrain
from container_engine_accelerators_tpu_torch.models.convert import (
    inception_from_flax,
    inception_to_flax,
)
from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    assert_trees_close,
    drawn_batchnorm,
    few_torch_threads,
    nchw,
)

PLAN = dict(num_classes=8, a_blocks=(32,), c_blocks=(128,), e_blocks=1)
SIZE, BATCH = 35, 2


def _images(seed):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, SIZE, SIZE, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flax():
    """(params, batch_stats): flax init, BatchNorm values drawn."""
    model = inception_v3(dtype=jnp.float32, **PLAN)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.ones((1, SIZE, SIZE, 3)), train=False)
    return drawn_batchnorm(variables["params"], variables["batch_stats"],
                           seed=1)


def _port(params, stats, dtype=torch.float32):
    model = pinc.inception_v3(dtype=dtype, **PLAN).to(dtype)
    model.load_state_dict(inception_from_flax(params, stats))
    return model


def test_eval_logits_match_flax():
    params, stats = _flax()
    x = _images(2)
    model = inception_v3(dtype=jnp.float32, **PLAN)
    want = np.asarray(jax.jit(lambda v, x: model.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, x))
    with torch.no_grad():
        got = _port(params, stats).eval()(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (BATCH, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_one_train_step_matches_jax():
    params, stats = _flax()
    x = _images(3)
    y = np.random.default_rng(4).integers(0, 8, BATCH).astype(np.int32)
    with jax.enable_x64(True):
        params, stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), (params, stats))
        model = inception_v3(dtype=jnp.float64, **PLAN)
        tx = jtrain.cosine_sgd(base_lr=0.1, total_steps=10, warmup_steps=1)
        state = jtrain.TrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=tx.init(params), tx=tx, apply_fn=model.apply)
        # Step 0 trains at lr 0: take two steps so the weights move.
        step = jax.jit(jtrain.train_step)
        for _ in range(2):
            state, want = step(state, jnp.asarray(x, jnp.float64),
                               jnp.asarray(y))
        want, want_params, want_stats = jax.device_get(
            (want, state.params, state.batch_stats))

    port = _port(params, stats, torch.float64)
    pstate = ptrain.create_train_state(port, None, ptrain.cosine_sgd(
        base_lr=0.1, total_steps=10, warmup_steps=1))
    for _ in range(2):
        pstate, got = ptrain.train_step(pstate, nchw(x).double(),
                                        torch.from_numpy(y))
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=1e-6)
    assert got["accuracy"].item() == float(want["accuracy"])
    got_params, got_stats = inception_to_flax(port)
    assert_trees_close(got_params, want_params, 1e-5, "params")
    assert_trees_close(got_stats, want_stats, 1e-5, "batch_stats")


def test_branches_register_in_flax_call_order_and_round_trip():
    params, stats = _flax()
    port = _port(params, stats)
    for block in (port.a[0], port.b[0], port.c[0], port.d[0], port.e[0]):
        assert tuple(n for n, _ in block.named_children()) == block.BRANCHES
    back_params, back_stats = inception_to_flax(port)
    assert_trees_close(back_params, params, 0.0, "params")
    assert_trees_close(back_stats, stats, 0.0, "batch_stats")
    # HWIO (1, 7) -> OIHW: the kernel's H and W stay apart.
    assert tuple(port.c[0].b7_2.conv.weight.shape) == (128, 128, 1, 7)
    assert params["InceptionC_0"]["ConvBNAct_2"]["Conv_0"]["kernel"].shape \
        == (1, 7, 128, 128)


def test_full_plan_builds_with_flax_shapes():
    """The standard 3/4/2 plan, on the meta device (no weight memory):
    the same parameter count as flax's, and BatchNorm epsilon 1e-3."""
    variables = jax.eval_shape(
        lambda r: inception_v3().init(r, jnp.ones((1, 75, 75, 3)),
                                      train=False), jax.random.PRNGKey(0))
    want = sum(np.prod(v.shape) for v in
               jax.tree_util.tree_leaves(variables["params"]))
    port = pinc.inception_v3(device="meta")
    assert (len(port.a), len(port.c), len(port.e)) == (3, 4, 2)
    assert sum(p.numel() for p in port.parameters()) == want
    assert port.stem[0].bn.eps == 1e-3
