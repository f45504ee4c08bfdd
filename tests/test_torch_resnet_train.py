"""The PyTorch port's image train step (``models/train.py``: ``cosine_sgd``,
``create_train_state``, ``train_step``) against the JAX package's.

The learning rate at every step is optax's ``warmup_cosine_decay_
schedule`` (step 0 at 0): exactly on the warmup, and on the cosine within
one f32 ulp of the peak rate (XLA's f32 ``cos`` is not correctly
rounded: 135 of 9500 arguments sit one ulp from the correctly rounded
value; 99.5% of the steps below are equal).

Three steps from the same converted variables (ResNet-18, CIFAR stem,
8 filters, BatchNorm values drawn from a seed) on the same numpy batches,
in f64 on both sides: with 4 images a batch the f32 gradients are
ill-conditioned in both packages (flax's one-pass variance cancels; for
some draws JAX's f32 steps land 0.2-0.5 of a leaf's max from the port's
after three steps, at lr 0.1 and at 0.01 alike), so the f32 comparison
would measure the draw, not the optimizer.  In f64: losses within 1e-6
relative and accuracies equal; params, momentum (optax's ``trace``) and
batch statistics within 1e-5 of each leaf's largest |x|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.models import resnet as jresnet
from container_engine_accelerators_tpu.models import train as jtrain
from container_engine_accelerators_tpu_torch.models import resnet as presnet
from container_engine_accelerators_tpu_torch.models import train as ptrain
from container_engine_accelerators_tpu_torch.models.convert import (
    resnet_from_flax,
    resnet_to_flax,
)
from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    assert_trees_close,
    drawn_batchnorm,
    few_torch_threads,
    nchw,
)

TOL = 1e-5  # of the leaf's largest |x|, in f64
STEPS, BATCH, CLASSES = 3, 4, 10


@pytest.mark.parametrize("base_lr,warmup,total", [
    (0.1, 2, 10), (0.1, 20, 200), (0.3, 7, 91), (0.05, 500, 2000),
    (0.1, 1, 2)])
def test_lr_equals_optax_schedule(base_lr, warmup, total):
    want = optax.warmup_cosine_decay_schedule(0.0, base_lr, warmup, total)
    tx = ptrain.cosine_sgd(base_lr=base_lr, total_steps=total,
                           warmup_steps=warmup)
    assert tx.lr(0) == 0.0
    ulp = float(np.spacing(np.float32(base_lr)))
    for step in range(total + 3):
        a, b = tx.lr(step), float(want(np.int32(step)))
        if step <= warmup:
            assert a == b, step
        else:
            assert abs(a - b) <= ulp, (step, a, b)


def test_lr_matches_the_stated_values():
    tx = ptrain.cosine_sgd(base_lr=0.1, total_steps=10, warmup_steps=2)
    assert [round(tx.lr(s), 4) for s in range(4)] == [0.0, 0.05, 0.1, 0.0962]


def test_cosine_needs_steps_past_the_warmup():
    with pytest.raises(ValueError, match="total_steps > warmup_steps"):
        ptrain.cosine_sgd(total_steps=1, warmup_steps=1)
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(0.0, 0.1, 1, 1)


def test_optimizer_decays_every_parameter_with_nesterov():
    model = presnet.resnet(18, num_classes=CLASSES, num_filters=8,
                           small_inputs=True)
    state = ptrain.create_train_state(model, torch.Generator().manual_seed(0))
    (group,) = state.optimizer.param_groups
    assert group["nesterov"] and group["momentum"] == 0.9
    assert group["weight_decay"] == 1e-4
    assert len(group["params"]) == len(list(model.parameters()))
    assert state.step == 0 and state.schedule(0) == 0.0


def _batches():
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
          for _ in range(STEPS)]
    ys = [rng.integers(0, CLASSES, BATCH).astype(np.int32)
          for _ in range(STEPS)]
    return xs, ys


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def test_three_steps_match_jax():
    xs, ys = _batches()
    with jax.enable_x64(True):
        model = jresnet(depth=18, num_classes=CLASSES, num_filters=8,
                        small_inputs=True, dtype=jnp.float64)
        tx = jtrain.cosine_sgd(base_lr=0.1, total_steps=10, warmup_steps=1)
        state = jtrain.create_train_state(model, jax.random.PRNGKey(0),
                                          jnp.asarray(xs[0]), tx=tx)
        params, stats = drawn_batchnorm(state.params, state.batch_stats,
                                        seed=1)
        params, stats = _f64(params), _f64(stats)
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=tx.init(params))
        step = jax.jit(jtrain.train_step)
        want = []
        for x, y in zip(xs, ys):
            state, metrics = step(state, jnp.asarray(x, jnp.float64),
                                  jnp.asarray(y))
            want.append(jax.device_get(metrics))
        want_params, want_stats, want_trace = jax.device_get(
            (state.params, state.batch_stats, state.opt_state[1][0].trace))
        assert int(state.step) == STEPS

    port = presnet.resnet(18, num_classes=CLASSES, num_filters=8,
                          small_inputs=True, dtype=torch.float64).double()
    port.load_state_dict(resnet_from_flax(params, stats))
    pstate = ptrain.create_train_state(
        port, None, ptrain.cosine_sgd(base_lr=0.1, total_steps=10,
                                      warmup_steps=1))
    for x, y, w in zip(xs, ys, want):
        pstate, got = ptrain.train_step(pstate, nchw(x).double(),
                                        torch.from_numpy(y))
        np.testing.assert_allclose(got["loss"].item(), float(w["loss"]),
                                   rtol=1e-6)
        assert got["accuracy"].item() == float(w["accuracy"])
    assert pstate.step == STEPS

    got_params, got_stats = resnet_to_flax(port)
    assert_trees_close(got_params, want_params, TOL, "params")
    assert_trees_close(got_stats, want_stats, TOL, "batch_stats")
    momentum, _ = resnet_to_flax({
        n: pstate.optimizer.state[p]["momentum_buffer"]
        for n, p in port.named_parameters()})
    # optax's state: chain(add_decayed_weights, sgd = chain(trace, scale)).
    assert_trees_close(momentum, want_trace, TOL, "momentum")


def test_step_zero_trains_at_lr_zero():
    """optax reads the schedule at the count before it increments: the
    first step moves no weight (the momentum still fills)."""
    model = presnet.resnet(18, num_classes=CLASSES, num_filters=8,
                           small_inputs=True, dtype=torch.float32)
    state = ptrain.create_train_state(
        model, torch.Generator().manual_seed(0),
        ptrain.cosine_sgd(total_steps=10, warmup_steps=2))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    xs, ys = _batches()
    state, _ = ptrain.train_step(state, nchw(xs[0]), torch.from_numpy(ys[0]))
    assert all(torch.equal(before[n], p) for n, p in model.named_parameters())
    state, _ = ptrain.train_step(state, nchw(xs[1]), torch.from_numpy(ys[1]))
    assert not all(torch.equal(before[n], p)
                   for n, p in model.named_parameters())
