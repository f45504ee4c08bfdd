"""The PyTorch port's sharded ResNet step (``models/train.py::
make_sharded_train_step``) and ``entry.dryrun_multichip`` against the
JAX package's, on 4 gloo ranks on the CPU.

Three steps of ResNet-18 (CIFAR stem, 8 filters, every BatchNorm value
drawn from a seed) over a (2, 2) mesh, batch 8 (4 rows a data-parallel
rank), from the same converted variables on the same numpy batches,
against JAX's ``make_sharded_train_step`` on a (2, 2) mesh of the host
devices — both in f64, as ``tests/test_torch_resnet_train.py`` holds the
single-device step (f32 gradients over a few images are ill-conditioned
in both packages).  Losses within 1e-6 relative and accuracies equal;
parameters, momentum and the running statistics within 1e-5 of each
leaf's largest |x|.  BatchNorm must take its statistics over the GLOBAL
batch of 8, as GSPMD does: statistics over one rank's 4 images land
orders of magnitude further away, which the first test shows.

``dryrun_multichip(4, regimes=["resnet"])`` starts its 4 ranks itself,
each at the test ranks' one torch thread, and runs regime 1 of
``__graft_entry__._dryrun_multichip_impl`` (ResNet-18, 16 filters, 64
classes, batch 8 of ones, bf16) on a (2, 2) mesh: from JAX's initial
variables its loss equals JAX's within 2e-2 relative (bf16 rounds after
every convolution in both, at places that differ).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_helpers as H
from container_engine_accelerators_tpu.models import resnet as jresnet
from container_engine_accelerators_tpu.models import train as jtrain
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu.parallel.mesh import batch_sharding
from container_engine_accelerators_tpu_torch.entry import dryrun_multichip
from container_engine_accelerators_tpu_torch.models.convert import (
    resnet_from_flax,
    resnet_to_flax,
)
from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    assert_trees_close,
    drawn_batchnorm,
    few_torch_threads,
)

TOL = 1e-5  # of the leaf's largest |x|, in f64
STEPS, BATCH, CLASSES = 3, 8, 10
KW = dict(num_classes=CLASSES, num_filters=8, small_inputs=True)
TX = dict(base_lr=0.1, total_steps=10, warmup_steps=1)


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32),
             rng.integers(0, CLASSES, BATCH).astype(np.int32))
            for _ in range(STEPS)]


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX in f64 over a mesh of the host devices: (initial params, batch
    stats, metrics, final params, batch stats, momentum), numpy."""
    batches = _batches()
    with jax.enable_x64(True):
        model = jresnet(depth=18, dtype=jnp.float64, **KW)
        tx = jtrain.cosine_sgd(**TX)
        state = jtrain.create_train_state(
            model, jax.random.PRNGKey(0), jnp.asarray(batches[0][0]), tx=tx)
        params, stats = drawn_batchnorm(state.params, state.batch_stats,
                                        seed=1)
        params, stats = _f64(params), _f64(stats)
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=tx.init(params))
        mesh = create_mesh(data=2, model=2, devices=jax.devices()[:4])
        step, placed = jtrain.make_sharded_train_step(mesh, state)
        metrics = []
        for x, y in batches:
            placed, m = step(placed, jax.device_put(
                jnp.asarray(x, jnp.float64), batch_sharding(mesh)),
                jax.device_put(jnp.asarray(y), batch_sharding(mesh)))
            metrics.append(jax.device_get(m))
        final = jax.device_get((placed.params, placed.batch_stats,
                                placed.opt_state[1][0].trace))
    return params, stats, metrics, final


@functools.lru_cache(maxsize=None)
def _port():
    import tempfile

    params, stats, _, _ = _jax()
    state = {k: v.numpy() for k, v in resnet_from_flax(params, stats).items()}
    with tempfile.TemporaryDirectory(prefix="resnet22_") as tmp:
        return H.spawn(H.resnet_step, 4, tmp, KW, state, _batches(), (2, 2),
                       TX)


def test_statistics_of_one_ranks_rows_differ_from_the_global_batchs():
    """What a per-rank BatchNorm would give: a step over rank 0's 4
    images (the port's single-device step, f64) leaves running
    statistics far past TOL from the 8-image step's."""
    import torch

    from container_engine_accelerators_tpu_torch.models import resnet
    from container_engine_accelerators_tpu_torch.models import train

    params, stats, _, _ = _jax()
    x, y = _batches()[0]
    got = []
    for rows in (BATCH, BATCH // 2):
        model = resnet.resnet(18, dtype=torch.float64, **KW).double()
        model.load_state_dict(resnet_from_flax(params, stats))
        state = train.create_train_state(model, None, train.cosine_sgd(**TX))
        train.train_step(state, torch.from_numpy(x[:rows]).double().permute(
            0, 3, 1, 2), torch.from_numpy(y[:rows]).long())
        got.append({k: v for k, v in model.state_dict().items()
                    if k.endswith(("running_mean", "running_var"))})
    worst = max(float((got[1][k] - got[0][k]).abs().max()
                      / got[0][k].abs().max()) for k in got[0])
    assert worst > 100 * TOL, worst


def test_losses_and_accuracy_equal_jax():
    _, _, metrics, _ = _jax()
    for res in _port():
        np.testing.assert_allclose(res["losses"],
                                   [float(m["loss"]) for m in metrics],
                                   rtol=1e-6)
        assert res["accuracy"] == [float(m["accuracy"]) for m in metrics]


def test_params_and_global_batch_statistics_equal_jax():
    import torch

    _, _, _, (want_params, want_stats, _) = _jax()
    for res in _port():
        got_params, got_stats = resnet_to_flax(
            {k: torch.from_numpy(v) for k, v in res["state"].items()})
        assert_trees_close(got_params, want_params, TOL, "params")
        assert_trees_close(got_stats, want_stats, TOL, "batch_stats")


def test_momentum_equals_jax():
    import torch

    _, _, _, (_, _, want_trace) = _jax()
    momentum, _ = resnet_to_flax({k: torch.from_numpy(v) for k, v in
                                  _port()[0]["momentum"].items()})
    assert_trees_close(momentum, want_trace, TOL, "momentum")


def test_dryrun_multichip_4_equals_regime_1():
    model = jresnet(depth=18, num_classes=64, num_filters=16,
                    small_inputs=True)
    x = jnp.ones((8, 32, 32, 3), jnp.float32)
    labels = jnp.zeros((8,), jnp.int32)
    state = jtrain.create_train_state(model, jax.random.PRNGKey(0), x)
    # The step donates the state: take the weights first.
    weights = resnet_from_flax(*jax.tree_util.tree_map(
        np.array, (state.params, state.batch_stats)))
    mesh = create_mesh(data=2, model=2, devices=jax.devices()[:4])
    step, placed = jtrain.make_sharded_train_step(mesh, state)
    _, metrics = step(placed, jax.device_put(x, batch_sharding(mesh)),
                      jax.device_put(labels, batch_sharding(mesh)))
    want = float(metrics["loss"])
    got = H.rendezvous_retried(
        dryrun_multichip, 4, device="cpu", regimes=["resnet"],
        inputs={"resnet": {"params": weights}},
        threads=H.TORCH_THREADS)["resnet"]
    assert abs(got - want) <= 2e-2 * abs(want), (got, want)
