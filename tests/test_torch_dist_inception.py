"""The port's sharded Inception-v3 step (``models/train.py::
make_sharded_train_step``, the step ResNet takes) against the JAX
package's, and ``cmd/train_resnet.py --model inception-v3 --model-par 2``,
on gloo ranks on the CPU.

The 1/1/1 block plan at 35x35 of ``tests/test_torch_inception.py`` (one
block of each kind: every branch, the (1, 7) / (7, 1) kernels, the SAME
average pool and both reductions), every BatchNorm value drawn from a
seed, three steps at batch 8 over a (2, 2) mesh in f64, from the same
converted variables on the same numpy batches, against JAX's
``make_sharded_train_step`` on a (2, 2) mesh of the host devices.
Tolerances are ``tests/test_torch_dist_resnet.py``'s: losses within 1e-6
relative and accuracies equal; parameters, momentum and the running
statistics within 1e-5 of each leaf's largest |x|.  Each rank's shard of
every parameter and of its momentum has the shape of JAX's shard of the
leaf (the JAX rule's layout), and the statistics stay whole.

The trainer: ``--model inception-v3 --model-par 2`` (the standard plan,
35x35, batch 2, bf16) on 2 ranks for 2 steps logs the same losses on
both ranks, within 2e-2 relative of the single-device trainer's (bf16
rounds the split convolutions' partial sums at other places).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import torch_dist_helpers as H
import torch_par_helpers as P
from container_engine_accelerators_tpu.models import inception_v3
from container_engine_accelerators_tpu.models import train as jtrain
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu.parallel.mesh import batch_sharding
from container_engine_accelerators_tpu_torch.models.convert import (
    inception_from_flax,
    inception_to_flax,
)
from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    assert_trees_close,
    drawn_batchnorm,
    few_torch_threads,
)

PLAN = dict(num_classes=8, a_blocks=(32,), c_blocks=(128,), e_blocks=1)
SIZE, BATCH, STEPS = 35, 8, 3
TOL = 1e-5
TX = dict(base_lr=0.1, total_steps=10, warmup_steps=1)


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((BATCH, SIZE, SIZE, 3)).astype(np.float32),
             rng.integers(0, PLAN["num_classes"], BATCH).astype(np.int32))
            for _ in range(STEPS)]


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _jax():
    """JAX in f64 on a (2, 2) mesh: (initial params, batch stats,
    metrics, (final params, batch stats, momentum), each parameter's
    shard as zeros), numpy."""
    batches = _batches()
    with jax.enable_x64(True):
        model = inception_v3(dtype=jnp.float64, **PLAN)
        tx = jtrain.cosine_sgd(**TX)
        state = jtrain.create_train_state(
            model, jax.random.PRNGKey(0), jnp.asarray(batches[0][0]), tx=tx)
        params, stats = _f64(drawn_batchnorm(state.params, state.batch_stats,
                                             seed=1))
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=tx.init(params))
        mesh = create_mesh(data=2, model=2, devices=jax.devices()[:4])
        step, placed = jtrain.make_sharded_train_step(mesh, state)
        shards = jax.tree_util.tree_map(
            lambda a: np.zeros(a.sharding.shard_shape(a.shape)),
            placed.params)
        metrics = []
        for x, y in batches:
            placed, m = step(placed, jax.device_put(
                jnp.asarray(x, jnp.float64), batch_sharding(mesh)),
                jax.device_put(jnp.asarray(y), batch_sharding(mesh)))
            metrics.append(jax.device_get(m))
        final = jax.device_get((placed.params, placed.batch_stats,
                                placed.opt_state[1][0].trace))
    return params, stats, metrics, final, shards


@functools.lru_cache(maxsize=None)
def _port():
    import tempfile

    params, stats, _, _, _ = _jax()
    state = {k: v.numpy() for k, v in
             inception_from_flax(params, stats).items()}
    with tempfile.TemporaryDirectory(prefix="inception22_") as tmp:
        return H.spawn(P.image_step, 4, tmp, "inception-v3", PLAN, state,
                       _batches(), (2, 2), TX)


def _torch_tree(named):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in named.items()}


def test_losses_and_accuracy_equal_jax():
    _, _, metrics, _, _ = _jax()
    for res in _port():
        np.testing.assert_allclose(res["losses"],
                                   [float(m["loss"]) for m in metrics],
                                   rtol=1e-6)
        assert res["accuracy"] == [float(m["accuracy"]) for m in metrics]


def test_params_and_global_batch_statistics_equal_jax():
    _, _, _, (want_params, want_stats, _), _ = _jax()
    for res in _port():
        got_params, got_stats = inception_to_flax(_torch_tree(res["state"]))
        assert_trees_close(got_params, want_params, TOL, "params")
        assert_trees_close(got_stats, want_stats, TOL, "batch_stats")


def test_momentum_equals_jax():
    _, _, _, (_, _, want_trace), _ = _jax()
    momentum, _ = inception_to_flax(_torch_tree(_port()[0]["momentum"]))
    assert_trees_close(momentum, want_trace, TOL, "momentum")


def test_parameter_and_momentum_shards_are_jaxs():
    """The JAX rule's layout through ``shard_params``: each rank's shard of
    every parameter, and of its momentum, has JAX's shard shape (some
    split on output channels, some on input channels, the small ones
    whole); the BatchNorm statistics stay whole and plain."""
    *_, want = _jax()
    for res in _port():
        assert res["plain_buffers"]
        for which in (0, 1):
            local = {n: torch.zeros(s[which]) for n, s in res["local"].items()}
            local.update({n: torch.from_numpy(v) for n, v in
                          res["state"].items() if n not in local})
            got, _ = inception_to_flax(local)
            assert jax.tree_util.tree_map(np.shape, got) == \
                jax.tree_util.tree_map(np.shape, want)
    rank0 = _port()[0]
    convs = [(s[0], rank0["state"][n].shape) for n, s in
             rank0["local"].items() if n.endswith("conv.weight")]
    assert any(got[0] < whole[0] for got, whole in convs)  # O split
    assert any(got[1] < whole[1] for got, whole in convs)  # I split


CLI = ["--device", "cpu", "--model", "inception-v3", "--image-size", "35",
       "--num-classes", "10", "--train-batch-size", "2", "--train-steps",
       "2"]


def test_trainer_cli_inception_on_2_ranks_matches_one_device(tmp_path):
    from container_engine_accelerators_tpu_torch.cmd import train_resnet

    out = H.spawn(P.resnet_trainer_runs, 2, tmp_path,
                  [CLI + ["--model-par", "2"]])
    assert out[0] == out[1]
    np.testing.assert_allclose(out[0][0], train_resnet.main(CLI), rtol=2e-2)
