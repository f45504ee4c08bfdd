"""The port's model-parallel convolution and head (``models/resnet.py::
Conv`` / ``Dense`` over ``parallel/mesh.py::model_parallel``) and the
sharded ResNet step on a (1, 4) mesh, against the unsharded layers and
the JAX package's, on gloo ranks on the CPU.

Layers, at (1, 2), (2, 2) and (1, 4) meshes in f64 (batch 8, 9x9 images):
a convolution the JAX rule splits on its output channels (3x3, stride 2,
8 -> 16), three it splits on their input channels ((1, 7), 16 -> 4; 1x1,
16 -> 4, which runs as one GEMM over the strided NHWC rows; 1x1 at
stride 2, 16 -> 4) and the head (16 -> 6, split on its input features).
Each rank's output, its rows of dx, and every parameter's whole gradient
after ``sync_grads`` equal the unsharded layer's and the flax layer's
(``nn.Conv(use_bias=False, padding="SAME")`` and ``nn.Dense``, the JAX
model's own modules) within 1e-10 of the largest |x|: a gradient M times
too large (a reduce-scatter where the gradient is already whole) or a
partial sum left unreduced lands orders of magnitude past it.  Each model
rank must hand ``F.conv2d`` / ``F.linear`` 1/M of the split axis.

The step: ResNet-18 (CIFAR stem, 8 filters) on a (1, 4) mesh, three
steps, f64, against JAX's ``make_sharded_train_step`` on a (1, 4) mesh
of the host devices, with ``tests/test_torch_dist_resnet.py``'s
tolerances (loss 1e-6 relative, every leaf within 1e-5 of its largest
|x|); each parameter's and its momentum's shard is the shape of JAX's.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_dist_helpers as H
import torch_par_helpers as P
from container_engine_accelerators_tpu.models import resnet as jresnet
from container_engine_accelerators_tpu.models import train as jtrain
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu.parallel.mesh import batch_sharding
from container_engine_accelerators_tpu_torch.models import resnet as presnet
from container_engine_accelerators_tpu_torch.models.convert import (
    resnet_from_flax,
    resnet_to_flax,
)
from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    assert_trees_close,
    drawn_batchnorm,
    few_torch_threads,
)

MESHES = ((1, 2), (2, 2), (1, 4))
BATCH, SIZE = 8, 9
LAYER_TOL = 1e-10
# (name, kind, kwargs, the port axis the JAX rule splits at M = 2 and 4)
LAYERS = [
    ("conv-O-3x3-s2", "conv", dict(in_channels=8, features=16, kernel=(3, 3),
                                   strides=(2, 2)), 0),
    ("conv-I-1x7", "conv", dict(in_channels=16, features=4, kernel=(1, 7)), 1),
    ("conv-I-1x1", "conv", dict(in_channels=16, features=4, kernel=(1, 1)), 1),
    ("conv-I-1x1-s2", "conv", dict(in_channels=16, features=4,
                                   kernel=(1, 1), strides=(2, 2)), 1),
    ("head-I", "dense", dict(in_features=16, features=6), 1),
]


def _layer_inputs(kind, kw, seed):
    """(weight in the port's layout, x, the output cotangent g), f64."""
    rng = np.random.default_rng(seed)
    if kind == "conv":
        w = rng.standard_normal((kw["features"], kw["in_channels"],
                                 *kw["kernel"]))
        x = rng.standard_normal((BATCH, SIZE, SIZE, kw["in_channels"]))
        strides = kw.get("strides", (1, 1))
        out = [-(-SIZE // s) for s in strides]
        g = rng.standard_normal((BATCH, *out, kw["features"]))
    else:
        w = rng.standard_normal((kw["features"], kw["in_features"]))
        x = rng.standard_normal((BATCH, kw["in_features"]))
        g = rng.standard_normal((BATCH, kw["features"]))
    return w, x, g


def _flax_layer(kind, kw, w, x, g):
    """The JAX model's module on the same values: (y, dx, {param: grad})
    in the port's layouts."""
    with jax.enable_x64(True):
        if kind == "conv":
            layer = nn.Conv(kw["features"], kw["kernel"],
                            kw.get("strides", (1, 1)), use_bias=False,
                            dtype=jnp.float64, padding="SAME")
            params = {"kernel": jnp.asarray(w.transpose(2, 3, 1, 0))}
        else:
            layer = nn.Dense(kw["features"], dtype=jnp.float64)
            params = {"kernel": jnp.asarray(w.T),
                      "bias": jnp.asarray(w[:, 0] + 1.0)}
        y, vjp = jax.vjp(lambda p, x: layer.apply({"params": p}, x), params,
                         jnp.asarray(x))
        dp, dx = vjp(jnp.asarray(g))
        y, dx, dp = jax.device_get((y, dx, dp))
    if kind == "conv":
        return (y.transpose(0, 3, 1, 2), dx.transpose(0, 3, 1, 2),
                {"weight": dp["kernel"].transpose(3, 2, 0, 1)})
    return y, dx, {"weight": dp["kernel"].T, "bias": dp["bias"]}


def _unsharded(kind, kw, w, x, g):
    """The port's layer on one process, f64: (y, dx, {param: grad})."""
    import torch

    if kind == "conv":
        layer = presnet.Conv(**kw).double()
        layer.load_state_dict({"weight": torch.from_numpy(w)})
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
        gt = torch.from_numpy(g).permute(0, 3, 1, 2)
    else:
        layer = presnet.Dense(**kw).double()
        layer.load_state_dict({"weight": torch.from_numpy(w),
                               "bias": torch.from_numpy(w[:, 0] + 1.0)})
        xt = torch.from_numpy(x).requires_grad_()
        gt = torch.from_numpy(g)
    y = layer(xt)
    (y * gt).sum().backward()
    return (y.detach().numpy(), xt.grad.numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


@pytest.fixture(scope="module")
def layer_runs(tmp_path_factory):
    """{mesh shape: (the cases' inputs, each rank's results)}."""
    cases = [(kind, kw, *_layer_inputs(kind, kw, i))
             for i, (_, kind, kw, _) in enumerate(LAYERS)]
    out = {}
    for world in (2, 4):
        shapes = [s for s in MESHES if s[0] * s[1] == world]
        ranks = H.spawn(P.sharded_layers, world,
                        tmp_path_factory.mktemp("layers"), shapes, cases)
        out.update({s: (cases, [r[s] for r in ranks]) for s in shapes})
    return out


def _close(got, want, what):
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= LAYER_TOL, f"{what}: {err}"


@pytest.mark.parametrize("layer", range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_layer_equals_unsharded_and_flax(layer_runs, shape, layer):
    cases, ranks = layer_runs[shape]
    kind, kw, w, x, g = cases[layer]
    refs = {"unsharded": _unsharded(kind, kw, w, x, g),
            "flax": _flax_layer(kind, kw, w, x, g)}
    for rank, res in enumerate(ranks):
        y, dx, grads, start, _, _ = res[layer]
        rows = slice(start, start + dx.shape[0])
        for ref, (want_y, want_dx, want_grads) in refs.items():
            _close(y, want_y, f"rank {rank} y vs {ref}")
            _close(dx, want_dx[rows], f"rank {rank} dx vs {ref}")
            assert grads.keys() == want_grads.keys()
            for name, gr in grads.items():
                _close(gr, want_grads[name], f"rank {rank} d{name} vs {ref}")


@pytest.mark.parametrize("layer", range(len(LAYERS)),
                         ids=[c[0] for c in LAYERS])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_model_rank_computes_its_share(layer_runs, shape, layer):
    """The JAX rule's axis is the one split, and the product each model
    rank runs takes 1/M of it: output channels (O) or input channels /
    features (I); a 1x1 window at stride 1 split on its input channels
    hands ``F.linear`` the ``[out, in / M]`` matrix."""
    cases, ranks = layer_runs[shape]
    _, kind, kw, dim = LAYERS[layer]
    m = shape[1]
    whole = list(cases[layer][2].shape)
    want = whole.copy()
    want[dim] //= m
    if (kind == "conv" and dim == 1 and kw["kernel"] == (1, 1)
            and kw.get("strides", (1, 1)) == (1, 1)):
        want = want[:2]
    for res in ranks:
        _, _, _, _, placements, seen = res[layer]
        assert placements == ["R", f"S({dim})"]
        assert seen == [tuple(want)], (seen, want)


# ---- the ResNet-18 step on a (1, 4) mesh ------------------------------------

TOL = 1e-5
STEPS, CLASSES, IMAGE = 3, 10, 16
KW = dict(num_classes=CLASSES, num_filters=8, small_inputs=True)
TX = dict(base_lr=0.1, total_steps=10, warmup_steps=1)


def _batches():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal((BATCH, IMAGE, IMAGE, 3)).astype(np.float32),
             rng.integers(0, CLASSES, BATCH).astype(np.int32))
            for _ in range(STEPS)]


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@functools.lru_cache(maxsize=None)
def _jax_14():
    """JAX in f64 on a (1, 4) mesh: (initial params, batch stats,
    metrics, (final params, batch stats, momentum), each parameter's
    shard shape), numpy."""
    batches = _batches()
    with jax.enable_x64(True):
        model = jresnet(depth=18, dtype=jnp.float64, **KW)
        tx = jtrain.cosine_sgd(**TX)
        state = jtrain.create_train_state(
            model, jax.random.PRNGKey(0), jnp.asarray(batches[0][0]), tx=tx)
        params, stats = _f64(drawn_batchnorm(state.params, state.batch_stats,
                                             seed=1))
        state = state.replace(params=params, batch_stats=stats,
                              opt_state=tx.init(params))
        mesh = create_mesh(data=1, model=4, devices=jax.devices()[:4])
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


@pytest.fixture(scope="module")
def port_14(tmp_path_factory):
    params, stats, _, _, _ = _jax_14()
    state = {k: v.numpy() for k, v in resnet_from_flax(params, stats).items()}
    return H.spawn(P.image_step, 4, tmp_path_factory.mktemp("resnet14"),
                   "resnet-18", KW, state, _batches(), (1, 4), TX)


def _torch_tree(named):
    import torch

    return {k: torch.from_numpy(np.asarray(v)) for k, v in named.items()}


def test_resnet_14_losses_and_accuracy_equal_jax(port_14):
    _, _, metrics, _, _ = _jax_14()
    for res in port_14:
        np.testing.assert_allclose(res["losses"],
                                   [float(m["loss"]) for m in metrics],
                                   rtol=1e-6)
        assert res["accuracy"] == [float(m["accuracy"]) for m in metrics]


def test_resnet_14_state_and_momentum_equal_jax(port_14):
    _, _, _, (want_params, want_stats, want_trace), _ = _jax_14()
    for res in port_14:
        got_params, got_stats = resnet_to_flax(_torch_tree(res["state"]))
        assert_trees_close(got_params, want_params, TOL, "params")
        assert_trees_close(got_stats, want_stats, TOL, "batch_stats")
    momentum, _ = resnet_to_flax(_torch_tree(port_14[0]["momentum"]))
    assert_trees_close(momentum, want_trace, TOL, "momentum")


def test_resnet_14_shards_are_jaxs(port_14):
    """Each rank's shard of every parameter, and of its momentum, has the
    shape of JAX's shard of the same leaf; the statistics stay whole."""
    _, _, _, (_, want_stats, _), want = _jax_14()
    import torch

    for res in port_14:
        assert res["plain_buffers"]
        for which in (0, 1):
            local = {n: torch.zeros(s[which]) for n, s in res["local"].items()}
            local.update({n: torch.from_numpy(v) for n, v in
                          res["state"].items() if n not in local})
            got, _ = resnet_to_flax(local)
            assert jax.tree_util.tree_map(np.shape, got) == \
                jax.tree_util.tree_map(np.shape, want)
