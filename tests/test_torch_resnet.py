"""The PyTorch port's ResNet (``models/resnet.py``) and its flax converter
(``models/convert.py``) against the JAX package's ResNet.

flax variables (init, then every BatchNorm value drawn from a seed so no
branch is zero) are converted with ``resnet_from_flax``; the same numpy
images go through both sides on the CPU.

Tolerances, f32 (same arithmetic, another summation order): eval logits
1e-4 (atol and rtol; measured <= 5e-6 at ResNet-50); at ResNet-18 the
train-mode loss 1e-5 relative, every gradient and every updated batch
statistic within 1e-4 of its leaf's largest |x| (measured <= 4e-5).
Train mode at ResNet-50 is compared in f64 on both sides (see that
test: its f32 gradients are ill-conditioned in both packages).  Each of
flax's
details that torch's layers do otherwise has a test here that fails if
the port does it torch's way: SAME padding, the biased running variance
with momentum 0.9, the zero-initialised last BatchNorm scale, and the
HWIO kernel layout.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from container_engine_accelerators_tpu.models import resnet as jresnet
from container_engine_accelerators_tpu_torch.models import resnet as presnet
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

# The package re-exports the function ``resnet`` under the module's name.
jresnet_mod = importlib.import_module(
    "container_engine_accelerators_tpu.models.resnet")

GRAD_TOL = 1e-4  # of the leaf's largest |x|
CASES = {  # name: (depth, num_filters, small_inputs, image size)
    "r18_small_32": (18, 8, True, 32),
    "r50_w8_32": (50, 8, False, 32),
    "r50_w8_64": (50, 8, False, 64),
}
CLASSES = 10


def _images(size, batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, size, size, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _flax(name):
    """(flax model, params, batch_stats) in f32: the flax tree's shapes
    (``eval_shape``: no compile of the init), kernels drawn from a seed
    with flax's variance 1/fan_in, then every BatchNorm value drawn."""
    depth, nf, small, _ = CASES[name]
    model = jresnet(depth=depth, num_classes=CLASSES, num_filters=nf,
                    small_inputs=small, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: model.init(
        r, jnp.ones((1, 32, 32, 3)), train=False), jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def kernel(s):
        return (rng.standard_normal(s.shape)
                * np.sqrt(1.0 / np.prod(s.shape[:-1]))).astype(np.float32)

    params = jax.tree_util.tree_map(kernel, shapes["params"])
    params, stats = drawn_batchnorm(params, shapes["batch_stats"], seed=1)
    return model, params, stats


def _port(name, params, stats):
    depth, nf, small, _ = CASES[name]
    model = presnet.resnet(depth, num_classes=CLASSES, num_filters=nf,
                           small_inputs=small, dtype=torch.float32)
    model.load_state_dict(resnet_from_flax(params, stats))
    return model


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_logits_match_flax(name):
    model, params, stats = _flax(name)
    x = _images(CASES[name][3], seed=2)
    want = np.asarray(jax.jit(lambda p, s, x: model.apply(
        {"params": p, "batch_stats": s}, x, train=False))(params, stats, x))
    port = _port(name, params, stats).eval()
    with torch.no_grad():
        got = port(nchw(x))
    assert got.dtype == torch.float32 and got.shape == (2, CLASSES)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _train_mode(name, dtype):
    """One train-mode forward and backward of the same variables and
    batch on both sides, in ``dtype``: (loss, grads, new batch_stats) of
    JAX and of the port, the trees in flax's layout."""
    model, params, stats = _flax(name)
    depth, nf, small, size = CASES[name]
    x = _images(size, batch=4, seed=3).astype(dtype)
    y = np.random.default_rng(4).integers(0, CLASSES, 4).astype(np.int32)
    if dtype == np.float64:
        model = jresnet(depth=depth, num_classes=CLASSES, num_filters=nf,
                        small_inputs=small, dtype=jnp.float64)
        params, stats = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), (params, stats))

    def loss_fn(p, s):
        logits, mutated = model.apply({"params": p, "batch_stats": s}, x,
                                      train=True, mutable=["batch_stats"])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, mutated["batch_stats"]

    (loss, new_stats), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, stats)
    want = float(loss), jax.device_get(grads), jax.device_get(new_stats)

    port = presnet.resnet(depth, num_classes=CLASSES, num_filters=nf,
                          small_inputs=small,
                          dtype=torch.from_numpy(x).dtype).to(
        torch.from_numpy(x).dtype)
    port.load_state_dict(resnet_from_flax(params, stats))
    port.train()
    got_loss = F.cross_entropy(port(nchw(x)), torch.from_numpy(y).long())
    got_loss.backward()
    got_grads, _ = resnet_to_flax({n: p.grad for n, p in
                                   port.named_parameters()})
    return want, (got_loss.item(), got_grads, resnet_to_flax(port)[1])


def test_train_mode_loss_grads_and_batch_stats_match_flax_f32():
    want, got = _train_mode("r18_small_32", np.float32)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    assert_trees_close(got[1], want[1], GRAD_TOL, "grads")
    assert_trees_close(got[2], want[2], GRAD_TOL, "batch_stats")


@pytest.mark.parametrize("name", ["r18_small_32", "r50_w8_64"])
def test_train_mode_loss_grads_and_batch_stats_match_flax_f64(name):
    """Both sides in f64 (``jax.enable_x64``; the port's modules in
    float64).  At ResNet-50 the f32 gradients are ill-conditioned here:
    JAX's own f32 gradients sit up to 0.41 of a leaf's max from its f64
    ones (flax's one-pass variance, E[x^2] - E[x]^2, cancels), the port's
    f32 ones 0.023.  In f64 the two agree to ~2e-7 (JAX's head still
    rounds to f32): tolerance 1e-6 on the loss, 1e-5 of each leaf."""
    with jax.enable_x64(True):
        want, got = _train_mode(name, np.float64)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert_trees_close(got[1], want[1], 1e-5, "grads")
    assert_trees_close(got[2], want[2], 1e-5, "batch_stats")


# ---- flax's details, one test each ------------------------------------------

def test_same_padding_is_flax_asymmetric_not_torch_symmetric():
    # The stem on 224, the stride-2 3x3 and the pool on even sizes, a 1x1
    # stride-2 projection (nothing to pad).
    assert presnet.same_padding(224, 7, 2) == (2, 3)
    assert presnet.same_padding(112, 3, 2) == (0, 1)
    assert presnet.same_padding(56, 1, 2) == (0, 0)
    assert presnet.same_padding(35, 3, 1) == (1, 1)
    row = np.arange(8, dtype=np.float32).reshape(1, 1, 8, 1)
    flax_pool = np.asarray(nn.max_pool(jnp.asarray(row), (1, 3),
                                       strides=(1, 2), padding="SAME"))
    port_pool = presnet.max_pool_same(
        torch.from_numpy(row).permute(0, 3, 1, 2).repeat(1, 1, 3, 1), 3, 2)
    assert flax_pool.ravel().tolist() == [2, 4, 6, 7]
    assert port_pool[0, 0, 0].tolist() == [2, 4, 6, 7]
    torch_pool = F.max_pool2d(torch.from_numpy(row).permute(0, 3, 1, 2),
                              (1, 3), (1, 2), (0, 1))
    assert torch_pool.ravel().tolist() == [1, 3, 5, 7]  # shifted by one

    # The 7x7/s2 stem and a 3x3/s2 convolution on an even input.
    x = _images(16, batch=1, seed=5)
    for kernel in ((7, 7), (3, 3)):
        conv = nn.Conv(4, kernel, (2, 2), padding="SAME", use_bias=False)
        variables = conv.init(jax.random.PRNGKey(1), x)
        want = np.asarray(conv.apply(variables, x))
        port = presnet.Conv(3, 4, kernel, (2, 2))
        port.load_state_dict({"weight": torch.from_numpy(np.ascontiguousarray(
            np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))})
        with torch.no_grad():
            got = port(nchw(x)).permute(0, 2, 3, 1).numpy()
            symmetric = F.conv2d(nchw(x), port.weight, stride=2,
                                 padding=kernel[0] // 2)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert not np.allclose(symmetric.permute(0, 2, 3, 1).numpy(), want,
                               atol=1e-2)


def test_running_variance_is_biased_with_flax_momentum():
    """One train-mode call: running mean 0.9 * 0 + 0.1 * mean, running
    variance 0.9 * 1 + 0.1 * var(ddof=0), as flax's batch_stats."""
    x = np.random.default_rng(6).normal(2.0, 3.0, (2, 4, 4, 3)).astype(
        np.float32)  # n = 32 values a channel: ddof 1 is 3% larger
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), x)
    _, mutated = bn.apply(variables, x, mutable=["batch_stats"])
    port = presnet.BatchNorm(3, 1e-5)
    port.load_state_dict({"weight": torch.ones(3), "bias": torch.zeros(3),
                          "running_mean": torch.zeros(3),
                          "running_var": torch.ones(3)})
    port.train()(nchw(x))
    flat = x.reshape(-1, 3).astype(np.float64)
    biased = 0.9 + 0.1 * flat.var(axis=0, ddof=0)
    for got, want in ((port.running_mean, 0.1 * flat.mean(axis=0)),
                      (port.running_var, biased),
                      (port.running_mean,
                       mutated["batch_stats"]["mean"]),
                      (port.running_var, mutated["batch_stats"]["var"])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    unbiased = 0.9 + 0.1 * flat.var(axis=0, ddof=1)
    assert not np.allclose(port.running_var.numpy(), unbiased, rtol=1e-3)


@pytest.mark.parametrize("depth", [18, 50])
def test_last_batchnorm_scale_of_each_block_starts_at_zero(depth):
    """flax's block (initialised alone: a whole model's init would cost
    a compile) zero-initialises exactly its last BatchNorm scale; the
    port's ``init_params`` zeroes exactly that one in every block, and
    leaves the running statistics at flax's initial mean 0 and var 1."""
    block_cls = jresnet_mod.ResNetBlock if depth < 50 else \
        jresnet_mod.BottleneckResNetBlock
    block = block_cls(
        filters=4, strides=(2, 2), act=nn.relu,
        conv=functools.partial(nn.Conv, use_bias=False, padding="SAME"),
        norm=functools.partial(nn.BatchNorm, use_running_average=True,
                               momentum=0.9, epsilon=1e-5))
    variables = block.init(jax.random.PRNGKey(0), jnp.ones((1, 8, 8, 4)))
    flax_zero = {k for k, v in variables["params"].items()
                 if "scale" in v and not np.asarray(v["scale"]).any()}
    last = "BatchNorm_1" if depth < 50 else "BatchNorm_2"
    assert flax_zero == {last}

    port = presnet.resnet(depth, num_classes=CLASSES, num_filters=8)
    init = presnet.init_params(port, torch.Generator().manual_seed(0))
    port.load_state_dict(init)
    params, stats = resnet_to_flax(port)
    zero = {(k, b) for k, v in params.items() if "Block_" in k
            for b, leaf in v.items()
            if "scale" in leaf and not leaf["scale"].any()}
    assert zero == {(f"{block_cls.__name__}_{i}", last)
                    for i in range(sum(presnet.STAGE_SIZES[depth]))}
    assert params["bn_init"]["scale"].all()
    assert all(not leaf["mean"].any() and (leaf["var"] == 1).all()
               for leaf in jax.tree_util.tree_leaves(
                   stats, is_leaf=lambda t: "mean" in t))


def test_init_draws_lecun_normal_kernels():
    port = presnet.resnet(18, num_classes=CLASSES, num_filters=8,
                          small_inputs=True)
    a = presnet.init_params(port, torch.Generator().manual_seed(0))
    b = presnet.init_params(port, torch.Generator().manual_seed(0))
    assert all(torch.equal(a[k], b[k]) for k in a)  # the generator's draw
    w = a["blocks.7.conv1.weight"]  # 64 x 64 x 3 x 3: fan_in 576
    assert abs(w.std().item() - (1 / 576) ** 0.5) < 0.05 * (1 / 576) ** 0.5
    assert w.abs().max().item() <= 2 * (1 / 576) ** 0.5 / 0.8796 + 1e-6
    assert not a["head.bias"].any()


@pytest.mark.parametrize("depth", sorted(presnet.STAGE_SIZES))
def test_every_depth_has_flax_param_shapes(depth):
    """Built on the meta device: no memory for the weights."""
    variables = jax.eval_shape(
        lambda rng: jresnet(depth=depth).init(rng, jnp.ones((1, 32, 32, 3)),
                                              train=False),
        jax.random.PRNGKey(0))
    want = {jax.tree_util.keystr(p): v.shape for p, v in
            jax.tree_util.tree_flatten_with_path(variables)[0]}
    got = {name: tuple(t.shape) for name, t in
           presnet.resnet(depth, device="meta").state_dict().items()}
    assert len(got) == len(want)
    assert sorted(np.prod(s) for s in got.values()) == sorted(
        np.prod(s) for s in want.values())


def test_unsupported_depth_raises():
    with pytest.raises(ValueError, match="unsupported ResNet depth"):
        presnet.resnet(42)
    with pytest.raises(ValueError, match="unsupported ResNet depth"):
        jresnet(depth=42)


def test_hwio_oihw_round_trip_and_kernel_layout():
    """flax -> port -> flax is the identity, leaf for leaf; a converted
    non-square kernel convolves as flax's (an H/W swap would not)."""
    _, params, stats = _flax("r50_w8_32")
    state = resnet_from_flax(params, stats)
    assert state["conv_init.weight"].shape == (8, 3, 7, 7)  # OIHW
    assert state["head.weight"].shape == (CLASSES, 256)
    back_params, back_stats = resnet_to_flax(state)
    assert_trees_close(back_params, params, 0.0, "params")
    assert_trees_close(back_stats, stats, 0.0, "batch_stats")

    x = _images(9, batch=1, seed=7)
    conv = nn.Conv(5, (1, 3), padding="SAME", use_bias=False)
    variables = conv.init(jax.random.PRNGKey(2), x)
    port = presnet.Conv(3, 5, (1, 3))
    tree = {"ResNetBlock_0": {"Conv_0": variables["params"]}}
    port.weight.data.copy_(resnet_from_flax(tree)["blocks.0.conv0.weight"])
    with torch.no_grad():
        got = port(nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, np.asarray(conv.apply(variables, x)),
                               rtol=1e-5, atol=1e-5)


def test_blocks_convert_by_index_not_by_sorted_name():
    """ResNet-50 has 16 blocks: BottleneckResNetBlock_10 sorts before _2,
    so a walk of sorted keys would load block 10's weights into block 2."""
    variables = jax.eval_shape(
        lambda rng: jresnet(depth=50, num_filters=8).init(
            rng, jnp.ones((1, 32, 32, 3)), train=False),
        jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                    variables["params"])
    for n in range(16):
        block = params[f"BottleneckResNetBlock_{n}"]
        block["BatchNorm_0"]["bias"] = np.full(
            block["BatchNorm_0"]["bias"].shape, n, np.float32)
    state = resnet_from_flax(params)
    for n in range(16):
        assert (state[f"blocks.{n}.bn0.bias"] == n).all()
    back, _ = resnet_to_flax(state)
    assert sorted(back) == sorted(params)


def test_forward_flops_counts_resnet50_at_its_published_figure():
    """4.09 G multiply-adds a 224 image (the figure torchvision publishes
    for ResNet-50 v1.5, whose stride sits on the 3x3 as here), counted
    on the meta device."""
    flops = presnet.forward_flops(presnet.resnet(50, device="meta"), 224)
    assert flops == 2 * 4_089_184_256


def test_entry_returns_the_resnet50_eval_forward(monkeypatch):
    from container_engine_accelerators_tpu_torch import entry

    monkeypatch.setenv("GRAFT_BATCH", "2")
    monkeypatch.setenv("GRAFT_IMAGE_SIZE", "32")
    fn, (model, x) = entry.entry(device="cpu")
    assert len(model.blocks) == 16 and model.dtype == torch.bfloat16
    assert not model.training
    assert x.shape == (2, 3, 32, 32)
    assert x.is_contiguous(memory_format=torch.channels_last)
    out = fn(model, x)
    assert out.shape == (2, 1000) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
