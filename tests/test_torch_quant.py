"""The PyTorch port's int8 serving weights (container_engine_accelerators_tpu_
torch/models/quant.py) against the JAX package's models/quant.py.

The same flax params (f32) go to both sides, converted with
``from_flax_params``.  Exact checks, no tolerance:

- the int8 kernels and f32 scales of ``quantize_params`` /
  ``serving_params(..., "int8")`` equal JAX's element for element (the
  port quantizes the bf16 cast, as JAX does);
- the int8 model's greedy tokens equal a float model's loaded with the
  dequantized weights, in f32 and in bf16 (the same arithmetic: both
  multiply the compute-dtype cast of the f32 dequantized kernel);
- in f32 compute, the port's int8 greedy tokens equal the JAX
  ``quant=True`` model's on the same int8 tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import generate as jgen
from container_engine_accelerators_tpu.models import quant as jquant
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
    to_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import generate
from container_engine_accelerators_tpu_torch.models.quant import (
    QDense,
    dequantize_kernel,
    dequantize_params,
    param_bytes,
    quantize_kernel,
    quantize_params,
    serving_params,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)

BASE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8, mlp_dim=32)
CFGS = {"mha": dict(BASE), "gqa": dict(BASE, num_kv_heads=2),
        "moe": dict(BASE, num_kv_heads=2, num_experts=4)}
MAX_NEW = 8


@pytest.fixture(scope="module")
def params():
    """Per config: (flax f32 params as numpy, the port's state dict)."""
    out = {}
    for i, (name, cfg) in enumerate(CFGS.items()):
        p = jtr.transformer_lm(**cfg).init(
            jax.random.PRNGKey(10 + i), jnp.zeros((1, 8), jnp.int32))["params"]
        p = jax.tree_util.tree_map(np.asarray, p)
        out[name] = (p, from_flax_params(p))
    return out


def _port(name, sd, dtype=torch.float32, quant=True, flash=False):
    model = TransformerLM(**CFGS[name], dtype=dtype, decode=True, quant=quant,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


def _prompts():
    rng = np.random.default_rng(4)
    return [rng.integers(1, 97, n).tolist() for n in (3, 8, 5)]


def _greedy(model, prompts):
    rows = []
    for ids in prompts:
        with torch.inference_mode():
            out = generate(model, torch.tensor([ids]), MAX_NEW)
        rows.append(out[0].tolist())
    return rows


def _same_tree(port_sd, jax_tree):
    """Every leaf of the JAX tree equals the port's, exactly."""
    conv = from_flax_params(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert conv.keys() == port_sd.keys()
    for k, v in port_sd.items():
        assert conv[k].dtype == (torch.int8 if v.dtype == torch.int8
                                 else torch.float32), k
        assert torch.equal(conv[k], v.to(conv[k].dtype)), k


@pytest.mark.parametrize("name", ["mha", "gqa", "moe"])
@pytest.mark.parametrize("weights", ["f32-tree", "serving-int8"])
def test_quantize_params_matches_jax(params, name, weights):
    """Same int8 values and f32 scales as JAX, every element."""
    flax_p, sd = params[name]
    if weights == "f32-tree":
        got, want = quantize_params(sd), jquant.quantize_params(flax_p)
    else:
        got, want = (serving_params(sd, "int8"),
                     jquant.serving_params(flax_p, "int8"))
        # The kernels come from the bf16 cast; the rest stays bf16.
        assert got["embed"].dtype == torch.bfloat16
        assert got["blocks.0.attn.q.scale"].dtype == torch.float32
    assert got["blocks.1.attn.out.kernel_q"].shape == (4, 8, 32)
    assert got["blocks.1.attn.out.scale"].shape == (32,)
    assert got["blocks.0.attn.k.scale"].shape == (
        CFGS[name].get("num_kv_heads", 4), 8)
    _same_tree(got, want)


def test_bf16_then_quantize_order_matters(params):
    """Quantizing the f32 weights instead of their bf16 cast changes some
    int8 values: the order is part of the contract."""
    _, sd = params["mha"]
    from_bf16 = serving_params(sd, "int8")
    from_f32 = quantize_params(sd)
    assert any(not torch.equal(from_bf16[k], from_f32[k])
               for k in from_bf16 if k.endswith("kernel_q"))


@pytest.mark.parametrize("shape,dims", [((16, 4, 8), (0,)), ((4, 8, 16), (0, 1)),
                                        ((16, 32), (0,)), ((3, 5), (0,))])
def test_quantize_kernel_matches_jax(shape, dims):
    w = np.random.default_rng(len(shape) + shape[0]).normal(
        size=shape).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel: the 1e-8 floor
    q, scale = quantize_kernel(torch.from_numpy(w), dims)
    jq, jscale = jquant.quantize_kernel(jnp.asarray(w), dims)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        dequantize_kernel(q, scale, dims).numpy(),
        np.asarray(jquant.dequantize_kernel(jq, jscale, dims)))
    assert q.abs().max() <= 127


def test_qdense_weight_is_the_dequantized_kernel_in_the_compute_dtype():
    w = torch.randn(16, 4, 8, generator=torch.Generator().manual_seed(0))
    q, scale = quantize_kernel(w, (0,))
    layer = QDense((16, 4, 8), 1)
    layer.load_state_dict({"kernel_q": q, "scale": scale})
    want = dequantize_kernel(q, scale, (0,))
    assert torch.equal(layer.weight(torch.float32), want)
    assert torch.equal(layer.weight(torch.bfloat16), want.to(torch.bfloat16))
    assert not layer.kernel_q.requires_grad and not layer.scale.requires_grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("name", ["mha", "gqa", "moe"])
def test_int8_greedy_equals_dequantized_float_model(params, name, flash,
                                                    dtype):
    _, sd = params[name]
    q = serving_params(sd, "int8")
    int8 = _port(name, q, dtype, flash=flash)
    dense = _port(name, dequantize_params(q), dtype, quant=False, flash=flash)
    assert _greedy(int8, _prompts()) == _greedy(dense, _prompts())


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_int8_greedy_matches_jax_quant_model(params, name, flash):
    """f32 compute on the same int8 tree: the port's greedy tokens equal
    the JAX ``quant=True`` model's (its flash decode in interpret
    mode)."""
    flax_p, sd = params[name]
    jq = jquant.serving_params(flax_p, "int8")
    model = _port(name, from_flax_params(
        jax.tree_util.tree_map(np.asarray, jq)), flash=flash)
    jmodel = jtr.transformer_lm(**CFGS[name], decode=True, quant=True,
                                dtype=jnp.float32, use_flash_decode=flash)
    want = [np.asarray(jgen.generate(jmodel, jq, jnp.asarray([ids]),
                                     MAX_NEW))[0].tolist()
            for ids in _prompts()]
    assert _greedy(model, _prompts()) == want


def test_int8_moe_greedy_matches_jax_quant_model(params):
    """int8 attention kernels with float experts (``tests/test_compose.py``
    pairs them too): the port's greedy tokens equal JAX's."""
    test_int8_greedy_matches_jax_quant_model(params, "moe", False)


def test_int8_tree_round_trips_through_flax_layout(params):
    _, sd = params["gqa"]
    q = serving_params(sd, "int8")
    tree = to_flax_params(q)
    blk = tree["blocks"]["block"]
    assert blk["attn"]["out"]["kernel_q"].dtype == np.int8
    assert blk["attn"]["out"]["kernel_q"].shape == (2, 4, 8, 32)
    assert blk["up"]["scale"].shape == (2, 32)
    back = from_flax_params(tree)
    assert back.keys() == q.keys()
    assert all(torch.equal(back[k], q[k].to(back[k].dtype)) for k in q)
    _port("gqa", back)  # loads into a quant=True model


def test_param_bytes_int8_is_near_a_quarter_of_f32(params):
    _, sd = params["mha"]
    kernels = {k: v for k, v in sd.items() if "ln" not in k and k != "embed"}
    f32 = param_bytes(kernels)
    int8 = param_bytes(quantize_params(kernels))
    assert f32 / 4 < int8 < f32 / 4 * 1.2  # + one f32 scale per channel
    assert param_bytes(serving_params(sd, "bf16")) * 2 == param_bytes(sd)


def test_quant_model_takes_no_float_weights(params):
    _, sd = params["mha"]
    with pytest.raises(RuntimeError, match="kernel_q"):
        _port("mha", sd)
