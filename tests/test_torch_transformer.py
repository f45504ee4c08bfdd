"""The PyTorch port's decode-mode LM against the JAX package.

JAX params (flax init, f32) are converted with ``from_flax_params``; the
same numpy inputs go through both sides on the CPU.  The JAX flash-decode
path runs its Pallas kernel in interpret mode (transformer.py picks it on
a CPU backend); the port's runs the kernel's plain version.

Tolerances: f32 compute, logits within 1e-4 (atol and rtol) — same
arithmetic, other summation order.  bf16 compute, logits within 5e-2 of
the largest absolute logit — both frameworks round to bf16 after every
projection and elementwise op, at places that differ (fused or not), and
that drift compounds through the layers.  Greedy tokens (f32) must be
identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import batching as jbatching
from container_engine_accelerators_tpu.models import generate as jgen
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu_torch.models import batching
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import (
    generate,
    init_cache,
    prefill,
    prefill_chunked,
)
from container_engine_accelerators_tpu_torch.models.quant import (
    serving_params,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    RMSNorm,
    TransformerLM,
    init_params,
    rotary_embedding,
)

BASE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8, mlp_dim=32)
CFGS = {"mha": dict(BASE), "gqa": dict(BASE, num_kv_heads=2)}
JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
MAX_NEW = 8


@pytest.fixture(scope="module")
def params():
    """Per config: (flax params, the port's converted state dict)."""
    out = {}
    for i, (name, cfg) in enumerate(CFGS.items()):
        p = jtr.transformer_lm(**cfg).init(
            jax.random.PRNGKey(i), jnp.zeros((1, 8), jnp.int32))["params"]
        out[name] = (p, from_flax_params(jax.tree_util.tree_map(np.asarray, p)))
    return out


def _port_model(name, sd, dtype="f32", flash=False):
    model = TransformerLM(**CFGS[name], dtype=TORCH_DTYPE[dtype], decode=True,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(sd)
    return model


def _prompt(true_len, seed=0):
    """Two rows of ``true_len`` real tokens, zero-padded to their bucket."""
    bucket = batching.bucket_len(true_len, 8)
    rng = np.random.default_rng(seed)
    p = np.zeros((2, bucket), np.int32)
    p[:, :true_len] = rng.integers(1, BASE["vocab_size"], (2, true_len))
    return p


def _jax_prefill_step(name, flax_params, prompt, plen, dtype, flash):
    """JAX: prefill's last logits and the first decode step's logits."""
    model = jtr.transformer_lm(**CFGS[name], decode=True,
                               dtype=JAX_DTYPE[dtype],
                               use_flash_decode=flash)

    @jax.jit
    def run(p, prompt):
        cache, last = jgen.prefill(model, p, prompt, plen,
                                   prompt.shape[1] + MAX_NEW)
        tok = jnp.argmax(last, -1).astype(jnp.int32)
        logits, _ = model.apply({"params": p, "cache": cache}, tok[:, None],
                                positions=jnp.full((1,), plen, jnp.int32),
                                mutable=["cache"])
        return last, tok, logits[:, 0]

    return [np.asarray(x) for x in run(flax_params, jnp.asarray(prompt))]


def _port_prefill_step(model, prompt, plen, tok):
    prompt_t = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        cache, last = prefill(model, prompt_t, plen,
                              prompt.shape[1] + MAX_NEW)
        logits = model(torch.tensor(tok, dtype=torch.long)[:, None],
                       positions=torch.full((1,), plen, dtype=torch.int32),
                       cache=cache)
    assert last.dtype == logits.dtype == torch.float32
    return last.numpy(), logits[:, 0].numpy()


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_f32_prefill_and_first_step_logits(params, name, flash):
    flax_p, sd = params[name]
    prompt = _prompt(5)
    j_last, j_tok, j_step = _jax_prefill_step(name, flax_p, prompt, 5,
                                              "f32", flash)
    t_last, t_step = _port_prefill_step(_port_model(name, sd, "f32", flash),
                                        prompt, 5, j_tok)
    np.testing.assert_allclose(t_last, j_last, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(t_step, j_step, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_bf16_prefill_and_first_step_logits(params, name, flash):
    flax_p, sd = params[name]
    prompt = _prompt(5, seed=1)
    j_last, j_tok, j_step = _jax_prefill_step(name, flax_p, prompt, 5,
                                              "bf16", flash)
    t_last, t_step = _port_prefill_step(_port_model(name, sd, "bf16", flash),
                                        prompt, 5, j_tok)
    for got, want in ((t_last, j_last), (t_step, j_step)):
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()


@pytest.mark.parametrize("true_len", [3, 5])
@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_greedy_tokens_identical_to_jax(params, name, flash, true_len):
    """Bucket-padded prompts (true lengths 3 and 5 in buckets 4 and 8):
    the pads are dead on arrival on both sides."""
    flax_p, sd = params[name]
    prompt = _prompt(true_len, seed=true_len)
    jm = jtr.transformer_lm(**CFGS[name], decode=True, dtype=jnp.float32,
                            use_flash_decode=flash)
    want = np.asarray(jax.jit(
        lambda p, x: jgen.generate(jm, p, x, MAX_NEW, prompt_len=true_len)
    )(flax_p, jnp.asarray(prompt)))
    with torch.inference_mode():
        got = generate(_port_model(name, sd, "f32", flash),
                       torch.from_numpy(prompt).long(), MAX_NEW,
                       prompt_len=true_len).numpy()
    assert got.shape == want.shape
    n = true_len + MAX_NEW
    np.testing.assert_array_equal(got[:, :n], want[:, :n])


@pytest.mark.parametrize("shared", [True, False])
def test_rotary_matches_jax(shared):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 8), dtype=np.float32)
    pos = (np.arange(5, dtype=np.int32) + 7 if shared
           else rng.integers(0, 50, (2, 5)).astype(np.int32))
    want = np.asarray(jtr.rotary_embedding(jnp.asarray(x), jnp.asarray(pos)))
    got = rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 16), dtype=np.float32)
    scale = rng.standard_normal(16, dtype=np.float32)
    want = jtr.RMSNorm(dtype=JAX_DTYPE[dtype]).apply(
        {"params": {"scale": jnp.asarray(scale)}},
        jnp.asarray(x, JAX_DTYPE[dtype]))
    norm = RMSNorm(16, TORCH_DTYPE[dtype])
    norm.scale.copy_(torch.from_numpy(scale))
    got = norm(torch.from_numpy(x).to(TORCH_DTYPE[dtype]))
    assert got.dtype == TORCH_DTYPE[dtype]
    tol = 1e-6 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_convert_covers_every_parameter(params, name):
    flax_p, sd = params[name]
    model = _port_model(name, sd)
    assert set(sd) == {n for n, _ in model.named_parameters()}
    assert model.blocks[1].attn.out.shape == tuple(
        flax_p["blocks"]["block"]["attn"]["out"]["kernel"].shape[1:])
    np.testing.assert_array_equal(
        model.blocks[1].gate.numpy(),
        np.asarray(flax_p["blocks"]["block"]["gate"]["kernel"][1]))


def test_convert_rejects_foreign_trees(params):
    flax_p, _ = params["mha"]
    tree = jax.tree_util.tree_map(np.asarray, flax_p)
    tree["blocks"]["block"]["moe"] = {"w": np.zeros(3)}
    with pytest.raises(ValueError, match="moe"):
        from_flax_params(tree)


def test_int8_decode_mode_is_ported_and_train_mode_refused():
    """Once rejected as a later slice's, now taken in decode mode; the
    JAX package has no quantized training, so train mode refuses it."""
    model = TransformerLM(**BASE, decode=True, quant=True, device="meta")
    assert model.blocks[0].attn.out.kernel_q.dtype == torch.int8
    assert model.blocks[0].attn.out.scale.shape == (32,)
    with pytest.raises(ValueError, match="decode=True"):
        TransformerLM(**BASE, quant=True, device="meta")
    with pytest.raises(ValueError, match="float weights"):
        init_params(model, torch.Generator())


def test_serving_params():
    model = TransformerLM(**BASE, decode=True, device="meta")
    sd = init_params(model, torch.Generator().manual_seed(0))
    assert serving_params(sd, "f32") is sd
    bf = serving_params(sd, "bf16")
    assert all(t.dtype == torch.bfloat16 for t in bf.values())
    q = serving_params(sd, "int8")
    assert q["blocks.0.up.kernel_q"].dtype == torch.int8
    assert q["blocks.0.up.scale"].dtype == torch.float32
    assert q["embed"].dtype == q["ln_f.scale"].dtype == torch.bfloat16
    with pytest.raises(ValueError):
        serving_params(sd, "fp8")


def test_init_params_seeded_and_scaled():
    model = TransformerLM(vocab_size=1000, num_layers=1, num_heads=4,
                          head_dim=16, mlp_dim=256, decode=True, device="meta")
    a = init_params(model, torch.Generator().manual_seed(7))
    b = init_params(model, torch.Generator().manual_seed(7))
    assert all(torch.equal(a[k], b[k]) for k in a)
    # lecun-normal law: std sqrt(1/fan_in) (fan_in 64 for q, 256 for down)
    assert abs(a["blocks.0.attn.q"].std().item() - 64 ** -0.5) < 0.02
    assert abs(a["blocks.0.down"].std().item() - 256 ** -0.5) < 0.01
    assert torch.equal(a["ln_f.scale"], torch.ones(64))


def test_bucket_len_matches_jax():
    for n in range(1, 70):
        for cap in (1, 8, 64, 48):
            assert batching.bucket_len(n, cap) == jbatching.bucket_len(n, cap)


def test_write_past_the_cache_raises(params):
    """The cache write is bounds-checked where flax's
    dynamic_update_slice would silently clamp."""
    model = _port_model("gqa", params["gqa"][1])
    cache = init_cache(model, 1, 4)
    cache["cache_index"].fill_(4)
    with pytest.raises(IndexError), torch.inference_mode():
        model(torch.zeros((1, 1), dtype=torch.long),
              positions=torch.full((1,), 4, dtype=torch.int32), cache=cache)


def test_generate_rejects_bad_prompt_len(params):
    model = _port_model("mha", params["mha"][1])
    with pytest.raises(ValueError, match="prompt_len"):
        generate(model, torch.zeros((1, 4), dtype=torch.long), 2,
                 prompt_len=5)


# Chunked prefill: the same cache and last logits as the single-shot
# prefill, in pieces (f32 within 1e-5: the pieces' products round as the
# whole prompt's may not), and as JAX's prefill_chunked (1e-4, this file's
# f32 tolerance); greedy tokens identical.  True lengths 5, 11 and 16 in a
# 16-token bucket; chunk 16 or more is the single-shot path.
@pytest.mark.parametrize("true_len", [5, 11, 16])
@pytest.mark.parametrize("chunk", [1, 3, 4, 7])
def test_prefill_chunked_matches_single_shot_and_jax(params, chunk, true_len):
    flax_p, sd = params["gqa"]
    rng = np.random.default_rng(chunk * 31 + true_len)
    prompt = np.zeros((2, 16), np.int32)
    prompt[:, :true_len] = rng.integers(1, BASE["vocab_size"], (2, true_len))
    model = _port_model("gqa", sd, "f32", flash=True)
    x = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        c_cache, c_last = prefill_chunked(model, x, true_len, 16 + MAX_NEW,
                                          chunk)
        s_cache, s_last = prefill(model, x, true_len, 16 + MAX_NEW)
    assert (c_cache["cache_index"] == true_len).all()
    torch.testing.assert_close(c_last, s_last, atol=1e-5, rtol=1e-5)
    for k in ("cached_key", "cached_value"):
        torch.testing.assert_close(c_cache[k], s_cache[k], atol=1e-5,
                                   rtol=1e-5)
    jm = jtr.transformer_lm(**CFGS["gqa"], decode=True, dtype=jnp.float32)
    _, j_last = jgen.prefill_chunked(jm, flax_p, jnp.asarray(prompt),
                                     true_len, 16 + MAX_NEW, chunk)
    np.testing.assert_allclose(c_last.numpy(), np.asarray(j_last),
                               atol=1e-4, rtol=1e-4)
    with torch.inference_mode():
        chunked = generate(model, x, MAX_NEW, prompt_len=true_len,
                           prefill_chunk=chunk)
        whole = generate(model, x, MAX_NEW, prompt_len=true_len)
    n = true_len + MAX_NEW
    assert torch.equal(chunked[:, :n], whole[:, :n])


def test_prefill_chunked_rejects_a_zero_chunk(params):
    model = _port_model("mha", params["mha"][1])
    with pytest.raises(ValueError, match="chunk"):
        prefill_chunked(model, torch.zeros((1, 8), dtype=torch.long), 8, 8, 0)
