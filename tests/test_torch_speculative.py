"""The PyTorch port's speculative decoding (container_engine_accelerators_
tpu_torch/models/speculative.py) against the JAX package's
models/speculative.py, mirroring its tests/test_speculative.py.

The same flax params (f32) go to both sides, converted with
``from_flax_params``.  Greedy speculation (f32) must give exactly the
target's own greedy tokens — the port's ``generate()``'s and JAX's
``generate_speculative``'s — with and without a spliced prefix, MHA and
GQA, through flash decode's plain version and the einsum path.  Sampled
speculation cannot match JAX's key stream: it must match the target's
distribution (total variation of per-position marginals, as JAX's test
bounds it) and repeat itself for a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import prefix_cache as jpc
from container_engine_accelerators_tpu.models import speculative as jspec
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import generate
from container_engine_accelerators_tpu_torch.models.prefix_cache import (
    PrefixCache,
)
from container_engine_accelerators_tpu_torch.models.speculative import (
    generate_speculative,
    generate_speculative_sampled,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
    init_params,
)

BASE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8, mlp_dim=32)
CFGS = {"mha": dict(BASE), "gqa": dict(BASE, num_kv_heads=2),
        "moe": dict(BASE, num_kv_heads=2, num_experts=4)}
MAX_NEW = 10
K = 3

jax_spec = jax.jit(jspec.generate_speculative,
                   static_argnames=("model", "draft_model", "max_new_tokens",
                                    "k"))


@pytest.fixture(scope="module")
def params():
    """Per config: (target flax, draft flax, target sd, draft sd)."""
    out = {}
    for i, (name, cfg) in enumerate(CFGS.items()):
        t = jtr.transformer_lm(**cfg).init(
            jax.random.PRNGKey(30 + i), jnp.zeros((1, 8), jnp.int32))["params"]
        d = jtr.transformer_lm(**dict(cfg, num_layers=1)).init(
            jax.random.PRNGKey(40 + i), jnp.zeros((1, 8), jnp.int32))["params"]
        out[name] = (t, d) + tuple(
            from_flax_params(jax.tree_util.tree_map(np.asarray, p))
            for p in (t, d))
    return out


def _model(cfg, sd, flash=False):
    model = TransformerLM(**cfg, dtype=torch.float32, decode=True,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(sd)
    return model.eval()


def _prompt():
    """Two rows, true length 5 in an 8-token bucket."""
    p = np.zeros((2, 8), np.int32)
    p[:, :5] = np.random.default_rng(5).integers(1, 97, (2, 5))
    return p


@pytest.mark.parametrize("prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_greedy_spec_is_exact_and_matches_jax(params, name, flash, prefix):
    t_flax, d_flax, t_sd, d_sd = params[name]
    cfg = CFGS[name]
    model = _model(cfg, t_sd, flash)
    draft = _model(dict(cfg, num_layers=1), d_sd, flash)
    prompt = _prompt()
    jm = jtr.transformer_lm(**cfg, decode=True, dtype=jnp.float32,
                            use_flash_decode=flash)
    jd = jtr.transformer_lm(**dict(cfg, num_layers=1), decode=True,
                            dtype=jnp.float32, use_flash_decode=flash)
    pfx_ids = (11, 22, 33)
    port_pfx = jax_pfx = None
    if prefix:
        t_kv, plen = PrefixCache(model, 8).get_or_build(pfx_ids)
        d_kv, _ = PrefixCache(draft, 8).get_or_build(pfx_ids)
        port_pfx = (t_kv, d_kv, plen)
        jt, jplen = jpc.PrefixCache(jm, t_flax, 8).get_or_build(pfx_ids)
        jdk, _ = jpc.PrefixCache(jd, d_flax, 8).get_or_build(pfx_ids)
        jax_pfx = (jt, jdk, jplen)
    x = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        got, stats = generate_speculative(model, draft, x, MAX_NEW, k=K,
                                          prompt_len=5, prefix=port_pfx)
        full = x if not prefix else torch.cat(
            [torch.tensor([pfx_ids] * 2), x[:, :5]], 1)
        plain = generate(model, full, MAX_NEW,
                         prompt_len=full.shape[1] if prefix else 5)
    n = 5 + MAX_NEW
    off = 3 if prefix else 0
    assert torch.equal(got[:, :n], plain[:, off:off + n])
    want, jstats = jax_spec(jm, t_flax, jd, d_flax, jnp.asarray(prompt),
                            MAX_NEW, k=K, prompt_len=5, prefix=jax_pfx)
    np.testing.assert_array_equal(got[:, :n].numpy(),
                                  np.asarray(want)[:, :n])
    # The same rounds and acceptances as JAX's (same draft tokens).
    assert stats["rounds"] == int(jstats["rounds"])
    np.testing.assert_array_equal(stats["accepted"].numpy(),
                                  np.asarray(jstats["accepted"]))
    np.testing.assert_array_equal(stats["drafted"].numpy(),
                                  np.asarray(jstats["drafted"]))


def test_moe_target_and_moe_draft_spec_is_exact_and_matches_jax(params):
    """An MoE target with an MoE draft (the server's draft inherits
    ``--num-experts``): the verify chunk routes k + 1 tokens drop-free."""
    test_greedy_spec_is_exact_and_matches_jax(params, "moe", False, False)


def test_self_draft_accepts_everything(params):
    _, _, t_sd, _ = params["gqa"]
    model = _model(CFGS["gqa"], t_sd, flash=True)
    x = torch.from_numpy(_prompt()).long()
    with torch.inference_mode():
        got, stats = generate_speculative(model, model, x, MAX_NEW, k=K,
                                          prompt_len=5)
        plain = generate(model, x, MAX_NEW, prompt_len=5)
    assert torch.equal(got[:, :5 + MAX_NEW], plain[:, :5 + MAX_NEW])
    assert torch.equal(stats["accepted"], stats["drafted"])
    assert stats["rounds"] == -(-(MAX_NEW - 1) // (K + 1))


def test_finished_rows_stay_inside_the_margin(params):
    """Rows that accept at different rates finish in different rounds;
    the finished ones keep taking part, parked where their writes stay
    inside the cache (the port's cache write raises past it), and the
    live rows' tokens stay the target's."""
    _, _, t_sd, _ = params["mha"]
    model = _model(CFGS["mha"], t_sd, flash=True)
    noisy = {k: v + 0.05 * torch.randn(v.shape, generator=torch.Generator()
                                       .manual_seed(7))
             if k.endswith("up") else v for k, v in t_sd.items()}
    draft = _model(CFGS["mha"], noisy, flash=True)
    x = torch.from_numpy(np.random.default_rng(9).integers(
        1, 97, (6, 4))).long()
    # Unbucketed 4-token prompts leave no slack: a row that finishes 2 or
    # more tokens past max_new while others run would write past the
    # cache if it were not parked.
    with torch.inference_mode():
        got, stats = generate_speculative(model, draft, x, 10, k=5)
        plain = generate(model, x, 10)
    assert torch.equal(got, plain)
    assert len(set(stats["drafted"].tolist())) > 1  # rows finished apart


def test_spec_rejects_bad_arguments(params):
    _, _, t_sd, d_sd = params["mha"]
    model = _model(CFGS["mha"], t_sd)
    x = torch.ones((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="k must be"):
        generate_speculative(model, model, x, 4, k=0)
    with pytest.raises(ValueError, match="temperature"):
        generate_speculative_sampled(model, model, x, 4, temperature=0.0)
    train = TransformerLM(**CFGS["mha"], device="cpu")
    with pytest.raises(ValueError, match="decode=True"):
        generate_speculative(model, train, x, 4)


# ---- sampled speculation: distribution-exact ------------------------------

S_CFG = dict(vocab_size=13, num_layers=2, num_heads=2, head_dim=4, mlp_dim=16)


def _s_models():
    meta = TransformerLM(**S_CFG, decode=True, device="meta")
    target = _model(S_CFG, init_params(meta, torch.Generator().manual_seed(3)))
    dmeta = TransformerLM(**dict(S_CFG, num_layers=1), decode=True,
                          device="meta")
    d_sd = init_params(dmeta, torch.Generator().manual_seed(9))
    # Deliberately mismatched: the doubled tied embedding sharpens the
    # draft's distribution, ~0.45 in total variation from the target's.
    d_sd["embed"] = 2.0 * d_sd["embed"]
    return target, _model(dict(S_CFG, num_layers=1), d_sd)


def _marginal(out, pos, vocab=13):
    return np.bincount(out[:, 3 + pos].numpy(), minlength=vocab) / len(out)


def test_sampled_spec_matches_target_distribution():
    """N=1024 rows, V=13: the noise floor of the total variation is ~0.05;
    the mismatched draft sits far off, so a scheme biased toward it fails
    the first bound (the JAX test's bounds)."""
    target, draft = _s_models()
    n, new = 1024, 3
    prompt = torch.tensor([[5, 9, 3]]).repeat(n, 1)
    with torch.inference_mode():
        spec, stats = generate_speculative_sampled(
            target, draft, prompt, new, k=2, temperature=1.0,
            generator=torch.Generator().manual_seed(42))
        plain = generate(target, prompt, new, temperature=1.0,
                         generator=torch.Generator().manual_seed(7))
        own = generate(draft, prompt, new, temperature=1.0,
                       generator=torch.Generator().manual_seed(8))
    for pos in range(new):
        mp = _marginal(plain, pos)
        tv_spec = 0.5 * np.abs(_marginal(spec, pos) - mp).sum()
        tv_draft = 0.5 * np.abs(_marginal(own, pos) - mp).sum()
        assert tv_spec < 0.15, (pos, tv_spec)
        assert tv_draft > 0.25, (pos, tv_draft)  # the test has power
    rate = int(stats["accepted"].sum()) / int(stats["drafted"].sum())
    assert 0.0 < rate < 0.95


def test_sampled_spec_deterministic_per_seed():
    target, draft = _s_models()
    prompt = torch.tensor([[5, 9, 3], [1, 2, 4]])

    def run(seed):
        with torch.inference_mode():
            return generate_speculative_sampled(
                target, draft, prompt, 6, k=2, temperature=0.8,
                generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_sampled_self_draft_accepts_nearly_everything():
    target, _ = _s_models()
    prompt = torch.tensor([[5, 9, 3]]).repeat(4, 1)
    with torch.inference_mode():
        _, stats = generate_speculative_sampled(
            target, target, prompt, 8, k=3, temperature=1.0,
            generator=torch.Generator().manual_seed(0))
    # p == q: every draft is accepted (u * q < p for u < 1).
    assert torch.equal(stats["accepted"], stats["drafted"])
