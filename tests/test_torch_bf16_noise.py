"""How far bf16 rounding moves the LM's tokens and logits, the port beside
the JAX package, on the CPU, on the same converted weights.

- Speculative against plain greedy tokens: in f32 the port's greedy
  speculation gives exactly ``generate``'s tokens
  (``tests/test_torch_speculative.py``); in bf16 the (k+1)-token verify
  chunk rounds differently from the single-token steps, so a near-tie
  can flip and the two continuations part.  The port's share of agreeing
  tokens is held to JAX's.
- The noise floor of the logits at the serving benchmark's full width
  (``cmd/bench_serving.py`` at the watcher's shape: 12 layers, 16x64
  heads, mlp 4096, vocab 32768): one 70-token context prefilled in
  buckets of 70 and 128 tokens gives last-position logits that
  differ by the padding's rounding alone.  The port's spread is held to
  within twice JAX's.  Both sit above the 0.02 tie margin of
  ``bench_serving``'s gate, which is why the card runs that gate in f32.

Run with ``-s`` to see the figures.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from container_engine_accelerators_tpu.models import speculative as jspec
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import (
    generate,
    prefill,
)
from container_engine_accelerators_tpu_torch.models.speculative import (
    generate_speculative,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)

# The JAX package's models/__init__ re-exports the function ``generate``
# under the module's name.
jgen = importlib.import_module("container_engine_accelerators_tpu.models.generate")

SPEC_CFG = dict(vocab_size=512, num_layers=4, num_heads=4, head_dim=32,
                mlp_dim=256)
ROWS, PROMPT, NEW, K = 8, 16, 32, 4
# How far below JAX's agreement the port's may sit: one row in eight
# parting at its first token.
SPEC_MARGIN = 1 / ROWS

WIDE_CFG = dict(vocab_size=32768, num_layers=12, num_heads=16, head_dim=64,
                mlp_dim=4096)
CONTEXT, BUCKETS = 70, (70, 128)
TIE_MARGIN = 0.02  # cmd/bench_serving.py --tie-margin's default


def _flax_params(cfg, seed):
    return jtr.transformer_lm(**cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]


def _port_model(cfg, flax_params):
    model = TransformerLM(**cfg, dtype=torch.bfloat16, decode=True,
                          device="cpu")
    model.load_state_dict(from_flax_params(
        jax.tree_util.tree_map(np.asarray, flax_params)))
    return model.eval()


def _agreement(a, b):
    """Share of generated positions where two [rows, NEW] token arrays
    agree."""
    return float((np.asarray(a) == np.asarray(b)).mean())


def test_bf16_spec_agrees_with_plain_as_often_as_jax():
    draft_cfg = dict(SPEC_CFG, num_layers=1)
    t_params = _flax_params(SPEC_CFG, 1)
    d_params = _flax_params(draft_cfg, 2)
    prompt = np.random.default_rng(3).integers(
        0, SPEC_CFG["vocab_size"], (ROWS, PROMPT)).astype(np.int32)
    out = slice(PROMPT, PROMPT + NEW)

    jm = jtr.transformer_lm(**SPEC_CFG, decode=True)  # bf16, the default
    jd = jtr.transformer_lm(**draft_cfg, decode=True)
    j_plain = jax.jit(jgen.generate, static_argnums=(0, 3))(
        jm, t_params, jnp.asarray(prompt), NEW)
    j_spec = jax.jit(jspec.generate_speculative,
                     static_argnames=("model", "draft_model",
                                      "max_new_tokens", "k"))(
        jm, t_params, jd, d_params, jnp.asarray(prompt), NEW, k=K)[0]
    jax_agree = _agreement(np.asarray(j_spec)[:, out],
                           np.asarray(j_plain)[:, out])

    model = _port_model(SPEC_CFG, t_params)
    draft = _port_model(draft_cfg, d_params)
    x = torch.from_numpy(prompt).long()
    with torch.inference_mode():
        p_plain = generate(model, x, NEW)[:, out]
        p_spec = generate_speculative(model, draft, x, NEW, k=K)[0][:, out]
    port_agree = _agreement(p_spec, p_plain)

    print(f"\nbf16 speculative vs plain greedy tokens: port {port_agree:.4f}, "
          f"JAX {jax_agree:.4f} ({ROWS} rows x {NEW} tokens)")
    assert port_agree >= jax_agree - SPEC_MARGIN


def test_bf16_logit_noise_at_full_width_is_jax_s():
    params = _flax_params(WIDE_CFG, 0)
    ids = np.random.default_rng(3).integers(
        0, WIDE_CFG["vocab_size"], CONTEXT).tolist()
    jm = jtr.transformer_lm(**WIDE_CFG, decode=True)
    model = _port_model(WIDE_CFG, params)

    def jax_last(bucket):
        p = jnp.asarray([ids + [0] * (bucket - CONTEXT)], jnp.int32)
        return np.asarray(jgen.prefill(jm, params, p, CONTEXT, bucket + 1)[1],
                          np.float32)[0]

    def port_last(bucket):
        p = torch.tensor([ids + [0] * (bucket - CONTEXT)])
        with torch.inference_mode():
            return prefill(model, p, CONTEXT, bucket + 1)[1].float()[0].numpy()

    def spread(rows):
        return max(float(np.abs(a - b).max()) for a in rows for b in rows)

    j = [jax_last(b) for b in BUCKETS]
    p = [port_last(b) for b in BUCKETS]
    jax_spread, port_spread = spread(j), spread(p)
    print(f"\nbf16 logits of one {CONTEXT}-token context over buckets "
          f"{BUCKETS} (12L 16x64 mlp4096 vocab32768, logit std "
          f"{float(j[0].std()):.3f}): max spread port {port_spread:.5f}, "
          f"JAX {jax_spread:.5f}; port vs JAX {float(np.abs(p[0] - j[0]).max()):.5f}")
    assert port_spread <= 2 * jax_spread
    # The reference itself rounds past the tie margin at this width.
    assert jax_spread > TIE_MARGIN
