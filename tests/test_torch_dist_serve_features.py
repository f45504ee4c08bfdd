"""``cmd/serve_lm.py --tp`` with ``--num-experts``, ``--weights int8`` and
``--prefix-cache`` against the JAX package's tensor-parallel decode
(``tests/test_compose.py:109``, ``:202-224``; the dry run's regime 8), on
2 and 4 gloo ranks on the CPU.

JAX's f32 weights of a 2-layer LM (4 query heads over 2 KV heads; the
MoE-LM with 4 experts at F 128, so the JAX rule splits every expert's
F) are saved as port checkpoints; the port's server serves them with
``--tp 2`` over real HTTP from rank 0 while rank 1 follows (models built
in f32), per request and through the engine (``--slots 3``, requests
sent together): MoE, int8, the prefix cache (requests carrying
``prefix_ids``, the second of each prefix a hit), and all three at once.
Greedy tokens must equal JAX's exactly (f32: a token differs only on an
argmax tie): ``generate`` on the weights sharded over a (1, 2) mesh —
``serving_params(params, "int8")`` into the quantized model for int8
(the MoE experts stay float in both) — and, for a prefixed request,
JAX's ``PrefixCache`` block spliced by ``generate_with_prefix`` under
the same sharding.  On 4 ranks ``generate`` of the sharded MoE-LM at F
64 (the rule then splits the experts' D, not F: the port gathers them
whole) and of the int8 model gives JAX's tokens on a (1, 4) mesh.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_helpers as H
from torch_image_helpers import few_torch_threads  # noqa: F401 (autouse)
from container_engine_accelerators_tpu.models import generate as jgen
from container_engine_accelerators_tpu.models import prefix_cache as jpc
from container_engine_accelerators_tpu.models import quant as jquant
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.parallel import (
    create_mesh,
    shard_params,
)
from container_engine_accelerators_tpu_torch.models import lm_train as lt
from container_engine_accelerators_tpu_torch.models.batching import (
    bucket_len,
)
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    TrainCheckpointer,
)
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)

DENSE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=16,
             mlp_dim=64, num_kv_heads=2)
MOE = dict(DENSE, mlp_dim=128, num_experts=4)
N_NEW, MAX_PROMPT = 5, 16
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [40]]
PREFIX = [9, 8, 7, 6, 5]


def _argv(cfg):
    out = ["--device", "cpu", "--vocab-size", "97", "--num-layers", "2",
           "--num-heads", "4", "--kv-heads", "2", "--head-dim", "16",
           "--mlp-dim", str(cfg["mlp_dim"]), "--max-new-tokens", str(N_NEW),
           "--max-prompt-len", str(MAX_PROMPT)]
    if cfg.get("num_experts"):
        out += ["--num-experts", str(cfg["num_experts"])]
    return out


def _key(cfg):
    return tuple(sorted(cfg.items()))


@functools.lru_cache(maxsize=None)
def _jax_params(key):
    cfg = dict(key)
    model = jtr.transformer_lm(**cfg, dtype=jnp.float32)
    return jax.device_get(model.init(jax.random.PRNGKey(3),
                                     jnp.ones((1, 8), jnp.int32))["params"])


@functools.lru_cache(maxsize=None)
def _jax_rows(key, tp, int8, prefix):
    """JAX's greedy rows (f32) for PROMPTS with the weights sharded over a
    (1, tp) mesh: each prompt padded to its bucket, or, with ``prefix``,
    as the suffix after the prefix's spliced block."""
    cfg = dict(key)
    params = _jax_params(key)
    if int8:
        params = jquant.serving_params(params, "int8")
    model = jtr.transformer_lm(**cfg, decode=True, dtype=jnp.float32,
                               quant=int8)
    mesh = create_mesh(data=1, model=tp, devices=jax.devices()[:tp])
    params = jax.device_put(params, shard_params(params, mesh))
    rows = []
    for ids in PROMPTS:
        bucket = bucket_len(len(ids), MAX_PROMPT)
        padded = jnp.asarray([ids + [0] * (bucket - len(ids))], jnp.int32)
        if prefix:
            kv, plen = jpc.PrefixCache(model, params, MAX_PROMPT
                                       ).get_or_build(tuple(PREFIX))
            out = np.asarray(jpc.generate_with_prefix(
                model, params, kv, plen, padded, N_NEW, suffix_len=len(ids)))
            rows.append(PREFIX + out[0, :len(ids) + N_NEW].tolist())
        else:
            out = np.asarray(jgen.generate(model, params, padded, N_NEW,
                                           prompt_len=len(ids)))
            rows.append(out[0, :len(ids) + N_NEW].tolist())
    return rows


def _port_params(cfg):
    return {k: v.numpy() for k, v in
            from_flax_params(_jax_params(_key(cfg))).items()}


def _save(cfg, directory):
    model = TransformerLM(**cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _port_params(cfg).items()})
    TrainCheckpointer(str(directory)).save(lt.create_lm_train_state(model))


# (name, cfg, extra flags, int8, prefix)
CONFIGS = [
    ("moe", MOE, [], False, False),
    ("int8", DENSE, ["--weights", "int8"], True, False),
    ("prefix", DENSE, ["--prefix-cache", "4"], False, True),
    ("all", MOE, ["--weights", "int8", "--prefix-cache", "4"], True, True),
]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Each config served with --tp 2 on 2 ranks, per request then with
    --slots 3 -> {(name, slots): (sequential rows, concurrent rows)}."""
    ckpts = {}
    for cfg in (DENSE, MOE):
        ckpts[_key(cfg)] = tmp_path_factory.mktemp("feat_ckpt")
        _save(cfg, ckpts[_key(cfg)])
    configs, names = [], []
    for name, cfg, extra, _, prefix in CONFIGS:
        flags = _argv(cfg) + extra + ["--tp", "2", "--checkpoint-dir",
                                      str(ckpts[_key(cfg)])]
        bodies = [dict({"prompt_ids": [p]},
                       **({"prefix_ids": PREFIX} if prefix else {}))
                  for p in PROMPTS]
        configs.append((flags, bodies, []))
        configs.append((flags + ["--slots", "3"], bodies[:1], bodies))
        names += [(name, 0), (name, 3)]
    out = H.spawn(H.tp_serve, 2, tmp_path_factory.mktemp("feat_serve"),
                  configs)
    assert all(r == {"kv_heads": 1} for r in out[1])
    return {n: ([r[0] for r in res["sequential"]],
                [r[0] for r in res["concurrent"]])
            for n, res in zip(names, out[0])}


@pytest.mark.parametrize("name,cfg,extra,int8,prefix", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_tp2_per_request_greedy_equals_jax(served, name, cfg, extra, int8,
                                           prefix):
    assert served[(name, 0)][0] == _jax_rows(_key(cfg), 2, int8, prefix)


@pytest.mark.parametrize("name,cfg,extra,int8,prefix", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_tp2_slots_greedy_equals_jax(served, name, cfg, extra, int8,
                                     prefix):
    seq, conc = served[(name, 3)]
    want = _jax_rows(_key(cfg), 2, int8, prefix)
    assert conc == want
    assert seq == want[:1]


@pytest.mark.parametrize("cfg,int8", [(dict(MOE, mlp_dim=64), False),
                                      (DENSE, True)], ids=["moe", "int8"])
def test_tp4_generate_equals_jax(tmp_path, cfg, int8):
    from container_engine_accelerators_tpu_torch.models.quant import (
        serving_params,
    )

    params = _port_params(cfg)
    if int8:
        # bf16 leaves travel as their exact f32 values.
        params = {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                  for k, v in serving_params(
                      {k: torch.from_numpy(v) for k, v in params.items()},
                      "int8").items()}
    out = H.spawn(H.tp_generate, 4, tmp_path, dict(cfg, quant=int8), params,
                  PROMPTS[:2], N_NEW)
    want = _jax_rows(_key(cfg), 4, int8, False)[:2]
    for rows, heads in out:
        assert heads == 2  # 2 KV heads do not divide over 4 ranks
        assert rows == want
