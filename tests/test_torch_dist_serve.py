"""``cmd/serve_lm.py --tp`` of the PyTorch port against the JAX package's
tensor-parallel decode, on 2 and 4 gloo ranks on the CPU.

The JAX model's f32 weights (a 2-layer LM, 4 query heads over 2 KV
heads) are saved as a port checkpoint; the port's server serves them
with ``--tp 2`` over real HTTP from rank 0 while rank 1 follows (models
built in f32), per request (with ``--prefill-chunk 4``) and through the
engine (``--slots 3``, requests sent together).  Its greedy tokens must
equal JAX's ``generate`` over the same weights sharded on a (1, 2) mesh
exactly (f32: a token differs only on an argmax tie).  A seeded sampled
request sent twice among them must repeat its tokens (the follower ranks
draw alike).  On 4 ranks the model axis does not divide the 2 KV heads:
each rank's cache then holds both, and ``generate`` on the sharded model
still gives JAX's tokens on a (1, 4) mesh.  At tp 2 each rank's cache
holds one KV head.
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

CFG = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=16, mlp_dim=64,
           num_kv_heads=2)
N_NEW, MAX_PROMPT = 6, 16
ARGS = ["--device", "cpu", "--vocab-size", "97", "--num-layers", "2",
        "--num-heads", "4", "--kv-heads", "2", "--head-dim", "16",
        "--mlp-dim", "64", "--max-new-tokens", str(N_NEW),
        "--max-prompt-len", str(MAX_PROMPT)]
PROMPTS = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [40], [3, 1, 4, 1, 5, 9, 2, 6,
                                                      5, 3]]


@functools.lru_cache(maxsize=None)
def _jax_params():
    model = jtr.transformer_lm(**CFG, dtype=jnp.float32)
    return jax.device_get(model.init(jax.random.PRNGKey(3),
                                     jnp.ones((1, 8), jnp.int32))["params"])


@functools.lru_cache(maxsize=None)
def _jax_greedy(tp, n_prompts=len(PROMPTS)):
    """JAX ``generate`` (f32) with the weights sharded over a (1, tp)
    mesh, the first ``n_prompts`` prompts each padded to its serving
    bucket -> token rows."""
    model = jtr.transformer_lm(**CFG, decode=True, dtype=jnp.float32)
    params = _jax_params()
    mesh = create_mesh(data=1, model=tp, devices=jax.devices()[:tp])
    params = jax.device_put(params, shard_params(params, mesh))
    rows = []
    for ids in PROMPTS[:n_prompts]:
        bucket = bucket_len(len(ids), MAX_PROMPT)
        prompt = jnp.asarray([ids + [0] * (bucket - len(ids))], jnp.int32)
        out = np.asarray(jgen.generate(model, params, prompt, N_NEW,
                                       prompt_len=len(ids)))
        rows.append(out[0, :len(ids) + N_NEW].tolist())
    return rows


def _port_params():
    return {k: v.numpy() for k, v in from_flax_params(_jax_params()).items()}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The JAX weights as a port checkpoint, served with --tp 2 on 2
    ranks: per request, then with --slots 3."""
    ckpt = tmp_path_factory.mktemp("tp_ckpt")
    model = TransformerLM(**CFG, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           _port_params().items()})
    TrainCheckpointer(str(ckpt)).save(lt.create_lm_train_state(model))
    flags = ARGS + ["--tp", "2", "--checkpoint-dir", str(ckpt)]
    greedy = [{"prompt_ids": [p]} for p in PROMPTS]
    sampled = {"prompt_ids": [[7, 7, 7]], "temperature": 0.8, "seed": 5}
    configs = [
        (flags + ["--prefill-chunk", "4"], greedy, []),
        (flags + ["--slots", "3"], greedy[:1],
         greedy + [sampled, sampled]),
    ]
    out = H.spawn(H.tp_serve, 2, tmp_path_factory.mktemp("tp_serve"),
                  configs)
    # The follower serves nothing itself; its cache holds its KV head.
    assert out[1] == [{"kv_heads": 1}] * 2
    return out[0]


def test_tp_per_request_greedy_equals_jax(served):
    rows = [r[0] for r in served[0]["sequential"]]
    assert rows == _jax_greedy(2)


def test_tp_slots_greedy_equals_jax(served):
    rows = [r[0] for r in served[1]["concurrent"][:len(PROMPTS)]]
    assert rows == _jax_greedy(2)
    assert served[1]["sequential"][0][0] == _jax_greedy(2)[0]


def test_tp_slots_sampled_request_repeats(served):
    a, b = served[1]["concurrent"][len(PROMPTS):]
    assert a == b and len(a[0]) == 3 + N_NEW


def test_tp4_generate_with_replicated_kv_heads_equals_jax(tmp_path):
    out = H.spawn(H.tp_generate, 4, tmp_path, CFG, _port_params(),
                  PROMPTS[:2], N_NEW)
    for rows, heads in out:
        assert heads == 2  # 2 KV heads do not divide over 4 ranks
        assert rows == _jax_greedy(4, 2)


def test_tp2_cache_holds_one_kv_head_a_rank(served):
    assert served[0]["kv_heads"] == 1
