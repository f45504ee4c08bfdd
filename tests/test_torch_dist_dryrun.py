"""``entry.dryrun_multichip`` of the PyTorch port — every regime of
``__graft_entry__._dryrun_multichip_impl`` — against the JAX package's
values, on 2 and 4 gloo ranks on the CPU.

For each n, JAX runs each regime's code at the dry run's shapes on n
host devices, from its ``jax.random`` weights and inputs; the port runs
all nine regimes in one ``dryrun_multichip(n)`` (its ranks capped at one
torch thread, within the dry run's deadline) from the same weights and
inputs (``inputs=``, converted).  Tolerances: the f32 regimes (pipeline,
MoE ep, fsdp) within 1e-5 relative — the same arithmetic in another
order; the bf16 ones (ResNet, ring, Ulysses) within 2e-2 relative (bf16
rounds after every product in both packages, at places that differ;
regime 1's bound in test_torch_dist_resnet.py); greedy tokens (tp decode, tp slots, tp
prefix) exactly equal to JAX's, as each regime itself holds the sharded
tokens to the unsharded ones.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_helpers as H
from container_engine_accelerators_tpu.models import lm_train as jlt
from container_engine_accelerators_tpu.models import resnet as jresnet
from container_engine_accelerators_tpu.models import train as jtrain
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.models.generate import generate
from container_engine_accelerators_tpu.models.prefix_cache import (
    PrefixCache,
    generate_with_prefix,
)
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu.parallel import pipeline as jpp
from container_engine_accelerators_tpu.parallel.mesh import (
    batch_sharding,
    shard_params,
)
from container_engine_accelerators_tpu_torch.entry import (
    REGIMES,
    dryrun_multichip,
)
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
    resnet_from_flax,
)

F32 = ("pipeline", "moe_ep", "fsdp")
BF16 = ("resnet", "ring", "ulysses")
TOKENS = ("tp_decode", "tp_slots", "tp_prefix")


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_resnet(n, devices):
    model = jresnet(depth=18, num_classes=64, num_filters=16,
                    small_inputs=True)
    x = jnp.ones((2 * n, 32, 32, 3), jnp.float32)
    state = jtrain.create_train_state(model, jax.random.PRNGKey(0), x)
    weights = resnet_from_flax(*jax.tree_util.tree_map(
        np.array, (state.params, state.batch_stats)))
    mp = 2 if n % 2 == 0 else 1
    mesh = create_mesh(data=n // mp, model=mp, devices=devices)
    step, placed = jtrain.make_sharded_train_step(mesh, state)
    _, m = step(placed, jax.device_put(x, batch_sharding(mesh)),
                jax.device_put(jnp.zeros((2 * n,), jnp.int32),
                               batch_sharding(mesh)))
    return float(m["loss"]), {"params": weights}


def _jax_seq(n, devices, kind, heads):
    lm = jtr.transformer_lm(vocab_size=128, num_layers=1, num_heads=heads,
                            head_dim=8, mlp_dim=32, seq_parallel=kind)
    toks = jnp.zeros((2, 8 * n), jnp.int32)
    state = jlt.create_lm_train_state(lm, jax.random.PRNGKey(0), toks,
                                      tx=optax.sgd(0.1))
    params = from_flax_params(jax.tree_util.tree_map(np.array, state.params))
    step, placed = jlt.make_lm_train_step(
        create_mesh(data=n, model=1, devices=devices), state, kind)
    lab, msk = jlt.next_token_targets(toks)
    _, m = step(placed, toks, lab, msk)
    return float(m["loss"]), {"params": params}


def _jax_pipeline(n, devices):
    pp = next(s for s in (4, 2, 1) if n % s == 0)
    dp = n // pp
    mesh = jpp.create_pipeline_mesh(pp, dp, devices)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = {"w": 0.3 * jax.random.normal(k1, (8, 16, 16)),
              "b": jnp.zeros((8, 16))}
    xb = jax.random.normal(k2, (4 * dp, 16))
    tgt = jax.random.normal(k3, (4 * dp, 16))
    apply = jpp.make_pipeline_apply(
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), mesh, 4)
    staged = jax.device_put(jpp.stage_params(params, pp), jpp.staged_sharding(
        mesh, jpp.stage_params(params, pp)))
    loss = jax.jit(lambda s: jnp.mean((apply(s, xb) - tgt) ** 2))(staged)
    return float(loss), {"w": _t(params["w"]), "b": _t(params["b"]),
                         "x": _t(xb), "target": _t(tgt)}


def _jax_moe(n, devices):
    import importlib

    jmoe = importlib.import_module("container_engine_accelerators_tpu.ops.moe")
    mp = 2 if n % 2 == 0 else 1
    mesh = create_mesh(data=n // mp, model=mp, devices=devices)
    moe = jmoe.MoEFFN(num_experts=n, mlp_dim=32, dtype=jnp.float32)
    xm = jax.random.normal(jax.random.PRNGKey(7), (4, 16, 16))
    p = moe.init(jax.random.PRNGKey(8), xm)["params"]
    placed = jax.device_put(p, jmoe.expert_sharding(mesh, p))

    def loss_fn(p):
        out, aux = moe.apply({"params": p}, xm)
        return jnp.mean(out ** 2) + 0.01 * aux

    loss = jax.jit(loss_fn)(placed)
    params = {"router": _t(p["router"]["kernel"]),
              **{k: _t(p[k]) for k in ("wi_gate", "wi_up", "wo")}}
    return float(loss), {"params": params, "x": _t(xm)}


def _jax_decode(n, devices):
    """Regimes 6, 6b and 8: JAX's tokens -> ({name: tokens}, inputs)."""
    from container_engine_accelerators_tpu.models.batching import (
        DecodeEngine,
    )

    dec = jtr.transformer_lm(vocab_size=128, num_layers=1,
                             num_heads=max(n, 2), head_dim=8,
                             mlp_dim=4 * n, decode=True)
    prompt = jax.random.randint(jax.random.PRNGKey(3), (1, 4), 0, 128,
                                jnp.int32)
    params = dec.init(jax.random.PRNGKey(4),
                      jnp.ones((1, 10), jnp.int32))["params"]
    mesh = create_mesh(data=1, model=n, devices=devices)
    placed = jax.device_put(params, shard_params(params, mesh))
    toks = np.asarray(jax.jit(lambda p, t: generate(dec, p, t, 6))(
        placed, prompt))
    eng = DecodeEngine(dec, placed, max_slots=2, max_len=12, mesh=mesh)
    rid = eng.submit([int(t) for t in np.asarray(prompt)[0]], 6)
    eng.step()
    rid2 = eng.submit([1, 2], 3)
    eng.run_until_drained()
    kv, plen = PrefixCache(dec, placed, max_prefix_len=2).get_or_build(
        tuple(int(t) for t in np.asarray(prompt)[0, :2]))
    pfx = np.asarray(generate_with_prefix(dec, placed, kv, plen,
                                          prompt[:, 2:], 6))
    out = {"tp_decode": toks.tolist(),
           "tp_slots": (eng.result(rid), eng.result(rid2)),
           "tp_prefix": pfx[:, :8].tolist()}
    given = {"params": from_flax_params(jax.tree_util.tree_map(np.array,
                                                               params)),
             "prompt": _t(prompt).long()}
    return out, given


def _jax_fsdp(n, devices):
    model = jtr.transformer_lm(vocab_size=128, num_layers=2, num_heads=4,
                               head_dim=8, mlp_dim=16 * n,
                               dtype=jnp.float32)
    toks = jax.random.randint(jax.random.PRNGKey(5), (n, 16), 0, 128,
                              jnp.int32)
    labels, mask = jlt.next_token_targets(toks)
    mesh = create_mesh(data=n, model=1, devices=devices)

    def state():
        return jlt.create_lm_train_state(model, jax.random.PRNGKey(6), toks,
                                         tx=optax.adamw(1e-2))

    params = from_flax_params(jax.tree_util.tree_map(np.array,
                                                     state().params))
    losses = []
    for layout in ("megatron", "fsdp"):
        step, placed = jlt.make_lm_train_step(mesh, state(),
                                              param_sharding=layout)
        _, m = step(placed, toks, labels, mask)
        losses.append(float(m["loss"]))
    return tuple(losses), {"params": params, "tokens": _t(toks).long()}


@functools.lru_cache(maxsize=None)
def _jax(n):
    """JAX's value of every regime at n devices, and the port's inputs."""
    devices = jax.devices()[:n]
    want, inputs = {}, {}
    for name, fn in (("resnet", _jax_resnet), ("pipeline", _jax_pipeline),
                     ("moe_ep", _jax_moe), ("fsdp", _jax_fsdp)):
        want[name], inputs[name] = fn(n, devices)
    want["ring"], inputs["ring"] = _jax_seq(n, devices, "ring", 4)
    want["ulysses"], inputs["ulysses"] = _jax_seq(n, devices, "ulysses",
                                                  max(n, 2))
    tokens, given = _jax_decode(n, devices)
    want.update(tokens)
    for name in TOKENS:
        inputs[name] = given
    return want, inputs


@functools.lru_cache(maxsize=None)
def _port(n):
    return H.rendezvous_retried(dryrun_multichip, n, device="cpu",
                                inputs=_jax(n)[1], threads=H.TORCH_THREADS)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(REGIMES))
def test_regime_equals_jax(name, n):
    want, got = _jax(n)[0][name], _port(n)[name]
    if name in TOKENS:
        assert got == want
    elif name == "fsdp":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        rtol = 1e-5 if name in F32 else 2e-2
        assert abs(got - want) <= rtol * abs(want), (got, want)


def test_every_regime_runs_in_jax_order():
    assert list(REGIMES) == ["resnet", "ring", "pipeline", "moe_ep",
                             "ulysses", "tp_decode", "tp_slots", "fsdp",
                             "tp_prefix"]
    assert list(_port(2)) == list(REGIMES)


def test_a_hung_regime_is_killed_at_the_deadline():
    """Ranks still running at the deadline are killed and the call
    raises, within a few seconds of it."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 1 s"):
        dryrun_multichip(2, device="cpu", regimes=["fsdp"], threads=1,
                         timeout=1)
    assert time.monotonic() - t0 < 30
