"""The PyTorch port's train-mode LM and its train step against the JAX
package.

JAX params (flax init, f32) are converted with ``from_flax_params``; the
same numpy tokens go through both sides on the CPU.  The JAX model runs
dense attention (its flash path needs the TPU off interpret mode); the
port runs dense attention or, with ``use_flash=True``, its
flash-attention op's plain version behind the autograd Function the
kernels use on the card.

Tolerances, f32: logits 1e-4 (atol and rtol) and the loss 1e-5 relative
— same arithmetic, another summation order; every gradient within 2e-5
of its leaf's largest |g| (measured ~2e-6).  bf16: the loss within 2e-2
relative (both frameworks round to bf16 after every projection, at
places that differ).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.models import lm_train as jlt
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu_torch.models import lm_train as lt
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
    to_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import generate
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)
from container_engine_accelerators_tpu_torch.ops import flash_attention as fa

BASE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=16, mlp_dim=32)
CFGS = {"mha": dict(BASE), "gqa": dict(BASE, num_kv_heads=2)}
SEQ, BATCH = 32, 2
GRAD_TOL = 2e-5  # of the leaf's largest |g|
LR = 3e-4


def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, BASE["vocab_size"], (BATCH, SEQ)).astype(np.int32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    """JAX, f32: (params, logits, loss, grads, params after one
    make_lm_train_step step with the default adamw), all numpy."""
    toks = jnp.asarray(_tokens())
    model = jtr.transformer_lm(**CFGS[name], dtype=jnp.float32,
                               use_flash=False)
    state = jlt.create_lm_train_state(model, jax.random.PRNGKey(0), toks)
    params = _np_tree(state.params)
    labels, mask = jlt.next_token_targets(toks)
    logits = np.asarray(model.apply({"params": params}, toks))

    def loss_fn(p):
        num, den = jlt._loss(model.apply, p, toks, labels, mask,
                             jnp.arange(SEQ))
        return num / den

    loss, grads = jax.value_and_grad(loss_fn)(params)
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    step, placed = jlt.make_lm_train_step(mesh, state)
    new, metrics = step(placed, toks, labels, mask)
    assert abs(float(metrics["loss"]) - float(loss)) < 1e-6
    return params, logits, float(loss), _np_tree(grads), _np_tree(new.params)


def _port_model(name, params, dtype=torch.float32, **kw):
    model = TransformerLM(**CFGS[name], dtype=dtype, device="cpu", **kw)
    model.load_state_dict(from_flax_params(params))
    return model


def _port_loss(model, toks=None):
    toks = torch.from_numpy(_tokens() if toks is None else toks).long()
    labels, mask = lt.next_token_targets(toks)
    num, den = lt._loss(model, toks, labels, mask, None)
    return num / den


def _grads(model):
    return to_flax_params({n: p.grad for n, p in model.named_parameters()})


def _assert_grads_close(got, want):
    for path, g in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(functools.reduce(lambda t, k: t[k.key], path, want))
        tol = GRAD_TOL * np.abs(w).max()
        np.testing.assert_allclose(g, w, atol=tol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("attention", ["flash", "dense"])
@pytest.mark.parametrize("name", list(CFGS))
def test_f32_logits_loss_and_grads_match_jax(name, attention, remat):
    params, logits, loss, grads, _ = _jax_run(name)
    model = _port_model(name, params, use_flash=attention == "flash",
                        remat=remat)
    with torch.no_grad():
        got = model(torch.from_numpy(_tokens()).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), logits, atol=1e-4, rtol=1e-4)
    port_loss = _port_loss(model)
    assert abs(port_loss.item() - loss) <= 1e-5 * abs(loss)
    port_loss.backward()
    _assert_grads_close(_grads(model), grads)


@pytest.mark.parametrize("name", list(CFGS))
def test_one_adamw_step_matches_optax(name):
    """One step of the port's default optimizer against optax.adamw(3e-4,
    weight_decay=0.1) inside the JAX make_lm_train_step.

    The gradients are held tightly first (GRAD_TOL of each leaf's
    largest |g|: delta below).  Adam's first step moves a param by
    lr * g / (|g| + eps) (plus the decay lr * wd * p, the same in both),
    so two gradients within delta of each other move it by amounts
    within lr * 2 delta / (|g| - delta) — and never more than 2 lr,
    which is what entries whose |g| sits at rounding noise can differ
    by.  Each post-step param is held to that bound plus 2e-6 for the f32
    rounding of the update."""
    params, _, _, grads, stepped = _jax_run(name)
    model = _port_model(name, params)
    state = lt.create_lm_train_state(model)
    step, state = lt.make_lm_train_step(None, state)
    toks = torch.from_numpy(_tokens()).long()
    state, metrics = step(state, toks, *lt.next_token_targets(toks))
    assert state.step == 1 and metrics["loss"].dtype == torch.float32
    got = to_flax_params(model.state_dict())
    for path, p in jax.tree_util.tree_leaves_with_path(got):
        def at(tree):
            return np.asarray(functools.reduce(lambda t, k: t[k.key], path,
                                               tree))
        g = np.abs(at(grads))
        delta = GRAD_TOL * g.max()
        bound = np.minimum(2 * LR, 2 * LR * delta / np.maximum(g - delta,
                                                               1e-30))
        err = np.abs(p - at(stepped))
        assert (err <= bound + 2e-6).all(), (jax.tree_util.keystr(path),
                                             err.max())


@pytest.mark.parametrize("name", list(CFGS))
def test_bf16_loss_matches_jax(name):
    params = _jax_run(name)[0]
    toks = jnp.asarray(_tokens())
    model = jtr.transformer_lm(**CFGS[name], dtype=jnp.bfloat16,
                               use_flash=False)
    labels, mask = jlt.next_token_targets(toks)
    num, den = jlt._loss(model.apply, params, toks, labels, mask,
                         jnp.arange(SEQ))
    want = float(num / den)
    for flash in (True, False):
        got = _port_loss(_port_model(name, params, torch.bfloat16,
                                     use_flash=flash)).item()
        assert abs(got - want) <= 2e-2 * abs(want), (flash, got, want)


def test_train_params_f32_trainable_and_cast_at_use():
    """bf16 train mode keeps f32 leaves with requires_grad (flax's
    params), computes in bf16, and gets f32 gradients through the cast."""
    params = _jax_run("gqa")[0]
    model = _port_model("gqa", params, torch.bfloat16)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    _port_loss(model).backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               and torch.isfinite(p.grad).all() for p in model.parameters())
    decode = TransformerLM(**CFGS["gqa"], dtype=torch.bfloat16, decode=True,
                           device="cpu")
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for n, p in decode.named_parameters() if "scale" not in n)


def test_train_params_load_into_the_decode_model():
    """The train-mode state dict (f32) loads into the decode model, which
    then gives the same greedy tokens as one loaded from the flax params,
    and its prefill's logits equal the train forward's."""
    params = _jax_run("gqa")[0]
    train = _port_model("gqa", params)
    prompt = torch.from_numpy(_tokens()[:, :8]).long()
    toks = {}
    for src in ("train", "flax"):
        decode = TransformerLM(**CFGS["gqa"], dtype=torch.float32,
                               decode=True, device="cpu")
        decode.load_state_dict(train.state_dict() if src == "train"
                               else from_flax_params(params))
        toks[src] = generate(decode, prompt, 6)
    assert torch.equal(toks["train"], toks["flax"])
    with torch.no_grad():
        logits = train(toks["train"][:, :14])
    assert torch.equal(logits[:, 7:13].argmax(-1), toks["train"][:, 8:14])


@pytest.mark.parametrize("remat,per_step", [(True, 2), (False, 1)],
                         ids=["remat", "no_remat"])
def test_flash_forward_runs_per_layer_once_or_twice(monkeypatch, remat,
                                                    per_step):
    """The launch-count rule chip_smoke.py checks on the card: a train
    step runs the flash forward once per layer, twice under remat (the
    backward recomputes each block), and the backward once per layer."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = fa.flash_forward, fa.flash_backward

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(fa, "flash_forward", count("fwd", fwd))
    monkeypatch.setattr(fa, "flash_backward", count("bwd", bwd))
    model = _port_model("mha", _jax_run("mha")[0], use_flash=True,
                        remat=remat)
    _port_loss(model).backward()
    assert calls == {"fwd": per_step * BASE["num_layers"],
                     "bwd": BASE["num_layers"]}


def test_auto_attention_on_the_cpu_is_dense(monkeypatch):
    """use_flash=None picks the kernel only for a CUDA tensor; on the CPU
    it is dense attention, as the JAX model off the TPU."""
    monkeypatch.setattr(fa, "flash_forward", None)  # would raise if reached
    model = _port_model("mha", _jax_run("mha")[0])
    assert model.use_flash is None
    assert torch.isfinite(_port_loss(model)).item()


def test_next_token_targets_match_jax():
    toks = _tokens(4)
    labels, mask = lt.next_token_targets(torch.from_numpy(toks))
    jl, jm = jlt.next_token_targets(jnp.asarray(toks))
    assert np.array_equal(labels.numpy(), np.asarray(jl))
    assert np.array_equal(mask.numpy(), np.asarray(jm))
    assert mask.dtype == torch.float32


def test_to_flax_params_inverts_from_flax_params():
    params = _jax_run("gqa")[0]
    back = to_flax_params(from_flax_params(params))
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(params))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        assert np.array_equal(a, b)


def test_optimizer_decays_every_parameter():
    """optax.adamw has no mask: the decay reaches the norm scales and the
    embedding too.  With a zero gradient, AdamW moves each param by
    exactly the decay lr * wd * p."""
    model = _port_model("mha", _jax_run("mha")[0])
    state = lt.create_lm_train_state(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), before[n] * (1 - LR * 0.1),
                                   atol=1e-7, rtol=1e-7, msg=n)


@pytest.mark.parametrize("kw", [dict(seq_parallel="ring"),
                                dict(seq_parallel="ulysses"),
                                dict(seq_parallel="ring-zigzag")],
                         ids=["ring", "ulysses", "ring-zigzag"])
def test_multi_gpu_step_options_raise(kw):
    """Sequence parallelism splits the sequence over a mesh's data axis:
    without a mesh the step refuses it."""
    with pytest.raises(ValueError, match="shards over a mesh's data axis"):
        lt.make_lm_train_step(**kw)


def test_fsdp_without_a_mesh_raises():
    with pytest.raises(ValueError, match="shards over a mesh"):
        lt.make_lm_train_step(param_sharding="fsdp")


def test_modes_reject_the_wrong_cache():
    train = TransformerLM(**BASE, dtype=torch.float32, device="cpu")
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="train mode"):
        train(toks, cache={})
    decode = TransformerLM(**BASE, decode=True, device="cpu")
    with pytest.raises(ValueError, match="KV cache"):
        decode(toks)
