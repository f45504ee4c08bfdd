"""The PyTorch port's Switch MoE FFN (``ops/moe.py``) and MoE-LM against
the JAX package, on the CPU at tiny widths.

The same numpy inputs go through JAX's ``MoEFFN`` (one-hot dispatch and
combine einsums) and the port's index form; the MoE-LM's flax params are
converted with ``from_flax_params``.  Besides the JAX comparisons, the
index form is held against a one-hot formulation written with torch
einsums on the same arithmetic: bit for bit in f32, drops included.

Tolerances, f32: FFN outputs within 1e-5 (atol and rtol), the aux loss
1e-6 relative, every gradient within 2e-5 of its leaf's largest |g| —
same arithmetic, another summation order (the LM tests' tolerances);
routing (expert index and kept set) and greedy tokens identical; LM
logits 1e-4, loss 1e-5 relative.
"""

import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.models import generate as jgen
from container_engine_accelerators_tpu.models import lm_train as jlt
from container_engine_accelerators_tpu.models import quant as jquant
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu_torch.cmd import serve_lm, train_lm
from container_engine_accelerators_tpu_torch.models import lm_train as lt
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    STATE_FILE,
)
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
    to_flax_params,
)
from container_engine_accelerators_tpu_torch.models.generate import generate
from container_engine_accelerators_tpu_torch.models.quant import (
    kernel_contract_dims,
    param_bytes,
    quantize_params,
    serving_params,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
    init_params,
)
from container_engine_accelerators_tpu_torch.ops import moe

jmoe = importlib.import_module("container_engine_accelerators_tpu.ops.moe")

B, T, D, H, E = 2, 16, 16, 32, 4
GRAD_TOL = 2e-5  # of the leaf's largest |g|
FFN_CASES = {"cf1.25": dict(capacity_factor=1.25),
             "cf0.5": dict(capacity_factor=0.5),
             "no_drop": dict(no_drop=True)}
BASE = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8, mlp_dim=32,
            num_experts=E)
CFGS = {"mha": dict(BASE), "gqa": dict(BASE, num_kv_heads=2)}
SEQ, BATCH = 16, 2
LR = 3e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_close_to_leaf_max(got, want, name):
    tol = GRAD_TOL * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)


# ---- the FFN alone ---------------------------------------------------------

def _ffn_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = rng.standard_normal((B, T, D)).astype(np.float32)  # loss weights
    return x, w


@functools.lru_cache(maxsize=None)
def _jax_ffn(case):
    """JAX, f32: (params, out, aux, expert, keep, grads of x and params)
    for ``sum(out * w) + 0.3 * aux``, all numpy.  The routing is JAX's
    own arithmetic (``ops/moe.py:66-93``) on its params."""
    x, w = _ffn_inputs()
    layer = jmoe.MoEFFN(num_experts=E, mlp_dim=H, dtype=jnp.float32,
                        **FFN_CASES[case])
    params = layer.init(jax.random.PRNGKey(1), x)["params"]

    def loss(x, p):
        out, aux = layer.apply({"params": p}, x)
        return jnp.sum(out * w) + 0.3 * aux, (out, aux)

    (_, (out, aux)), grads = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), params)
    flat = jnp.asarray(x).reshape(-1, D)
    probs = jax.nn.softmax(flat @ params["router"]["kernel"], axis=-1)
    expert = jnp.argmax(probs, axis=-1)
    onehot = jax.nn.one_hot(expert, E, dtype=jnp.float32)
    pos = jnp.einsum("ne,ne->n", onehot,
                     jnp.cumsum(onehot, axis=0) - 1.0).astype(jnp.int32)
    cap = moe.capacity(B * T, E, FFN_CASES[case].get("capacity_factor", 1.25),
                       FFN_CASES[case].get("no_drop", False))
    return (_np_tree(params), np.asarray(out), float(aux), np.asarray(expert),
            np.asarray(pos < cap), _np_tree(grads))


def _port_weights(params):
    return {"router": params["router"]["kernel"], "wi_gate": params["wi_gate"],
            "wi_up": params["wi_up"], "wo": params["wo"]}


def _leaves(params, requires_grad=False, dtype=torch.float32):
    return {k: torch.tensor(v, dtype=dtype, requires_grad=requires_grad)
            for k, v in _port_weights(params).items()}


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_jax(case):
    """Output, aux, expert index, kept set and the gradients of x and of
    every weight, the router included, against JAX's layer."""
    params, out, aux, expert, keep, (gx, gp) = _jax_ffn(case)
    x_np, w = _ffn_inputs()
    x = torch.tensor(x_np, requires_grad=True)
    ws = _leaves(params, requires_grad=True)
    kw = FFN_CASES[case]
    got, got_aux, dropped = moe.moe_ffn(x, ws["router"], ws["wi_gate"],
                                        ws["wi_up"], ws["wo"], torch.float32,
                                        **kw)
    np.testing.assert_allclose(got.detach().numpy(), out, atol=1e-5,
                               rtol=1e-5)
    assert abs(got_aux.item() - aux) <= 1e-6 * abs(aux)
    cap = moe.capacity(B * T, E, kw.get("capacity_factor", 1.25),
                       kw.get("no_drop", False))
    r = moe.route(x.detach().reshape(-1, D), ws["router"].detach(), cap)
    np.testing.assert_array_equal(r.expert.numpy(), expert)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    # JAX's own output agrees on the kept set: dropped rows are zero.
    assert (np.abs(out.reshape(-1, D)).max(1) == 0).tolist() == (~keep).tolist()
    assert dropped.item() == (~keep).mean()
    if case == "cf0.5":
        assert (~keep).sum() >= B * T - E * cap > 0  # tokens really drop
    (got * torch.from_numpy(w)).sum().add(0.3 * got_aux).backward()
    _assert_close_to_leaf_max(x.grad.numpy(), np.asarray(gx), "x")
    for name, g in _port_weights(gp).items():
        _assert_close_to_leaf_max(ws[name].grad.numpy(), np.asarray(g), name)
    assert np.abs(ws["router"].grad.numpy()).max() > 0


def _onehot_ffn(x, ws, cap):
    """The JAX layer's capacity formulation (``ops/moe.py:88-107``,
    ``:132-136``) in torch: one-hot [N, E, C] dispatch and combine
    einsums around the same batched matmuls."""
    flat = x.reshape(-1, D)
    r = moe.route(flat, ws["router"], cap)
    onehot = torch.nn.functional.one_hot(r.expert, E).float()
    pos_oh = torch.nn.functional.one_hot(r.pos.clamp(max=cap - 1),
                                         cap).float()
    dispatch = onehot[:, :, None] * pos_oh[:, None, :] * r.keep[:, None,
                                                                None]
    slots = torch.einsum("nec,nd->ecd", dispatch, flat)
    h = torch.nn.functional.silu(torch.bmm(slots, ws["wi_gate"])) * torch.bmm(
        slots, ws["wi_up"])
    out_slots = torch.bmm(h, ws["wo"])
    combine = dispatch * r.gate[:, None, None]
    out = torch.einsum("nec,ecd->nd", combine, out_slots)
    return out.reshape(x.shape)


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_index_form_equals_onehot_form_bit_for_bit(case):
    """Each slot holds at most one token at weight 1 and each token one
    nonzero combine term, so the one-hot einsums only add exact zeros:
    the index form gives the same f32 bits, dropped tokens included."""
    params = _jax_ffn(case)[0]
    ws = _leaves(params)
    x = torch.from_numpy(_ffn_inputs(3)[0])
    kw = FFN_CASES[case]
    cap = moe.capacity(B * T, E, kw.get("capacity_factor", 1.25),
                       kw.get("no_drop", False))
    got, _, dropped = moe.moe_ffn(x, ws["router"], ws["wi_gate"],
                                  ws["wi_up"], ws["wo"], torch.float32, **kw)
    assert torch.equal(got, _onehot_ffn(x, ws, cap))
    if case == "cf0.5":
        assert dropped.item() > 0
    if case == "no_drop":
        assert dropped.item() == 0


def test_routing_makes_no_host_sync_and_has_static_shapes():
    """Every tensor of the layer has a shape fixed by (N, D, E, C): the
    same shapes at two inputs that route differently."""
    params = _jax_ffn("cf0.5")[0]
    ws = _leaves(params)
    shapes = []
    for seed in (0, 7):
        x = torch.from_numpy(_ffn_inputs(seed)[0])
        r = moe.route(x.reshape(-1, D), ws["router"], 4)
        out, aux, dropped = moe.moe_ffn(x, ws["router"], ws["wi_gate"],
                                        ws["wi_up"], ws["wo"], torch.float32,
                                        capacity_factor=0.5)
        shapes.append([tuple(t.shape) for t in (*r, out, aux, dropped)])
    assert shapes[0] == shapes[1]


def test_module_router_stays_f32_in_decode():
    """The router is held in f32 whatever the compute dtype, as the JAX
    router (Dense(dtype=float32)) multiplies its stored weights in f32;
    the experts follow the mode (f32 leaves in training, the compute
    dtype in decode)."""
    dec = TransformerLM(**BASE, decode=True, device="meta")
    layer = dec.blocks[0].moe
    assert layer.router.dtype == torch.float32
    assert layer.wi_gate.dtype == layer.wo.dtype == torch.bfloat16
    assert layer.no_drop and not layer.router.requires_grad
    train = TransformerLM(**BASE, device="meta").blocks[0].moe
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in train.parameters())
    assert not train.no_drop and train.capacity_factor == 1.25


# ---- ports of the JAX MoE tests that need no mesh (tests/test_moe.py) ------

def test_identical_experts_equal_gated_dense_ffn():
    """tests/test_moe.py:25: with every expert identical and capacity N,
    the layer is gate * FFN(x)."""
    params = _jax_ffn("cf1.25")[0]
    ws = {k: (torch.tensor(v[:1]).expand(v.shape).contiguous()
              if v.ndim == 3 else torch.tensor(v))
          for k, v in _port_weights(params).items()}
    x = torch.from_numpy(_ffn_inputs()[0])
    out, aux, _ = moe.moe_ffn(x, ws["router"], ws["wi_gate"], ws["wi_up"],
                              ws["wo"], torch.float32,
                              capacity_factor=float(E))
    flat = x.reshape(-1, D)
    gate = torch.softmax(flat @ ws["router"], -1).max(-1).values
    ref = (torch.nn.functional.silu(flat @ ws["wi_gate"][0])
           * (flat @ ws["wi_up"][0])) @ ws["wo"][0]
    torch.testing.assert_close(out, (ref * gate[:, None]).reshape(x.shape),
                               atol=2e-5, rtol=2e-5)
    assert torch.isfinite(aux)


def test_capacity_overflow_drops_to_zero():
    """tests/test_moe.py:51: one slot per expert; every other token's row
    is exactly zero, and nothing is NaN."""
    ws = _leaves(_jax_ffn("cf1.25")[0])
    x = torch.from_numpy(_ffn_inputs()[0])
    out, _, dropped = moe.moe_ffn(x, ws["router"], ws["wi_gate"],
                                  ws["wi_up"], ws["wo"], torch.float32,
                                  capacity_factor=1e-9)
    flat = out.reshape(-1, D)
    assert int((flat == 0).all(1).sum()) >= B * T - E
    assert dropped.item() >= (B * T - E) / (B * T)
    assert torch.isfinite(flat).all()


def test_gradients_flow_and_aux_balances():
    """tests/test_moe.py:86: finite gradients everywhere, and the router
    gets one through the gate and the aux term."""
    ws = _leaves(_jax_ffn("cf1.25")[0], requires_grad=True)
    x = torch.from_numpy(_ffn_inputs()[0])
    out, aux, _ = moe.moe_ffn(x, ws["router"], ws["wi_gate"], ws["wi_up"],
                              ws["wo"], torch.float32)
    ((out ** 2).mean() + 0.01 * aux).backward()
    assert all(torch.isfinite(p.grad).all() for p in ws.values())
    assert ws["router"].grad.abs().max() > 0
    # E * sum_e frac_e * mean_gate_e: 1 when balanced, at most E.
    assert 0 < aux.item() <= E


def test_moe_decode_matches_dropfree_train_forward():
    """tests/test_moe.py:138: KV-cache decode (drop-free) equals iterated
    argmax of a train-mode forward with capacity_factor = E (no drops)."""
    sd = init_params(TransformerLM(**BASE, device="meta"),
                     torch.Generator().manual_seed(3))
    ref = TransformerLM(**BASE, dtype=torch.float32,
                        moe_capacity_factor=float(E), device="cpu")
    ref.load_state_dict(sd)
    dec = TransformerLM(**BASE, dtype=torch.float32, decode=True,
                        device="cpu")
    dec.load_state_dict(sd)
    toks = torch.tensor([[5, 17, 42], [88, 3, 9]])
    with torch.no_grad():
        for _ in range(5):
            nxt = ref(toks)[:, -1].argmax(-1)
            toks = torch.cat([toks, nxt[:, None]], 1)
        got = generate(dec, toks[:, :3], 5)
    assert torch.equal(got[:, :8], toks)


# ---- the MoE-LM in training ------------------------------------------------

def _tokens(seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, BASE["vocab_size"], (BATCH, SEQ)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_lm(name):
    """JAX, f32: (params, logits, loss with the aux term, aux, grads,
    params after one make_lm_train_step step with the default adamw)."""
    toks = jnp.asarray(_tokens())
    model = jtr.transformer_lm(**CFGS[name], dtype=jnp.float32,
                               use_flash=False)
    state = jlt.create_lm_train_state(model, jax.random.PRNGKey(0), toks)
    params = _np_tree(state.params)
    labels, mask = jlt.next_token_targets(toks)
    logits, sown = model.apply({"params": params}, toks, mutable=["losses"])
    aux = float(sum(jnp.sum(v) for v in jax.tree_util.tree_leaves(sown)))

    def loss_fn(p):
        num, den = jlt._loss(model.apply, p, toks, labels, mask,
                             jnp.arange(SEQ))
        return num / den

    loss, grads = jax.value_and_grad(loss_fn)(params)
    mesh = create_mesh(data=1, model=1, devices=jax.devices()[:1])
    step, placed = jlt.make_lm_train_step(mesh, state)
    new, _ = step(placed, toks, labels, mask)
    return (params, np.asarray(logits), float(loss), aux, _np_tree(grads),
            _np_tree(new.params))


def _port_lm(name, params, **kw):
    model = TransformerLM(**CFGS[name], dtype=torch.float32, device="cpu",
                          **kw)
    model.load_state_dict(from_flax_params(params))
    return model


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("name", list(CFGS))
def test_lm_logits_loss_with_aux_and_grads_match_jax(name, remat):
    params, logits, loss, aux, grads, _ = _jax_lm(name)
    model = _port_lm(name, params, use_flash=True, remat=remat)
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        got, got_aux = model(toks, return_aux=True)
    np.testing.assert_allclose(got.numpy(), logits, atol=1e-4, rtol=1e-4)
    assert abs(got_aux.loss.item() - aux) <= 1e-5 * abs(aux)
    num, den = lt._loss(model, toks, *lt.next_token_targets(toks), None)
    port_loss = num / den
    assert abs(port_loss.item() - loss) <= 1e-5 * abs(loss)
    port_loss.backward()
    got_grads = to_flax_params({n: p.grad
                                for n, p in model.named_parameters()})
    for path, g in jax.tree_util.tree_leaves_with_path(got_grads):
        want = functools.reduce(lambda t, k: t[k.key], path, grads)
        _assert_close_to_leaf_max(g, np.asarray(want),
                                  jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", list(CFGS))
def test_one_adamw_step_matches_optax(name):
    """As ``test_torch_lm_train.py``'s: each post-step param within the
    bound two gradients GRAD_TOL apart can move it by, plus 2e-6."""
    params, _, _, _, grads, stepped = _jax_lm(name)
    model = _port_lm(name, params)
    state = lt.create_lm_train_state(model)
    toks = torch.from_numpy(_tokens()).long()
    state, metrics = lt.make_lm_train_step()[0](
        state, toks, *lt.next_token_targets(toks))
    assert set(metrics) == {"loss", "moe_aux", "moe_dropped"}
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


def test_dense_model_adds_a_zero_aux_term():
    model = TransformerLM(**dict(BASE, num_experts=0), dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    toks = torch.from_numpy(_tokens()).long()
    with torch.no_grad():
        logits, aux = model(toks, return_aux=True)
        assert torch.equal(logits, model(toks))
    assert aux.loss.item() == 0.0 and aux.dropped.item() == 0.0
    state, metrics = lt.make_lm_train_step()[0](
        lt.create_lm_train_state(model), toks, *lt.next_token_targets(toks))
    assert set(metrics) == {"loss"}


# ---- serving ---------------------------------------------------------------

def _prompt():
    p = np.zeros((2, 8), np.int32)
    p[:, :5] = np.random.default_rng(6).integers(1, 97, (2, 5))
    return p


@pytest.mark.parametrize("flash", [False, True], ids=["einsum", "flash"])
@pytest.mark.parametrize("name", list(CFGS))
def test_greedy_tokens_match_jax_generate(name, flash):
    params = _jax_lm(name)[0]
    model = TransformerLM(**CFGS[name], dtype=torch.float32, decode=True,
                          use_flash_decode=flash, device="cpu")
    model.load_state_dict(from_flax_params(params))
    prompt = _prompt()
    with torch.inference_mode():
        got = generate(model, torch.from_numpy(prompt).long(), 8,
                       prompt_len=5)
    jmodel = jtr.transformer_lm(**CFGS[name], decode=True, dtype=jnp.float32,
                                use_flash_decode=flash)
    want = np.asarray(jgen.generate(jmodel, params, jnp.asarray(prompt), 8,
                                    prompt_len=5))
    np.testing.assert_array_equal(got[:, :13].numpy(), want[:, :13])


# ---- conversion, quantization, init ----------------------------------------

def test_converter_round_trips_float_and_int8_moe_trees():
    params = _jax_lm("gqa")[0]
    sd = from_flax_params(params)
    assert "blocks.1.moe.wo" in sd and "blocks.1.gate" not in sd
    assert sd["blocks.1.moe.router"].shape == (32, E)
    assert sd["blocks.1.moe.wi_up"].shape == (E, 32, 32)
    for tree in (params, _np_tree(jquant.quantize_params(params))):
        back = to_flax_params(from_flax_params(tree))
        assert (jax.tree_util.tree_structure(back)
                == jax.tree_util.tree_structure(tree))
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(tree)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    mixed = _np_tree(params)
    mixed["blocks"]["block"]["gate"] = {"kernel": np.zeros((2, 32, 32))}
    with pytest.raises(ValueError, match="gate"):
        from_flax_params(mixed)


def test_quantize_params_leaves_moe_untouched():
    params = _jax_lm("mha")[0]
    sd = from_flax_params(params)
    assert all(kernel_contract_dims(k) is None for k in sd if ".moe." in k)
    q = quantize_params(sd)
    assert all(q[k] is sd[k] for k in sd if ".moe." in k)
    assert q["blocks.0.attn.q.kernel_q"].dtype == torch.int8
    # The JAX walk's tree, converted, is the port's.
    want = from_flax_params(_np_tree(jquant.quantize_params(params)))
    assert q.keys() == want.keys()
    assert all(torch.equal(q[k], want[k]) for k in q)
    served = serving_params(sd, "int8")
    assert all(served[k].dtype == torch.bfloat16 for k in sd if ".moe." in k)
    assert param_bytes(served) == sum(t.numel() * t.element_size()
                                      for t in served.values())
    assert param_bytes(served) < param_bytes(serving_params(sd, "bf16"))


def test_init_std_follows_the_experts_fan_in():
    """flax's lecun_normal(batch_axis=(0,)) reads the fan-in of the
    stacked experts from the middle axis: D for wi_gate / wi_up, H for
    wo; the router's is D.  Each slab's standard deviation follows it,
    in the port's init and in flax's."""
    cfg = dict(BASE, num_heads=2, head_dim=16, mlp_dim=512, num_layers=1)
    sd = init_params(TransformerLM(**cfg, device="meta"),
                     torch.Generator().manual_seed(0))
    flax_p = jtr.transformer_lm(**cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    fmoe = flax_p["blocks"]["block"]["moe"]
    for name, fan_in, flax_w in (
            ("wi_gate", 32, fmoe["wi_gate"][0]),
            ("wi_up", 32, fmoe["wi_up"][0]), ("wo", 512, fmoe["wo"][0]),
            ("router", 32, fmoe["router"]["kernel"][0])):
        w = sd[f"blocks.0.moe.{name}"]
        slabs = [w] if name == "router" else list(w)
        for slab in slabs:
            assert abs(slab.std().item() * fan_in ** 0.5 - 1) < 0.1, name
        assert abs(float(np.std(flax_w)) * fan_in ** 0.5 - 1) < 0.1, name


# ---- the CLIs ----------------------------------------------------------------

TRAIN = ["--device", "cpu", "--vocab-size", "64", "--num-layers", "1",
         "--num-heads", "2", "--head-dim", "8", "--mlp-dim", "32",
         "--num-experts", "4", "--seq-len", "16", "--train-batch-size", "2",
         "--learning-rate", "3e-2"]
SERVE = ["--device", "cpu", "--vocab-size", "64", "--num-layers", "1",
         "--num-heads", "2", "--head-dim", "8", "--mlp-dim", "32",
         "--num-experts", "4", "--max-prompt-len", "8",
         "--max-new-tokens", "4", "--port", "0"]


def test_train_resumes_bit_for_bit(tmp_path):
    ckpt = str(tmp_path / "ck")
    unbroken = train_lm.main(TRAIN + ["--train-steps", "6"])
    first = train_lm.main(TRAIN + ["--train-steps", "3", "--checkpoint-dir",
                                   ckpt, "--checkpoint-interval", "2"])
    resumed = train_lm.main(TRAIN + ["--train-steps", "6",
                                     "--checkpoint-dir", ckpt])
    assert first + resumed == unbroken
    assert all(np.isfinite(unbroken))


def test_train_reports_aux_and_drop_share():
    seen = []
    train_lm.main(TRAIN + ["--train-steps", "2"],
                  on_step=lambda step, loss, m: seen.append(
                      (float(m["moe_aux"]), float(m["moe_dropped"]))))
    assert len(seen) == 2
    assert all(0 < aux <= 4 and 0 <= drop < 1 for aux, drop in seen)


def test_train_then_serve_gives_jax_tokens(tmp_path, caplog):
    """tests/test_demo_workloads.py:560-592's contract: the server loads
    the trained MoE step (not random weights), and its tokens are the
    port's generate()'s on the saved weights, which in f32 are JAX's."""
    ckpt = str(tmp_path / "ck")
    train_lm.main(TRAIN + ["--train-steps", "2", "--checkpoint-dir", ckpt,
                           "--checkpoint-interval", "2"])
    args = serve_lm.parse_args(SERVE + ["--checkpoint-dir", ckpt])
    serve_lm.validate_args(args)
    with caplog.at_level("INFO"):
        run = serve_lm.build_generate(args)
    assert f"loaded step-2 params from {ckpt}" in caplog.text
    saved = torch.load(os.path.join(ckpt, "2", STATE_FILE),
                       weights_only=True)["model"]
    assert all(torch.equal(saved[k], run.params[k]) for k in saved)
    assert run.model.blocks[0].moe is not None
    cfg = dict(vocab_size=64, num_layers=1, num_heads=2, head_dim=8,
               mlp_dim=32, num_experts=4)
    prompt = torch.tensor([[1, 2, 3, 0]])
    got = run(prompt, 3, 0.0, 0, False)
    bf16 = TransformerLM(**cfg, decode=True, device="cpu")
    bf16.load_state_dict(saved)
    with torch.inference_mode():
        assert torch.equal(got, generate(bf16, prompt, 4, prompt_len=3))
    f32 = TransformerLM(**cfg, dtype=torch.float32, decode=True,
                        device="cpu")
    f32.load_state_dict(saved)
    with torch.inference_mode():
        mine = generate(f32, prompt, 4, prompt_len=3)
    want = jgen.generate(jtr.transformer_lm(**cfg, decode=True,
                                            dtype=jnp.float32),
                         to_flax_params(saved), jnp.asarray(prompt.numpy()),
                         4, prompt_len=3)
    np.testing.assert_array_equal(mine[:, :7].numpy(),
                                  np.asarray(want)[:, :7])


def test_serve_draft_inherits_the_experts():
    args = serve_lm.parse_args(SERVE + ["--speculative", "2"])
    serve_lm.validate_args(args)
    assert serve_lm._draft_cfg(args)["num_experts"] == 4
    run = serve_lm.build_generate(args)
    assert run.draft.blocks[0].moe is not None
    assert run(torch.tensor([[5, 6, 0, 0]]), 2, 0.0, 0, False).shape == (1, 8)


def test_num_experts_with_seq_parallel_exits_naming_num_experts():
    with pytest.raises(SystemExit, match="--num-experts with --seq-parallel"):
        train_lm.main(TRAIN + ["--seq-parallel", "ring"])


def test_tp_still_exits_with_moe():
    """``--num-experts`` with ``--tp`` is taken since the expert slice (as
    the JAX server takes it; served across ranks in
    ``test_torch_dist_serve_features.py``); with ``--tp`` the MoE server
    still exits on what JAX refuses there, the draft and the kernel."""
    serve_lm.validate_args(serve_lm.parse_args(SERVE + ["--tp", "2"]))
    for refused in (["--speculative", "2"], ["--flash-decode"]):
        with pytest.raises(SystemExit, match="mutually exclusive"):
            serve_lm.validate_args(serve_lm.parse_args(
                SERVE + ["--tp", "2"] + refused))


def test_optax_and_torch_agree_on_the_decay_of_moe_params():
    """AdamW (optax has no mask) decays the router and experts too: with
    a zero gradient each moves by exactly lr * wd * p."""
    model = _port_lm("mha", _jax_lm("mha")[0])
    state = lt.create_lm_train_state(model)
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if ".moe." in n}
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    state.optimizer.step()
    tx = optax.adamw(LR, weight_decay=0.1)
    for n, p in model.named_parameters():
        if n in before:
            w = jnp.asarray(before[n].numpy())
            upd, _ = tx.update(jnp.zeros_like(w), tx.init(w), w)
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(w + upd), atol=1e-7,
                                       rtol=1e-7, err_msg=n)
