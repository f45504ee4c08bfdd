"""The port's MoE-LM train step on a mesh against the JAX package's, on
4 gloo ranks on the CPU.

A 2-layer MoE-LM (4 experts, D 32, F 64: the JAX rule shards every
expert weight's F, ``mlp_dim``, over the model axis, as at the trainer's
widths) from JAX's initial weights, three AdamW steps on the same three
numpy batches: JAX's ``make_lm_train_step`` on one device and on a (2,
2) mesh of host devices under megatron and fsdp, the port's on a (2, 2)
mesh of 4 ranks under both, each rank feeding its own rows.  Routing
runs on the GLOBAL batch in both packages (capacity and queue positions
over all 8 rows, the aux loss the global one), so the port's ranks must
agree with one JAX device.

Tolerances are the dense LM's (``test_torch_dist_lm.py``,
f32): losses within 2e-6 relative, parameters after three steps within
3e-6 absolute; the routing itself is exact (an argmax of the same
logits; a flipped route would move a loss by far more).

Across layouts in bf16 (the trainer's compute dtype), each package's
first loss on a (1, 2) mesh against its own on one device, on the same
weights and batch: the port's gap may not exceed JAX's by more than a
bf16 rounding's worth (``test_bf16_cross_layout_gap_within_jaxs``).
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
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.parallel import create_mesh
import torch_par_helpers as P
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
    to_flax_params,
)

CFG = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=16, mlp_dim=64,
           num_experts=4)
BATCH, SEQ, STEPS = 8, 16, 3
LOSS_RTOL = 2e-6
PARAM_ATOL = 3e-6
LAYOUTS = ("megatron", "fsdp")


def _batches():
    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        toks = rng.integers(0, CFG["vocab_size"], (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        mask = np.ones((BATCH, SEQ), np.float32)
        mask[:, -1] = 0.0
        out.append((toks.astype(np.int64), labels.astype(np.int64), mask))
    return out


def _jax_state():
    model = jtr.transformer_lm(**CFG, dtype=jnp.float32, use_flash=False)
    return jlt.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.asarray(_batches()[0][0], jnp.int32),
        tx=optax.adamw(3e-4, weight_decay=0.1))


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """JAX, f32: the init params and, for one device and the (2, 2) mesh
    under each layout, (losses, aux per step, final params)."""
    init = jax.tree_util.tree_map(np.asarray, _jax_state().params)
    runs = {}
    for name, (shape, layout) in {
            "single": ((1, 1), "megatron"), "megatron": ((2, 2), "megatron"),
            "fsdp": ((2, 2), "fsdp")}.items():
        n = shape[0] * shape[1]
        mesh = create_mesh(data=shape[0], model=shape[1],
                           devices=jax.devices()[:n])
        step, placed = jlt.make_lm_train_step(mesh, _jax_state(),
                                              param_sharding=layout)
        losses, aux = [], []
        for toks, labels, mask in _batches():
            placed, m = step(placed, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(labels, jnp.int32),
                             jnp.asarray(mask))
            losses.append(float(m["loss"]))
        runs[name] = (losses, jax.tree_util.tree_map(
            np.asarray, jax.device_get(placed.params)))
    return init, runs


@pytest.fixture(scope="module")
def port_22(tmp_path_factory):
    init, _ = _jax_runs()
    params = {k: v.numpy() for k, v in from_flax_params(init).items()}
    return H.spawn(H.lm_train, 4, tmp_path_factory.mktemp("moe22"), CFG,
                   params, _batches(), (2, 2), LAYOUTS)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("ref", ["single", "megatron", "fsdp"])
def test_moe_losses_equal_jax(port_22, layout, ref):
    _, runs = _jax_runs()
    for rank, res in enumerate(port_22):
        np.testing.assert_allclose(res[layout]["losses"], runs[ref][0],
                                   rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("ref", ["single", "megatron", "fsdp"])
def test_moe_params_after_three_steps_equal_jax(port_22, layout, ref):
    _, runs = _jax_runs()
    got = to_flax_params({k: torch.from_numpy(v) for k, v in
                          port_22[0][layout]["params"].items()})
    worst = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(runs[ref][1]):
        g = got
        for k in path:
            g = g[k.key]
        worst = max(worst, float(np.abs(g - w).max()))
    assert worst <= PARAM_ATOL, worst


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_experts_split_on_mlp_dim(port_22, layout):
    """Each rank holds half of every expert weight's F under megatron,
    and a quarter (F over model, then D over data) under fsdp."""
    share = {"megatron": 2, "fsdp": 4}[layout]
    for res in port_22:
        r = res[layout]
        for name in ("blocks.0.moe.wi_gate", "blocks.1.moe.wo"):
            assert r["local"][name] * share == r["numel"][name], name
            assert r["adam_local"][name] == [r["local"][name]] * 2, name


LM_CLI = ["--device", "cpu", "--num-layers", "2", "--num-heads", "2",
          "--mlp-dim", "64", "--vocab-size", "97", "--seq-len", "32",
          "--train-batch-size", "4", "--train-steps", "3",
          "--num-experts", "2"]


@pytest.mark.parametrize("flags", [["--model-par", "2"],
                                   ["--param-sharding", "fsdp"]],
                         ids=["model-par", "fsdp"])
def test_trainer_cli_moe_on_2_ranks_matches_one_device(tmp_path, flags):
    """``train_lm --num-experts 2`` on 2 ranks, tensor parallel or fsdp
    over a (2, 1) mesh: every rank logs the same global losses, within
    2e-2 relative of the single-device trainer's (bf16 compute, sums
    rounded at other places; the f32 step is held to JAX above)."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm

    out = H.spawn(H.lm_trainer_runs, 2, tmp_path, [LM_CLI + flags])
    assert out[0] == out[1]
    np.testing.assert_allclose(out[0][0], train_lm.main(LM_CLI), rtol=2e-2)


# The trainer's widths (``LM_CLI``): D = 2 x 64 = 128 > mlp 64, so the rule
# splits every q/k/v kernel and expert weight on D, a contracted dim of
# the projections.
BF16_CFG = dict(vocab_size=97, num_layers=2, num_heads=2, head_dim=64,
                mlp_dim=64, num_experts=2)
# bf16 rounding's share of the gap when no route flips: the port's gap
# 0-5e-6 and JAX's 5e-5-4.3e-4 at four other seeds (CPU).
GAP_MARGIN = 1e-4


def test_bf16_cross_layout_gap_within_jaxs(tmp_path):
    """``train_lm --num-experts 2 --model-par 2``'s first step: the
    trainer's seed-0 weights and first synthetic batch, bf16.  A (1, 2)
    mesh splits the projections' contracted dim, so each rank's product
    is a partial sum.  Summed in bf16 (each partial rounded first), they
    moved the layer-0 router input by a bf16 step and flipped a near-tie
    route: the port's 2-rank loss sat 4.9e-3 from one device's (5.3998
    against 5.3737) where JAX's gap is 2.4e-4.  The port sums them in
    f32 and rounds once (``models/transformer.py::_project``)."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm
    from container_engine_accelerators_tpu_torch.models import lm_train as lt
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )

    args = train_lm.parse_args(LM_CLI)
    batch = train_lm.synthetic_batches(args, 1)[0]
    model = TransformerLM(**BF16_CFG, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict(init_params(model, torch.Generator().manual_seed(0)))
    params = {k: v.detach().numpy().copy()
              for k, v in model.state_dict().items()}
    step, state = lt.make_lm_train_step(None, lt.create_lm_train_state(model))
    _, m = step(state, *(torch.from_numpy(x).long() for x in batch[:2]),
                torch.from_numpy(batch[2]))
    port = {"one": float(m["loss"])}
    ranks = H.spawn(P.lm_bf16_first_loss, 2, tmp_path, BF16_CFG, params,
                    batch, (1, 2))
    assert ranks[0] == ranks[1]
    port["mesh"] = ranks[0]

    flax = to_flax_params({k: torch.from_numpy(v) for k, v in params.items()})
    model = jtr.transformer_lm(**BF16_CFG, dtype=jnp.bfloat16,
                               use_flash=False)
    jax_ = {}
    for name, shape in (("one", (1, 1)), ("mesh", (1, 2))):
        tx = optax.adamw(3e-4, weight_decay=0.1)
        state = jlt.create_lm_train_state(model, jax.random.PRNGKey(0),
                                          jnp.asarray(batch[0]), tx=tx)
        state = state.replace(params=flax, opt_state=tx.init(flax))
        mesh = create_mesh(data=shape[0], model=shape[1],
                           devices=jax.devices()[:shape[0] * shape[1]])
        step, placed = jlt.make_lm_train_step(mesh, state,
                                              param_sharding="megatron")
        _, m = step(placed, *(jnp.asarray(x) for x in batch))
        jax_[name] = float(m["loss"])

    def gap(losses):
        return abs(losses["mesh"] - losses["one"]) / losses["one"]

    assert gap(port) <= gap(jax_) + GAP_MARGIN, (port, jax_)
