"""The PyTorch port's sharded LM train step against the JAX package's,
on 4 and 2 gloo ranks on the CPU (``tests/torch_dist_helpers.py``).

The same converted f32 weights (a 2-layer GQA LM) and the same three
numpy batches go through JAX's ``make_lm_train_step`` on one device and
on a (2, 2) mesh of the 8 host devices, megatron and fsdp, and through
the port's on a (2, 2) mesh of 4 ranks, each rank feeding its own rows.
The third batch masks a different number of positions in each data
shard's rows: the loss must be the global masked mean (the sum over the
whole batch over the global count), which a mean of per-rank means is
not.

Tolerances, f32.  Losses within 2e-6 relative: the same arithmetic,
summed in another order (the sharded contractions add two half-sums,
and the loss adds per-rank partial sums), and a loss of ~4.6 sums 112
terms of ~4.6, so each order rounds within ~1e-6 of it.  Parameters
after three AdamW steps within 3e-6 absolute (weights are ~0.2, one
f32 ulp ~1.5e-8): AdamW moves an entry by lr * m / (sqrt(v) + eps), at
most ~lr = 3e-4 a step, and two runs whose gradients differ by rounding
move it by amounts that differ by lr times the gradients' relative
difference — except where a gradient sits at rounding noise, where the
step can differ by up to 2 lr.  Measured on the CPU: losses within
1.8e-7 relative and parameters within 4.2e-7 of every JAX run (JAX's
own (2, 2) runs sit 2.0e-7 from its one-device run), so each bound
keeps a ~10x margin.  (The seed's failing JAX test bounds FSDP against
DP at 2e-6 over every parameter; these bounds are stated for the port's
own reduction orders and checked against all three JAX runs.)

Per rank, every parameter and both AdamW moments hold 1/(dp tp) of the
whole tensor under fsdp, and 1/tp under megatron, for every leaf the
rule shards on both axes (on one axis: that axis's share).

Checkpoints do not depend on the layout: one written on 2 ranks under
fsdp restores into the plain single-device state, and one the plain
trainer wrote restores on 2 ranks; the resumed losses equal the
unbroken run's.
"""

import functools
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dist_helpers as H
from torch_image_helpers import few_torch_threads  # noqa: F401 (autouse)
from container_engine_accelerators_tpu.models import lm_train as jlt
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu_torch.models import lm_train as lt
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    TrainCheckpointer,
)
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
    to_flax_params,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)
from container_engine_accelerators_tpu_torch.parallel import mesh as pmesh

CFG = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=16, mlp_dim=32,
           num_kv_heads=2)
BATCH, SEQ, STEPS = 8, 16, 3
LOSS_RTOL = 2e-6
PARAM_ATOL = 3e-6
LAYOUTS = ("megatron", "fsdp")


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for i in range(STEPS):
        toks = rng.integers(0, CFG["vocab_size"], (BATCH, SEQ))
        labels = np.roll(toks, -1, axis=1)
        mask = np.ones((BATCH, SEQ), np.float32)
        mask[:, -1] = 0.0
        if i == STEPS - 1:
            # Data shard 0 (rows 0-3) keeps 4 positions a row, shard 1
            # all 15: per-rank means would weigh them alike.
            mask[:BATCH // 2, 4:] = 0.0
        out.append((toks.astype(np.int64), labels.astype(np.int64), mask))
    return out


def _jax_state():
    """A fresh JAX state from the seed (a step donates the one it takes)
    and its model."""
    model = jtr.transformer_lm(**CFG, dtype=jnp.float32, use_flash=False)
    state = jlt.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.asarray(_batches()[0][0], jnp.int32),
        tx=optax.adamw(3e-4, weight_decay=0.1))
    return model, state


@functools.lru_cache(maxsize=None)
def _jax_runs():
    """JAX, f32: the init params (numpy), for each run — one device,
    (2, 2) megatron, (2, 2) fsdp — its losses and final params, and from
    the one-device run's weights before the last step, each data shard's
    (masked loss sum, mask count) on the last batch."""
    batches = _batches()
    model, state = _jax_state()
    init = jax.tree_util.tree_map(np.asarray, state.params)
    runs, sums = {}, []
    for name, (shape, layout) in {
            "single": ((1, 1), "megatron"), "megatron": ((2, 2), "megatron"),
            "fsdp": ((2, 2), "fsdp")}.items():
        n = shape[0] * shape[1]
        mesh = create_mesh(data=shape[0], model=shape[1],
                           devices=jax.devices()[:n])
        step, placed = jlt.make_lm_train_step(mesh, _jax_state()[1],
                                              param_sharding=layout)
        losses = []
        for i, (toks, labels, mask) in enumerate(batches):
            if name == "single" and i == len(batches) - 1:
                for rows in (slice(0, BATCH // 2), slice(BATCH // 2, BATCH)):
                    num, den = jlt._loss(
                        model.apply, placed.params,
                        jnp.asarray(toks[rows], jnp.int32),
                        jnp.asarray(labels[rows], jnp.int32),
                        jnp.asarray(mask[rows]), jnp.arange(SEQ))
                    sums.append((float(num), float(den)))
            placed, m = step(placed, jnp.asarray(toks, jnp.int32),
                             jnp.asarray(labels, jnp.int32),
                             jnp.asarray(mask))
            losses.append(float(m["loss"]))
        runs[name] = (losses, jax.tree_util.tree_map(
            np.asarray, jax.device_get(placed.params)))
    return init, runs, sums


def _port_init():
    init, _, _ = _jax_runs()
    return {k: v.numpy() for k, v in from_flax_params(init).items()}


@pytest.fixture(scope="module")
def port_22(tmp_path_factory):
    """The port on a (2, 2) mesh of 4 gloo ranks, megatron then fsdp:
    each rank's results."""
    return H.spawn(H.lm_train, 4, tmp_path_factory.mktemp("lm22"), CFG,
                   _port_init(), _batches(), (2, 2), LAYOUTS)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("ref", ["single", "megatron", "fsdp"])
def test_losses_equal_jax(port_22, layout, ref):
    _, runs, _ = _jax_runs()
    want = runs[ref][0]
    for rank, res in enumerate(port_22):
        got = res[layout]["losses"]
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"rank {rank}")


def test_masked_batch_gives_the_global_loss_not_a_mean_of_means(port_22):
    """Batch 3: the data shards mask different counts.  From JAX's
    weights before that step, each shard's (masked sum, count): the
    global loss is their sums' ratio, the port's equals it, and the mean
    of the two shards' means lands far from both."""
    _, runs, sums = _jax_runs()
    counts = [c for _, c in sums]
    assert counts[0] != counts[1]
    global_loss = sum(n for n, _ in sums) / sum(counts)
    mean_of_means = sum(n / c for n, c in sums) / 2
    assert abs(global_loss - runs["single"][0][-1]) <= \
        LOSS_RTOL * global_loss
    assert abs(mean_of_means - global_loss) > 100 * LOSS_RTOL * global_loss
    for layout in LAYOUTS:
        got = port_22[0][layout]["losses"][-1]
        assert abs(got - global_loss) <= LOSS_RTOL * global_loss, layout


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("ref", ["single", "megatron", "fsdp"])
def test_params_after_three_steps_equal_jax(port_22, layout, ref):
    _, runs, _ = _jax_runs()
    want = runs[ref][1]
    got = to_flax_params({k: torch.from_numpy(v) for k, v in
                          port_22[0][layout]["params"].items()})
    worst = 0.0
    for path, w in jax.tree_util.tree_leaves_with_path(want):
        g = got
        for k in path:
            g = g[k.key]
        worst = max(worst, float(np.abs(g - w).max()))
    assert worst <= PARAM_ATOL, worst


def test_every_rank_holds_the_same_whole_params(port_22):
    for layout in LAYOUTS:
        for res in port_22[1:]:
            for k, v in res[layout]["params"].items():
                np.testing.assert_array_equal(
                    v, port_22[0][layout]["params"][k], err_msg=k)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_per_rank_param_and_adam_bytes_follow_the_rule(port_22, layout):
    model = TransformerLM(**CFG, device="meta")
    mods = dict(model.named_modules())
    both = 0
    for rank, res in enumerate(port_22):
        r = res[layout]
        for name, p in model.named_parameters():
            mod, _, leaf = name.rpartition(".")
            spec = pmesh.flax_spec(mods[mod], leaf, tuple(p.shape), 2, 2,
                                   layout == "fsdp")
            share = 2 ** sum(a is not None for a in spec)
            assert r["local"][name] * share == r["numel"][name], name
            assert r["adam_local"][name] == [r["local"][name]] * 2, name
            both += share == 4
    if layout == "fsdp":
        # Every weight matrix divides on both axes: 1/(dp tp) a rank.
        assert both >= 4 * 2 * 7, both
    else:
        assert both == 0


def test_hybrid_mesh_splits_the_batch_slice_major(port_22):
    """``create_hybrid_mesh(1, 2, num_slices=2)`` on 4 ranks: the dcn axis
    outermost, the batch split over dcn and data (ranks 0-1 hold rows
    0-3, ranks 2-3 rows 4-7), replicated over model."""
    for rank, res in enumerate(port_22):
        h = res["hybrid"]
        assert h["names"] == ("dcn", "data", "model")
        assert tuple(h["rows"]) == ((rank // 2) * 4, 4)
        assert h["placements"] == ["S(0)", "S(0)", "R"]


# ---- layout-free checkpoints ---------------------------------------------


def _plain_run(params, batches, directory=None, save_after=None):
    model = TransformerLM(**CFG, dtype=torch.float32, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    state = lt.create_lm_train_state(model)
    step, state = lt.make_lm_train_step(None, state)
    losses = []
    ck = TrainCheckpointer(directory) if directory else None
    todo = batches
    if ck is not None and save_after is None:
        state, _ = ck.restore_latest(state)
        todo = batches[state.step:]
    for toks, labels, mask in todo:
        state, m = step(state, torch.from_numpy(toks),
                        torch.from_numpy(labels), torch.from_numpy(mask))
        losses.append(float(m["loss"]))
        if save_after is not None and state.step == save_after:
            ck.save(state)
            break
    return losses


@pytest.fixture(scope="module")
def checkpoint_runs(tmp_path_factory):
    """The unbroken single-device losses; a single-device save at step 2
    restored and finished on 2 ranks; 2 ranks' fsdp save at step 2
    restored and finished on one device."""
    params, batches = _port_init(), _batches()
    tmp = tmp_path_factory.mktemp("ckpt")
    unbroken = _plain_run(params, batches)
    plain_first = _plain_run(params, batches, str(tmp / "plain"), 2)
    out = H.spawn(H.lm_checkpoints, 2, tmp / "ranks", CFG, params, batches,
                  2, str(tmp / "plain"), str(tmp / "fsdp"))
    assert out[0] == out[1]
    ranks_resumed, ranks_first = out[0]
    plain_resumed = _plain_run(params, batches, str(tmp / "fsdp"))
    return unbroken, plain_first + ranks_resumed, ranks_first + plain_resumed


def test_checkpoint_from_2_rank_fsdp_restores_on_one(checkpoint_runs):
    unbroken, _, from_ranks = checkpoint_runs
    np.testing.assert_allclose(from_ranks, unbroken, rtol=LOSS_RTOL)


def test_checkpoint_from_one_rank_restores_on_2(checkpoint_runs):
    unbroken, to_ranks, _ = checkpoint_runs
    np.testing.assert_allclose(to_ranks, unbroken, rtol=LOSS_RTOL)


# ---- the command-line trainers across ranks --------------------------------

LM_CLI = ["--device", "cpu", "--num-layers", "2", "--num-heads", "2",
          "--mlp-dim", "64", "--vocab-size", "97", "--seq-len", "32",
          "--train-batch-size", "4", "--train-steps", "3"]
RESNET_CLI = ["--device", "cpu", "--resnet-depth", "18", "--image-size",
              "32", "--num-classes", "10", "--train-batch-size", "4",
              "--train-steps", "2"]


def test_trainers_on_2_ranks_match_one_device(tmp_path):
    """``train_lm --model-par 2 --param-sharding fsdp`` and ``train_resnet``
    (data parallel) on 2 ranks: every rank logs the same global losses,
    and the LM's equal the single-device trainer's within 2e-2 relative
    (bf16 compute, sharded sums rounded at other places).  The image
    trainer's ranks each make their own rows (``default_rng(<data
    index>)``, as the JAX trainer's processes do), so its losses are
    only held equal across ranks and finite."""
    from container_engine_accelerators_tpu_torch.cmd import train_lm

    lm_flags = ["--model-par", "2", "--param-sharding", "fsdp",
                "--checkpoint-dir", str(tmp_path / "ckpt")]
    out = H.spawn(H.trainers, 2, tmp_path / "ranks", LM_CLI + lm_flags,
                  RESNET_CLI)
    assert out[0] == out[1]
    lm, resnet = out[0]
    np.testing.assert_allclose(lm, train_lm.main(LM_CLI), rtol=2e-2)
    assert len(resnet) == 2 and all(np.isfinite(resnet))
    assert TrainCheckpointer(str(tmp_path / "ckpt")).all_steps() == [3]
