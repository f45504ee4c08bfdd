"""The PyTorch port's sequence-parallel LM step and trainer against the
JAX package's, on 2 and 4 gloo ranks on the CPU
(``tests/torch_dist_helpers.py``).

The configuration of ``tests/test_transformer_lm.py:63-97`` (vocab 97, 2
layers, 4 heads of 8, mlp 64, f32, batch 4 x 32 tokens), MHA and GQA (2
KV heads), from the same converted weights and the same three numpy
batches: JAX's ``make_lm_train_step(mesh, state, kind)`` on a (n, 1)
mesh of the host devices, and the port's on n ranks, each rank feeding
its columns, for ring, ring-zigzag and Ulysses, three AdamW steps.  The
third batch masks most of rank 0's columns, so a mean of per-rank means
would miss JAX's global loss (its masked sum over its global count).

Tolerances are those of the sharded steps (``test_torch_dist_lm.py``),
f32: losses within 2e-6 relative and parameters within 3e-6 absolute
after three steps — the same arithmetic summed in other orders (ring
blocks merged by logsumexp against JAX's chunked online softmax, the
loss and gradients as per-rank partial sums), which AdamW turns into
steps that differ by at most ~lr times the gradients' relative
difference.  That reasoning fails where a first-step gradient g sits
near AdamW's eps: the first step is lr g / (|g| + eps), whose slope
lr eps / (|g| + eps)^2 turns f32 rounding of g into a visible move.  So
each entry's bound adds that slope times delta = 1e-6 of its leaf's
largest |g| (rounding of sums of such terms).  It adds nothing where
|g| >> eps and over 3e-6 at one entry of each model on this data: a
``blocks.1.gate`` entry of the MHA model (bound 8.3e-6; the port within
5.4e-7 of JAX there) and an embedding entry of the GQA model whose g is
-1.4e-7 against a median |g| of 9.4e-3 (bound 2.6e-5; the port 4.8e-6
from JAX at n = 4 under ring and Ulysses, where JAX's own one-device and
ring runs sit 1.1e-6 apart).  Measured on the CPU otherwise: losses
within 1.9e-7 relative, every other parameter within 2.8e-7.

The trainer's ``main`` with ``--seq-parallel ring`` on 2 ranks resumes
from its checkpoint to the unbroken run's losses exactly, as the JAX
trainer resumes (``tests/test_transformer_lm.py:219``); each scheme's
losses (bf16 compute) stay within 2e-2 relative of the plain trainer's,
the bound ``chip_smoke.py`` holds the card to.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import torch_dist_helpers as H
from torch_image_helpers import few_torch_threads  # noqa: F401 (autouse)
from container_engine_accelerators_tpu.models import lm_train as jlt
from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.parallel import create_mesh
from container_engine_accelerators_tpu_torch.cmd import train_lm
from container_engine_accelerators_tpu_torch.models import lm_train as lt
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
)

CFG = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8, mlp_dim=64)
BATCH, SEQ, STEPS = 4, 32, 3
LOSS_RTOL = 2e-6
PARAM_ATOL = 3e-6
KINDS = ("ring", "ring-zigzag", "ulysses")
HEADS = {"mha": None, "gqa": 2}
WORLDS = (2, 4)
CLI = ["--device", "cpu", "--num-layers", "2", "--num-heads", "2",
       "--mlp-dim", "64", "--vocab-size", "97", "--seq-len", "64",
       "--train-batch-size", "2", "--steps-per-eval", "1"]
CLI_STEPS, CLI_STOP = 4, 2


def _tokens():
    rng = np.random.default_rng(0)
    return [rng.integers(0, CFG["vocab_size"], (BATCH, SEQ)).astype(np.int32)
            for _ in range(STEPS)]


def _batches(kind, n):
    """JAX's prepared batches (storage order) as numpy, the last one with
    rank 0's columns masked after their first two positions."""
    out = []
    for i, toks in enumerate(_tokens()):
        toks, labels, mask = (np.asarray(x) for x in
                              jlt.prepare_seq_parallel_batch(
                                  jnp.asarray(toks), kind, n_shards=n))
        if i == STEPS - 1:
            mask = mask.copy()
            mask[:, 2:SEQ // n] = 0.0
        out.append((toks.astype(np.int64), labels.astype(np.int64), mask))
    return out


@functools.lru_cache(maxsize=None)
def _jax_run(heads, kind, n):
    """JAX, f32: the init params (port names, numpy) and, from them, the
    sequence-parallel step's losses and final params (port names)."""
    cfg = dict(CFG, num_kv_heads=HEADS[heads], dtype=jnp.float32)
    model = jtr.transformer_lm(**cfg, seq_parallel=kind)
    state = jlt.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.asarray(_tokens()[0]),
        tx=optax.adamw(3e-4, weight_decay=0.1))
    init = {k: v.numpy() for k, v in from_flax_params(
        jax.tree_util.tree_map(np.asarray, state.params)).items()}
    mesh = create_mesh(data=n, model=1, devices=jax.devices()[:n])
    step, placed = jlt.make_lm_train_step(mesh, state, seq_parallel=kind)
    losses = []
    for toks, labels, mask in _batches(kind, n):
        placed, m = step(placed, jnp.asarray(toks, jnp.int32),
                         jnp.asarray(labels, jnp.int32), jnp.asarray(mask))
        losses.append(float(m["loss"]))
    final = {k: v.numpy() for k, v in from_flax_params(
        jax.tree_util.tree_map(np.asarray, placed.params)).items()}
    return init, losses, final


@functools.lru_cache(maxsize=None)
def _first_grads(heads):
    """JAX's one-device gradient of the first batch's loss at the init
    weights, port names, numpy."""
    cfg = dict(CFG, num_kv_heads=HEADS[heads], dtype=jnp.float32)
    model = jtr.transformer_lm(**cfg)
    params = jlt.create_lm_train_state(
        model, jax.random.PRNGKey(0), jnp.asarray(_tokens()[0])).params
    toks, labels, mask = (jnp.asarray(x) for x in _batches("ring", 1)[0])

    def loss(p):
        num, den = jlt._loss(model.apply, p, toks.astype(jnp.int32),
                             labels.astype(jnp.int32), mask,
                             jnp.arange(SEQ))
        return num / den

    return {k: v.numpy() for k, v in from_flax_params(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params))).items()}


def _param_bound(g, lr=3e-4, eps=1e-8):
    """PARAM_ATOL plus the first AdamW step's slope at each entry's
    first gradient ``g`` times 1e-6 of the leaf's largest |g|."""
    delta = 1e-6 * np.abs(g).max()
    return PARAM_ATOL + lr * eps * delta / (np.abs(g) + eps) ** 2


@pytest.fixture(scope="module")
def port_steps(tmp_path_factory):
    """The port's step on each world, every (heads, kind): each rank's
    results.  One spawn a world, every configuration in it."""
    return {n: H.spawn(H.lm_seq_step, n, tmp_path_factory.mktemp(f"lm{n}"),
                       [(f"{heads}-{kind}", dict(CFG, num_kv_heads=kv),
                         kind, _jax_run(heads, kind, n)[0],
                         _batches(kind, n))
                        for heads, kv in HEADS.items() for kind in KINDS])
            for n in WORLDS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("n", WORLDS)
def test_losses_equal_jax(port_steps, n, heads, kind):
    _, want, _ = _jax_run(heads, kind, n)
    for rank, res in enumerate(port_steps[n]):
        np.testing.assert_allclose(res[f"{heads}-{kind}"]["losses"], want,
                                   rtol=LOSS_RTOL, atol=0,
                                   err_msg=f"rank {rank}")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("n", WORLDS)
def test_params_after_three_steps_equal_jax(port_steps, n, heads, kind):
    _, _, want = _jax_run(heads, kind, n)
    name = f"{heads}-{kind}"
    got = port_steps[n][0][name]["params"]
    assert got.keys() == want.keys()
    grads = _first_grads(heads)
    for k in want:
        err = np.abs(got[k] - want[k])
        bound = _param_bound(grads[k])
        assert (err <= bound).all(), (k, float(err.max()),
                                      float(bound.flat[err.argmax()]))
    for res in port_steps[n][1:]:  # replicated: every rank the same
        for k, v in res[name]["params"].items():
            np.testing.assert_array_equal(v, got[k], err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_step_refusals_that_need_a_mesh(port_steps, n):
    model_axis, other = port_steps[n][0]["refused"]
    assert "mesh with model=1" in model_axis
    assert other == ("the model was built with seq_parallel='ulysses', the "
                     "step asks for 'ring'")


def test_step_refusals():
    model = TransformerLM(**CFG, seq_parallel="ring", device="cpu")
    state = lt.create_lm_train_state(model)
    with pytest.raises(ValueError, match="applies to dense mode only"):
        lt.make_lm_train_step(None, state, "ring", "fsdp")
    with pytest.raises(ValueError, match="pass one"):
        lt.make_lm_train_step(None, state, "ring")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", WORLDS)
def test_prepared_batch_equals_jax(kind, n):
    import torch

    toks = _tokens()[0]
    got = lt.prepare_seq_parallel_batch(torch.from_numpy(toks).long(), kind,
                                        n_shards=n)
    want = jlt.prepare_seq_parallel_batch(jnp.asarray(toks), kind,
                                          n_shards=n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- the trainer ------------------------------------------------------------


@pytest.mark.parametrize("flags,message", [
    (["--param-sharding", "fsdp"],
     "--param-sharding fsdp applies to dense mode only"),
    (["--model-par", "2"],
     "--model-par does not compose with --seq-parallel yet"),
    (["--num-experts", "4"],
     "--num-experts with --seq-parallel is not validated"),
])
def test_trainer_refusals(flags, message):
    with pytest.raises(SystemExit, match=message):
        train_lm.validate_args(train_lm.parse_args(
            CLI + ["--seq-parallel", "ring"] + flags))


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The trainer on 2 ranks, in one spawn: each scheme unbroken, then
    ring stopped with a checkpoint and resumed; the plain trainer in this
    process -> ({kind: each rank's losses}, (first, resumed) of each rank,
    plain losses)."""
    tmp = tmp_path_factory.mktemp("seq_cli")
    steps = ["--train-steps", str(CLI_STEPS)]
    ckpt = ["--seq-parallel", "ring", "--checkpoint-dir", str(tmp / "ckpt"),
            "--checkpoint-interval", "1"]
    argvs = ([CLI + ["--seq-parallel", kind] + steps for kind in KINDS]
             + [CLI + ckpt + ["--train-steps", str(CLI_STOP)],
                CLI + ckpt + steps])
    ranks = H.spawn(H.lm_trainer_runs, 2, tmp, argvs)
    unbroken = {kind: [r[i] for r in ranks] for i, kind in enumerate(KINDS)}
    resumes = [(r[-2], r[-1]) for r in ranks]
    return unbroken, resumes, train_lm.main(CLI + steps)


def test_trainer_ring_resume_equals_the_unbroken_run(trainer_runs):
    unbroken, resumes, _ = trainer_runs
    for want, (first, resumed) in zip(unbroken["ring"], resumes):
        assert len(want) == CLI_STEPS
        assert first == want[:CLI_STOP]
        assert resumed == want[CLI_STOP:]


@pytest.mark.parametrize("kind", KINDS)
def test_trainer_losses_stay_near_the_plain_trainers(trainer_runs, kind):
    unbroken, _, plain = trainer_runs
    assert unbroken[kind][0] == unbroken[kind][1]  # one loss, every rank
    np.testing.assert_allclose(unbroken[kind][0], plain, rtol=2e-2, atol=0)
