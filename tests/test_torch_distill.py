"""The port's distillation corpus tool (container_engine_accelerators_tpu_
torch/cmd/make_distill_data.py) against the JAX package's
cmd/make_distill_data.py, mirroring its tests/test_distill.py.

A JAX target saved by the JAX ``TrainCheckpointer`` is converted into
the port's checkpoint
(``from_flax_params``); both tools then sample it at ``--temperature 0``
on the same seed.  In f32 (each tool's model factory patched to f32; the
tools have no dtype flag) the two corpora are byte-equal, shards and
index: the same prompts and the same greedy tokens.  In the bf16 default
the shard layout, the index and every row's prompt are equal (greedy
tokens may part at a bf16 near-tie).  Then the refusals, the sampling
loop's shard flushes, and — ``slow``, as the JAX test — the behavioural
claim: a draft distilled on the target's samples beats a random draft's
acceptance on the port's speculative decoder by more than 0.1, run from
the JAX test's own initial weights (``tests/torch_distill_inits.py``:
that margin holds for the JAX test's draws, not for most seeds).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from container_engine_accelerators_tpu.models import transformer as jtr
from container_engine_accelerators_tpu.models.checkpoint import (
    TrainCheckpointer as JaxCheckpointer,
)
from container_engine_accelerators_tpu.models.lm_train import (
    create_lm_train_state as jax_train_state,
)
from container_engine_accelerators_tpu_torch.cmd import (
    make_distill_data as mk,
    train_lm,
)
from container_engine_accelerators_tpu_torch.data import (
    TokenBatchLoader,
    TokenShardReader,
    write_token_shards,
)
from container_engine_accelerators_tpu_torch.models import transformer as ttr
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    TrainCheckpointer,
)
from container_engine_accelerators_tpu_torch.models.convert import (
    from_flax_params,
)
from container_engine_accelerators_tpu_torch.models.lm_train import (
    create_lm_train_state,
)
from container_engine_accelerators_tpu_torch.models.speculative import (
    generate_speculative,
)
from tests import torch_distill_inits

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(vocab_size=32, num_layers=2, num_heads=2, head_dim=8, mlp_dim=64)
TARGET = ["--num-layers", "2", "--num-heads", "2", "--head-dim", "8",
          "--mlp-dim", "64", "--vocab-size", "32"]
DRAFT = ["--num-layers", "1", "--num-heads", "2", "--head-dim", "8",
         "--mlp-dim", "32", "--vocab-size", "32"]
# 4 batches of 16 rows of 4 + 28 tokens: 2,048 tokens, one shard.
CORPUS = ["--tokens", "2000", "--batch", "16", "--prompt-len", "4",
          "--gen-len", "28", "--temperature", "0", "--seed", "5"]
PROMPT_LEN, ROW = 4, 32


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def targets(tmp_path_factory):
    """(JAX checkpoint dir, the port's checkpoint dir) of one JAX target:
    the JAX trainer's state (seed 7) saved by the JAX TrainCheckpointer at
    step 3, then restored, its params converted and saved by the port's
    at the same step."""
    root = tmp_path_factory.mktemp("distill_targets")
    jck, tck = str(root / "jax_ck"), str(root / "torch_ck")

    def jax_state(seed):
        return jax_train_state(
            jtr.transformer_lm(**CFG), jax.random.PRNGKey(seed),
            jnp.zeros((1, 8), jnp.int32),
            tx=optax.adamw(3e-4, weight_decay=0.1))

    ck = JaxCheckpointer(jck)
    ck.save(jax_state(7).replace(step=3), wait=True)
    state, step = ck.restore_latest(jax_state(0))
    ck.close()
    assert step == 3
    model = ttr.TransformerLM(**CFG, device="cpu")
    model.load_state_dict(from_flax_params(state.params))
    port_state = create_lm_train_state(model)
    port_state.step = step
    TrainCheckpointer(tck).save(port_state)
    return jck, tck


def _f32(monkeypatch):
    """Both tools' model factories at f32 compute."""

    class TorchF32(ttr.TransformerLM):
        def __init__(self, *a, **kw):
            super().__init__(*a, **dict(kw, dtype=torch.float32))

    monkeypatch.setattr(ttr, "TransformerLM", TorchF32)
    monkeypatch.setattr(jtr, "transformer_lm",
                        lambda **kw: jtr.TransformerLM(
                            **dict(kw, dtype=jnp.float32)))


def _corpora(targets, tmp_path):
    """Both tools on their checkpoint of the same target -> the two
    output dirs."""
    jck, tck = targets
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    jax_mk = _load("jax_make_distill_data", "cmd/make_distill_data.py")
    assert jax_mk.main(TARGET + CORPUS + ["--checkpoint-dir", jck,
                                          "--out", jout]) == 0
    assert mk.main(TARGET + CORPUS + ["--device", "cpu",
                                      "--checkpoint-dir", tck,
                                      "--out", tout]) == 0
    return jout, tout


def _files(directory):
    return {f: open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))}


def _rows(directory):
    return np.concatenate([
        np.fromfile(os.path.join(directory, f), "<u4")
        for f in sorted(os.listdir(directory)) if f.endswith(".tokens")
    ]).reshape(-1, ROW)


def _prompts(n_rows, seed=5, batch=16):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.integers(0, CFG["vocab_size"],
                                        (batch, PROMPT_LEN))
                           for _ in range(n_rows // batch)])


def test_f32_corpus_is_byte_equal_to_the_jax_tools(targets, tmp_path,
                                                   monkeypatch):
    """Tolerance: none — every byte of every shard and of index.json."""
    _f32(monkeypatch)
    jout, tout = _corpora(targets, tmp_path)
    jax_files, port_files = _files(jout), _files(tout)
    assert list(port_files) == ["00000.tokens", "index.json"]
    assert port_files == jax_files
    rows = _rows(tout)
    assert rows.shape == (64, ROW)
    np.testing.assert_array_equal(rows[:, :PROMPT_LEN], _prompts(64))
    # The greedy continuations are real samples, not the prompt echoed.
    assert len(np.unique(rows[:, PROMPT_LEN:])) > 1


def test_bf16_corpus_has_the_jax_tools_layout_index_and_prompts(
        targets, tmp_path):
    """Tolerance: the layout, the index and the prompts exactly; the
    greedy tokens only within the vocab (bf16 near-ties may part)."""
    jout, tout = _corpora(targets, tmp_path)
    jax_files, port_files = _files(jout), _files(tout)
    assert list(port_files) == list(jax_files)
    assert port_files["index.json"] == jax_files["index.json"]
    assert {f: len(b) for f, b in port_files.items()} == \
        {f: len(b) for f, b in jax_files.items()}
    rows, jax_rows = _rows(tout), _rows(jout)
    np.testing.assert_array_equal(rows[:, :PROMPT_LEN],
                                  jax_rows[:, :PROMPT_LEN])
    np.testing.assert_array_equal(rows[:, :PROMPT_LEN], _prompts(64))
    assert rows.max() < CFG["vocab_size"]


def test_sample_corpus_flushes_shards_in_order(tmp_path):
    """The loop's buffer: a shard once ``shard_tokens`` are buffered, the
    rest at the end; rows in batch order, prompts from the seed, and the
    trainer's loader reads the corpus at its vocab."""
    model = ttr.TransformerLM(**CFG, decode=True, device="cpu")
    model.load_state_dict(ttr.init_params(model,
                                          torch.Generator().manual_seed(3)))
    out = str(tmp_path / "c")
    written, shards = mk.sample_corpus(model, out, 5 * 4 * ROW, 4,
                                       PROMPT_LEN, ROW - PROMPT_LEN, 1.0, 7,
                                       shard_tokens=2 * 4 * ROW)
    assert (written, shards) == (5 * 4 * ROW, 3)
    index = json.load(open(os.path.join(out, "index.json")))
    assert index["shards"] == [
        {"name": f"{i:05d}.tokens", "tokens": n}
        for i, n in enumerate([256, 256, 128])]
    rows = _rows(out)
    np.testing.assert_array_equal(rows[:, :PROMPT_LEN],
                                  _prompts(20, seed=7, batch=4))
    # Sampling draws from seed + i: the same call gives the same corpus.
    again = str(tmp_path / "again")
    mk.sample_corpus(model, again, 5 * 4 * ROW, 4, PROMPT_LEN,
                     ROW - PROMPT_LEN, 1.0, 7, shard_tokens=2 * 4 * ROW)
    assert _files(again) == _files(out)
    loader = TokenBatchLoader(TokenShardReader(out), 4, 32,
                              vocab_size=CFG["vocab_size"])
    tokens, labels, _ = loader.batch_at(0)
    assert tokens.shape == (4, 32) and labels.shape == (4, 32)


def test_make_distill_data_refuses_missing_checkpoint(tmp_path):
    os.makedirs(tmp_path / "empty_ck", exist_ok=True)
    with pytest.raises(SystemExit, match="no checkpoint"):
        mk.main(TARGET + ["--device", "cpu",
                          "--checkpoint-dir", str(tmp_path / "empty_ck"),
                          "--out", str(tmp_path / "c"), "--tokens", "100"])
    assert not os.path.exists(tmp_path / "c")


def test_make_distill_data_refuses_populated_out(tmp_path):
    """Before any restore: the checkpoint directory is never read."""
    write_token_shards(str(tmp_path / "c"), [np.asarray([1, 2], np.uint32)])
    with pytest.raises(SystemExit, match="refusing to mix"):
        mk.main(TARGET + ["--device", "cpu",
                          "--checkpoint-dir", str(tmp_path / "whatever"),
                          "--out", str(tmp_path / "c"), "--tokens", "100"])
    assert not os.path.exists(tmp_path / "whatever")


def test_defaults_match_the_jax_tool():
    jax_mk = _load("jax_make_distill_data_defaults",
                   "cmd/make_distill_data.py")
    req = ["--checkpoint-dir", "ck", "--out", "o"]
    ours = vars(mk.parse_args(req))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jax_mk.parse_args(req))


def test_jax_inits_fixture_is_the_jax_tests_draws():
    """The committed initial weights are JAX's PRNGKey draws, bit for
    bit (tolerance: none)."""
    want = torch_distill_inits.jax_inits()
    with np.load(torch_distill_inits.PATH) as f:
        assert sorted(f.files) == sorted(want)
        for key, value in want.items():
            np.testing.assert_array_equal(f[key], value, err_msg=key)
    for name, (cfg, _) in torch_distill_inits.DRAWS.items():
        model = ttr.TransformerLM(**cfg, device="cpu")
        model.load_state_dict(torch_distill_inits.load(name))


def _seed_checkpoint(directory, cfg, name):
    """A step-0 checkpoint of the JAX test's draw ``name``: the trainer
    resumes from it, so it trains from JAX's initial weights."""
    model = ttr.TransformerLM(**cfg, device="cpu")
    model.load_state_dict(torch_distill_inits.load(name))
    TrainCheckpointer(directory).save(create_lm_train_state(model))


def _accept_rate(target_ck, draft):
    """Acceptance of the port's greedy speculative decoder (k 4, 32 new
    tokens, seed-9 prompts, as the JAX test) with ``draft``'s weights."""
    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    def decode(cfg, sd):
        m = ttr.TransformerLM(**cfg, decode=True, device="cpu")
        m.load_state_dict(sd)
        return m.eval()

    d_cfg = torch_distill_inits.DRAFT_CFG
    target, step = serve_lm._restore(target_ck, CFG)
    assert step is not None
    model, draft = decode(CFG, target), decode(d_cfg, draft)
    prompts = torch.from_numpy(np.random.default_rng(9).integers(0, 32,
                                                                 (4, 4)))
    with torch.inference_mode():
        _, stats = generate_speculative(model, draft, prompts, 32, k=4)
    return float(stats["accepted"].sum()) / max(
        float(stats["drafted"].sum()), 1.0)


@pytest.mark.slow
def test_distilled_draft_beats_random_acceptance(tmp_path):
    """The JAX test's recipe through the port's CLIs on the CPU, from its
    initial weights: train the target, sample a corpus, train the draft
    on it, speculate."""
    from container_engine_accelerators_tpu_torch.cmd import serve_lm

    target_ck, draft_ck = str(tmp_path / "target_ck"), str(tmp_path / "d_ck")
    _seed_checkpoint(target_ck, CFG, "target")
    _seed_checkpoint(draft_ck, torch_distill_inits.DRAFT_CFG, "draft")
    train_lm.main(TARGET + [
        "--device", "cpu", "--seq-len", "32", "--train-batch-size", "16",
        "--train-steps", "30", "--steps-per-eval", "10",
        "--checkpoint-dir", target_ck, "--checkpoint-interval", "30"])
    assert mk.main(TARGET + [
        "--device", "cpu", "--checkpoint-dir", target_ck,
        "--out", str(tmp_path / "corpus"), "--tokens", "40000",
        "--batch", "16", "--prompt-len", "4", "--gen-len", "28"]) == 0
    train_lm.main(DRAFT + [
        "--device", "cpu", "--seq-len", "32", "--train-batch-size", "16",
        "--train-steps", "60", "--steps-per-eval", "20",
        "--data-dir", str(tmp_path / "corpus"),
        "--checkpoint-dir", draft_ck, "--checkpoint-interval", "60"])
    distilled = _accept_rate(target_ck, serve_lm._restore(
        draft_ck, torch_distill_inits.DRAFT_CFG)[0])
    random_init = _accept_rate(target_ck, torch_distill_inits.load("random"))
    assert distilled > random_init + 0.1, (distilled, random_init)
