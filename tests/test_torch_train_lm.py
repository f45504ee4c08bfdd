"""The PyTorch port's trainer entry point (``cmd/train_lm.py``) on the
CPU at a tiny width: it trains and returns finite losses, takes the JAX
trainer's flags and defaults, rejects the flags of later slices, reads a
token-shard dataset through the port's loader (which gives the JAX
loader's batches), and exits 80 on SIGTERM."""

import importlib.util
import math
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

from container_engine_accelerators_tpu.data import loader as jloader
from container_engine_accelerators_tpu.data import tokens as jtokens
from container_engine_accelerators_tpu_torch.cmd import train_lm
from container_engine_accelerators_tpu_torch.data import (
    TokenBatchLoader,
    TokenShardReader,
    write_token_shards,
)
from container_engine_accelerators_tpu_torch.utils import preempt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--vocab-size", "61", "--num-layers", "2",
        "--num-heads", "2", "--head-dim", "64", "--mlp-dim", "32",
        "--seq-len", "128", "--train-batch-size", "2"]


def test_main_trains_on_the_cpu():
    losses = train_lm.main(TINY + ["--train-steps", "5",
                                   "--steps-per-eval", "2"])
    assert len(losses) == 5
    assert all(math.isfinite(x) for x in losses)
    # Steps 0 and 4 see the same batch (four rotate): four AdamW steps
    # later its loss is lower.
    assert losses[4] < losses[0]


def test_main_is_deterministic():
    argv = TINY + ["--train-steps", "2", "--kv-heads", "1"]
    assert train_lm.main(argv) == train_lm.main(argv)


def test_defaults_match_the_jax_trainer():
    spec = importlib.util.spec_from_file_location(
        "jax_train_lm_defaults", os.path.join(REPO, "cmd", "train_lm.py"))
    jax_train = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_train)
    want = vars(jax_train.parse_args([]))
    got = vars(train_lm.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


@pytest.mark.parametrize("flags,slice_", [
    (["--seq-parallel", "ring"], "multi-GPU slice"),
    (["--seq-parallel", "ulysses"], "multi-GPU slice"),
    (["--model-par", "2"], "multi-GPU slice"),
    (["--param-sharding", "fsdp"], "multi-GPU slice"),
    (["--num-experts", "4"], "later training slice"),
    (["--checkpoint-dir", "/nonexistent"], "later training slice"),
    (["--profile-dir", "/nonexistent"], "later training slice"),
])
def test_later_slice_flags_exit(flags, slice_):
    with pytest.raises(SystemExit, match=slice_):
        train_lm.main(TINY + flags)


def test_bad_checkpoint_interval_exits():
    with pytest.raises(SystemExit, match="checkpoint-interval"):
        train_lm.main(TINY + ["--checkpoint-interval", "0"])


def test_synthetic_batches_rotate_four_seeded_batches():
    args = train_lm.parse_args(TINY)
    batches = train_lm.synthetic_batches(args)
    assert len(batches) == 4
    first = np.random.default_rng(0).integers(0, 61, (2, 128))
    toks, labels, mask = batches[0]
    assert np.array_equal(toks, first)
    assert np.array_equal(labels, np.roll(first, -1, axis=1))
    assert mask[:, :-1].all() and not mask[:, -1].any()
    assert not np.array_equal(batches[1][0], toks)


def test_data_dir_trains(tmp_path):
    rng = np.random.default_rng(1)
    write_token_shards(str(tmp_path), [rng.integers(0, 61, n)
                                       for n in (700, 300)])
    losses = train_lm.main(TINY + ["--data-dir", str(tmp_path),
                                   "--train-steps", "3"])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)


@pytest.mark.parametrize("start,steps", [(0, 3), (5, 4)])
def test_loader_batches_match_the_jax_loader(tmp_path, start, steps):
    """The port's copy of the token pipeline reads the JAX package's
    format and gives the same (tokens, labels, mask) for the same steps,
    through the prefetch thread too."""
    rng = np.random.default_rng(2)
    jtokens.write_token_shards(str(tmp_path), [rng.integers(0, 97, n)
                                               for n in (500, 64, 333)])
    port = TokenBatchLoader(TokenShardReader(str(tmp_path)), 3, 40,
                            vocab_size=97)
    ref = jloader.TokenBatchLoader(jtokens.TokenShardReader(str(tmp_path)),
                                   3, 40, vocab_size=97)
    assert port.steps_per_epoch() == ref.steps_per_epoch()
    it = port.iter_batches(start, steps)
    try:
        for s, got in zip(range(start, start + steps), it):
            for a, b, c in zip(got, port.batch_at(s), ref.batch_at(s)):
                assert a.dtype == c.dtype
                assert np.array_equal(a, c) and np.array_equal(b, c)
    finally:
        it.close()


def test_sigterm_exits_80():
    """SIGTERM during a step: the step finishes, then the trainer exits
    80 (no --checkpoint-dir in this slice: progress is lost) and the
    previous SIGTERM handler is back."""
    before = signal.getsignal(signal.SIGTERM)
    steps = []

    def on_step(step, loss):
        steps.append(step)
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as exc:
        train_lm.main(TINY + ["--train-steps", "5"], on_step=on_step)
    assert exc.value.code == preempt.PREEMPTED_EXIT_CODE == 80
    assert steps == [0, 1]
    assert signal.getsignal(signal.SIGTERM) is before


def test_checkpoint_and_exit_saves_off_interval():
    class Saver:
        def __init__(self):
            self.calls = []

        def save(self, state, wait):
            self.calls.append(("save", state, wait))

        def close(self):
            self.calls.append(("close",))

    for step, want in ((4, [("save", "s", True), ("close",)]),
                       (9, [("close",)])):  # step 10 is on the interval
        saver = Saver()
        with pytest.raises(SystemExit) as exc:
            preempt.checkpoint_and_exit(saver, "s", step, 10)
        assert exc.value.code == 80 and saver.calls == want


def test_module_entry_point_trains():
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.train_lm"] + TINY
        + ["--train-steps", "2", "--steps-per-eval", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "step 2 loss=" in proc.stderr and "done: 2 steps" in proc.stderr
