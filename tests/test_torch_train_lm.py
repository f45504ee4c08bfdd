"""The PyTorch port's trainer entry point (``cmd/train_lm.py``) on the
CPU at a tiny width: it trains and returns finite losses, takes the JAX
trainer's flags and defaults, rejects the flags of later slices, reads a
token-shard dataset through the port's loader (which gives the JAX
loader's batches), checkpoints and resumes bitwise, exits 80 on SIGTERM
with a checkpoint, and profiles a window of steps into a trace that
``cmd/trace_summary.py`` reads.  Checkpoints and traces go under pytest's
``tmp_path``."""

import importlib.util
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from container_engine_accelerators_tpu.data import loader as jloader
from container_engine_accelerators_tpu.data import tokens as jtokens
from container_engine_accelerators_tpu_torch.cmd import trace_summary, train_lm
from container_engine_accelerators_tpu_torch.data import (
    TokenBatchLoader,
    TokenShardReader,
    write_token_shards,
)
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    STATE_FILE,
    TrainCheckpointer,
)
from container_engine_accelerators_tpu_torch.utils import faults, preempt

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
    # --seq-parallel trains since the sequence-parallel slice; what of it
    # still exits is its combination with the weight layouts, with the
    # JAX trainer's messages (ids kept from when the flag itself exited).
    pytest.param(["--seq-parallel", "ring", "--model-par", "2"],
                 "--model-par does not compose with --seq-parallel",
                 id="flags0-multi-GPU slice"),
    pytest.param(["--seq-parallel", "ulysses", "--param-sharding", "fsdp"],
                 "--param-sharding fsdp applies to dense mode only",
                 id="flags1-multi-GPU slice"),
    # --num-experts on a mesh trains since the pipeline / expert slice:
    # at one rank --model-par 2 exits for want of ranks, and fsdp trains
    # on the (1, 1) mesh (None).  Ids kept from when both exited.
    pytest.param(["--num-experts", "2", "--model-par", "2"],
                 "--model-par 2 needs a multiple of 2 ranks",
                 id="flags2-next multi-GPU slice"),
    pytest.param(["--num-experts", "2", "--param-sharding", "fsdp"], None,
                 id="flags3-next multi-GPU slice"),
])
def test_later_slice_flags_exit(flags, slice_):
    if slice_ is None:
        losses = train_lm.main(TINY + flags + ["--train-steps", "2"])
        assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
        return
    with pytest.raises(SystemExit, match=slice_):
        train_lm.main(TINY + flags)


@pytest.mark.parametrize("flag", ["--checkpoint-dir", "--profile-dir"])
def test_checkpoint_and_profile_flags_are_ported(tmp_path, flag):
    """Once rejected as a later slice's, now taken: the run trains and
    writes into the directory."""
    out = tmp_path / "out"
    losses = train_lm.main(TINY + ["--train-steps", "2", flag, str(out)])
    assert len(losses) == 2
    assert os.listdir(out)


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
    80 (without --checkpoint-dir progress is lost) and the previous
    SIGTERM handler is back."""
    before = signal.getsignal(signal.SIGTERM)
    steps = []

    def on_step(step, loss, metrics):
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


@pytest.mark.parametrize("source", ["synthetic", "data_dir"])
def test_resumed_run_equals_the_unbroken_run(tmp_path, source):
    """6 steps, or 3 steps, a restart, and 3 more from the checkpoint:
    the same losses, bit for bit (the resumed run indexes the synthetic
    batches, or reads the dataset, from the restored step)."""
    argv = TINY[:]
    if source == "data_dir":
        rng = np.random.default_rng(4)
        write_token_shards(str(tmp_path / "data"),
                           [rng.integers(0, 61, n) for n in (900, 500)])
        argv += ["--data-dir", str(tmp_path / "data")]
    ckpt = ["--checkpoint-dir", str(tmp_path / "ckpt")]
    unbroken = train_lm.main(argv + ["--train-steps", "6"])
    first = train_lm.main(argv + ckpt + ["--train-steps", "3"])
    resumed = train_lm.main(argv + ckpt + ["--train-steps", "6"])
    assert len(first) == len(resumed) == 3
    assert first + resumed == unbroken
    assert TrainCheckpointer(str(tmp_path / "ckpt")).all_steps() == [3, 6]
    # A finished run restarted trains no step and saves nothing new.
    assert train_lm.main(argv + ckpt + ["--train-steps", "6"]) == []


def test_checkpoints_at_the_interval_and_at_the_end(tmp_path, caplog):
    ckpt = tmp_path / "ckpt"
    train_lm.main(TINY + ["--train-steps", "5", "--checkpoint-interval", "2",
                          "--checkpoint-dir", str(ckpt)])
    ck = TrainCheckpointer(str(ckpt))
    assert ck.all_steps() == [2, 4, 5]  # the newest 3
    saved = torch.load(ckpt / "5" / STATE_FILE, weights_only=True)
    assert saved["step"] == 5 and set(saved) == {"step", "model",
                                                 "optimizer"}
    with caplog.at_level("INFO"):
        losses = train_lm.main(TINY + ["--train-steps", "7",
                                       "--checkpoint-dir", str(ckpt)])
    assert len(losses) == 2
    assert "resuming from checkpoint at step 5" in caplog.text
    assert ck.all_steps() == [4, 5, 7]


def test_an_armed_save_fault_is_retried(tmp_path):
    with faults.armed("checkpoint.save:fail@1") as inj:
        losses = train_lm.main(TINY + ["--train-steps", "2",
                                       "--checkpoint-dir", str(tmp_path)])
        assert inj.fired("checkpoint.save") == 1
    assert len(losses) == 2
    assert TrainCheckpointer(str(tmp_path)).all_steps() == [2]


def test_sigterm_in_process_saves_off_interval(tmp_path):
    def on_step(step, loss, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as exc:
        train_lm.main(TINY + ["--train-steps", "9", "--checkpoint-dir",
                              str(tmp_path), "--checkpoint-interval", "2"],
                      on_step=on_step)
    assert exc.value.code == 80
    assert TrainCheckpointer(str(tmp_path)).all_steps() == [2, 3]


def test_sigterm_checkpoints_exits_80_and_resumes(tmp_path):
    """The module run as a Job runs it, a real SIGTERM after observed
    progress: exit 80 with a checkpoint; a second run resumes from it
    and finishes."""
    base = [sys.executable, "-m",
            "container_engine_accelerators_tpu_torch.cmd.train_lm"] + TINY + [
        "--checkpoint-dir", str(tmp_path / "ckpt"),
        "--checkpoint-interval", "10000", "--steps-per-eval", "1"]
    proc = subprocess.Popen(base + ["--train-steps", "100000"], cwd=REPO,
                            stderr=subprocess.PIPE, text=True)
    seen_step, rest = None, ""
    try:
        deadline = time.monotonic() + 120
        for line in proc.stderr:
            m = re.search(r"step (\d+) loss", line)
            if m:
                seen_step = int(m.group(1))
                break
            assert time.monotonic() < deadline, "no training progress"
        assert seen_step is not None, "the trainer never logged a step"
        proc.send_signal(signal.SIGTERM)
        rest = proc.stderr.read()
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stderr.close()
    assert rc == preempt.PREEMPTED_EXIT_CODE, rest[-2000:]
    assert "preempted at step" in rest and "checkpoint saved" in rest
    saved = TrainCheckpointer(str(tmp_path / "ckpt")).latest_step()
    assert saved >= seen_step

    done = subprocess.run(base + ["--train-steps", str(saved + 2)], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr[-2000:]
    m = re.search(r"resuming from checkpoint at step (\d+)", done.stderr)
    assert m and int(m.group(1)) == saved, done.stderr[-2000:]
    assert "done: 2 steps" in done.stderr


def test_profile_dir_writes_a_trace_that_trace_summary_reads(tmp_path,
                                                              capsys):
    """Steps 10-20 are traced (here, of 12: steps 10 and 11).  On the CPU
    the trace has no device events: device time 0, busy share null."""
    prof = tmp_path / "prof"
    train_lm.main(TINY + ["--train-steps", "12", "--profile-dir", str(prof)])
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
    capsys.readouterr()
    trace_summary.main([str(prof)])
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary["trace"] == str(prof / traces[0])
    assert summary["steps"] == 2
    assert summary["device_ms"] == 0 and summary["launches"] == 0
    assert summary["busy_share"] is None
    assert summary["window_ms"] > 0


def test_checkpoint_and_exit_stops_the_profile_first(tmp_path):
    calls = []

    class Profile:
        def stop(self):
            calls.append("stop")

    class Saver:
        def save(self, state, wait):
            calls.append("save")

        def close(self):
            calls.append("close")

    with pytest.raises(SystemExit) as exc:
        preempt.checkpoint_and_exit(Saver(), "s", 4, 10, Profile())
    assert exc.value.code == 80 and calls == ["stop", "save", "close"]
