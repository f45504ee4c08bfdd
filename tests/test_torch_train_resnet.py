"""The PyTorch port's image trainer (``cmd/train_resnet.py``) on the CPU
at a small size (ResNet-18 at 32x32, batch 4, 10 classes): it trains and
returns finite losses, takes the JAX trainer's flags and defaults and its
synthetic arrays, reads shards the JAX package wrote, refuses a shape
mismatch and the multi-GPU flag, resumes bitwise from a checkpoint,
exits 80 on SIGTERM and then resumes, profiles a window of steps for
``cmd/trace_summary.py`` and writes the final params.  Checkpoints,
traces and datasets go under pytest's ``tmp_path``."""

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

from container_engine_accelerators_tpu.data import arrays as jarrays
from container_engine_accelerators_tpu_torch.cmd import (
    trace_summary,
    train_resnet,
)
from container_engine_accelerators_tpu_torch.models.checkpoint import (
    STATE_FILE,
    TrainCheckpointer,
)
from container_engine_accelerators_tpu_torch.utils import preempt
from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    FEW_THREADS_ENV,
    few_torch_threads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--resnet-depth", "18", "--image-size", "32",
        "--num-classes", "10", "--train-batch-size", "4"]


def _dataset(directory, shape=(32, 32, 3), sizes=(6, 9)):
    """uint8 shards written by the JAX package's writer."""
    rng = np.random.default_rng(5)
    jarrays.write_array_shards(str(directory), [
        (rng.integers(0, 256, (n,) + shape, dtype=np.uint8),
         rng.integers(0, 10, n).astype(np.int32)) for n in sizes])
    return str(directory)


def test_main_trains_on_the_cpu(caplog):
    with caplog.at_level("INFO"):
        losses = train_resnet.main(TINY + ["--train-steps", "4",
                                           "--steps-per-eval", "2"])
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert re.search(r"step 4 loss=\S+ acc=\S+ images/sec=", caplog.text)
    assert "done: 4 steps" in caplog.text


def test_main_is_deterministic():
    argv = TINY + ["--train-steps", "3"]
    assert train_resnet.main(argv) == train_resnet.main(argv)


def test_inception_trains():
    losses = train_resnet.main(["--device", "cpu", "--model", "inception-v3",
                                "--image-size", "35", "--num-classes", "10",
                                "--train-batch-size", "2",
                                "--train-steps", "2"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)


def _jax_trainer():
    spec = importlib.util.spec_from_file_location(
        "jax_train_resnet_defaults",
        os.path.join(REPO, "cmd", "train_resnet.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_defaults_match_the_jax_trainer():
    want = vars(_jax_trainer().parse_args([]))
    got = vars(train_resnet.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_synthetic_batches_are_the_jax_trainers_arrays():
    """JAX's trainer (process 0): four image batches from
    ``default_rng(0)``, then four label batches."""
    args = train_resnet.parse_args(TINY)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((4, 32, 32, 3), dtype=np.float32)
          for _ in range(4)]
    ys = [rng.integers(0, 10, (4,), dtype=np.int32) for _ in range(4)]
    got = train_resnet.synthetic_batches(args)
    assert len(got) == 4
    for (x, y), wx, wy in zip(got, xs, ys):
        assert x.dtype == np.float32 and np.array_equal(x, wx)
        assert y.dtype == np.int32 and np.array_equal(y, wy)


def test_model_par_exits_naming_the_multi_gpu_slice():
    with pytest.raises(SystemExit, match="--model-par 2 needs a multiple "
                                         "of 2 ranks"):
        train_resnet.main(TINY + ["--model-par", "2"])


def test_bad_checkpoint_interval_exits():
    with pytest.raises(SystemExit, match="checkpoint-interval"):
        train_resnet.main(TINY + ["--checkpoint-interval", "0"])


def test_data_dir_trains_on_jax_written_shards(tmp_path, caplog):
    data = _dataset(tmp_path / "data")
    with caplog.at_level("INFO"):
        losses = train_resnet.main(TINY + ["--data-dir", data,
                                           "--train-steps", "3"])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert "dataset: 15 samples (3 steps/epoch)" in caplog.text


def test_data_dir_shape_mismatch_exits(tmp_path):
    data = _dataset(tmp_path / "data", shape=(16, 16, 3))
    with pytest.raises(SystemExit, match=r"samples are \(16, 16, 3\)"):
        train_resnet.main(TINY + ["--data-dir", data, "--train-steps", "2"])


@pytest.mark.parametrize("source", ["synthetic", "data_dir"])
def test_resumed_run_equals_the_unbroken_run(tmp_path, source):
    """6 steps unbroken, against the same run SIGTERMed in step 2 (it
    saves step 3 and exits 80) and restarted: the same losses, bit for
    bit.  The momentum and the BatchNorm statistics ride in the
    checkpoint, and the schedule reads the restored step (the restarts
    keep ``--train-steps``, which sets the schedule)."""
    argv = TINY + ["--train-steps", "6"]
    if source == "data_dir":
        argv += ["--data-dir", _dataset(tmp_path / "data")]
    ckpt = ["--checkpoint-dir", str(tmp_path / "ckpt")]
    unbroken = train_resnet.main(argv)
    first = []

    def preempt(step, loss):
        first.append(float(loss))
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as exc:
        train_resnet.main(argv + ckpt, on_step=preempt)
    assert exc.value.code == 80
    resumed = train_resnet.main(argv + ckpt)
    assert len(first) == len(resumed) == 3
    assert first + resumed == unbroken
    assert TrainCheckpointer(str(tmp_path / "ckpt")).all_steps() == [3, 6]
    saved = torch.load(tmp_path / "ckpt" / "6" / STATE_FILE,
                       weights_only=True)
    assert "bn_init.running_var" in saved["model"]
    assert saved["optimizer"]["state"]  # the momentum buffers


def test_sigterm_in_process_saves_and_exits_80(tmp_path):
    before = signal.getsignal(signal.SIGTERM)

    def on_step(step, loss):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as exc:
        train_resnet.main(TINY + ["--train-steps", "9", "--checkpoint-dir",
                                  str(tmp_path), "--checkpoint-interval",
                                  "5"], on_step=on_step)
    assert exc.value.code == preempt.PREEMPTED_EXIT_CODE == 80
    assert TrainCheckpointer(str(tmp_path)).all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) is before


def test_sigterm_checkpoints_exits_80_and_resumes(tmp_path):
    """The module run as a Job runs it, a real SIGTERM after observed
    progress: exit 80 with a checkpoint; a second run resumes from it and
    finishes."""
    base = [sys.executable, "-m",
            "container_engine_accelerators_tpu_torch.cmd.train_resnet"] + \
        TINY + ["--checkpoint-dir", str(tmp_path / "ckpt"),
                "--checkpoint-interval", "10000", "--steps-per-eval", "1"]
    proc = subprocess.Popen(base + ["--train-steps", "100000"], cwd=REPO,
                            stderr=subprocess.PIPE, text=True,
                            env={**os.environ, **FEW_THREADS_ENV})
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
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, **FEW_THREADS_ENV})
    assert done.returncode == 0, done.stderr[-2000:]
    m = re.search(r"resuming from checkpoint at step (\d+)", done.stderr)
    assert m and int(m.group(1)) == saved, done.stderr[-2000:]
    assert "done: 2 steps" in done.stderr


def test_profile_dir_writes_a_trace_that_trace_summary_reads(tmp_path,
                                                              capsys):
    """Steps 10-20 are traced (here, of 12: steps 10 and 11), into a file
    named for this trainer."""
    prof = tmp_path / "prof"
    train_resnet.main(TINY + ["--train-steps", "12", "--profile-dir",
                              str(prof)])
    traces = os.listdir(prof)
    assert len(traces) == 1
    assert re.fullmatch(r"train_resnet\.\d+\.pt\.trace\.json", traces[0])
    capsys.readouterr()
    trace_summary.main([str(prof)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["trace"] == str(prof / traces[0])
    assert summary["steps"] == 2
    assert summary["busy_share"] is None  # no device on the CPU


def test_model_dir_gets_the_final_params_without_batch_stats(tmp_path):
    out = tmp_path / "model"
    train_resnet.main(TINY + ["--train-steps", "2", "--model-dir", str(out)])
    params = torch.load(out / train_resnet.PARAMS_FILE, weights_only=True)
    assert "conv_init.weight" in params and "head.bias" in params
    assert not any("running" in k for k in params)
    assert len(params) == 62  # ResNet-18: 20 convs, 20 BatchNorms x 2, head x 2


def test_module_entry_point_trains():
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.train_resnet"] + TINY
        + ["--train-steps", "2", "--steps-per-eval", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, **FEW_THREADS_ENV})
    assert proc.returncode == 0, proc.stderr
    assert "step 2 loss=" in proc.stderr and "done: 2 steps" in proc.stderr
