"""The precision control has to come out not correct: the reference
computed in float8 (the step below the configurations' bf16) in the
program's place, and for a served model also the program's own lower
precision, its int8 weight path.  On the CPU at the tiny size against
the tiny cell's limits (float8); on a card, each real cell at its own
size against its own limits."""

import json
import subprocess
import sys

import pytest
import torch
from conftest import REPO, run_tiny

CELLS = [w["name"] for w in
         json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
SERVE_CELLS = [c for c in CELLS if ".serve" in c]


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.serve"])
def test_control_fails_tiny(tiny_manifest, cell):
    result, _ = run_tiny(tiny_manifest, cell, 23, control=True)
    assert result["correct"], result["checks"]
    assert not all(c["ok"] for c in result["control"].values()), \
        result["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "own size")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 29), "--seconds", "30", "--trace", "0",
         "--control", "1"], capture_output=True, text=True, timeout=1200,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert not all(c["ok"] for c in result["control"].values()), \
        result["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_int8_weights_fail_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the int8 path runs at the "
                    "cell's own size")
    out = subprocess.run(
        [sys.executable, "benchmark/tools/faults.py", "--fault",
         "int8_weights", "--workload", cell, "--seconds", "30", "--seeds",
         str(2 ** 31 + 31)], capture_output=True, text=True, timeout=1200,
        cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    row = json.loads(out.stdout.strip().splitlines()[-1])
    assert not row["correct"], row["checks"]
