"""A tiny cell of the benchmark's own, for the CPU: the SmolLM equations
at test sizes (``data/configs/tiny.json``) under a training and a
serving mix (``data/traffic``), with limits of their own
(``data/limits``), driven through the same harness as the real cells."""

import copy
import json
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
DATA = Path(__file__).resolve().parent / "data"
sys.path[:0] = [str(BENCH), str(REPO), str(BENCH / "tools")]

TINY_CELLS = {"tiny.train": "tiny-train", "tiny.serve": "tiny-serve"}


def tiny_spec() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        spec = json.load(f)
    spec = copy.deepcopy(spec)
    spec["configs"] = [{"name": "tiny",
                        "file": "benchmark/tests/data/configs/tiny.json"}]
    spec["workloads"] = [{"name": n, "config": "tiny", "traffic": t,
                          "chips": 1} for n, t in TINY_CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = list(TINY_CELLS)
    return spec


@pytest.fixture(scope="session")
def tiny_manifest():
    from harness.manifest import BENCH_DIR, Manifest

    return Manifest(tiny_spec(), REPO, search=[DATA, BENCH_DIR])


def run_tiny(manifest, cell, seed, control=False):
    """One CPU run of a tiny cell: (result, record)."""
    from harness import run_cell

    seconds = 3.0 if cell == "tiny.serve" else 0.5
    return run_cell(manifest, cell, seed, seconds, False, "cpu",
                    time.perf_counter(), control)
