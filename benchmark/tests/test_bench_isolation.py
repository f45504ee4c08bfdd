"""What the harness loads: no JAX and nothing of the JAX package (top-
level names compared whole, since the port's name begins with the JAX
package's), and a reference that imports nothing of the program."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
from conftest import BENCH, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax",
             "container_engine_accelerators_tpu"}
PORT = "container_engine_accelerators_tpu_torch"


def imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not set(imported(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert PORT not in set(imported(path))
    assert "harness" not in set(imported(path))


def test_a_run_loads_no_jax(tmp_path):
    """The tiny cells run end to end in a fresh process; then no module
    whose top-level name is JAX's or the JAX package's is loaded."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH / 'tests')!r}]
from conftest import *
from harness.manifest import BENCH_DIR, Manifest
m = Manifest(tiny_spec(), REPO, search=[DATA, BENCH_DIR])
for cell in TINY_CELLS:
    run_tiny(m, cell, 5)
sys.path.insert(0, {str(BENCH)!r})
from run import forbidden_modules
print(forbidden_modules())
"""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "smollm-1.7b.train-2k", "--seed", str(2 ** 31 + 3), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=cwd, env=env)


def test_run_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(REPO, env)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only the manifest and the benchmark's
    folder, the program cannot be imported and no result is printed."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert "container_engine_accelerators_tpu_torch" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    json.loads((tmp_path / "BENCHMARK.json").read_text())
