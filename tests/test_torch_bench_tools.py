"""The port's measurement tools (``container_engine_accelerators_tpu_torch/
cmd/bench_{micro,attention,prefix,serving}.py``, ``roofline_{resnet,
check}.py``) against the root JAX tools, on the CPU.

- Each tool's flags and defaults equal the JAX tool's (loaded by file, as
  ``tests/test_bench_cli.py`` loads them), apart from the divergences
  ``DIVERGENCES`` lists (and ROADMAP.md records).
- Each tool's ``main(argv)`` runs in-process with ``--device cpu`` at a
  small size, and its JSON lines carry the JAX tool's field names
  (``JAX_KEYS``, each checked to be a string in the JAX tool's source).
- ``bench_attention --check`` in f32 holds flash against dense within
  1e-5; ``bench_serving`` greedy in f32 gives the engine exactly the
  port's own ``generate`` tokens (plain and speculative), and ``--fleet``
  emits the QPS series and its headline under one run id.
- Run in a fresh process with ``jax``, ``bench`` and the JAX package
  blocked from import and a temporary working directory, every tool runs
  and nothing under the repo changes.
"""

import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from torch_image_helpers import (  # noqa: F401 (autouse fixture)
    FEW_THREADS_ENV,
    few_torch_threads,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = "container_engine_accelerators_tpu_torch.cmd"
TOOLS = ("bench_micro", "bench_attention", "bench_prefix", "bench_serving",
         "roofline_resnet", "roofline_check")

# Flags the port adds or drops against the JAX tool, and defaults it
# changes: (added, dropped, {flag: port default}).
DIVERGENCES = {
    "bench_micro": ({"device"}, {"force_log"}, {}),
    "bench_attention": ({"device", "dtype"}, set(), {"blocks": "kernel"}),
    "bench_prefix": ({"device"}, {"force_log"}, {}),
    "bench_serving": ({"device", "dtype"}, set(), {}),
    "roofline_resnet": ({"device"}, set(), {}),
    "roofline_check": ({"device"}, set(), {}),
}

# The JAX tools' JSON field names, line kind by line kind.
JAX_KEYS = {
    "micro_h2d_gbps": {"metric", "value", "unit", "vs_baseline", "mib",
                       "note", "init_s"},
    "micro_hbm_copy_gbps": {"metric", "value", "unit", "vs_baseline", "mib",
                            "iters", "hbm_bw_source", "compile_s"},
    "micro_matmul_bf16_tflops": {"metric", "value", "unit", "vs_baseline",
                                 "dim", "iters", "peak_source", "compile_s"},
    "attention_row": {"config", "B", "T", "H", "D", "fwd_ms", "fwd_tflops",
                      "fwdbwd_ms", "fwdbwd_tflops"},
    "attention_check": {"config", "check_max_abs_err_out",
                        "check_max_abs_err_dqkv"},
    "prefix": {"metric", "value", "unit", "vs_baseline", "prefix_len",
               "suffix_len", "max_new", "calls", "nonce"},
    "serving": {"metric", "value", "run_id", "version", "unit",
                "vs_baseline", "throughput_speedup", "requests", "max_new",
                "prompt_lens", "engine_tokens_per_sec",
                "sequential_tokens_per_sec", "mean_ttft_ms",
                "exact_match_fraction", "tie_mismatches", "platform",
                "nonce"},
    "serving_spec": {"spec_k", "spec_draft", "spec_accept_rate",
                     "spec_rounds"},
    "fleet_window": {"mode", "window_s", "qps", "inflight", "run_id",
                     "version"},
    "fleet_head": {"metric", "value", "unit", "run_id", "version", "ok",
                   "errors", "shed", "elapsed_s", "p99_e2e_ms", "cpu_attr",
                   "dominant_phase", "nodes", "payload_bytes", "inflight",
                   "max_batch"},
}
JAX_SOURCE = {
    "micro_h2d_gbps": "bench_micro", "micro_hbm_copy_gbps": "bench_micro",
    "micro_matmul_bf16_tflops": "bench_micro",
    "attention_row": "bench_attention", "attention_check": "bench_attention",
    "prefix": "bench_prefix", "serving": "bench_serving",
    "serving_spec": "bench_serving", "fleet_window": "bench_serving",
    "fleet_head": "bench_serving",
}

SERVING_SMALL = ["--device", "cpu", "--dtype", "float32", "--requests", "4",
                 "--max-new", "8"]
ATTN_SMALL = ["--device", "cpu", "--batch", "1", "--seq", "128", "--heads",
              "2", "--head-dim", "64", "--steps", "1"]

# Every tool at a small CPU size, for the jax-blocked run.
SMALL_RUNS = (
    ("bench_micro", ["--device", "cpu", "--matmul-dim", "64", "--copy-mib",
                     "1", "--h2d-mib", "1", "--iters", "2"]),
    ("bench_attention", ATTN_SMALL + ["--dtype", "float32", "--check"]),
    ("bench_prefix", ["--device", "cpu"]),
    ("bench_serving", SERVING_SMALL + ["--speculative", "2"]),
    ("bench_serving", ["--fleet", "--fleet-seconds", "0.5"]),
    ("roofline_resnet", ["--device", "cpu", "--depth", "18", "--batches",
                         "2", "--image-size", "32"]),
    ("roofline_check", ["--device", "cpu", "--batch", "2", "--image-size",
                        "32", "--steps", "1", "--profile-steps", "1"]),
)


def _load_jax_tool(name):
    path = os.path.join(REPO, "cmd", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_tool(name):
    return importlib.import_module(f"{CLI}.{name}")


def _run(name, argv, capsys):
    """``main(argv)`` in-process -> (return code, its JSON lines)."""
    rc = _port_tool(name).main(argv)
    out = capsys.readouterr().out
    return rc, [json.loads(line) for line in out.splitlines()
                if line.startswith("{")]


@pytest.mark.parametrize("name", TOOLS)
def test_flags_and_defaults_equal_jax_but_the_divergences(name):
    jax_args = vars(_load_jax_tool(name).parse_args([]))
    port_args = vars(_port_tool(name).parse_args([]))
    added, dropped, changed = DIVERGENCES[name]
    assert set(port_args) - set(jax_args) == added
    assert set(jax_args) - set(port_args) == dropped
    assert port_args["device"] == "cuda"
    for flag, value in port_args.items():
        if flag in added:
            continue
        want = changed.get(flag, jax_args[flag])
        assert value == want, (name, flag, value, want)


@pytest.mark.parametrize("kind", sorted(JAX_KEYS))
def test_jax_key_lists_come_from_the_jax_sources(kind):
    with open(os.path.join(REPO, "cmd",
                           f"{JAX_SOURCE[kind]}.py")) as f:
        src = f.read()
    for key in JAX_KEYS[kind]:
        assert f'"{key}"' in src, (kind, key)


def test_bench_micro_cpu_lines_carry_jax_keys(capsys):
    rc, lines = _run("bench_micro", SMALL_RUNS[0][1], capsys)
    assert rc == 0
    assert [r["metric"] for r in lines] == [
        "micro_h2d_gbps", "micro_hbm_copy_gbps", "micro_matmul_bf16_tflops"]
    for r in lines:
        assert JAX_KEYS[r["metric"]] <= set(r), r["metric"]
        assert r["value"] > 0
    # A CPU device has no card name: its peaks are a guess, and say so.
    assert lines[1]["hbm_bw_source"] == lines[2]["peak_source"] == "default"


def test_bench_attention_f32_check_holds_flash_to_dense(capsys):
    rc, lines = _run("bench_attention",
                     ATTN_SMALL + ["--dtype", "float32", "--check"], capsys)
    assert rc == 0
    (check,) = [r for r in lines if "check_max_abs_err_out" in r]
    rows = [r for r in lines if "fwd_ms" in r]
    assert [r["config"] for r in rows] == ["flash_64x64", "xla_dense"]
    assert JAX_KEYS["attention_check"] <= set(check)
    for r in rows:
        assert JAX_KEYS["attention_row"] <= set(r)
    assert check["check_max_abs_err_out"] <= 1e-5
    assert max(check["check_max_abs_err_dqkv"]) <= 1e-5
    # 3*steps+1 forwards, as many forward+backwards, and the check's own.
    assert rows[0]["flash_calls"] == {"flash_attention_fwd": 10,
                                      "flash_attention_bwd_dq": 5,
                                      "flash_attention_bwd_dkv": 5}


def test_bench_attention_blocks_is_the_kernel_tile_alone(capsys):
    mod = _port_tool("bench_attention")
    assert mod.flash_configs("kernel", "bfloat16", 64) == ["flash_128x128"]
    assert mod.flash_configs("128x64", "bfloat16", 256) == ["flash_128x64"]
    assert mod.flash_configs("64x64", "float32", 128) == ["flash_64x64"]
    assert mod.flash_configs("", "bfloat16", 64) == []
    for spec in ("256x128", "128x128,256x256"):
        with pytest.raises(SystemExit, match="compiled for the 128x128 tile"):
            mod.flash_configs(spec, "bfloat16", 64)
    rc, lines = _run("bench_attention", ATTN_SMALL + ["--blocks", ""], capsys)
    assert rc == 0 and [r["config"] for r in lines] == ["xla_dense"]


def test_bench_prefix_cpu_lines_and_tokens(capsys):
    rc, lines = _run("bench_prefix", ["--device", "cpu"], capsys)
    assert rc == 0
    assert [r["metric"] for r in lines] == ["prefix_ttft_full_ms",
                                            "prefix_ttft_cached_ms"]
    for r in lines:
        assert JAX_KEYS["prefix"] <= set(r)
    assert lines[0]["prefix_len"] == 12 and lines[0]["suffix_len"] == 4
    assert lines[1]["tokens_match_full"] is True


@pytest.mark.parametrize("extra", [
    [], ["--speculative", "2"], ["--speculative", "2", "--spec-draft", "1L"],
], ids=["greedy", "spec-self", "spec-1L"])
def test_bench_serving_greedy_f32_is_exact(extra, capsys):
    rc, lines = _run("bench_serving", SERVING_SMALL + extra, capsys)
    assert rc == 0
    (r,) = lines
    assert JAX_KEYS["serving"] <= set(r)
    assert r["exact_match_fraction"] == 1.0 and r["tie_mismatches"] == []
    assert r["platform"] == "cpu"
    if extra:
        draft = "1L" if "1L" in extra else "self"
        assert JAX_KEYS["serving_spec"] <= set(r)
        assert r["metric"].endswith(f"_speck2{draft}")
        if draft == "self":
            assert r["spec_accept_rate"] == 1.0


def test_bench_serving_sampled_lanes_follow_their_seeds(capsys):
    rc, lines = _run("bench_serving",
                     SERVING_SMALL + ["--temperature", "1.0"], capsys)
    assert rc == 0
    (r,) = lines
    assert r["metric"].endswith("_sampledT1")
    assert r["exact_match_fraction"] == 1.0


def test_bench_serving_fleet_emits_qps_series(capsys, monkeypatch):
    monkeypatch.delenv("TPU_HISTORY_DIR", raising=False)
    rc, lines = _run("bench_serving", ["--fleet", "--fleet-seconds", "2"],
                     capsys)
    assert rc == 0
    windows = [r for r in lines if r.get("mode") == "fleet-serving"]
    head = [r for r in lines
            if r.get("metric") == "serving_fleet_sustained_qps"]
    assert windows, "per-second QPS series missing"
    assert len(head) == 1
    assert head[0]["value"] > 0 and head[0]["errors"] == 0
    assert len(head[0]["run_id"]) == 16 and head[0]["version"]
    assert {w["run_id"] for w in windows} == {head[0]["run_id"]}
    assert JAX_KEYS["fleet_head"] <= set(head[0])
    for w in windows:
        assert JAX_KEYS["fleet_window"] <= set(w)


def test_tools_refuse_cuda_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("bench_micro", "bench_prefix", "roofline_resnet"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _port_tool(name).main([])


def _repo_state():
    """``git status --porcelain`` of the repo, each listed file with a
    hash of its content (a file modified before may be modified again)."""
    out = subprocess.run(["git", "status", "--porcelain",
                          "--untracked-files=all"], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    state = {}
    for line in out.splitlines():
        path = os.path.join(REPO, line[3:].split(" -> ")[-1])
        digest = None
        if os.path.isfile(path):
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
        state[line] = digest
    return state


_BLOCKED_RUN = """
import contextlib, io, json, sys
for name in ("jax", "bench", "container_engine_accelerators_tpu"):
    sys.modules[name] = None  # any import of it raises ImportError
import importlib
runs = json.loads(sys.argv[1])
for name, argv in runs:
    mod = importlib.import_module(
        "container_engine_accelerators_tpu_torch.cmd." + name)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    assert not rc, (name, argv, rc)
    assert buf.getvalue().strip(), (name, argv)
loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "bench", "container_engine_accelerators_tpu.")))
print(json.dumps({"loaded": [m for m in loaded
                             if sys.modules[m] is not None]}))
"""


def test_every_tool_runs_without_jax_and_writes_nothing(tmp_path):
    before = _repo_state()
    env = dict(os.environ, PYTHONPATH=REPO, **FEW_THREADS_ENV)
    env.pop("TPU_HISTORY_DIR", None)
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED_RUN, json.dumps(SMALL_RUNS)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == {"loaded": []}
    assert _repo_state() == before
    assert os.listdir(tmp_path) == []
