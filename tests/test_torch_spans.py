"""The port's own spans and counters (``utils/profile.py``): ``cpu_op``
ranges on the profiler's clock, kept in a table only while a profiler
records, the table of the most recent profiled window; the decode
engine's, the train step's and the kernel loader's spans; and why a
program range must not be a user annotation: the benchmark's trace
reduction (``benchmark/harness/tracing.py``) gives each launch to the
latest-starting user annotation around it."""

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import torch_dist_helpers as H
from container_engine_accelerators_tpu_torch.models import lm_train as lt
from container_engine_accelerators_tpu_torch.models.batching import (
    DecodeEngine,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    TransformerLM,
    init_params,
)
from container_engine_accelerators_tpu_torch.ops import build
from container_engine_accelerators_tpu_torch.utils.profile import (
    count,
    last_window,
    recording,
    span,
)

REPO = Path(__file__).resolve().parents[1]
CFG = dict(vocab_size=97, num_layers=2, num_heads=4, head_dim=8,
           mlp_dim=32, num_kv_heads=2)
# Two requests on a fleet of 2 x 32: A's 3-token prompt pads to 4, B's 5
# to 8; B retires after the first fleet step, A after the second.
REQUESTS = (([1, 2, 3], 3), ([4, 5, 6, 7, 8], 2))
ENGINE_SPANS = ("lm.engine.submit", "lm.engine.submit.prefill",
                "lm.engine.submit.insert", "lm.engine.submit.read",
                "lm.engine.step", "lm.engine.step.dispatch",
                "lm.engine.step.read", "lm.engine.step.retire")


@pytest.fixture(autouse=True)
def no_profiler():
    """Each test starts with no profiler recording; finding none (as a
    span or count outside a window does) lets the next window start a
    table of its own."""
    assert not recording()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    return data["traceEvents"] if isinstance(data, dict) else data


def _trace_module():
    spec = importlib.util.spec_from_file_location(
        "bench_tracing", REPO / "benchmark" / "harness" / "tracing.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def model():
    m = TransformerLM(**CFG, decode=True, dtype=torch.float32, device="cpu")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(3)))
    return m.eval()


def _serve(model):
    eng = DecodeEngine(model, max_slots=2, max_len=32)
    rids = [eng.submit(p, n) for p, n in REQUESTS]
    while eng.step():
        pass
    return eng, [eng.result(r) for r in rids]


def test_span_without_a_profiler_records_nothing():
    with _cpu_profile():
        with span("lm.kept"):
            pass
    assert not recording()
    with span("lm.unseen"):
        count("lm.unseen.count", 3)
    w = last_window()
    assert set(w["spans"]) == {"lm.kept"} and w["counts"] == {}


def test_ranges_are_cpu_ops_never_user_annotations(model, tmp_path):
    """Inside a caller's own ``record_function``, as the benchmark wraps
    ``step()`` in ``fleet_step``: every program range is a ``cpu_op``
    nested in it, and the engine's parts nest in their parent range."""
    eng = DecodeEngine(model, max_slots=2, max_len=32)
    with _cpu_profile() as prof:
        with record_function("prefill"):
            eng.submit(*REQUESTS[0])
        with record_function("fleet_step"):
            eng.step()
    events = [e for e in _events(prof, tmp_path) if e.get("ph") == "X"]
    ours = [e for e in events if e["name"].startswith("lm.")]
    assert {e["cat"] for e in ours} == {"cpu_op"}
    names = {e["name"] for e in ours}
    assert names == set(ENGINE_SPANS)

    def inside(inner, outer):
        return (outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"]
                <= outer["ts"] + outer["dur"])

    by = {e["name"]: e for e in events}
    for e in ours:
        outer = "prefill" if e["name"].startswith("lm.engine.submit") \
            else "fleet_step"
        assert by[outer]["cat"] == "user_annotation" and inside(e, by[outer])
    for part in ("dispatch", "read", "retire"):
        assert inside(by[f"lm.engine.step.{part}"], by["lm.engine.step"])


def test_last_window_is_cleared_when_a_new_window_starts():
    with _cpu_profile():
        with span("lm.first"):
            count("lm.first.count", 2)
    with span("lm.between"):
        pass
    assert set(last_window()["spans"]) == {"lm.first"}
    with _cpu_profile():
        with span("lm.second"):
            pass
    w = last_window()
    assert set(w["spans"]) == {"lm.second"} and w["counts"] == {}


def test_count_and_recording():
    assert not recording()
    count("lm.c", 5)
    with _cpu_profile():
        assert recording()
        count("lm.c", 2)
        count("lm.c", 3)
        count("lm.d", 1)
    assert not recording()
    assert last_window()["counts"] == {"lm.c": 5, "lm.d": 1}


def test_span_times_the_host_and_passes_exceptions():
    with _cpu_profile():
        for _ in range(2):
            with span("lm.sleep"):
                time.sleep(0.02)
        with pytest.raises(KeyError):
            with span("lm.fails"):
                raise KeyError("x")
    w = last_window()["spans"]
    assert w["lm.sleep"]["n"] == 2 and w["lm.sleep"]["host_s"] >= 0.04
    assert w["lm.sleep"]["device_s"] is None  # no CUDA in use
    assert w["lm.fails"]["n"] == 1


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _fleet_step_trace(range_cat):
    """A traced fleet step: the harness's ``fleet_step`` annotation, the
    engine's ranges inside it as ``range_cat``, two kernels launched in
    the dispatch and a copy launched in the read, after the dispatch
    closed.  The idle gap 200-460 lies in the dispatch."""
    return [
        _x("bench.window", "user_annotation", 0, 1000),
        _x("fleet_step", "user_annotation", 100, 800),
        _x("lm.engine.step", range_cat, 105, 790),
        _x("lm.engine.step.dispatch", range_cat, 110, 400),
        _x("lm.engine.step.read", range_cat, 520, 300),
        _x("cudaLaunchKernel", "cuda_runtime", 150, 5, 1),
        _x("k1", "kernel", 160, 40, 1),
        _x("cudaLaunchKernel", "cuda_runtime", 450, 5, 2),
        _x("k2", "kernel", 460, 50, 2),
        _x("cudaMemcpyAsync", "cuda_runtime", 530, 280, 3),
        _x("Memcpy DtoH", "gpu_memcpy", 800, 10, 3),
    ]


def test_program_range_leaves_the_harness_iteration_whole():
    t = _trace_module().Trace(_fleet_step_trace("cpu_op"))
    assert [[n for n, _ in ops] for ops in t.iterations["fleet_step"]] == [
        ["k1", "k2", "Memcpy DtoH"]]
    assert "lm.engine.step.dispatch" not in t.iterations
    gaps = dict(t.idle_gaps())
    assert gaps["lm.engine.step.dispatch"] == pytest.approx(260e-6)
    assert "fleet_step" not in gaps


def test_a_user_annotation_in_its_place_takes_the_launches():
    """The trap the ``cpu_op`` ranges avoid: as user annotations, the
    engine's ranges would take every launch from ``fleet_step``."""
    t = _trace_module().Trace(_fleet_step_trace("user_annotation"))
    assert t.iterations["fleet_step"] == [[]]
    assert [n for n, _ in t.iterations["lm.engine.step.dispatch"][0]] == [
        "k1", "k2"]


def test_engine_spans_and_counters_under_a_profiler(model):
    with _cpu_profile():
        eng, _ = _serve(model)
    w = last_window()
    assert eng.steps == 2
    assert {n: s["n"] for n, s in w["spans"].items()} == {
        n: 2 for n in ENGINE_SPANS}
    # Step 1: A holds 3 + 1 rows, B 5 + 1; step 2: A 3 + 2.
    assert w["counts"] == {
        "lm.engine.prefill.prompt_tokens": 8,
        "lm.engine.prefill.pad_tokens": 4,
        "lm.engine.kv.used_rows": 15,
        "lm.engine.kv.reserved_rows": 2 * 2 * 32,
    }


def test_engine_tokens_do_not_change_under_a_profiler(model):
    _, plain = _serve(model)
    assert not recording()
    with _cpu_profile():
        _, traced = _serve(model)
    assert traced == plain and [len(t) for t in plain] == [3, 2]


def _train_run(steps):
    m = TransformerLM(**{**CFG, "head_dim": 16}, dtype=torch.float32,
                      device="cpu")
    m.load_state_dict(init_params(m, torch.Generator().manual_seed(5)))
    torch.manual_seed(0)
    step, state = lt.make_lm_train_step(state=lt.create_lm_train_state(m))
    toks = torch.randint(0, CFG["vocab_size"], (2, 16))
    labels, mask = lt.next_token_targets(toks)
    for _ in range(steps):
        state, metrics = step(state, toks, labels, mask)
    return metrics["loss"].item()


def test_train_step_has_one_forward_backward_optimizer_a_step():
    plain = _train_run(2)
    assert not recording()
    with _cpu_profile():
        traced = _train_run(2)
    assert traced == plain
    assert {n: s["n"] for n, s in last_window()["spans"].items()} == {
        "lm.train.forward": 2, "lm.train.backward": 2,
        "lm.train.optimizer": 2}


def test_seq_parallel_step_has_the_same_spans(tmp_path):
    cfg = dict(CFG, head_dim=16, num_kv_heads=4)
    ranks = H.spawn(H.lm_seq_spans, 2, tmp_path, cfg, "ring", 2)
    assert ranks == [{"lm.train.forward": 2, "lm.train.backward": 2,
                      "lm.train.optimizer": 2}] * 2


def test_load_ops_times_its_first_call_once(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    calls = []

    def load(**kw):
        calls.append(kw["name"])
        time.sleep(0.02)

    monkeypatch.setattr(cpp_extension, "load", load)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_ops", None)
    monkeypatch.setattr(build, "LOAD_S", None)
    with _cpu_profile():
        ops = build.load_ops()
    first = build.LOAD_S
    assert calls == ["cea_tpu_torch_kernels"] and first >= 0.02
    assert last_window()["spans"]["lm.ops.load"]["n"] == 1
    assert build.load_ops() is ops
    assert build.LOAD_S == first and len(calls) == 1


@pytest.mark.cuda
def test_span_times_the_device_between_events_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events)")
    a = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            with span("lm.matmul"):
                for _ in range(10):
                    a = a @ a * 1e-3
    s = last_window()["spans"]["lm.matmul"]
    assert s["n"] == 3 and 0 < s["device_s"]
