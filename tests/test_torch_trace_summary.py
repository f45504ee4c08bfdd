"""The port's ``cmd/trace_summary.py`` on hand-written Chrome traces:
device work summed by name, launches counted, the busy share from the
union of device intervals over the window, steps from the
``ProfilerStep#`` annotations, and the newest trace of a directory."""

import json
import os
import subprocess
import sys

import pytest

from container_engine_accelerators_tpu_torch.cmd import trace_summary

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "args": {"name": "python"}},
    _x("ProfilerStep#10", "user_annotation", 0.0, 400.0),
    _x("ProfilerStep#11", "user_annotation", 400.0, 400.0),
    _x("ProfilerStep#10", "gpu_user_annotation", 10.0, 300.0),
    _x("aten::mm", "cpu_op", 5.0, 20.0),
    _x("cudaLaunchKernel", "cuda_runtime", 6.0, 3.0),
    _x("void fa_fwd_sm90_kernel<64>(...)", "kernel", 100.0, 50.0),
    _x("void fa_fwd_sm90_kernel<64>(...)", "kernel", 500.0, 50.0),
    # A second stream's kernel overlapping the first: counted in the
    # device time, once in the busy time.
    _x("gemm", "kernel", 120.0, 60.0),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 700.0, 10.0),
    _x("Memset (Device)", "gpu_memset", 790.0, 10.0),
]}


def test_sums_device_work_and_the_busy_share(tmp_path, capsys):
    path = tmp_path / "a.pt.trace.json"
    path.write_text(json.dumps(TRACE))
    s = trace_summary.summarize(str(path))
    assert s["window_ms"] == pytest.approx(0.8)
    assert s["steps"] == 2
    assert s["device_ms"] == pytest.approx(0.18)
    assert s["device_busy_ms"] == pytest.approx(0.15)
    assert s["busy_share"] == pytest.approx(0.15 / 0.8)
    assert s["device_ms_per_step"] == pytest.approx(0.09)
    assert s["launches"] == 5
    assert [(o["name"], o["launches"]) for o in s["ops"]] == [
        ("void fa_fwd_sm90_kernel<64>(...)", 2), ("gemm", 1),
        ("Memcpy HtoD (Pageable -> Device)", 1), ("Memset (Device)", 1)]
    assert sum(o["pct"] for o in s["ops"]) == pytest.approx(100)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == s
    assert "fa_fwd_sm90_kernel" in err


def test_a_directory_means_its_newest_trace(tmp_path):
    old, new = tmp_path / "old.pt.trace.json", tmp_path / "sub"
    old.write_text(json.dumps({"traceEvents": []}))
    new.mkdir()
    (new / "new.pt.trace.json").write_text(json.dumps(TRACE))
    os.utime(old, (1, 1))
    assert trace_summary.find_trace(str(tmp_path)) == str(
        new / "new.pt.trace.json")
    empty = trace_summary.summarize(str(old))
    assert empty["busy_share"] is None and empty["window_ms"] == 0
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no .*trace"):
        trace_summary.find_trace(str(tmp_path / "empty"))


def test_module_entry_point(tmp_path):
    (tmp_path / "t.pt.trace.json").write_text(json.dumps(TRACE))
    proc = subprocess.run(
        [sys.executable, "-m",
         "container_engine_accelerators_tpu_torch.cmd.trace_summary",
         str(tmp_path), "--top", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(line["ops"]) == 1 and line["launches"] == 5


def _launch(name, ts, corr, kernel_ts, kernel_dur):
    """A runtime call at ``ts`` and the device operation it launched,
    joined by their correlation id."""
    call = _x("cudaLaunchKernel", "cuda_runtime", ts, 2.0)
    op = _x(name, "kernel", kernel_ts, kernel_dur)
    call["args"] = op["args"] = {"correlation": corr}
    return [call, op]


def test_device_work_by_program_range(tmp_path, capsys):
    """Each device operation goes to the innermost ``lm.*`` range around
    its launch (the kernel may run after the range closed); a launch
    outside every range, and the ranges' ``user_annotation`` namesakes,
    count for none."""
    events = [
        _x("lm.train.forward", "cpu_op", 0.0, 100.0),
        _x("lm.train.backward", "cpu_op", 100.0, 100.0),
        _x("lm.engine.step", "cpu_op", 300.0, 100.0),
        _x("lm.engine.step.dispatch", "cpu_op", 310.0, 40.0),
        _x("lm.train.backward", "user_annotation", 0.0, 400.0),
        *_launch("fwd", 10.0, 1, 20.0, 30.0),
        *_launch("bwd", 150.0, 2, 160.0, 50.0),
        *_launch("late", 190.0, 3, 250.0, 10.0),
        *_launch("fleet", 320.0, 4, 330.0, 5.0),
        *_launch("read", 380.0, 5, 390.0, 1.0),
        *_launch("outside", 500.0, 6, 510.0, 1.0),
    ]
    path = tmp_path / "r.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace_summary.summarize(str(path))
    assert s["ranges"] == {
        "lm.train.forward": {"n": 1, "ms": pytest.approx(0.03),
                             "launches": 1},
        "lm.train.backward": {"n": 1, "ms": pytest.approx(0.06),
                              "launches": 2},
        "lm.engine.step": {"n": 1, "ms": pytest.approx(0.001),
                           "launches": 1},
        "lm.engine.step.dispatch": {"n": 1, "ms": pytest.approx(0.005),
                                    "launches": 1},
    }
    assert s["launches"] == 6
    assert "lm.engine.step.dispatch" in capsys.readouterr().err
