"""The per-layer metrics that read what the program records about
itself (``harness/program.py``): the spans and counters of its most
recent profiled window, and its kernels' load time.  On a faked window
each reader gives its number; a program without the recorder (an older
checkout) or without the span or counter gives None, never an error;
and a traced run of the tiny serving cell reports the engine's."""

import time

import pytest
from conftest import run_tiny  # noqa: F401 (the tiny cell's helpers)

from container_engine_accelerators_tpu_torch.ops import build
from container_engine_accelerators_tpu_torch.utils import profile

PROGRAM_METRICS = ("fleet_step_dispatch_ms", "kv_used_share",
                   "prefill_pad_share", "prefill_device_ms", "backward_ms",
                   "optimizer_ms", "ops_load_s")
WINDOW = {
    "spans": {
        "lm.engine.step.dispatch": {"n": 4, "host_s": 0.1,
                                    "device_s": None},
        "lm.engine.submit.prefill": {"n": 2, "host_s": 0.3,
                                     "device_s": 0.12},
        "lm.train.backward": {"n": 3, "host_s": 0.2, "device_s": 4.5},
        "lm.train.optimizer": {"n": 3, "host_s": 0.01, "device_s": 0.15},
    },
    "counts": {
        "lm.engine.kv.used_rows": 700, "lm.engine.kv.reserved_rows": 1000,
        "lm.engine.prefill.prompt_tokens": 3, "lm.engine.prefill.pad_tokens":
        1,
    },
}
EXPECTED = {"fleet_step_dispatch_ms": 25.0, "kv_used_share": 70.0,
            "prefill_pad_share": 25.0, "prefill_device_ms": 60.0,
            "backward_ms": 1500.0, "optimizer_ms": 50.0, "ops_load_s": 1.5}


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_reader_on_a_faked_window(tiny_manifest, monkeypatch, name):
    monkeypatch.setattr(profile, "last_window", lambda: WINDOW)
    monkeypatch.setattr(build, "LOAD_S", 1.5)
    assert tiny_manifest.reader(name)(None) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_reader_of_a_program_without_the_recorder(tiny_manifest,
                                                  monkeypatch, name):
    monkeypatch.delattr(profile, "last_window")
    monkeypatch.delattr(build, "LOAD_S")
    assert tiny_manifest.reader(name)(None) is None


@pytest.mark.parametrize("name", PROGRAM_METRICS)
def test_reader_of_a_window_without_its_span(tiny_manifest, monkeypatch,
                                             name):
    monkeypatch.setattr(profile, "last_window",
                        lambda: {"spans": {}, "counts": {}})
    monkeypatch.setattr(build, "LOAD_S", None)
    assert tiny_manifest.reader(name)(None) is None


def test_device_time_readers_need_events(tiny_manifest, monkeypatch):
    """A CPU run's spans hold no device seconds."""
    spans = {n: dict(s, device_s=None) for n, s in WINDOW["spans"].items()}
    monkeypatch.setattr(profile, "last_window",
                        lambda: {"spans": spans, "counts": {}})
    for name in ("prefill_device_ms", "backward_ms", "optimizer_ms"):
        assert tiny_manifest.reader(name)(None) is None


def test_traced_tiny_serving_run_reports_the_engine(tiny_manifest):
    from harness import program, run_cell

    result, _ = run_cell(tiny_manifest, "tiny.serve", 2 ** 31 + 77, 1.0,
                         True, "cpu", time.perf_counter())
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert m["fleet_step_dispatch_ms"] > 0
    assert 0 < m["kv_used_share"] <= 100
    # The slice's two iterations prefill only where a request finished
    # just before; prompts of 16-48 tokens pad to 16, 32 or 64.
    if program.span("lm.engine.submit.prefill") is None:
        assert "prefill_pad_share" not in m
    else:
        assert 0 <= m["prefill_pad_share"] < 50
    for name in ("prefill_device_ms", "backward_ms", "optimizer_ms"):
        assert name not in m  # no CUDA events; no train step
    assert result["correct"]
