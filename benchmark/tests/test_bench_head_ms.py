"""``head_ms``, the reader of the tied LM head's two spans: on a faked
window the forward's and the backward's device ms a step, summed; None
for a program without the recorder, for a window without either span
(the head took the f32 path) and for spans without device time."""

import pytest
from conftest import run_tiny  # noqa: F401 (the tiny cell's helpers)

from container_engine_accelerators_tpu_torch.utils import profile

SPANS = {"lm.train.head.forward": {"n": 3, "host_s": 0.01, "device_s": 0.09},
         "lm.train.head.backward": {"n": 3, "host_s": 0.02,
                                    "device_s": 0.3}}


def _window(monkeypatch, spans):
    monkeypatch.setattr(profile, "last_window",
                        lambda: {"spans": spans, "counts": {}})


def test_reads_forward_plus_backward_a_step(tiny_manifest, monkeypatch):
    _window(monkeypatch, SPANS)
    assert tiny_manifest.reader("head_ms")(None) == pytest.approx(130.0)


@pytest.mark.parametrize("left", ["lm.train.head.forward",
                                  "lm.train.head.backward"])
def test_needs_both_spans(tiny_manifest, monkeypatch, left):
    _window(monkeypatch, {n: s for n, s in SPANS.items() if n == left})
    assert tiny_manifest.reader("head_ms")(None) is None


def test_needs_device_time(tiny_manifest, monkeypatch):
    _window(monkeypatch, {n: dict(s, device_s=None)
                          for n, s in SPANS.items()})
    assert tiny_manifest.reader("head_ms")(None) is None


def test_program_without_the_recorder(tiny_manifest, monkeypatch):
    monkeypatch.delattr(profile, "last_window")
    assert tiny_manifest.reader("head_ms")(None) is None
