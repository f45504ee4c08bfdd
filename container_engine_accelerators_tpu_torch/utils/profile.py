"""The port's own measurement on ``torch.profiler``'s clock.

:class:`ProfileWindow` is a ``torch.profiler`` window over a trainer's
steps, shared by ``cmd/train_lm.py`` and ``cmd/train_resnet.py`` (their
``--profile-dir``) and read by ``cmd/trace_summary.py``.

:class:`span` and :func:`count` are the program's spans and counters
(``lm.*``: the decode engine, the train step, the kernel loader).  A
span always opens a ``cpu_op`` range (``_RecordFunctionFast``), which a
Chrome trace shows on the kernels' clock beside the ``aten`` ops; never
a ``record_function`` (a ``user_annotation``), so a caller's own
annotation around it keeps the device operations launched inside it.
While a profiler is recording, spans and counts also fill a table in
this process — per span its count, host seconds and, with CUDA in use,
device seconds between a pair of events on the current stream — which
:func:`last_window` returns for the most recent profiled window.  With
no profiler recording a span costs about a microsecond and a count
less.
"""

import contextlib
import logging
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:  # no fast range in this torch: spans open none
    _RecordFunctionFast = contextlib.nullcontext

log = logging.getLogger(__name__)


class ProfileWindow:
    """``torch.profiler`` over a window of train steps (CPU activity, and
    CUDA activity on the card), each step marked ``ProfilerStep#<n>``.
    :meth:`stop` waits for the device, ends the trace and writes it into
    ``directory`` as a Chrome trace, ``<name>.<pid>.pt.trace.json``
    (``name``: the trainer's)."""

    def __init__(self, directory, device, name):
        from torch.profiler import ProfilerActivity, profile

        self.directory, self.device, self.name = directory, device, name
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self.path = None
        self._prof = profile(activities=activities)
        self._prof.start()

    @staticmethod
    def step(step):
        return torch.profiler.record_function(f"ProfilerStep#{step}")

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.directory, exist_ok=True)
        self.path = os.path.join(
            self.directory, f"{self.name}.{os.getpid()}.pt.trace.json")
        self._prof.export_chrome_trace(self.path)
        log.info("wrote torch.profiler trace to %s", self.path)


# The window's table: a span's name -> [n, host seconds, event pairs],
# a counter's name -> its sum.
_SPANS = {}
_COUNTS = {}
_found = False  # whether the last span, count or recording() found one


def recording() -> bool:
    """Whether a torch profiler is recording, so whether spans and counts
    are kept: a count that costs work to compute is computed only then.
    The first finding of a recording after one of none (by a span, a
    count or this call) starts a new window; two profiled windows with
    no such finding between them share one table."""
    global _found
    on = _autograd_profiler._is_profiler_enabled
    if on and not _found:
        _SPANS.clear()
        _COUNTS.clear()
    _found = on
    return on


def count(name: str, n) -> None:
    """Add ``n`` to counter ``name`` while a profiler is recording."""
    if recording():
        _COUNTS[name] = _COUNTS.get(name, 0) + n


class span:
    """``with span(name):`` a ``cpu_op`` range around the block and,
    while a profiler is recording, one more of ``name`` in the window's
    table: its host seconds and, with CUDA in use, the device seconds
    between an event recorded on the current stream as the block starts
    and one as it ends."""

    __slots__ = ("name", "_range", "_t0", "_start")

    def __init__(self, name: str):
        self.name = name
        self._range = _RecordFunctionFast(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = None
        if recording():
            self._start = None
            if torch.cuda.is_initialized():
                self._start = torch.cuda.Event(enable_timing=True)
                self._start.record()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            host_s = time.perf_counter() - self._t0
            entry = _SPANS.setdefault(self.name, [0, 0.0, []])
            entry[0] += 1
            entry[1] += host_s
            if self._start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                entry[2].append((self._start, end))
        self._range.__exit__(*exc)
        return False


def last_window() -> dict:
    """The table of the most recent profiled window: ``{"spans": {name:
    {"n", "host_s", "device_s"}}, "counts": {name: n}}``; ``device_s``
    is None for a span that recorded no events.  Waits for the device to
    resolve the events."""
    if any(ev for _, _, ev in _SPANS.values()):
        torch.cuda.synchronize()
    spans = {}
    for name, (n, host_s, ev) in _SPANS.items():
        device_s = (sum(s.elapsed_time(e) for s, e in ev) / 1e3
                    if ev else None)
        spans[name] = {"n": n, "host_s": host_s, "device_s": device_s}
    return {"spans": spans, "counts": dict(_COUNTS)}
