"""The traced slice of a ``--trace 1`` run, and its reduction.

The harness runs a few more iterations of the cell's own loop right
after the measured window, under ``torch.profiler`` (CPU and CUDA
activity), each iteration inside a ``record_function`` named after what
it drives and the whole slice inside ``bench.window``.  The Chrome trace
goes to a temporary directory and is read back here:

- device intervals (kernels, copies, memsets) inside the slice, their
  union (``busy_s``) against the slice's length (``window_s``);
- device time and launches by kernel name;
- for each named iteration, the device operations it launched, joined
  through the runtime call's correlation id;
- the idle gaps between device intervals, each named by the innermost
  host event that spans its middle.
"""

import bisect
import json
import os
import shutil
import tempfile
from collections import defaultdict
from contextlib import contextmanager

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
GAPS_NAMED = 500  # longest idle gaps named by host activity


class Trace:
    """The reduced slice.  Times in seconds."""

    def __init__(self, events):
        win = [e for e in events if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
        if not win:
            raise ValueError("trace holds no bench.window annotation")
        w0 = win[0]["ts"]
        w1 = w0 + win[0]["dur"]
        self.window_s = (w1 - w0) / 1e6
        dev = []
        for e in events:
            if e.get("cat") in DEVICE_CATS and "dur" in e:
                s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
                if t > s:
                    dev.append((s, t, e))
        self.kernel_us = defaultdict(float)
        self.kernel_n = defaultdict(int)
        for s, t, e in dev:
            self.kernel_us[e["name"]] += t - s
            self.kernel_n[e["name"]] += 1
        merged = _merge((s, t) for s, t, _ in dev)
        self.busy_s = sum(t - s for s, t in merged) / 1e6
        # Host launch time of each device op, by correlation id.
        launch = {}
        for e in events:
            if e.get("cat") in ("cuda_runtime", "cuda_driver"):
                c = e.get("args", {}).get("correlation")
                if c is not None:
                    launch[c] = e["ts"]
        # Named iterations (user annotations other than the window).
        self.iterations = defaultdict(list)
        spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                       for e in events if e.get("cat") == "user_annotation"
                       and e.get("name") != WINDOW and "dur" in e)
        starts = [s for s, _, _ in spans]
        per_span = defaultdict(list)
        for s, t, e in dev:
            c = e.get("args", {}).get("correlation")
            ts = launch.get(c)
            if ts is None:
                continue
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and spans[i][0] <= ts <= spans[i][1]:
                per_span[i].append((e["name"], t - s))
        for i, (s, t, name) in enumerate(spans):
            self.iterations[name].append(per_span.get(i, []))
        self.idle_by_host = _name_gaps(merged, w0, w1, events)

    def device_ops(self, top: int = 10):
        rows = sorted(self.kernel_us.items(), key=lambda kv: -kv[1])[:top]
        return [[name, us / 1e6] for name, us in rows]

    def idle_gaps(self, top: int = 10):
        rows = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])
        return [[name, us / 1e6] for name, us in rows[:top]]

    def time_s(self, match) -> float:
        """Device seconds in kernels whose name ``match`` accepts."""
        return sum(us for n, us in self.kernel_us.items() if match(n)) / 1e6

    def launches(self, match) -> int:
        return sum(c for n, c in self.kernel_n.items() if match(n))


def _merge(intervals):
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def _name_gaps(merged, w0, w1, events):
    """Seconds of the longest idle gaps, summed by the innermost host
    event that spans each gap's middle."""
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
            for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
    gaps.sort(reverse=True)
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                  for e in events if e.get("cat") in HOST_CATS
                  and e.get("name") != WINDOW)
    starts = [h[0] for h in host]
    out = defaultdict(float)
    for length, s, t in gaps[:GAPS_NAMED]:
        mid = (s + t) / 2
        i = bisect.bisect_right(starts, mid) - 1
        best = None
        for j in range(i, max(i - 4000, -1), -1):
            hs, he, name = host[j]
            if he >= mid and (best is None or he - hs < best[0]):
                best = (he - hs, name)
        out[best[1] if best else "(host between ops)"] += length
    return out


@contextmanager
def capture(device):
    """Profile the enclosed slice; yields a holder whose ``trace`` is
    set to the reduced :class:`Trace` on exit."""
    from torch.profiler import ProfilerActivity, profile, record_function

    holder = type("Captured", (), {"trace": None})()
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        with profile(activities=acts) as prof:
            with record_function(WINDOW):
                yield holder
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        holder.trace = Trace(events)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
