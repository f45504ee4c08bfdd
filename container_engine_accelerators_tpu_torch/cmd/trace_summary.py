#!/usr/bin/env python3
"""Summarize a ``torch.profiler`` trace of the port: where does the time
go?  Counterpart of ``cmd/trace_summary.py``, which reads the JAX
profiler's XLA traces.

Reads a Chrome trace (``*.pt.trace.json``, as ``cmd/train_lm.py
--profile-dir`` writes it; a directory means its newest one) and sums the
device's work — kernels, copies and memsets — by name: milliseconds and
launches.  The busy share is the time the device was busy (the union of
its intervals) over the trace's window (first event start to last event
end).  ``ProfilerStep#<n>`` annotations count the traced steps.  A trace
without device events (a CPU run) gives device time 0 and a busy share of
null.

The program's own ranges (``lm.*`` ``cpu_op`` events, opened by
``utils/profile.py::span``: ``lm.train.forward``, ``lm.train.backward``,
``lm.train.optimizer``, ``lm.engine.step.dispatch``, ...) each get the
device work they launched: a device operation belongs, through its
runtime call's correlation id, to the innermost range that contains the
launch.  ``ranges`` gives each range's count, device ms and launches.

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.trace_summary \\
      <profile-dir-or-trace.json> [--top 30]
Prints a human table on stderr, then one JSON line on stdout.
"""

import argparse
import glob
import json
import os
import sys
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP_PREFIX = "ProfilerStep#"
RANGE_PREFIX = "lm."


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("path", help="profile dir or one *.pt.trace.json file")
    p.add_argument("--top", type=int, default=30)
    return p.parse_args(argv)


def find_trace(path: str) -> str:
    if not os.path.isdir(path):
        return path
    files = glob.glob(os.path.join(path, "**", "*.pt.trace.json"),
                      recursive=True)
    if not files:
        raise SystemExit(f"no *.pt.trace.json under {path}")
    return max(files, key=os.path.getmtime)  # newest capture


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def by_range(spans) -> dict:
    """Count, device ms and launches of each program range, every device
    operation given to the innermost range around its launch."""
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans
                    if e.get("cat") == "cpu_op"
                    and e["name"].startswith(RANGE_PREFIX))
    out = {}
    for _, _, name in ranges:
        out.setdefault(name, {"n": 0, "ms": 0.0, "launches": 0})["n"] += 1
    launch = {e["args"]["correlation"]: e["ts"] for e in spans
              if e.get("cat") in LAUNCH_CATS
              and "correlation" in e.get("args", {})}
    ops = sorted((launch[c], e["dur"]) for e in spans
                 if e.get("cat") in DEVICE_CATS
                 and (c := e.get("args", {}).get("correlation")) in launch)
    active, i = [], 0
    for ts, dur in ops:
        while i < len(ranges) and ranges[i][0] <= ts:
            active.append(ranges[i])
            i += 1
        active = [r for r in active if r[1] >= ts]
        if active:  # nested ranges: the latest start is the innermost
            row = out[active[-1][2]]
            row["ms"] += dur / 1e3
            row["launches"] += 1
    return out


def summarize(path: str, top: int = 30) -> dict:
    trace = find_trace(path)
    with open(trace) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window_us = (max(e["ts"] + e["dur"] for e in spans)
                 - min(e["ts"] for e in spans)) if spans else 0.0
    per_us, launches = defaultdict(float), defaultdict(int)
    intervals = []
    for e in spans:
        if e.get("cat") in DEVICE_CATS:
            per_us[e["name"]] += e["dur"]
            launches[e["name"]] += 1
            intervals.append((e["ts"], e["ts"] + e["dur"]))
    steps = sum(1 for e in spans if e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(STEP_PREFIX))
    device_us = sum(per_us.values())
    busy_us = _busy_us(intervals)

    rows = sorted(per_us.items(), key=lambda kv: -kv[1])[:top]
    width = min(max((len(n) for n, _ in rows), default=10), 70)
    print(f"{'device op':<{width}}  {'ms':>10}  {'launches':>8}  {'%':>6}",
          file=sys.stderr)
    for name, us in rows:
        print(f"{name[:width]:<{width}}  {us / 1e3:10.3f}  "
              f"{launches[name]:8d}  {100 * us / device_us:6.2f}",
              file=sys.stderr)
    ranges = by_range(spans)
    if ranges:
        rw = max(len(n) for n in ranges)
        print(f"\n{'program range':<{rw}}  {'n':>6}  {'device ms':>10}  "
              f"{'launches':>8}", file=sys.stderr)
        for name, r in sorted(ranges.items()):
            print(f"{name:<{rw}}  {r['n']:6d}  {r['ms']:10.3f}  "
                  f"{r['launches']:8d}", file=sys.stderr)
    summary = {
        "trace": trace,
        "window_ms": window_us / 1e3,
        "steps": steps,
        "device_ms": device_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "busy_share": busy_us / window_us if intervals else None,
        "device_ms_per_step": (device_us / 1e3 / steps
                               if steps and intervals else None),
        "launches": sum(launches.values()),
        "ops": [{"name": n, "ms": us / 1e3, "launches": launches[n],
                 "pct": 100 * us / device_us} for n, us in rows],
        "ranges": ranges,
    }
    print(json.dumps(summary))
    return summary


def main(argv=None):
    args = parse_args(argv)
    summarize(args.path, args.top)


if __name__ == "__main__":
    main()
