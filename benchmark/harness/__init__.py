"""The benchmark's harness: one run of one cell.

:func:`run_cell` looks the cell up in the manifest, hands its
configuration and traffic mix to the runner of the mix's ``kind``
(``harness/train.py``, ``harness/serve.py``), which sets the program up,
measures the window, reads the device's peak memory, frees the program
and then checks what the window produced against the plain reference.
The metric readers (``metrics/<name>.py``) then turn the runner's
:class:`Record` into the result's metrics, and the cell's limits
(``limits/<cell>.json``) into ``correct``.
"""

import time
from collections import defaultdict

import torch

from harness.manifest import Manifest


def clock() -> float:
    return time.perf_counter()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free_device(device) -> None:
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Record:
    """What one run measured, for the metric readers: the set-up and
    window seconds (host clock), counters of the work done in the
    window, host spans and samples by name, the peak memory, and with
    ``--trace 1`` the reduced trace (``harness/tracing.py``) and what
    the runner noted about the traced iterations."""

    def __init__(self, cell: str, cfg: dict, mix: dict):
        self.cell, self.cfg, self.mix = cell, cfg, mix
        self.setup_s = None
        self.window_s = None
        self.memory_peak_bytes = None
        self.counters = defaultdict(float)
        self.spans = defaultdict(list)
        self.samples = defaultdict(list)
        self.trace = None
        self.trace_info = defaultdict(list)
        self.attempted = 0
        self.failed = 0


class Context:
    """What a runner gets: the cell's files, the run's arguments and the
    record to fill."""

    def __init__(self, manifest: Manifest, cell: str, seed: int,
                 seconds: float, trace: bool, device, t_start: float,
                 control: bool = False):
        self.manifest = manifest
        self.cell = manifest.cell(cell)
        self.cfg = manifest.config(self.cell["config"])
        self.mix = manifest.mix(self.cell["traffic"])
        self.seed, self.seconds, self.trace = int(seed), seconds, trace
        self.device = torch.device(device)
        self.t_start = t_start
        self.control = control
        self.record = Record(cell, self.cfg, self.mix)

    def reference(self):
        return self.manifest.reference(self.cfg["architecture"])


def judge(numbers: dict, limits: dict) -> dict:
    """Each number beside its limit; a number with no limit set fails,
    and one the cell's limits file marks ``not_compared`` (no reading
    separates it from sound runs) is reported and never fails."""
    out = {}
    for name, value in numbers.items():
        entry = limits.get(name, {})
        limit = entry.get("limit")
        ok = ("not_compared" in entry
              or (limit is not None and value <= limit))
        out[name] = {"value": value, "limit": limit, "ok": ok}
    return out


def run_cell(manifest: Manifest, cell: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False):
    """One run of ``cell``: the result object (without ``device``'s card
    fields, which :mod:`run` adds) and the record."""
    ctx = Context(manifest, cell, seed, seconds, trace, device, t_start,
                  control)
    runner = manifest.runner(ctx.mix["kind"])
    numbers, control_numbers = runner.run(ctx)
    rec = ctx.record
    limits = manifest.limits(cell)
    checks = judge(numbers, limits)
    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_for(cell, group):
        value = manifest.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": all(c["ok"] for c in checks.values()) and not rec.failed,
        "attempted": rec.attempted,
        "failed": rec.failed,
        "metrics": metrics,
        "device": {"memory_peak_bytes": rec.memory_peak_bytes},
    }
    if trace and rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s,
                                window_s=rec.trace.window_s)
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    if control:
        result["control"] = judge(control_numbers, limits)
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result, rec
