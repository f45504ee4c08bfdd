#!/usr/bin/env python3
"""Micro-benchmark: seconds-scale evidence of the card's three rates —
counterpart of ``cmd/bench_micro.py``.

- ``micro_h2d_gbps``            — 64 MiB host->device copy from a
  pageable numpy array (``.to(device)``, as ``jax.device_put``); no
  peak is claimed, ``vs_baseline`` = 0.0;
- ``micro_hbm_copy_gbps``       — ``x + i`` over 256 MiB of f32, one read
  and one write an iteration; ``vs_baseline`` = share of the card's HBM
  bandwidth (``utils/chip.py``);
- ``micro_matmul_bf16_tflops``  — ``((x + i) @ y).sum(dtype=float32)``
  at 4096^3 bf16; ``vs_baseline`` = share of the card's dense bf16 peak.
  ``torch.matmul`` is cuBLAS here, as the JAX tool's dot is XLA's: a
  measure of the card, not of a port kernel.

Every timed iteration gets a distinct scalar, only the newest output is
held, and the clock stops after a device synchronize.  A share above
1.0 on the card raises (``utils/chip.py::_validate_utilization``) instead
of being reported.  Each result is printed as soon as it exists, one JSON
line each; nothing is written to disk (the JAX tool's BENCH_TPU_LOG and
its ``--force-log`` have no counterpart).

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.bench_micro \\
      [--device cuda] [--matmul-dim 4096] [--copy-mib 256] [--h2d-mib 64]
"""

import argparse
import json
import sys
import time

from container_engine_accelerators_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)


def _mark(t0, msg):
    print(f"bench_micro: [{time.monotonic() - t0:7.1f}s] {msg}",
          file=sys.stderr, flush=True)


def _sig4(x):
    """4 significant figures (fixed-decimal rounding zeroes out tiny
    smoke runs)."""
    return float(f"{x:.4g}")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, or cpu for a smoke run)")
    p.add_argument("--matmul-dim", type=int, default=4096)
    p.add_argument("--copy-mib", type=int, default=256)
    p.add_argument("--h2d-mib", type=int, default=64)
    p.add_argument("--iters", type=int, default=32)
    return p.parse_args(argv)


def _timed_loop(fn, iters, dev):
    """Dispatch ``fn(i)`` for distinct i, synchronize, return seconds.
    Only the newest output is held: the card runs one stream in order,
    so the synchronize waits for every dispatch, and device memory holds
    about one output instead of ``iters``."""
    out = None
    t0 = time.perf_counter()
    for i in range(iters):
        out = fn(i)
    synchronize(dev)
    del out
    return time.perf_counter() - t0


def run_micro(args):
    """Measure the three metrics; yield each result dict as soon as it
    exists."""
    import numpy as np
    import torch

    from container_engine_accelerators_tpu_torch.utils.chip import (
        _chip_hbm_bw,
        _chip_peak_flops,
        _validate_utilization,
    )

    t_start = time.monotonic()
    dev = resolve_device(args.device)
    on_accel = dev.type == "cuda"
    torch.empty(1, device=dev)  # the context and the allocator up
    synchronize(dev)
    init_s = round(time.monotonic() - t_start, 1)
    kind = torch.cuda.get_device_name(dev) if on_accel else "cpu"
    _mark(t_start, f"device up: {kind} (init {init_s}s)")

    rng = np.random.default_rng(time.time_ns() % 2**31)

    # --- host -> device from pageable memory ---------------------------
    nbytes = args.h2d_mib * (1 << 20)
    host = torch.from_numpy(rng.random(nbytes // 4, dtype=np.float32))
    host.to(dev, copy=True)  # warm the path
    synchronize(dev)
    reps = 4
    t0 = time.perf_counter()
    for _ in range(reps):
        host.to(dev, copy=True)
        synchronize(dev)
    h2d_gbps = reps * nbytes / (time.perf_counter() - t0) / 1e9
    yield {
        "metric": "micro_h2d_gbps", "value": _sig4(h2d_gbps),
        "unit": "GB/s", "vs_baseline": 0.0, "mib": args.h2d_mib,
        "note": "host->device from pageable host memory; measures the "
                "host's copy and the link, no card peak claimed",
        "init_s": init_s,
    }
    _mark(t_start, f"h2d {h2d_gbps:.2f} GB/s")

    # --- HBM streaming copy ---------------------------------------------
    n = args.copy_mib * (1 << 20) // 4
    a = torch.from_numpy(rng.random(n, dtype=np.float32)).to(dev)
    t0 = time.perf_counter()
    out = a + 1.0  # warm-up
    synchronize(dev)
    del out
    copy_warm_s = round(time.perf_counter() - t0, 1)
    dt = _timed_loop(lambda i: a + float(i), args.iters, dev)
    moved = 2 * a.numel() * a.element_size() * args.iters
    hbm_gbps = moved / dt / 1e9
    bw, bw_src = _chip_hbm_bw(dev)
    frac = _validate_utilization(hbm_gbps * 1e9 / bw, "HBM fraction",
                                 "HBM bandwidth", on_accel)
    yield {
        "metric": "micro_hbm_copy_gbps", "value": _sig4(hbm_gbps),
        "unit": "GB/s", "vs_baseline": round(frac, 4),
        "mib": args.copy_mib, "iters": args.iters,
        "hbm_bw_source": bw_src, "compile_s": copy_warm_s,
    }
    _mark(t_start, f"hbm copy {hbm_gbps:.1f} GB/s ({frac:.0%} of peak)")
    del a

    # --- bf16 matmul ------------------------------------------------------
    d = args.matmul_dim
    lhs = torch.from_numpy(rng.random((d, d), dtype=np.float32)).to(
        dev, torch.bfloat16)
    rhs = torch.from_numpy(rng.random((d, d), dtype=np.float32)).to(
        dev, torch.bfloat16)

    def mm(i):
        return ((lhs + i) @ rhs).sum(dtype=torch.float32)

    t0 = time.perf_counter()
    mm(1)  # warm-up: the library's handle and its kernel choice
    synchronize(dev)
    mm_warm_s = round(time.perf_counter() - t0, 1)
    # i <= 256 is exact in bf16, so every iteration's operand differs.
    dt = _timed_loop(mm, args.iters, dev)
    flops = 2 * d ** 3 * args.iters
    tflops = flops / dt / 1e12
    peak, peak_src = _chip_peak_flops(dev, "bfloat16")
    frac = _validate_utilization(tflops * 1e12 / peak, "matmul MFU",
                                 "the card's peak", on_accel)
    yield {
        "metric": "micro_matmul_bf16_tflops", "value": _sig4(tflops),
        "unit": "TFLOP/s", "vs_baseline": round(frac, 4), "dim": d,
        "iters": args.iters, "peak_source": peak_src,
        "compile_s": mm_warm_s,
    }
    _mark(t_start, f"matmul {tflops:.1f} TFLOP/s ({frac:.0%} of peak)")


def main(argv=None):
    args = parse_args(argv)
    for result in run_micro(args):
        print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
