#!/usr/bin/env python3
"""Hold the analytic roofline against one real profiler trace —
counterpart of ``cmd/roofline_check.py``.

1. build the ResNet-50 train step (``models/train.py::train_step``, bf16,
   ``channels_last``), time real steps over 4 rotating device batches,
   and trace a few of them with ``torch.profiler``;
2. sum the trace's device time by kernel (``cmd/trace_summary.py``);
3. compare the measured step with the analytic floor ``t_floor =
   max(flops/peak, bytes/hbm_bw)`` (``cmd/roofline_resnet.py``'s counts,
   ``utils/chip.py``'s card figures) and split the device time between
   tensor-core kernels and everything else.

Verdicts (``roofline_verdict``), the JAX tool's thresholds:

- ``model-confirmed-headroom`` — step >= 1.25x the floor AND non-tensor-
  core kernels hold >= 25% of device time: the headroom is in the kernels
  around the convolutions (batch norm, element-wise), the ones to fuse;
- ``mxu-bound-headroom`` — step >= 1.25x the floor but tensor-core
  kernels dominate: the headroom is inside the convolutions;
- ``model-refuted-near-ceiling`` — step within 1.25x of the floor.

(``mxu_*`` keep the JAX tool's field names; here they are the tensor-core
kernels.)  The timed steps run outside the profiler.  The result is one
JSON line on stdout; ``--out PATH`` also writes it to PATH, and nothing
is written otherwise.

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.roofline_check \\
      [--steps 30] [--profile-steps 8] [--device cuda] [--out PATH]
"""

import argparse
import contextlib
import io
import json
import re
import shutil
import sys
import tempfile
import time

from container_engine_accelerators_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)

# Kernels whose device time is tensor-core work, by name (lower case),
# read from a traced ResNet-50 step on an H100 (torch 2.11, CUDA 12.8):
# the convolutions are cuDNN's ``sm90_xmma_{fprop,dgrad,wgrad}_*
# implicit_gemm_*`` and ``cutlass__5x_cudnn::Kernel<...s16816fprop...>`` /
# ``...ImplicitGemmConvolution...``; the 1x1 convolutions the port runs
# as GEMMs and the head are cuBLAS's ``nvjet_tst_*`` and
# ``cutlass_80_tensorop_*s16816gemm*``.  Batch norm, element-wise,
# pools, copies, cuDNN's padding, cuBLAS's split-K reduction and the
# optimizer are "other", and so are cuDNN's workspace fill, whose name
# carries "xmma" and "implicit_gemm", and the f32 head's CUDA-core GEMMs
# (``sgemm_*``, ``*_ffma_*``) (``NOT_TENSOR_CORE``).  A tensor-core
# kernel this list misses counts as "other" and biases the verdict
# toward "model-confirmed-headroom".
TENSOR_CORE_PATTERNS = (
    "xmma", "gemm", "cutlass", "nvjet", "fprop", "dgrad", "wgrad",
)
NOT_TENSOR_CORE = ("init_device_workspace", "sgemm", "ffma")
_TENSOR_CORE_RE = re.compile("|".join(map(re.escape, TENSOR_CORE_PATTERNS)))
_NOT_TENSOR_CORE_RE = re.compile("|".join(map(re.escape, NOT_TENSOR_CORE)))

RATIO_NEAR_CEILING = 1.25
TENSOR_CORE_DOMINANT = 0.75


def is_tensor_core(kernel_name: str) -> bool:
    """True for a kernel the step's tensor-core work runs in."""
    name = kernel_name.lower()
    return (_TENSOR_CORE_RE.search(name) is not None
            and _NOT_TENSOR_CORE_RE.search(name) is None)


def split_device_time(ops):
    """(tensor-core ms, every-other ms) over trace_summary's ``ops``."""
    tc = sum(o["ms"] for o in ops if is_tensor_core(o["name"]))
    return tc, sum(o["ms"] for o in ops) - tc


def verdict_of(ratio, tc_frac):
    if ratio < RATIO_NEAR_CEILING:
        return "model-refuted-near-ceiling"
    if tc_frac < TENSOR_CORE_DOMINANT:
        return "model-confirmed-headroom"
    return "mxu-bound-headroom"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, or cpu for a smoke run)")
    p.add_argument("--batch", type=int, default=None,
                   help="default: 128 on the card, 8 CPU smoke")
    p.add_argument("--steps", type=int, default=None,
                   help="timed steps (default 30 card / 2 smoke)")
    p.add_argument("--profile-steps", type=int, default=None,
                   help="steps inside the trace (default 8 card / 1)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--out", default=None,
                   help="also write the verdict JSON to this path")
    return p.parse_args(argv)


def run_check(args):
    from container_engine_accelerators_tpu_torch.cmd.roofline_resnet import (
        TRAIN_FLOPS_FACTOR,
        _bytes_of,
        analytic_counts,
        build_state,
        synthetic_batches,
    )
    from container_engine_accelerators_tpu_torch.cmd.trace_summary import (
        summarize,
    )
    from container_engine_accelerators_tpu_torch.models.train import (
        train_step,
    )
    from container_engine_accelerators_tpu_torch.utils.chip import (
        _chip_hbm_bw,
        _chip_peak_flops,
        _validate_utilization,
    )
    from container_engine_accelerators_tpu_torch.utils.profile import (
        ProfileWindow,
    )

    dev = resolve_device(args.device)
    on_accel = dev.type == "cuda"
    batch = args.batch or (128 if on_accel else 8)
    steps = args.steps or (30 if on_accel else 2)
    prof_steps = args.profile_steps or (8 if on_accel else 1)
    size = args.image_size or (224 if on_accel else 64)
    peak, peak_src = _chip_peak_flops(dev, "bfloat16")
    bw, _ = _chip_hbm_bw(dev)

    state = build_state(50, dev)
    nonce = time.time_ns() & 0x7FFFFFFF
    xs, ys = synthetic_batches(batch, size, dev, nonce)
    fwd_flops, act_elems, p_elems = analytic_counts(state.model, xs[0])
    flops = TRAIN_FLOPS_FACTOR * fwd_flops
    model_bytes = _bytes_of(act_elems, p_elems)

    st, m = train_step(state, xs[0], ys[0])
    for i in range(3):
        st, m = train_step(st, xs[i % 4], ys[i % 4])
    float(m["loss"])  # drain the warm-up

    prof_dir = tempfile.mkdtemp(prefix="roofline_check_")
    try:
        t0 = time.perf_counter()
        window = ProfileWindow(prof_dir, dev, "roofline_check")
        for i in range(prof_steps):
            with ProfileWindow.step(i):
                st, m = train_step(st, xs[i % 4], ys[i % 4])
        float(m["loss"])
        window.stop()
        t_prof = time.perf_counter() - t0

        # Timed OUTSIDE the profiler: tracing must not inflate the step
        # the verdict judges.
        t0 = time.perf_counter()
        for i in range(steps):
            st, m = train_step(st, xs[i % 4], ys[i % 4])
        final_loss = float(m["loss"])
        synchronize(dev)
        step_s = (time.perf_counter() - t0) / steps

        # Every op, not a top-N cut: time past a cut would count as
        # "other" and bias the verdict.  The summary's table goes to
        # stderr; its own JSON line is dropped (the result carries it).
        with contextlib.redirect_stdout(io.StringIO()):
            trace = summarize(window.path, top=100_000)
    finally:
        shutil.rmtree(prof_dir, ignore_errors=True)
    device_ms = trace["device_ms"]
    tc_ms, other_ms = split_device_time(trace["ops"])
    tc_frac = tc_ms / max(device_ms, 1e-9)

    t_compute = flops / peak
    t_memory = model_bytes / bw
    t_floor = max(t_compute, t_memory)
    # A step faster than the hardware floor did not run what it claims.
    _validate_utilization(t_floor / step_s, "roofline floor fraction",
                          "the hardware floor", on_accel)
    ratio = step_s / t_floor
    return {
        "metric": "roofline_check_resnet50_step_ms",
        "value": round(step_s * 1e3, 2),
        "unit": "ms/step",
        "vs_baseline": round(ratio, 3),
        "roofline_verdict": verdict_of(ratio, tc_frac),
        "batch": batch, "image_size": size, "steps": steps,
        "profiled_steps": prof_steps,
        "profiled_wall_s": round(t_prof, 2),
        "flops_per_step_T": round(flops / 1e12, 3),
        "flops_model": "analytic: 3 x forward",
        "model_bytes_G": round(model_bytes / 1e9, 3),
        "t_floor_ms": round(t_floor * 1e3, 2),
        "t_compute_ms": round(t_compute * 1e3, 2),
        "t_memory_ms": round(t_memory * 1e3, 2),
        "device_total_ms": device_ms,
        "traced_steps": trace["steps"],
        "busy_share": trace["busy_share"],
        "mxu_ms": round(tc_ms, 3),
        "other_ms": round(other_ms, 3),
        "mxu_frac": round(tc_frac, 4),
        "tensor_core_patterns": list(TENSOR_CORE_PATTERNS),
        "top_ops": [{"op": o["name"], "ms": o["ms"],
                     "launches": o["launches"],
                     "tensor_core": is_tensor_core(o["name"])}
                    for o in trace["ops"][:8]],
        "final_loss": round(final_loss, 4),
        "peak_source": peak_src,
        "nonce": nonce,
    }


def main(argv=None):
    args = parse_args(argv)
    result = run_check(args)
    if args.out:
        try:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        except OSError as e:
            print(f"roofline_check: could not write {args.out}: {e}",
                  file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
