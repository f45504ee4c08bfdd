#!/usr/bin/env python3
"""Attention microbenchmark: the port's flash kernels against dense
attention — counterpart of ``cmd/bench_attention.py``.

Times the forward and the forward+backward at training shapes on the
card: the flash row is ``ops/flash_attention.py::flash_attention`` (the
hand-written forward, dQ and dK/dV kernels on CUDA tensors, their plain
versions on CPU ones), the yardstick row ``parallel/seq.py::
dense_attention`` (materialized f32 scores), the counterpart of the JAX
tool's ``xla_dense``.

``--blocks``: the port's kernels have their tiles fixed at compile time,
so the flag names the tile of the kernel the run's dtype and head dim
reach (``kernel``, the default: 128x128 for bf16 at D 64 and 128, 128x64
at D 256, and the CUDA-core kernel's 64x64 / 32x32 for f32); the flash
row is named after it.  A spec for any other tile is refused; ``--blocks
""`` runs dense only.  ``--dtype`` (bf16 by default, as the JAX tool's
only dtype) lets a CPU run hold f32 within 1e-5.

Timing discipline (the JAX tool's ``_time_fn``): one distinct query
tensor for each dispatch (3*steps + 1 of them, 64 MiB each at the
default shape, so the sets also overflow the card's 50 MB L2), the
median of three rounds, each ending in a device synchronize.  A row
above the card's peak is flagged ``suspect``.

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.bench_attention \\
      [--seq 4096] [--batch 8] [--heads 16] [--head-dim 64] [--steps 10] \\
      [--check] [--device cuda]
Prints one JSON line per row (and one per checked row) and a table on
stderr.
"""

import argparse
import json
import sys
import time

from container_engine_accelerators_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)

KERNEL_TILE = "kernel"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, or cpu for a smoke run)")
    p.add_argument("--seq", type=int, default=4096)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--heads", type=int, default=16)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--steps", type=int, default=10,
                   help="timed dispatches per round; 3*steps+1 distinct "
                        "query tensors are materialized")
    p.add_argument("--blocks", default=KERNEL_TILE,
                   help="flash QxK tile: the kernel's own (the default, "
                        "'kernel', or its QxK spelled out); any other "
                        "tile is refused.  '' = dense only")
    p.add_argument("--check", action="store_true",
                   help="before timing, compare the flash output and "
                        "grads against dense attention (max abs err)")
    return p.parse_args(argv)


def kernel_tile(dtype: str, head_dim: int):
    """(query rows, keys) of the forward tile the port's kernel compiles
    for ``dtype`` and ``head_dim`` (``ops/csrc/flash_attention_sm90.cu``
    for bf16, ``flash_attention.cu``'s ``Tile<D>`` for f32)."""
    if dtype == "bfloat16":
        return 128, 64 if head_dim == 256 else 128
    rows = 32 if head_dim == 256 else 64
    return rows, rows


def flash_configs(spec: str, dtype: str, head_dim: int):
    """The flash rows ``--blocks`` asks for: [] for "", else the one
    kernel tile; a spec naming another tile raises SystemExit."""
    tile = kernel_tile(dtype, head_dim)
    name = f"{tile[0]}x{tile[1]}"
    specs = [s.strip() for s in spec.split(",") if s.strip()]
    for s in specs:
        if s not in (KERNEL_TILE, name):
            raise SystemExit(
                f"bench_attention: --blocks {s}: the port's {dtype} kernel "
                f"at head dim {head_dim} is compiled for the {name} tile "
                f"alone; pass --blocks {name} (or leave the default)")
    return [f"flash_{name}"] if specs else []


def _time_fn(fn, argsets, steps, dev):
    """Median-of-3 seconds per dispatch of ``steps`` back-to-back
    dispatches, each on its own input set; ``argsets[-1]`` warms up and
    is never timed."""
    assert len(argsets) >= 3 * steps + 1, "need unique inputs per dispatch"
    out = fn(*argsets[-1])
    synchronize(dev)
    times = []
    for r in range(3):
        t0 = time.perf_counter()
        for i in range(steps):
            out = fn(*argsets[r * steps + i])
        synchronize(dev)
        times.append((time.perf_counter() - t0) / steps)
    del out
    return sorted(times)[1]


def main(argv=None):
    args = parse_args(argv)
    import torch

    from container_engine_accelerators_tpu_torch.ops.flash_attention import (
        flash_attention,
    )
    from container_engine_accelerators_tpu_torch.parallel.seq import (
        dense_attention,
    )
    from container_engine_accelerators_tpu_torch.utils.chip import (
        _chip_peak_flops,
    )

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    b, t, h, d = args.batch, args.seq, args.heads, args.head_dim
    flash_names = flash_configs(args.blocks, args.dtype, d)
    n_sets = 3 * args.steps + 1
    # One distinct query tensor for each dispatch; k, v and the output
    # cotangent g are shared.
    nonce = time.time_ns() & 0x7FFFFFFF
    gen = torch.Generator(device=dev).manual_seed(nonce)

    def normal():
        return torch.randn((b, t, h, d), generator=gen, device=dev,
                           dtype=dtype)

    k, v = normal().requires_grad_(), normal().requires_grad_()
    argsets = [(normal().requires_grad_(), k, v) for _ in range(n_sets)]
    g = normal()
    synchronize(dev)

    # Causal attention FLOPs: QK^T + PV, half the square each.
    fwd_flops = 2 * 2 * 0.5 * b * h * t * t * d
    bwd_flops = fwd_flops * 2.5  # dq + dk/dv recompute-based passes

    def attn_of(name):
        if name == "xla_dense":
            return lambda q, k, v: dense_attention(q, k, v, causal=True)
        return lambda q, k, v: flash_attention(q, k, v, causal=True)

    def fwd_of(attn):
        def fwd(q, k, v):
            with torch.no_grad():
                return attn(q, k, v)
        return fwd

    def grad_of(attn):
        def grad(q, k, v):
            loss = (attn(q, k, v).float() * g.float()).sum()
            return torch.autograd.grad(loss, (q, k, v))
        return grad

    configs = flash_names + ["xla_dense"]
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"attention bench: B={b} T={t} H={h} D={d} {args.dtype} ({kind})",
          file=sys.stderr)
    peak_flops, peak_src = _chip_peak_flops(dev, args.dtype)
    peak = peak_flops / 1e12 if peak_src != "default" else None

    # The check runs on the warm-up set (argsets[-1], never timed); the
    # dense reference runs once.
    ref_out = ref_grads = None
    if args.check and flash_names:
        qc, kc, vc = argsets[-1]
        dense = attn_of("xla_dense")
        ref_out = fwd_of(dense)(qc, kc, vc).float()
        ref_grads = [x.float() for x in grad_of(dense)(qc, kc, vc)]

    rows = []
    for name in configs:
        attn = attn_of(name)
        fwd, grad = fwd_of(attn), grad_of(attn)
        checked = False
        if ref_out is not None and name != "xla_dense":
            qc, kc, vc = argsets[-1]
            err_o = float((fwd(qc, kc, vc).float() - ref_out).abs().max())
            errs_g = [float((a.float() - r).abs().max())
                      for a, r in zip(grad(qc, kc, vc), ref_grads)]
            checked = True
            print(json.dumps({
                "config": name, "check_max_abs_err_out": err_o,
                "check_max_abs_err_dqkv": errs_g,
                "check_ref_max_abs_out": float(ref_out.abs().max()),
                "check_ref_max_abs_dqkv": [float(r.abs().max())
                                           for r in ref_grads]}), flush=True)
        tf = _time_fn(fwd, argsets, args.steps, dev)
        tg = _time_fn(grad, argsets, args.steps, dev)
        row = {
            "config": name, "B": b, "T": t, "H": h, "D": d,
            "dtype": args.dtype,
            "fwd_ms": round(tf * 1e3, 3),
            "fwd_tflops": round(fwd_flops / tf / 1e12, 2),
            "fwdbwd_ms": round(tg * 1e3, 3),
            "fwdbwd_tflops": round((fwd_flops + bwd_flops) / tg / 1e12, 2),
        }
        if name != "xla_dense":
            # The flash op calls this row made, check included: one
            # forward a forward dispatch; one forward, one dQ and one
            # dK/dV a forward+backward dispatch.
            row["flash_calls"] = {
                "flash_attention_fwd": 2 * n_sets + 2 * checked,
                "flash_attention_bwd_dq": n_sets + checked,
                "flash_attention_bwd_dkv": n_sets + checked}
        if peak is not None and (
                row["fwd_tflops"] > peak or row["fwdbwd_tflops"] > peak):
            row["suspect"] = "exceeds the card's peak; not synchronized"
        rows.append(row)
        print(json.dumps(row), flush=True)

    width = max(len(r["config"]) for r in rows)
    print(f"\n{'config':<{width}}  fwd ms  fwd TF/s  fwd+bwd ms  fwd+bwd TF/s",
          file=sys.stderr)
    for r in rows:
        print(f"{r['config']:<{width}}  {r['fwd_ms']:6.2f}  "
              f"{r['fwd_tflops']:8.2f}  {r['fwdbwd_ms']:10.2f}  "
              f"{r['fwdbwd_tflops']:12.2f}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
