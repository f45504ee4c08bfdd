"""Ring-attention layout microbenchmark — PyTorch counterpart of
``cmd/bench_ring.py``: contiguous against zigzag causal ring attention.

Times the port's causal ``ring_attention`` (``parallel/seq.py``: its
blocks on the flash-attention kernels on the card) over every rank of
the process group in both layouts, forward only as the JAX bench does,
and prints the measured contiguous / zigzag ratio beside
``ring_skip_stats``' analytic critical-path ratio (closed form
4n/(2n+1), about 2).  Each layout runs over distinct query sets, none
repeated within a round, median of three rounds, every rank
synchronized (a barrier) before the clock stops.

Launch one process a GPU:

    torchrun --nproc-per-node N -m \\
        container_engine_accelerators_tpu_torch.cmd.bench_ring --seq 16384

(``--device cpu`` runs it on gloo ranks, for a check of the wiring; its
times are the CPU's.)  Rank 0 prints one JSON line:
``{"metric": "ring_zigzag_speedup", "value": contiguous_s / zigzag_s,
"predicted": ..., "device": ..., ...}``.
"""

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (one GPU a rank, NCCL) or cpu (gloo)")
    p.add_argument("--seq", type=int, default=16384, help="GLOBAL seq len")
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check", action="store_true",
                   help="also verify both layouts agree numerically")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import dcn
    from container_engine_accelerators_tpu_torch.parallel.seq import (
        from_zigzag,
        ring_attention,
        ring_skip_stats,
        to_zigzag,
    )

    n, rank = dcn.initialize(device=args.device, force=True)
    try:
        if args.seq % (2 * n):
            raise SystemExit(f"--seq must divide by 2*{n}")
        device = dcn.local_device(args.device)
        on_cuda = device.type == "cuda"
        dtype = torch.bfloat16 if on_cuda else torch.float32

        def sync():
            if on_cuda:
                torch.cuda.synchronize(device)
            dist.barrier()

        # Every rank draws the same global tensors from the seed and keeps
        # its shard: one distinct Q per timed call, shared K/V.
        gen = torch.Generator().manual_seed(args.seed)
        shape = (args.batch, args.seq, args.heads, args.head_dim)
        k, v = (torch.randn(shape, generator=gen) for _ in range(2))
        n_sets = 3 * args.iters + 1  # the last: warm-up and check only
        qs = [torch.randn(shape, generator=gen) for _ in range(n_sets)]
        width = args.seq // n
        cols = slice(rank * width, (rank + 1) * width)

        def shard(x, layout):
            x = to_zigzag(x, n) if layout == "zigzag" else x
            return x[:, cols].contiguous().to(device, dtype)

        results, outs = {}, {}
        for layout in ("contiguous", "zigzag"):
            kk, vv = shard(k, layout), shard(v, layout)
            argsets = [(shard(q, layout), kk, vv) for q in qs]

            def call(q, k_, v_):
                return ring_attention(q, k_, v_, causal=True, layout=layout)

            for _ in range(args.warmup):
                out = call(*argsets[-1])
            sync()
            times = []
            for r in range(3):
                t0 = time.perf_counter()
                for i in range(args.iters):
                    out = call(*argsets[r * args.iters + i])
                sync()
                times.append((time.perf_counter() - t0) / args.iters)
            results[layout] = sorted(times)[1]
            out = call(*argsets[-1]).float()
            parts = [torch.empty_like(out) for _ in range(n)]
            dist.all_gather(parts, out)
            whole = torch.cat(parts, 1)
            outs[layout] = (from_zigzag(whole, n) if layout == "zigzag"
                            else whole)
            if rank == 0:
                print(f"bench_ring: {layout:10s} "
                      f"{results[layout] * 1e3:8.3f} ms/iter median-of-3",
                      file=sys.stderr)
        err = (outs["contiguous"] - outs["zigzag"]).abs().max().item()
        if args.check and err >= 0.05:
            raise SystemExit(f"layouts disagree: {err}")
        stats_c = ring_skip_stats(args.seq, n, "contiguous")
        stats_z = ring_skip_stats(args.seq, n, "zigzag")
        predicted = stats_c["critical"] / stats_z["critical"]
        speedup = results["contiguous"] / results["zigzag"]
        if rank == 0:
            print(json.dumps({
                "metric": "ring_zigzag_speedup", "value": speedup,
                "unit": "x (contiguous/zigzag wall clock)",
                "predicted": predicted, "vs_predicted": speedup / predicted,
                "seq": args.seq, "devices": n, "dtype": str(dtype),
                "contiguous_ms": results["contiguous"] * 1e3,
                "zigzag_ms": results["zigzag"] * 1e3,
                "layout_max_abs_diff": err,
                "device": (torch.cuda.get_device_name(device) if on_cuda
                           else "cpu")}))
    finally:
        dcn.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
