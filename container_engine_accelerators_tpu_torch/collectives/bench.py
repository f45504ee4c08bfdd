"""NCCL collectives bandwidth rig of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/collectives/bench.py``, the
nccl-tests analog: a message-size sweep (1M -> 512M, x2 a step, 100
iterations after 5 of warm-up by default) of one collective over every
rank of the process group, with nccl-tests' bus-bandwidth accounting:

    all-reduce      busbw = algbw * 2(n-1)/n
    all-gather      busbw = algbw * (n-1)/n      (S = total output bytes)
    reduce-scatter  busbw = algbw * (n-1)/n
    ppermute-ring   busbw = algbw               (point-to-point shift)

One process a GPU, NCCL on the card (``--device cpu``: gloo, for a check
of the wiring; its times are the CPU's):

    torchrun --nproc-per-node N -m \\
        container_engine_accelerators_tpu_torch.collectives.bench \\
        -b 1M -e 512M -f 2 --iters 100 --warmup 5 --op all_reduce \\
        [--percentiles] [--line-rate-gbps G --pass-threshold 0.9] \\
        [--json] [--verdict-json FILE]

Without a launcher it runs on a group of one rank, where every
collective is a local copy and busbw reads 0 by the factor above.  Rank
0 alone prints and writes the verdict; every rank exits with its code.

``--percentiles`` times each round alone as one ``bench.iter`` span
(``obs/trace.py``; op, size and iteration attributes) that also feeds
the ``bench.<op>`` latency histogram, as the JAX rig does.

With ``DCN_UDS_DIR`` in the env each rank mirrors its sweep's bytes
into the node dcnxferd's flow accounting (:class:`DcnBenchAccounting`,
flow ``bench-<op>``; a second rank of one node adds ``.<LOCAL_RANK>``),
so the daemon's ``stats`` see bench traffic like workload traffic.
"""

import argparse
import dataclasses
import json
import logging
import os
import sys
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from container_engine_accelerators_tpu_torch.collectives.synth import (
    bus_factor,
)
from container_engine_accelerators_tpu_torch.obs import trace

log = logging.getLogger(__name__)

OPS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")


@dataclasses.dataclass
class CollectiveResult:
    op: str
    size_bytes: int  # total message size S (nccl-tests convention)
    time_us: float
    alg_bw_gbps: float  # GB/s
    bus_bw_gbps: float
    # Filled only by per-round timing (--percentiles): the tail latency
    # of single rounds, which a mean cannot show.
    p50_us: Optional[float] = None
    p99_us: Optional[float] = None


class DcnBenchAccounting:
    """Mirror sweep traffic into the node dcnxferd's flow accounting.

    When the pod env carries ``DCN_UDS_DIR`` the bench registers a flow
    with the node transfer daemon and records each sweep point's bytes,
    so per-node `stats` (and anything scraping them) sees bench traffic
    exactly like workload traffic.  The client is the *resilient* one:
    a daemon restart mid-sweep reconnects, replays the flow, and the
    sweep finishes.  If the daemon stays gone past the retry budget the
    accounting degrades gracefully — logged once, disabled, bench
    results unaffected.
    """

    # Accounting only: reserve the minimum staging buffer, not the
    # sweep's max message size (the pool belongs to real transfers).
    FLOW_BYTES = 4096

    def __init__(self, client, flow: str):
        self._client = client
        self._flow = flow
        if self._client is not None:
            self._client.register_flow(self._flow, peer="bench",
                                       bytes=self.FLOW_BYTES)

    @classmethod
    def from_env(cls, flow: str) -> "DcnBenchAccounting":
        from container_engine_accelerators_tpu_torch.parallel import dcn
        from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
            DcnXferError,
        )
        from container_engine_accelerators_tpu_torch.utils.retry import RetryPolicy

        client = None
        try:
            # Small budget for the initial probe: optional accounting
            # must not stall bench startup ~30s when the sidecar is
            # down.  Once connected, swap in the full budget so a
            # mid-sweep daemon restart is actually covered.
            client = dcn.make_xfer_client(
                resilient=True,
                retry=RetryPolicy(max_attempts=3, initial_backoff_s=0.1,
                                  max_backoff_s=0.5, deadline_s=2.0),
            )
            acct = cls(client, flow)
            if client is not None:
                from container_engine_accelerators_tpu_torch.parallel.dcn_client \
                    import DEFAULT_DCN_RETRY

                client._retry = DEFAULT_DCN_RETRY
            return acct
        except (DcnXferError, OSError) as e:
            log.error("dcn accounting unavailable: %s", e)
            if client is not None:  # connected but register_flow refused
                try:
                    client.close()
                except OSError:
                    pass
            return cls(None, flow)

    def record(self, result: "CollectiveResult") -> None:
        if self._client is None:
            return
        from container_engine_accelerators_tpu_torch.parallel.dcn_client import (
            DcnXferError,
        )

        try:
            self._client.record_transfer(self._flow, result.size_bytes)
        except (DcnXferError, OSError) as e:
            log.error("dcn accounting disabled after terminal error: %s", e)
            self.close()
            self._client = None

    def close(self) -> None:
        if self._client is not None:
            try:
                self._client.close()
            except OSError:
                pass


def bench_flow(op: str, env=None) -> str:
    """The accounting flow of this rank: ``bench-<op>``, and
    ``bench-<op>.<LOCAL_RANK>`` for a node's further ranks (a flow name
    is one connection's on the daemon)."""
    env = env if env is not None else os.environ
    local = int(env.get("LOCAL_RANK", "0"))
    return f"bench-{op}" if local == 0 else f"bench-{op}.{local}"


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    mult = 1
    if s.endswith("G"):
        mult, s = 2**30, s[:-1]
    elif s.endswith("M"):
        mult, s = 2**20, s[:-1]
    elif s.endswith("K"):
        mult, s = 2**10, s[:-1]
    return int(float(s) * mult)


def make_collective(op: str, group=None) -> Callable:
    """``fn(x, reps)``: ``reps`` chained collectives over ``group`` (None:
    the default group) on this rank's block ``x``, each fed the previous
    one's output, so none can be elided or overlapped (the serialization
    nccl-tests enforces).  Each keeps the local shape, as the JAX rig's
    chained step does: an all-gather slices this rank's chunk back out,
    a reduce-scatter tiles its chunk back to the block.  ``x`` is not
    modified (the all-reduce, which works in place, starts on a copy)."""
    if op not in OPS:
        raise ValueError(f"unknown collective {op!r}")
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if op == "all_reduce":

        def one(c):
            dist.all_reduce(c, group=group)
            return c

    elif op == "all_gather":

        def one(c):
            gathered = c.new_empty((n * c.shape[0],))
            dist.all_gather_into_tensor(gathered, c, group=group)
            return gathered[rank * c.shape[0]:(rank + 1) * c.shape[0]]

    elif op == "reduce_scatter":

        def one(c):
            if c.shape[0] % n:
                raise ValueError(f"reduce_scatter of {c.shape[0]} elements "
                                 f"over {n} ranks")
            scattered = c.new_empty((c.shape[0] // n,))
            dist.reduce_scatter_tensor(scattered, c, group=group)
            return scattered.repeat(n)

    elif n == 1:
        # JAX's perm [(0, 0)]: the block itself.  NCCL cannot send to its
        # own rank, so a local copy stands for the shift.
        def one(c):
            return c.clone()

    else:
        world = group if group is not None else dist.group.WORLD
        to = dist.get_global_rank(world, (rank + 1) % n)
        frm = dist.get_global_rank(world, (rank - 1) % n)

        def one(c):
            out = torch.empty_like(c)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, c, to, group),
                dist.P2POp(dist.irecv, out, frm, group)])
            for r in reqs:
                r.wait()
            return out

    def run(x: torch.Tensor, reps: int) -> torch.Tensor:
        c = x.clone() if op == "all_reduce" else x
        for _ in range(reps):
            c = one(c)
        return c

    return run


def _device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def run_sweep(
    group=None,
    min_bytes: int = 2**20,
    max_bytes: int = 2**29,
    step_factor: int = 2,
    iters: int = 100,
    warmup: int = 5,
    op: str = "all_reduce",
    dtype: torch.dtype = torch.bfloat16,
    on_result: Optional[Callable[[CollectiveResult], None]] = None,
    per_iter: bool = False,
) -> List[CollectiveResult]:
    """Message-size sweep over the ranks of ``group`` (None: the default
    group).  The default timing enqueues ``iters`` chained collectives
    back to back, between two CUDA events on the current stream on the
    card (nccl-tests' own loop: no per-round host wait in the
    measurement), or on the host clock after a barrier under gloo.
    ``per_iter=True`` instead times each round alone, the host's wait
    included, as one ``bench.iter`` span, and reports p50/p99 beside the
    mean."""
    if step_factor < 2:
        raise ValueError(f"step factor must be >= 2, got {step_factor}")
    n = dist.get_world_size(group)
    device = _device(group)
    on_cuda = device.type == "cuda"
    itemsize = torch.empty((), dtype=dtype).element_size()
    fn = make_collective(op, group)

    def sync():
        if on_cuda:
            torch.cuda.synchronize(device)

    results = []
    size = min_bytes
    while size <= max_bytes:
        # nccl-tests accounting: S is the per-rank payload, the buffer each
        # rank holds for all-reduce / reduce-scatter / the shift, and the
        # total gathered output for all-gather, whose block is S/n.
        local_elems = max(1, size // itemsize)
        if op == "all_gather":
            local_elems = max(1, size // itemsize // n)
        x = torch.ones(local_elems, dtype=dtype, device=device)
        fn(x, max(warmup, 1))
        sync()
        dist.barrier(group=group)
        payload_bytes = local_elems * itemsize
        if op == "all_gather":
            payload_bytes *= n
        p50_us = p99_us = None
        if per_iter:
            samples = []
            for i in range(iters):
                with trace.span("bench.iter", histogram=f"bench.{op}",
                                op=op, size_bytes=payload_bytes,
                                iteration=i) as s:
                    fn(x, 1)
                    sync()
                samples.append(s.duration_s)
            dt = sum(samples) / iters
            ordered = sorted(samples)
            p50_us = ordered[len(ordered) // 2] * 1e6
            p99_us = ordered[min(len(ordered) - 1,
                                 int(len(ordered) * 0.99))] * 1e6
        elif on_cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn(x, iters)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
        else:
            t0 = time.perf_counter()
            fn(x, iters)
            dt = (time.perf_counter() - t0) / iters

        alg_bw = payload_bytes / dt / 1e9 if dt > 0 else float("inf")
        result = CollectiveResult(
            op=op,
            size_bytes=payload_bytes,
            time_us=dt * 1e6,
            alg_bw_gbps=alg_bw,
            bus_bw_gbps=alg_bw * bus_factor(op, n),
            p50_us=p50_us,
            p99_us=p99_us,
        )
        results.append(result)
        if on_result is not None:
            on_result(result)
        size *= step_factor
    return results


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="NCCL collectives bandwidth "
                                            "sweep")
    p.add_argument("-b", "--min-bytes", default="1M")
    p.add_argument("-e", "--max-bytes", default="512M")
    p.add_argument("-f", "--step-factor", type=int, default=2)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--op", default="all_reduce", choices=list(OPS))
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument(
        "--percentiles", action="store_true",
        help="time every round alone and report p50/p99 next to the mean; "
             "the host's wait for each round is included, so means run "
             "higher than the default chained-loop timing")
    p.add_argument("--line-rate-gbps", type=float, default=None,
                   help="NVLink / network line rate; enables the "
                        ">=threshold pass bar on the peak busbw")
    p.add_argument("--pass-threshold", type=float, default=0.9)
    p.add_argument("--json", action="store_true",
                   help="one JSON line per size")
    p.add_argument(
        "--verdict-json", default=None, metavar="FILE",
        help="write the whole sweep and the PASS/FAIL verdict as one JSON "
             "document (the artifact a cluster rig uploads)")
    p.add_argument("--device", default="cuda",
                   help="cuda (one GPU a rank, NCCL) or cpu (gloo)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    dtype = getattr(torch, args.dtype, None)
    if not isinstance(dtype, torch.dtype):
        raise SystemExit(f"unknown --dtype {args.dtype!r}")

    from container_engine_accelerators_tpu_torch.parallel import dcn

    owns_group = not dist.is_initialized()
    n, rank = dcn.initialize(device=args.device, force=True)
    acct = DcnBenchAccounting.from_env(bench_flow(args.op))
    try:
        results = run_sweep(
            min_bytes=_parse_size(args.min_bytes),
            max_bytes=_parse_size(args.max_bytes),
            step_factor=args.step_factor,
            iters=args.iters,
            warmup=args.warmup,
            op=args.op,
            dtype=dtype,
            on_result=acct.record,
            per_iter=args.percentiles,
        )
        on_cuda = _device(None).type == "cuda"
        platform = "gpu" if on_cuda else "cpu"
        best = max((r.bus_bw_gbps for r in results), default=0.0)
        ok, frac = True, None
        if args.line_rate_gbps:
            frac = best / args.line_rate_gbps
            ok = frac >= args.pass_threshold
        if rank == 0:
            _report(args, results, n, platform, best, ok, frac, on_cuda)
        if n > 1:
            ok = _agree(ok)
    finally:
        acct.close()
        if owns_group:
            dcn.shutdown()
    return 0 if ok else 1


def _agree(ok: bool) -> bool:
    """Rank 0's verdict on every rank, so they all exit alike."""
    box = [ok]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _report(args, results, n, platform, best, ok, frac, on_cuda):
    print(f"# {args.op} over {n} devices ({platform})")
    tail_hdr = f" {'p50(us)':>10} {'p99(us)':>10}" if args.percentiles else ""
    print(f"# {'bytes':>12} {'time(us)':>12} {'algbw(GB/s)':>12} "
          f"{'busbw(GB/s)':>12}{tail_hdr}")
    for r in results:
        if args.json:
            print(json.dumps(dataclasses.asdict(r)))
        else:
            tail = (f" {r.p50_us:>10.1f} {r.p99_us:>10.1f}"
                    if r.p50_us is not None else "")
            print(f"  {r.size_bytes:>12} {r.time_us:>12.1f} "
                  f"{r.alg_bw_gbps:>12.2f} {r.bus_bw_gbps:>12.2f}{tail}")
    if args.line_rate_gbps:
        print(f"# peak busbw {best:.1f} GB/s = {frac:.1%} of line rate "
              f"{args.line_rate_gbps} GB/s -> {'PASS' if ok else 'FAIL'}")
    if args.verdict_json:
        verdict = {
            "op": args.op,
            "devices": n,
            "platform": platform,
            "device_kind": (torch.cuda.get_device_name() if on_cuda
                            else "cpu"),
            "dtype": args.dtype,
            "iters": args.iters,
            "warmup": args.warmup,
            "results": [dataclasses.asdict(r) for r in results],
            "peak_busbw_gbps": best,
            "line_rate_gbps": args.line_rate_gbps,
            "pass_threshold": args.pass_threshold,
            "line_rate_fraction": frac,
            "pass": ok if args.line_rate_gbps else None,
        }
        with open(args.verdict_json, "w") as f:
            json.dump(verdict, f, indent=1)
            f.write("\n")
    sys.stdout.flush()


if __name__ == "__main__":
    sys.exit(main())
