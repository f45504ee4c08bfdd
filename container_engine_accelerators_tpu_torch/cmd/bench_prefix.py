#!/usr/bin/env python3
"""Prefix-cache TTFT benchmark: full prefill against a spliced prefix
and a suffix prefill — counterpart of ``cmd/bench_prefix.py``.

A request fronted by a long shared system prompt pays prefill ~
prefix+suffix on the plain path and ~ suffix after one cache hit
(``models/prefix_cache.py``).  This tool times both paths on the device
at serving shapes and prints one JSON line each:

  prefix_ttft_full_ms    — ``generate()`` over the concatenated prompt
  prefix_ttft_cached_ms  — ``generate_with_prefix()`` with a hot entry;
                           ``vs_baseline`` = full/cached speedup, and
                           ``tokens_match_full`` says whether the cached
                           call's tokens equal the full call's

Defaults by device: on the card prefix 1920, suffix 64, 20 calls, 12
layers, 16x64 heads, mlp 4096, vocab 32768 (bf16, random weights from
seed 0); on the CPU the JAX tool's smoke sizes.  The prefix is fixed, as
the cache premise says; every timed call takes a fresh suffix and is
synchronized (TTFT is latency).  Nothing is written to disk.

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.bench_prefix \\
      [--device cuda] [--calls 20]
"""

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, or cpu for a smoke run)")
    p.add_argument("--prefix-len", type=int, default=0,
                   help="0 = device default (1920 card / 12 cpu)")
    p.add_argument("--suffix-len", type=int, default=0,
                   help="0 = device default (64 card / 4 cpu)")
    p.add_argument("--max-new", type=int, default=1,
                   help="1 isolates TTFT; raise to amortize decode")
    p.add_argument("--calls", type=int, default=0,
                   help="timed calls per path (0 = device default)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )
    from container_engine_accelerators_tpu_torch.models.prefix_cache import (
        PrefixCache,
        generate_with_prefix,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(args.device)
    on_accel = dev.type == "cuda"
    pfx = args.prefix_len or (1920 if on_accel else 12)
    suf = args.suffix_len or (64 if on_accel else 4)
    calls = args.calls or (20 if on_accel else 2)
    lm_kw = dict(
        vocab_size=32_768 if on_accel else 128,
        num_layers=12 if on_accel else 2,
        num_heads=16 if on_accel else 4,
        head_dim=64 if on_accel else 8,
        mlp_dim=4096 if on_accel else 32,
    )
    model = TransformerLM(**lm_kw, decode=True, device=dev)
    model.load_state_dict(init_params(
        TransformerLM(**lm_kw, decode=True, device="meta"),
        torch.Generator().manual_seed(0)))
    model.eval()

    nonce = time.time_ns() & 0x7FFFFFFF
    vocab = lm_kw["vocab_size"]
    prefix_ids = tuple(torch.randint(
        0, vocab, (pfx,), generator=torch.Generator().manual_seed(7)).tolist())
    gen = torch.Generator().manual_seed(nonce)
    suffixes = [torch.randint(0, vocab, (1, suf), generator=gen).to(dev)
                for _ in range(calls + 1)]
    prefix_arr = torch.tensor([list(prefix_ids)], dtype=torch.long,
                              device=dev)

    def run_full(sfx):
        return generate(model, torch.cat([prefix_arr, sfx], dim=1),
                        args.max_new)[:, pfx:]

    cache = PrefixCache(model, max_prefix_len=pfx)
    with torch.inference_mode():
        kv, plen = cache.get_or_build(prefix_ids)  # the one-time build

    def run_cached(sfx):
        return generate_with_prefix(model, kv, plen, sfx, args.max_new)

    results, tokens = [], {}
    with torch.inference_mode():
        for name, fn in (("full", run_full), ("cached", run_cached)):
            out = fn(suffixes[-1])
            tokens[name] = out[0, suf:].tolist()  # warm-up + synchronize
            t0 = time.perf_counter()
            for i in range(calls):
                out = fn(suffixes[i])
                int(out[0, -1])  # synchronize each call: TTFT is latency
            dt = time.perf_counter() - t0
            results.append((name, dt / calls * 1e3))

    full_ms = dict(results)["full"]
    cached_ms = dict(results)["cached"]
    for name, ms in results:
        entry = {
            "metric": f"prefix_ttft_{name}_ms",
            "value": round(ms, 3),
            "unit": "ms",
            "vs_baseline": (round(full_ms / cached_ms, 3)
                            if name == "cached" else 1.0),
            "prefix_len": pfx, "suffix_len": suf,
            "max_new": args.max_new, "calls": calls, "nonce": nonce,
        }
        if name == "cached":
            entry["tokens_match_full"] = tokens["cached"] == tokens["full"]
        print(json.dumps(entry), flush=True)
    print(f"bench_prefix: full {full_ms:.1f} ms vs cached "
          f"{cached_ms:.1f} ms -> {full_ms / cached_ms:.2f}x",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
