#!/usr/bin/env python3
"""Serving-throughput microbenchmark: continuous batching against
sequential requests — counterpart of ``cmd/bench_serving.py``.

Runs one mixed stream of generation requests (cycling prompt lengths)
two ways on the same weights:

  sequential — per-request ``generate()``, one after another;
  engine     — ``models/batching.py::DecodeEngine`` with ``--slots``
      lanes, requests joining and leaving mid-flight.

Prints one JSON line:
  {"metric": "serving_continuous_batching_ttft_speedup",
   "value": <mean sequential TTFT / mean engine TTFT>, ...}

with ``engine_tokens_per_sec`` beside ``sequential_tokens_per_sec``.
``--speculative K`` runs ``SpecDecodeEngine`` against per-request
``generate_speculative`` (the same draft on both paths, ``--spec-draft
self|1L``), so the ratio isolates the batching; ``--temperature``
samples on both paths from per-request seeds (an engine lane's generator
is seeded as the request's own).

Gates, before any number is printed: every request's first token (a
batch-1 prefill on both paths) must agree; greedy mismatches later in a
sequence are triaged by the logit gap at the first divergent position,
recomputed through the port's ``prefill`` — a gap above ``--tie-margin``
is a real divergence and fails the run; sampled runs fail below
``--sampled-exact-floor``.  The engine is held against the port's own
``generate``: tokens are never compared across frameworks.

**Fleet mode** (``--fleet``): a ``serving/frontend.py`` frontend over an
in-process emulated fleet (``fleet/``), driven closed-loop for
``--fleet-seconds``: one JSONL record per second window, then the
``serving_fleet_sustained_qps`` headline.  Host code only.  With
``TPU_HISTORY_DIR`` set the run is recorded in ``obs/history.py``'s
ledger and judged against earlier runs (``--trend-gate``).

Model runs go to ``--device`` (the card by default); ``--dtype`` is
bf16 by default, the JAX tool's only dtype.  Nothing else is written.

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.bench_serving \\
      [--slots 4] [--requests 12] [--max-new 32] [--speculative K] \\
      [--temperature T] [--device cuda] | --fleet [--fleet-seconds 3]
"""

import argparse
import json
import sys
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda",
                   help="torch device of the model runs (cuda, cuda:N, or "
                        "cpu for a smoke run)")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16", help="the models' compute dtype")
    p.add_argument("--fleet", action="store_true",
                   help="fleet serving throughput: drive a "
                        "ServingFrontend over an in-process emulated "
                        "fleet and record sustained QPS (no model)")
    p.add_argument("--fleet-nodes", type=int, default=3)
    p.add_argument("--fleet-seconds", type=float, default=3.0)
    p.add_argument("--fleet-payload", type=int, default=4096,
                   help="per-request payload bytes (the shard read)")
    p.add_argument("--fleet-inflight", type=int, default=32,
                   help="closed-loop concurrency: requests kept "
                        "outstanding")
    p.add_argument("--fleet-batch", type=int, default=8,
                   help="frontend max_batch")
    p.add_argument("--fleet-min-qps", type=float, default=0.0,
                   help="exit non-zero when sustained QPS lands below "
                        "this floor (the regression gate)")
    p.add_argument("--trend-gate", action="store_true",
                   help="fleet mode: judge sustained QPS and p99 "
                        "against the history ledger baseline "
                        "(TPU_HISTORY_DIR); a regression exits 1 "
                        "with the cpu_attr attribution named")
    p.add_argument("--slots", type=int, default=4)
    p.add_argument("--requests", type=int, default=12)
    p.add_argument("--prompt-lens", default="8,24,48",
                   help="cycled across requests")
    p.add_argument("--max-new", type=int, default=32)
    p.add_argument("--vocab-size", type=int, default=512)
    p.add_argument("--num-layers", type=int, default=2)
    p.add_argument("--num-heads", type=int, default=4)
    p.add_argument("--head-dim", type=int, default=16)
    p.add_argument("--mlp-dim", type=int, default=128)
    p.add_argument("--kv-heads", type=int, default=0)
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative continuous batching "
                        "(SpecDecodeEngine): the fleet drafts K tokens "
                        "per round; the sequential reference becomes "
                        "per-request generate_speculative, so the "
                        "speedup isolates the batching")
    p.add_argument("--spec-draft", choices=("self", "1L"), default="self",
                   help="draft for --speculative: self = the target drafts "
                        "itself (acceptance ~1, bounds the win), 1L = a "
                        "random 1-layer draft (acceptance ~0, bounds the "
                        "per-round overhead)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="sampled serving: both paths sample, request i "
                        "from a generator seeded 1000 + i (an engine "
                        "lane's generator is seeded as the request's); "
                        "gated by --sampled-exact-floor.  0 = greedy")
    p.add_argument("--sampled-exact-floor", type=float, default=0.5,
                   help="sampled mode fails if exact_match_fraction "
                        "drops below this — a seed desync zeroes "
                        "agreement, while bf16 tie flips cost at most "
                        "a few requests")
    p.add_argument("--tie-margin", type=float, default=0.02,
                   help="logit gap below which a sequential/engine "
                        "token mismatch counts as a bf16 argmax "
                        "near-tie (the fleet's [slots, 1, D] products "
                        "may round differently); mismatches with a "
                        "LARGER gap are real divergences and fail "
                        "the run")
    return p.parse_args(argv)


def fleet_main(args) -> int:
    """--fleet: sustained QPS through the serving frontend over an
    in-process emulated fleet (no model: the serving stack is the thing
    under test)."""
    from collections import deque

    from container_engine_accelerators_tpu_torch.fleet.controller import (
        FleetController,
    )
    from container_engine_accelerators_tpu_torch.obs import (
        critpath,
        histo,
        history,
        profiler,
    )
    from container_engine_accelerators_tpu_torch.serving.frontend import (
        RequestShed,
    )

    run_id = history.new_run_id()
    version = history.repo_version()
    # The run's subsystem shares are the delta against this snapshot,
    # so a regressed p99 comes with the subsystem whose share moved.
    prof0 = profiler.snapshot(top=0)["subsystems"]
    e2e0 = dict(histo.snapshot().get("serving.e2e",
                                     {}).get("buckets", {}))
    scenario = {
        "name": "bench-serving-fleet",
        "workload": "serving",
        "nodes": args.fleet_nodes,
        "racks": 1,
        "chips": 2,
        "topology": "1x2x1",
        "rounds": 0,
        "payload_bytes": args.fleet_payload,
        "serving": {
            "max_batch": args.fleet_batch,
            "max_wait_ms": 2.0,
            "admission_capacity": max(64, 2 * args.fleet_inflight),
        },
    }
    ctl = FleetController(scenario).boot()
    try:
        fe = ctl.frontend
        pending: "deque" = deque()
        ok = errors = shed = submitted = 0
        t0 = time.monotonic()
        next_mark = t0 + 1.0
        ok_at_mark = 0
        windows = []
        deadline = t0 + max(0.5, args.fleet_seconds)
        payload_of = lambda i: bytes([i % 256]) * args.fleet_payload  # noqa: E731
        while time.monotonic() < deadline:
            while len(pending) < args.fleet_inflight:
                p = payload_of(submitted)
                try:
                    pending.append((fe.submit(p), p))
                    submitted += 1
                except RequestShed:
                    shed += 1
                    break
            head, _ = pending[0]
            head.wait(0.02)
            # Reap every completed request, not just the head: hedged and
            # failed-over batches resolve out of order.
            for _ in range(len(pending)):
                req, payload = pending.popleft()
                if not req.done():
                    pending.append((req, payload))
                    continue
                if req.error is None and req.result == payload:
                    ok += 1
                else:
                    errors += 1
            now = time.monotonic()
            if now >= next_mark:
                windows.append({
                    "mode": "fleet-serving",
                    "window_s": round(now - t0, 1),
                    "qps": ok - ok_at_mark,
                    "inflight": len(pending),
                })
                ok_at_mark = ok
                next_mark = now + 1.0
        # Drain: every outstanding request must terminate.
        drain_by = time.monotonic() + 30.0
        while pending and time.monotonic() < drain_by:
            req, payload = pending.popleft()
            if not req.wait(max(0.0, drain_by - time.monotonic())):
                errors += 1
                continue
            if req.error is None and req.result == payload:
                ok += 1
            else:
                errors += 1
        elapsed = time.monotonic() - t0
        qps = ok / max(elapsed, 1e-9)
        p99_us = histo.delta_percentile_us("serving.e2e", e2e0, 0.99)
        p99_ms = round((p99_us or 0.0) / 1e3, 3)
        cpu_attr = profiler.subsystem_shares(baseline=prof0) or None
        dominant = critpath.analyze(
            ctl.telemetry.spans()).get("dominant_phase")
        for w in windows:
            w["run_id"] = run_id
            w["version"] = version
            print(json.dumps(w))
        result = {
            "metric": "serving_fleet_sustained_qps",
            "value": round(qps, 2),
            "unit": f"req/s ({args.fleet_nodes} nodes, "
                    f"{args.fleet_payload} B shard reads, closed loop "
                    f"x{args.fleet_inflight})",
            "run_id": run_id,
            "version": version,
            "ok": ok,
            "errors": errors,
            "shed": shed,
            "elapsed_s": round(elapsed, 2),
            "p99_e2e_ms": p99_ms,
            "cpu_attr": {k: round(v, 4)
                         for k, v in (cpu_attr or {}).items()},
            "dominant_phase": dominant,
            "nodes": args.fleet_nodes,
            "payload_bytes": args.fleet_payload,
            "inflight": args.fleet_inflight,
            "max_batch": args.fleet_batch,
        }
        print(json.dumps(result), flush=True)
        print(f"bench_serving --fleet: {qps:.1f} req/s sustained "
              f"({ok} ok, {errors} errors, {shed} shed over "
              f"{elapsed:.1f}s, p99 {p99_ms:.1f}ms)", file=sys.stderr)
        trend_rc = _fleet_trend(args, run_id, qps, p99_ms, cpu_attr,
                                dominant)
        if errors or not ok:
            return 1
        if args.fleet_min_qps and qps < args.fleet_min_qps:
            print(f"bench_serving --fleet: {qps:.1f} req/s below the "
                  f"--fleet-min-qps floor {args.fleet_min_qps:g}",
                  file=sys.stderr)
            return 1
        return trend_rc
    finally:
        ctl.close()


def _fleet_trend(args, run_id, qps, p99_ms, cpu_attr, dominant) -> int:
    """Record this fleet-serving run into the history ledger and judge it
    against PRIOR runs of the same config (judged first, so a regressed
    run cannot poison its own baseline).  Returns 1 on a regression
    under --trend-gate, else 0; ledger trouble costs the trend layer,
    never the bench.  Off unless ``TPU_HISTORY_DIR`` is set."""
    from container_engine_accelerators_tpu_torch.obs import history

    ledger = history.RunLedger()
    if not ledger.enabled:
        return 0
    cfg_key = history.config_key(
        "fleet-serving", f"n{args.fleet_nodes}",
        f"p{args.fleet_payload}", f"b{args.fleet_batch}",
        f"c{args.fleet_inflight}")
    metrics = {"sustained_qps": round(qps, 2), "p99_e2e_ms": p99_ms}
    try:
        prior = ledger.records(kind="fleet_serving", cfg_key=cfg_key)
    except history.LedgerError as e:
        print(f"history ledger unreadable ({e}); trend gate skipped",
              file=sys.stderr)
        return 0
    verdicts = [
        history.trend_verdict(prior, m, v, cpu_attr=cpu_attr,
                              dominant_phase=dominant)
        for m, v in sorted(metrics.items())
    ]
    ledger.record("fleet_serving", cfg_key, metrics, run_id=run_id,
                  cpu_attr=cpu_attr, dominant_phase=dominant)
    regressed = [v for v in verdicts if v["status"] == "regressed"]
    for v in verdicts:
        if v["status"] != "no_baseline":
            print("trend: " + history.format_verdict(v), file=sys.stderr)
    return 1 if (args.trend_gate and regressed) else 0


def _random_lm(cfg, dtype, dev, seed):
    """A decode-mode LM on ``dev`` with random weights from ``seed``
    (``models/transformer.py::init_params``, the flax law), cast once."""
    import torch

    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )

    model = TransformerLM(**cfg, dtype=dtype, decode=True, device=dev)
    model.load_state_dict(init_params(
        TransformerLM(**cfg, dtype=dtype, decode=True, device="meta"),
        torch.Generator().manual_seed(seed)))
    return model.eval()


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.fleet:
        return fleet_main(args)
    import torch

    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
        SpecDecodeEngine,
        bucket_len,
    )
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
        prefill,
    )
    from container_engine_accelerators_tpu_torch.models.speculative import (
        generate_speculative,
        generate_speculative_sampled,
    )
    from container_engine_accelerators_tpu_torch.obs import history
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    dev = resolve_device(args.device)
    dtype = getattr(torch, args.dtype)
    cfg = dict(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, head_dim=args.head_dim,
        mlp_dim=args.mlp_dim, num_kv_heads=args.kv_heads or None,
    )
    model = _random_lm(cfg, dtype, dev, 0)

    # Nonce-seeded prompts, lengths cycling so the stream is mixed.
    nonce = time.time_ns() & 0x7FFFFFFF
    lens = [int(x) for x in args.prompt_lens.split(",")]
    prompts = [
        torch.randint(0, args.vocab_size, (lens[i % len(lens)],),
                      generator=torch.Generator().manual_seed(nonce + i)
                      ).tolist()
        for i in range(args.requests)
    ]
    max_prompt = max(lens)
    max_len = bucket_len(max_prompt, max_prompt) + args.max_new

    # Speculative mode: both paths speculate (the same draft), so the
    # reported ratio isolates continuous batching.
    draft = model
    if args.speculative and args.spec_draft == "1L":
        draft = _random_lm(dict(cfg, num_layers=1), dtype, dev, 1)

    # Sampled mode: request i rides seed SEED0 + i on BOTH paths.
    SEED0 = 1000
    temp = args.temperature

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def run(padded, n, seed):
        if args.speculative:
            if temp > 0:
                return generate_speculative_sampled(
                    model, draft, padded, args.max_new, k=args.speculative,
                    temperature=temp, generator=generator(seed),
                    prompt_len=n)[0]
            return generate_speculative(model, draft, padded, args.max_new,
                                        k=args.speculative, prompt_len=n)[0]
        if temp > 0:
            return generate(model, padded, args.max_new, temperature=temp,
                            generator=generator(seed), prompt_len=n)
        return generate(model, padded, args.max_new, prompt_len=n)

    def seq_one(ids, seed=0):
        bucket = bucket_len(len(ids), max_prompt)
        padded = torch.tensor([ids + [0] * (bucket - len(ids))],
                              dtype=torch.long, device=dev)
        with torch.inference_mode():
            out = run(padded, len(ids), seed)
        return out[0, len(ids): len(ids) + args.max_new].tolist()

    for ln in sorted(set(lens)):  # warm each bucket
        seq_one([0] * ln)
    seq_out, seq_ttft = [], []
    t0 = time.perf_counter()
    for i, ids in enumerate(prompts):
        seq_out.append(seq_one(ids, SEED0 + i))
        # The request's first token becomes observable when its call
        # returns, after every predecessor finished.
        seq_ttft.append(time.perf_counter() - t0)
    seq_s = time.perf_counter() - t0

    # --- engine path (one thread: fill free slots, step).
    # ONE engine for the warm and timed runs; it drains between them.
    if args.speculative:
        eng = SpecDecodeEngine(model, draft, max_slots=args.slots,
                               max_len=max_len + args.speculative,
                               k=args.speculative)
    else:
        eng = DecodeEngine(model, max_slots=args.slots, max_len=max_len)

    def engine_run(reqs):
        rids, queue = {}, list(range(len(reqs)))
        outs, ttft = [None] * len(reqs), [None] * len(reqs)
        t0 = time.perf_counter()
        while queue or rids:
            while queue and eng.free_slots:
                i = queue.pop(0)
                rids[i] = eng.submit([int(t) for t in reqs[i]],
                                     args.max_new, temperature=temp,
                                     seed=SEED0 + i)
                ttft[i] = time.perf_counter() - t0  # tok0 observable
            eng.step()
            for i, rid in list(rids.items()):
                got = eng.take_result(rid)
                if got is not None:
                    outs[i] = got
                    del rids[i]
        return outs, ttft, time.perf_counter() - t0

    # Warm every prefill bucket and the fleet step.
    engine_run([[0] * ln for ln in sorted(set(lens))])
    if args.speculative:
        # The warm run's rounds must not blend into the timed telemetry.
        eng.spec_rounds = eng.spec_drafted = eng.spec_accepted = 0
    eng_out, eng_ttft, eng_s = engine_run(prompts)

    # Gate: each request's FIRST token comes from a batch-1 prefill on
    # both paths, so a mismatch there is a real fault.  Later tokens may
    # flip at a bf16 near-tie ([slots, 1, D] products against [1, 1,
    # D]): report the agreement and triage the mismatches below.
    for i, (a, b) in enumerate(zip(seq_out, eng_out)):
        assert a[0] == b[0], (
            f"request {i}: engine prefill diverged from generate()")
    exact = sum(
        a == b[: args.max_new] for a, b in zip(seq_out, eng_out)
    ) / len(prompts)

    def _divergence_gap(ids, seq_toks, eng_toks):
        """Teacher-force the sequential tokens up to the first divergence
        through a batch-1 prefill -> (position, sequential logit minus
        the engine token's logit there).  A third rounding of the same
        math: a classifier, not an oracle."""
        j = next(k for k in range(args.max_new)
                 if seq_toks[k] != eng_toks[k])
        ctx = [int(t) for t in ids] + seq_toks[:j]
        bucket = bucket_len(len(ctx), max(max_len, len(ctx)))
        padded = torch.tensor([ctx + [0] * (bucket - len(ctx))],
                              dtype=torch.long, device=dev)
        with torch.inference_mode():
            _, logits = prefill(model, padded, len(ctx), bucket + 1)
        row = logits.float()[0]
        return j, float(row[seq_toks[j]]) - float(row[eng_toks[j]])

    ties, real = [], []
    if temp == 0:
        for i, (a, b) in enumerate(zip(seq_out, eng_out)):
            if a == b[: args.max_new]:
                continue
            j, gap = _divergence_gap(prompts[i], a, b)
            (ties if abs(gap) <= args.tie_margin else real).append(
                {"request": i, "pos": j, "gap": round(gap, 5)})
        assert not real, (
            f"engine genuinely diverged from generate() (|gap| > "
            f"{args.tie_margin} at the first divergent position — not "
            f"a bf16 near-tie): {real}")
    if temp > 0:
        assert exact >= args.sampled_exact_floor, (
            f"sampled engine agreement {exact:.3f} below the "
            f"{args.sampled_exact_floor} floor — per-request generators "
            f"have desynced from generate()'s")

    tokens = args.requests * args.max_new
    mean_seq_ttft = sum(seq_ttft) / len(seq_ttft)
    mean_eng_ttft = sum(eng_ttft) / len(eng_ttft)
    print(f"bench_serving: sequential {seq_s:.2f}s "
          f"({tokens / seq_s:.1f} tok/s, mean TTFT "
          f"{mean_seq_ttft * 1e3:.0f}ms)  engine[{args.slots} slots] "
          f"{eng_s:.2f}s ({tokens / eng_s:.1f} tok/s, mean TTFT "
          f"{mean_eng_ttft * 1e3:.0f}ms)", file=sys.stderr)
    stag = (f"_speck{args.speculative}{args.spec_draft}"
            if args.speculative else "")
    if temp > 0:
        stag += f"_sampledT{temp:g}"
    result = {
        "metric": "serving_continuous_batching_ttft_speedup" + stag,
        "value": round(mean_seq_ttft / mean_eng_ttft, 3),
        "run_id": history.new_run_id(),
        "version": history.repo_version(),
        "unit": f"x (mean burst TTFT, sequential/engine, "
                f"{args.slots} slots)",
        "vs_baseline": round(seq_s / eng_s, 3),
        "throughput_speedup": round(seq_s / eng_s, 3),
        "requests": args.requests,
        "max_new": args.max_new,
        "prompt_lens": lens,
        "engine_tokens_per_sec": round(tokens / eng_s, 2),
        "sequential_tokens_per_sec": round(tokens / seq_s, 2),
        "mean_ttft_ms": {"sequential": round(mean_seq_ttft * 1e3, 1),
                         "engine": round(mean_eng_ttft * 1e3, 1)},
        "exact_match_fraction": round(exact, 3),
        "tie_mismatches": ties,
        "platform": dev.type,
        "nonce": nonce,
    }
    if args.speculative:
        result["spec_k"] = args.speculative
        result["spec_draft"] = args.spec_draft
        result["spec_accept_rate"] = round(
            eng.spec_accepted / max(eng.spec_drafted, 1), 4)
        result["spec_rounds"] = eng.spec_rounds
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
