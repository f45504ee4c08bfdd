"""Faults planted under the timed path, to show that ``correct`` catches
them, and the readings that set a cell's limits.  Each fault is a
context manager that patches the program while a run goes through the
harness as usual:

- ``none``: no fault, the sound program (its readings set the lower
  end of each limit);
- ``unchanged``: the training step leaves its state as it was (no
  optimizer update);
- ``half_batch``: the training step sees half of the batch's rows and
  takes the mean over them;
- ``token``: each fleet step alters one lane's token where it is
  produced (the lane changes from step to step), and the altered token
  is what the request serves and feeds on;
- ``int8_weights``: the serving cells on the program's own lower
  precision, its int8 weight path (``serving_params(..., "int8")`` into
  a ``quant=True`` model: int8 kernels with per-channel scales,
  dequantized to bf16 at use), the serving control.

    python benchmark/tools/faults.py --fault none,half_batch \\
        --workload <cell> --seconds 10 --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--check-tokens N] [--out runs.jsonl]

Every seed's runs share one process, so set-up is paid once.  A
training cell's faults on one seed are judged against one run of the
reference; ``--control-seeds`` also runs the float8 reference there,
on the first fault named (list ``none`` first).
Prints one JSON line a run: each compared number beside the cell's
limit; ``--out`` also keeps each serving run's gap at every checked
token.
"""

import argparse
import json
import sys
import time
from contextlib import contextmanager, nullcontext
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


@contextmanager
def _patched_step(wrap):
    from container_engine_accelerators_tpu_torch.models import lm_train

    orig = lm_train.make_lm_train_step

    def make(*a, **k):
        step, state = orig(*a, **k)
        return wrap(step), state

    lm_train.make_lm_train_step = make
    try:
        yield
    finally:
        lm_train.make_lm_train_step = orig


def unchanged():
    def wrap(step):
        def frozen(s, tokens, labels, mask):
            s.optimizer.step = lambda *a, **k: None
            try:
                return step(s, tokens, labels, mask)
            finally:
                del s.optimizer.step
        return frozen
    return _patched_step(wrap)


def half_batch():
    def wrap(step):
        def half(s, tokens, labels, mask):
            h = tokens.shape[0] // 2
            return step(s, tokens[:h], labels[:h], mask[:h])
        return half
    return _patched_step(wrap)


@contextmanager
def token():
    from container_engine_accelerators_tpu_torch.models import batching

    orig = batching._fleet_step
    calls = [0]

    def altered(model, cache, pos, last_tok, active, sampled):
        new_pos, new_tok, nxt = orig(model, cache, pos, last_tok, active,
                                     sampled)
        lane = calls[0] % nxt.shape[0]
        calls[0] += 1
        nxt[lane] = (nxt[lane] + 1) % model.vocab_size
        new_tok = new_tok.clone()
        new_tok[lane] = nxt[lane]
        return new_pos, new_tok, nxt

    batching._fleet_step = altered
    try:
        yield
    finally:
        batching._fleet_step = orig


@contextmanager
def int8_weights():
    import torch
    from container_engine_accelerators_tpu_torch.models.quant import (
        serving_params,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    from harness import serve, weights

    orig = serve.build

    def build(cfg, seed, device):
        s = weights.sizes(cfg)
        model = TransformerLM(vocab_size=s["V"], num_layers=s["L"],
                              num_heads=s["H"], head_dim=s["hd"],
                              mlp_dim=s["F"], num_kv_heads=s["KVH"],
                              dtype=torch.bfloat16, decode=True, quant=True,
                              use_flash_decode=True, device=device)
        drawn = weights.draw(cfg, seed, device, torch.bfloat16)
        model.load_state_dict(serving_params(drawn, "int8"))
        return model

    serve.build = build
    try:
        yield
    finally:
        serve.build = orig


FAULTS = {"none": nullcontext, "unchanged": unchanged,
          "half_batch": half_batch, "token": token,
          "int8_weights": int8_weights}


def _row(ctx, fault, numbers, control, limits, keep_gaps):
    from harness import judge

    rec = ctx.record
    checks = judge(numbers, limits)
    row = {"fault": fault, "workload": rec.cell, "seed": ctx.seed,
           "correct": all(c["ok"] for c in checks.values())
           and not rec.failed,
           "failed": rec.failed, "checks": checks,
           "memory_peak_bytes": rec.memory_peak_bytes,
           "window_s": rec.window_s, "counters": dict(rec.counters)}
    if control is not None:
        row["control"] = judge(control, limits)
    if keep_gaps:
        row["gaps"] = {k: v for k, v in rec.samples.items()
                       if k.endswith("token_gap")}
    return row


def readings(manifest, cell, seed, faults, seconds, control, device,
             check_tokens=None, keep_gaps=False):
    """One run of ``cell`` under each of ``faults`` on ``seed``, each
    judged by the cell's limits; with ``control``, the float8 control
    on the first of them."""
    import torch

    from harness import Context

    limits = manifest.limits(cell)
    rows, pending = [], []
    for i, fault in enumerate(faults):
        ctx = Context(manifest, cell, seed, seconds, False, device,
                      time.perf_counter(), control and i == 0)
        if check_tokens:
            ctx.mix["check_tokens"] = check_tokens
        if ctx.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(ctx.device)
        runner = manifest.runner(ctx.mix["kind"])
        with FAULTS[fault]():
            if ctx.mix["kind"] == "train":
                pending.append((ctx, fault, runner.measure(ctx)))
                continue
            numbers, ctl_numbers = runner.run(ctx)
        rows.append(_row(ctx, fault, numbers, ctl_numbers, limits,
                         keep_gaps))
    if pending:
        from harness import compare

        train = manifest.runner("train")
        first = pending[0][0]
        reference = train.reference_readings(first)
        r_grad = reference[1]
        for ctx, fault, got in pending:
            ctx.record.counters["leaves_left_out"] = \
                len(r_grad) - len(compare.kept_leaves(r_grad))
            ctl_numbers = None
            if ctx.control:
                ctl_numbers = train.numbers(
                    train.reference_readings(ctx, "fp8"), reference)
            rows.append(_row(ctx, fault, train.numbers(got, reference),
                             ctl_numbers, limits, keep_gaps))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--fault", required=True,
                   help="comma-separated, of " + ", ".join(sorted(FAULTS)))
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--check-tokens", type=int, default=None)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    faults = args.fault.split(",")
    unknown = sorted(set(faults) - set(FAULTS))
    if unknown:
        p.error(f"unknown faults {unknown}")
    from harness.manifest import Manifest

    manifest = Manifest.load()
    control_seeds = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        for row in readings(manifest, args.workload, seed, faults,
                            args.seconds, seed in control_seeds, "cuda",
                            args.check_tokens, bool(args.out)):
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(row) + "\n")
            row.pop("gaps", None)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
