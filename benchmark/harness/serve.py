"""Serving cells: the port's LM served through the continuous-batching
engine on flash decode.

Set-up builds the architecture's model for serving
(``arch/<architecture>.py``: ``build(cfg, device, "serve")``; SmolLM's
decodes on flash decode) on bf16 weights drawn from the seed and a
``DecodeEngine`` with the mix's slots and slot length, prefills one
prompt of every bucket the mix's prompts fall in, then fills the fleet:
every client sends its first request, and the loop runs
``warmup_iterations`` more iterations.

The loop is closed: each client sends its next request when its answer
has come.  An iteration submits the waiting clients' requests to free
slots (each ``submit`` is a bucket-padded batch-1 prefill, the lane
insert and the first token, and ends on reading that token), takes one
fleet step if any lane is live (``step`` ends on reading the step's
tokens), and collects the finished answers.  The window runs iterations
until ``--seconds`` have passed; its rate counts every token emitted in
it, first tokens included, over its whole time.

After the window the program is freed, and the plain reference runs
over a sample of the requests the window finished, drawn from the seed
with the longest among them: at each served token, the gap by which its
reference logit lies below the reference's best.  The check compares
the widest of those gaps and their mean over the sample.

With ``--control 1`` the check also reads the control: at each served
position, the token the reference computed in float8 puts first, and
its gap in the f32 reference.
"""

import collections
from contextlib import nullcontext

import numpy as np
import torch

from harness import clock, compare, free_device, sync, tracing, traffic
from harness import weights


def build(arch, cfg, seed, device):
    """The program's decode model on the drawn bf16 weights."""
    model = arch.build(cfg, device, "serve")
    weights.load_into(dict(model.named_parameters()), arch.kinds(cfg), seed,
                      device, torch.bfloat16)
    return model


class ClosedLoop:
    """The mix's clients over one engine."""

    def __init__(self, engine, stream, clients: int, rec):
        self.engine, self.stream, self.rec = engine, stream, rec
        self.pending = collections.deque((c, None) for c in range(clients))
        self.running = {}  # request id -> what the loop knows of it
        self.finished = []  # (request, served tokens) finished in the window
        self.lengths = None  # with tracing: each fleet step's lane lengths

    def iterate(self, measured: bool, traced: bool = False) -> None:
        from torch.profiler import record_function

        rec, eng = self.rec, self.engine
        for _ in range(len(self.pending)):
            if not eng.free_slots:
                break
            client, sent = self.pending.popleft()
            req = self.stream.next()
            t0 = clock()
            with record_function("prefill") if traced else nullcontext():
                try:
                    rid = eng.submit(req.prompt, req.max_new)
                except ValueError:
                    rec.failed += measured
                    self.pending.append((client, clock()))
                    continue
            t1 = clock()
            n = len(req.prompt)
            if measured:
                rec.attempted += 1
                rec.spans["prefill"].append(t1 - t0)
                rec.samples["ttft"].append(t1 - sent)
                rec.counters["tokens"] += 1
                rec.counters["prefill_tokens"] += n
                rec.counters["prefill_keys"] += n * (n + 1) // 2
            self.running[rid] = {"req": req, "client": client, "emitted": 1}
        live = [r for r in self.running.values()
                if r["emitted"] < r["req"].max_new]
        if live:
            if traced:
                self.lengths.append((eng.pos + 1).tolist())
            t0 = clock()
            with record_function("fleet_step") if traced else nullcontext():
                eng.step()
            t1 = clock()
            if measured:
                rec.spans["fleet_step"].append(t1 - t0)
                rec.counters["tokens"] += len(live)
                rec.counters["decode_tokens"] += len(live)
                rec.counters["decode_keys"] += sum(
                    len(r["req"].prompt) + r["emitted"] for r in live)
            for r in live:
                r["emitted"] += 1
        done = clock()
        for rid in list(self.running):
            tokens = eng.take_result(rid)
            if tokens is None:
                continue
            r = self.running.pop(rid)
            if measured:
                self.finished.append((r["req"], tokens))
            self.pending.append((r["client"], done))


def warm_buckets(engine, stream, bucket_len, law, max_len):
    """One one-token request of every prefill bucket the law's lengths
    fall in (its shortest length), retired at once."""
    lo, hi = traffic.bounds(law)
    seen = set()
    for n in range(lo, hi + 1):
        b = bucket_len(n, max_len)
        if b not in seen:
            seen.add(b)
            engine.take_result(engine.submit(stream.prompt_of_len(n), 1))


def run(ctx):
    cfg, mix, dev, rec = ctx.cfg, ctx.mix, ctx.device, ctx.record
    arch = ctx.arch()
    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
        bucket_len,
    )

    model = build(arch, cfg, ctx.seed, dev)
    engine = DecodeEngine(model, max_slots=mix["slots"],
                          max_len=mix["max_len"])
    stream = traffic.ServeTraffic(mix, arch.sizes(cfg)["V"], ctx.seed)
    warm_buckets(engine, stream, bucket_len, mix["prompt_len"],
                 mix["max_len"])
    loop = ClosedLoop(engine, stream, mix["clients"], rec)
    for _ in range(1 + mix["warmup_iterations"]):
        loop.iterate(measured=False)
    sync(dev)

    t0 = clock()
    rec.setup_s = t0 - ctx.t_start
    loop.pending = collections.deque((c, t0 if sent is None else sent)
                                     for c, sent in loop.pending)
    while clock() - t0 < ctx.seconds:
        loop.iterate(measured=True)
    rec.window_s = clock() - t0
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    if ctx.trace:
        loop.lengths = []
        with tracing.capture(dev) as cap:
            for _ in range(mix["trace_iterations"]):
                loop.iterate(measured=False, traced=True)
        rec.trace = cap.trace
        rec.trace_info["fleet_step_lengths"] = loop.lengths

    finished = loop.finished
    del loop, engine, model
    free_device(dev)
    return check(ctx, finished)


def sample(finished, seed: int, tokens_wanted: int):
    """The longest finished request, then others in an order drawn from
    the seed, until ``tokens_wanted`` served tokens are in."""
    if not finished:
        return []
    longest = max(range(len(finished)), key=lambda i: len(finished[i][1]))
    rest = [i for i in range(len(finished)) if i != longest]
    order = np.random.default_rng([int(seed) % (2 ** 64), 7]).permutation(
        len(rest))
    picked, total = [], 0
    for i in [longest] + [rest[j] for j in order]:
        picked.append(finished[i])
        total += len(finished[i][1])
        if total >= tokens_wanted:
            break
    return picked


@torch.no_grad()
def check(ctx, finished):
    cfg, mix, dev, rec = ctx.cfg, ctx.mix, ctx.device, ctx.record
    t0 = clock()
    arch = ctx.arch()
    s = arch.sizes(cfg)
    ref = ctx.reference()
    ref.no_tf32()
    params = {n: t.float() for n, t in weights.draw(
        arch.kinds(cfg), ctx.seed, dev, torch.bfloat16).items()}
    plain = ref.Reference(s, params)
    low = ref.Reference(s, params, ref.fp8) if ctx.control else None
    picked = sample(finished, ctx.seed, mix["check_tokens"])
    gaps, gaps_low = [], []
    for req, served in picked:
        if len(served) != req.max_new:
            rec.failed += 1  # an answer cut short or run on
            continue
        n = len(req.prompt)
        ids = req.prompt + served[:-1]
        rows = list(range(n - 1, n - 1 + len(served)))
        logits = plain.logits_at(ids, rows)
        gaps.append(compare.token_gaps(logits, served))
        if low is not None:
            # The control: the token the float8 reference puts first.
            first = low.logits_at(ids, rows).argmax(-1)
            gaps_low.append(compare.token_gaps(logits, first))
    rec.counters["checked_requests"] = len(picked)
    rec.counters["checked_tokens"] = sum(len(t) for _, t in picked)
    if not picked:
        rec.failed += 1  # nothing finished to check
    for key, g in (("token_gap", gaps), ("control_token_gap", gaps_low)):
        rec.samples[key] = torch.cat(g).tolist() if g else []
    del params
    free_device(dev)
    rec.counters["check_s"] = clock() - t0
    return (compare.serve_numbers(gaps),
            compare.serve_numbers(gaps_low) if ctx.control else None)
