"""Minimal LM generation server — PyTorch counterpart of ``cmd/serve_lm.py``.

Serves autoregressive decode from the KV-cache path on one CUDA device
(``--device cpu`` for tests): per request (``models/generate.py``), or
with ``--slots N`` through the continuous-batching engine
(``models/batching.py``), where the rows of all requests in flight share
one decode step over N lanes:

    POST /generate  {"prompt_ids": [[...ints...], ...],
                     "max_new_tokens": N, "temperature": t, "seed": s,
                     "prefix_ids": [...]}
                    -> {"tokens": [[...]], "latency_ms": t}
    GET  /healthz   -> ok

Run: ``python -m container_engine_accelerators_tpu_torch.cmd.serve_lm
[--flash-decode] [--weights bf16|int8] [--slots N] [--checkpoint-dir D]
[--prefill-chunk T] [--prefix-cache N] [--speculative K
[--draft-layers L] [--draft-checkpoint-dir D]] ...``.
With ``--checkpoint-dir`` it serves the newest step the port's trainer
saved there (``models/checkpoint.py``); without one, or before the first
save, random weights drawn from a seeded ``torch.Generator``.

The single-GPU features compose as in the JAX server: ``--weights int8``
(``models/quant.py``) with everything; ``--prefix-cache``
(``models/prefix_cache.py``: a request's ``prefix_ids`` are prefilled
once and their block copied into each request's cache) and
``--speculative`` (``models/speculative.py``) with each other and with
``--slots``; ``--prefill-chunk`` (``generate.prefill_chunked``) with
``--slots`` but not with those two.  ``--num-experts E`` serves the
MoE-LM (drop-free top-1 routing, ``ops/moe.py``) and composes with all
of them; the ``--speculative`` draft is an MoE-LM of the same experts.
``--tp N`` serves the model tensor parallel over N ranks, one process a
GPU (``torchrun --nproc-per-node N -m ...serve_lm --tp N``; the K8s env
contract of ``parallel/dcn.py``), per request or with ``--slots``: the
weights are DTensors laid out by the JAX rule over a (1, N) mesh and
each rank's cache holds its KV heads (``models/generate.py``,
``models/batching.py``).  Rank 0 alone serves HTTP and admits requests;
before each collective step it broadcasts what the other ranks need —
a request's padded prompt, its length, temperature, seed and sampling
flag (per request), or the batch of jobs the engine is about to advance
(prompt, ``max_new``, temperature, seed) — and the others repeat that
step in :func:`follow`, which they leave on a broadcast shutdown.  A
request is parsed and checked on rank 0 before anything is broadcast,
and the engine refuses an over-long one on every rank alike before any
collective, so a failed request fails alone and no rank waits on a
collective the others skip; a fault inside a collective (a lost rank, a
device error) ends the server.  ``--num-experts``, ``--weights int8`` and
``--prefix-cache`` compose with ``--tp``, as in the JAX server: the
experts' F and the int8 kernels and scales are laid out by the JAX rule
(``ops/moe.py``, ``models/quant.py``), and a request's prefix travels as
its token ids, each rank looking its block (its KV heads) up in its own
prefix cache in step with the others.  ``--flash-decode`` and
``--speculative`` with ``--tp > 1`` exit, as the JAX server does.
"""

import argparse
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from container_engine_accelerators_tpu_torch.models.batching import bucket_len

log = logging.getLogger("serve-lm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PyTorch transformer-LM serving "
                                            "demo")
    p.add_argument("--port", type=int, default=9001)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve from (cuda, cuda:N or cpu)")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--mlp-dim", type=int, default=2048)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="GQA KV heads (0 = MHA); shrinks the KV cache and "
                        "the per-token cache read by heads/kv-heads")
    p.add_argument("--num-experts", type=int, default=0,
                   help="MoE-LM decode (0 = dense): drop-free top-1 "
                        "routing so the KV-cache contract holds; composes "
                        "with slots/prefix/speculative/int8")
    p.add_argument("--weights", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="serving weight precision (models/quant.py): bf16, "
                        "or int8 kernels with f32 per-channel scales "
                        "(quantized from the bf16 cast; the embedding and "
                        "norms in bf16)")
    p.add_argument("--flash-decode", action="store_true",
                   help="hand-written CUDA cache-attention kernel for "
                        "decode steps (ops/flash_decode.py): streams the "
                        "cache up to each sequence's length instead of "
                        "masking the full buffer")
    p.add_argument("--max-prompt-len", type=int, default=64,
                   help="longest accepted prompt; prompts are padded to "
                        "power-of-two buckets")
    p.add_argument("--max-new-tokens", type=int, default=32,
                   help="tokens generated per prompt (pinned: requests "
                        "asking for more are capped, fewer are sliced)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="serve the newest step the trainer saved here "
                        "(cmd/train_lm.py --checkpoint-dir)")
    p.add_argument("--slots", type=int, default=0,
                   help="continuous batching over this many decode lanes "
                        "(0: one request at a time); composes with "
                        "--prefix-cache, --speculative (a speculative "
                        "round per fleet step) and --prefill-chunk")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: one rank a GPU, launched "
                        "by torchrun (or the K8s env of parallel/dcn.py)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative decoding (models/speculative.py): a "
                        "draft proposes K tokens a round, the target "
                        "verifies them in one forward; greedy requests "
                        "give the target's own tokens, sampled ones its "
                        "distribution (rejection sampling).  0 = off")
    p.add_argument("--draft-layers", type=int, default=0,
                   help="draft depth for --speculative (0 = num_layers/4, "
                        "min 1)")
    p.add_argument("--draft-checkpoint-dir", default=None,
                   help="the --speculative draft's weights: the newest step "
                        "the trainer saved here (without one the draft is "
                        "random and acceptance ~1/vocab)")
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="T",
                   help="prefill prompts in T-token pieces (bounds the "
                        "[prompt x cache] score tensor; same tokens).  0 = "
                        "single-shot; per request and in the --slots "
                        "engine, not with --speculative or --prefix-cache")
    p.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                   help="cache up to N shared prompt prefixes' KV blocks "
                        "(models/prefix_cache.py): requests carrying "
                        "\"prefix_ids\" prefill only their suffix after "
                        "the first.  0 = off")
    return p.parse_args(argv)


def validate_args(args):
    """Flag gates: the JAX server's composition rules."""
    if args.tp < 1:
        raise SystemExit("--tp must be >= 1")
    if args.speculative and args.tp > 1:
        raise SystemExit("--speculative and --tp > 1 are mutually "
                         "exclusive (the draft runs single-device)")
    if args.flash_decode and args.tp > 1:
        raise SystemExit("--flash-decode and --tp > 1 are mutually "
                         "exclusive (the kernel is single-device)")
    if args.prefill_chunk < 0:
        raise SystemExit("--prefill-chunk must be >= 0")
    if args.prefill_chunk and (args.speculative or args.prefix_cache):
        raise SystemExit("--prefill-chunk wires into the plain path only; "
                         "the speculative and prefix-cache paths still run "
                         "single-shot prefill, so combining would silently "
                         "drop the promised memory bound — drop one flag")
    if args.slots < 0:
        raise SystemExit("--slots must be >= 0")


def serving_mesh(args):
    """The (1, tp) mesh to serve over, or None: with ``--tp > 1``, or
    when a launcher (torchrun) started more than one rank, the process
    group is joined (``parallel/dcn.py::initialize``) and its world must
    be ``--tp`` ranks.  One rank at ``--tp 1`` serves the plain path,
    launcher or not; a launcher of several ranks at ``--tp 1`` exits, so
    every combination ``validate_args`` refuses with ``--tp > 1`` is
    refused wherever a mesh is taken."""
    from container_engine_accelerators_tpu_torch.parallel import dcn
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        create_mesh,
    )

    if args.tp == 1 and dcn.resolve_cluster()[1] == 1:
        return None
    world, rank = dcn.initialize(device=args.device, force=True)
    if world != args.tp:
        raise SystemExit(f"--tp {args.tp} needs {args.tp} ranks, one a "
                         f"GPU; the process group has {world}")
    log.info("rank %d/%d: params sharded %d-way tensor parallel", rank,
             world, args.tp)
    return create_mesh(data=1, model=args.tp)


def _model_cfg(args, **over) -> dict:
    cfg = dict(vocab_size=args.vocab_size, num_layers=args.num_layers,
               num_heads=args.num_heads, head_dim=args.head_dim,
               mlp_dim=args.mlp_dim, num_kv_heads=args.kv_heads or None,
               num_experts=args.num_experts)
    cfg.update(over)
    return cfg


def _restore(directory, cfg):
    """(f32 weights as a CPU state dict, step) of the newest step the
    port's trainer saved under ``directory``, or (None, None).  The
    checkpoint is read as the JAX server reads it, into the train-shaped
    state (the model and its AdamW), whose weights are then taken."""
    from container_engine_accelerators_tpu_torch.models.checkpoint import (
        TrainCheckpointer,
    )
    from container_engine_accelerators_tpu_torch.models.lm_train import (
        create_lm_train_state,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )

    train_model = TransformerLM(**cfg, device="cpu")
    # The optimizer must match cmd/train_lm.py's (AdamW) so the
    # checkpoint's optimizer state loads; serving reads the weights.
    state = create_lm_train_state(train_model, optimizer=torch.optim.AdamW(
        train_model.parameters(), lr=3e-4, weight_decay=0.1))
    ck = TrainCheckpointer(os.path.abspath(directory))
    state, step = ck.restore_latest(state)
    ck.close()
    if step is None:
        return None, None
    return {k: v.detach() for k, v in train_model.state_dict().items()}, step


def _random_params(cfg, seed: int) -> dict:
    """Random f32 weights for ``cfg``, drawn from a seeded generator."""
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )

    return init_params(TransformerLM(**cfg, decode=True, device="meta"),
                       torch.Generator().manual_seed(seed))


def load_params(args) -> dict:
    """The f32 weights to serve, as a state dict on the CPU: the newest
    step under ``--checkpoint-dir``, else random (seed 0)."""
    cfg = _model_cfg(args)
    if args.checkpoint_dir:
        params, step = _restore(args.checkpoint_dir, cfg)
        if step is not None:
            log.info("loaded step-%d params from %s", step,
                     args.checkpoint_dir)
            return params
        log.info("no checkpoint found; serving random params")
    else:
        log.info("serving randomly-initialized params (demo mode)")
    return _random_params(cfg, 0)


def _draft_cfg(args) -> dict:
    """The ``--speculative`` draft: ``--draft-layers`` layers, else
    ``max(1, num_layers // 4)``, at the target's widths and experts."""
    return _model_cfg(args, num_layers=args.draft_layers
                      or max(1, args.num_layers // 4))


def load_draft_params(args) -> dict:
    """The draft's f32 weights: the newest step under
    ``--draft-checkpoint-dir``, else random (seed 1)."""
    cfg = _draft_cfg(args)
    if args.draft_checkpoint_dir:
        params, step = _restore(args.draft_checkpoint_dir, cfg)
        log.info("draft: %s params from %s",
                 f"step-{step}" if step is not None
                 else "NO checkpoint found; random",
                 args.draft_checkpoint_dir)
        if params is not None:
            return params
    else:
        log.info("draft: randomly-initialized %d-layer model (exact but "
                 "acceptance ~1/vocab; train one with cmd/train_lm.py for "
                 "real speedup)", cfg["num_layers"])
    return _random_params(cfg, 1)


def build_generate(args, mesh=None):
    """Build the decode model on ``args.device`` with the weights of
    :func:`load_params` (cast or quantized to ``--weights``), and with
    ``--speculative`` its draft, and return ``run(prompt, prompt_len,
    temperature, seed, sample, prefix=None) -> [1, bucket + max_new]
    tokens`` (on the CPU) for a bucket-padded [1, bucket] prompt — with
    ``prefix``, a prefix's token ids (a tuple of ints, its block looked
    up in the prefix cache inside the call, on every rank of a mesh),
    the prompt is the suffix after that prefix.  Calls are serialized
    under one lock: the handler threads share the device.

    ``run.model`` is the model, ``run.params`` its f32 weights (before
    ``--weights``), ``run.draft`` the draft model or None;
    ``run.spec_rounds`` / ``spec_drafted`` / ``spec_accepted`` count the
    per-request speculative rounds.  With ``--prefix-cache``,
    ``run.prefix_cache`` (and ``run.draft_prefix_cache`` with
    ``--speculative``) hold the prefix blocks.

    With a ``mesh`` (:func:`serving_mesh`) the weights are sharded over
    it, the device is this rank's GPU, and every rank calls ``run`` alike:
    rank 0's arguments are broadcast and the others run with them
    (:func:`follow` makes those calls on the follower ranks)."""
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )
    from container_engine_accelerators_tpu_torch.models.prefix_cache import (
        PrefixCache,
        generate_with_prefix,
    )
    from container_engine_accelerators_tpu_torch.models.quant import (
        serving_params,
    )
    from container_engine_accelerators_tpu_torch.models.speculative import (
        generate_speculative,
        generate_speculative_sampled,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        broadcast_control,
        shard_params,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(args.device)
    if mesh is not None:
        from container_engine_accelerators_tpu_torch.parallel.dcn import (
            local_device,
        )

        device = local_device(args.device)
    model = TransformerLM(**_model_cfg(args), decode=True,
                          quant=args.weights == "int8",
                          use_flash_decode=args.flash_decode, device=device)
    params = f32_params = load_params(args)
    if args.weights != "f32":
        params = serving_params(params, args.weights)
        log.info("serving weights cast to %s", args.weights)
    model.load_state_dict(params)  # casts to the compute dtype once
    model.eval()
    if mesh is not None:
        shard_params(model, mesh)

    # Speculative decoding: greedy requests draft/verify with the
    # argmax-match rule (the target's own greedy tokens); sampled
    # requests with distribution-exact rejection sampling.  The draft
    # keeps f32 weights cast to the compute dtype whatever --weights says,
    # as the JAX server's does.
    draft = None
    if args.speculative:
        draft = TransformerLM(**_draft_cfg(args), decode=True,
                              use_flash_decode=args.flash_decode,
                              device=device)
        draft.load_state_dict(load_draft_params(args))
        draft.eval()

    lock = threading.Lock()
    n_new = args.max_new_tokens

    def run(prompt, prompt_len, temperature, seed, sample, prefix=None):
        with lock:
            if mesh is not None:
                # Every rank enters here with rank 0's arguments.
                prompt, prompt_len, temperature, seed, sample, prefix = \
                    broadcast_control(("run", (prompt, prompt_len,
                                               temperature, seed, sample,
                                               prefix)))[1]
            return run_local(prompt, prompt_len, temperature, seed, sample,
                             prefix)

    def run_local(prompt, prompt_len, temperature, seed, sample,
                  prefix=None):
        if prefix is not None:
            prefix = resolve_prefix(prefix)
        with torch.inference_mode():
            prompt = prompt.to(device)
            sample = sample and temperature > 0
            gen = (torch.Generator(device=device).manual_seed(seed)
                   if sample else None)
            if draft is not None:
                if sample:
                    out, stats = generate_speculative_sampled(
                        model, draft, prompt, n_new, k=args.speculative,
                        temperature=temperature, generator=gen,
                        prompt_len=prompt_len, prefix=prefix)
                else:
                    out, stats = generate_speculative(
                        model, draft, prompt, n_new, k=args.speculative,
                        prompt_len=prompt_len, prefix=prefix)
                run.spec_rounds += stats["rounds"]
                run.spec_drafted += int(stats["drafted"].sum())
                run.spec_accepted += int(stats["accepted"].sum())
                log.debug("spec acceptance: %d/%d", run.spec_accepted,
                          run.spec_drafted)
            elif prefix is not None:
                out = generate_with_prefix(
                    model, prefix[0], prefix[2], prompt, n_new,
                    temperature=temperature if sample else 0.0,
                    generator=gen, suffix_len=prompt_len)
            else:
                out = generate(model, prompt, n_new,
                               temperature=temperature if sample else 0.0,
                               generator=gen, prompt_len=prompt_len,
                               prefill_chunk=args.prefill_chunk or None)
            return out.cpu()

    def resolve_prefix(ids):
        """A prefix's token ids -> (block, draft block or None,
        prefix_len) from this rank's prefix caches (a miss prefills:
        every rank of a mesh looks up the same ids at the same point)."""
        block, pfx_len = run.prefix_cache.get_or_build(tuple(ids))
        d_block = (None if run.draft_prefix_cache is None
                   else run.draft_prefix_cache.get_or_build(tuple(ids))[0])
        return block, d_block, pfx_len

    def engine_prefix(ids):
        """A prefix's ids -> the engine's ``submit(prefix=)`` form."""
        block, d_block, pfx_len = resolve_prefix(ids)
        return ((block, pfx_len) if d_block is None
                else (block, d_block, pfx_len))

    run.engine_prefix = engine_prefix
    run.model = model
    run.mesh = mesh
    run.lock = lock
    run.local = run_local
    run.params = f32_params
    run.draft = draft
    run.spec_rounds = run.spec_drafted = run.spec_accepted = 0
    # Prefix caching: requests that mark their shared system prompt
    # ("prefix_ids") prefill only the suffix once its block is cached.
    run.prefix_cache = run.draft_prefix_cache = None
    if args.prefix_cache:
        run.prefix_cache = PrefixCache(model, args.max_prompt_len,
                                       args.prefix_cache)
        if draft is not None:
            # The draft needs its OWN block for the shared prompt.
            run.draft_prefix_cache = PrefixCache(draft, args.max_prompt_len,
                                                 args.prefix_cache)
    # Warm up (builds the CUDA kernels with --flash-decode) before
    # traffic: the greedy path, which is the speculative one with
    # --speculative.
    warm = bucket_len(1, args.max_prompt_len)
    run(torch.zeros((1, warm), dtype=torch.long), 1, 0.0, 0, False)
    return run


def build_engine(run, args):
    """Continuous-batching engine over ``run.model``, sized for this
    server's admission bound: a lane holds the largest prompt bucket plus
    ``--max-new-tokens``, plus another prompt bucket with the prefix cache
    (prefix bucket + suffix bucket), plus ``k`` tail slots with
    ``--speculative`` (a final verify round can overshoot).  With
    ``--speculative`` it is a ``SpecDecodeEngine`` over ``run.draft``."""
    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
        SpecDecodeEngine,
    )

    prompt_bucket = bucket_len(args.max_prompt_len, args.max_prompt_len)
    max_len = (prompt_bucket + args.max_new_tokens
               + (prompt_bucket if args.prefix_cache else 0)
               + args.speculative)
    if args.speculative:
        return SpecDecodeEngine(run.model, run.draft, max_slots=args.slots,
                                max_len=max_len, k=args.speculative)
    return DecodeEngine(run.model, max_slots=args.slots, max_len=max_len,
                        prefill_chunk=args.prefill_chunk or None)


def _leader(run) -> bool:
    import torch.distributed as dist

    return run.mesh is None or dist.get_rank() == 0


def start_engine(run, args):
    """With ``--slots``: the engine's stepper (an ``EngineLoop``), warmed
    before traffic (max_new 2, so that a fleet step runs: a 1-token
    request retires inside submit).  None without ``--slots``.  On a
    mesh, rank 0's loop broadcasts each batch of jobs before it advances
    it, and a follower rank gets its bare engine (it steps in
    :func:`follow`)."""
    if not args.slots:
        return None
    from container_engine_accelerators_tpu_torch.models.batching import (
        EngineLoop,
        job_args,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        broadcast_control,
    )

    engine = build_engine(run, args)
    if not _leader(run):
        return engine
    hook = None
    if run.mesh is not None:
        def hook(jobs):
            broadcast_control(("advance", job_args(jobs)))
    engine_loop = EngineLoop(engine, on_advance=hook,
                             resolve_prefix=run.engine_prefix)
    engine_loop.generate([0], 2)
    log.info("continuous batching: %d decode slots%s", args.slots,
             f" (speculative, k={args.speculative})" if args.speculative
             else "")
    return engine_loop


def make_handler(run, args, engine_loop=None):
    def pad_row(ids):
        """One request row -> (bucket-padded [1, bucket] tensor, true len)."""
        plen = len(ids)
        bucket = bucket_len(plen, args.max_prompt_len)
        return torch.tensor([ids + [0] * (bucket - plen)],
                            dtype=torch.long), plen

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):
            log.debug(fmt, *a)

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/generate":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(n) or b"{}")
                prompts = req.get("prompt_ids") or [[1]]
                max_new = min(int(req.get("max_new_tokens",
                                          args.max_new_tokens)),
                              args.max_new_tokens)
                temperature = float(req.get("temperature", 0.0))
                # Per-request seed (overridable for reproducibility).
                seed = int(req.get("seed", time.time_ns() & 0x7FFFFFFF))
                t0 = time.perf_counter()
                clean = [
                    [int(t) % args.vocab_size
                     for t in p][: args.max_prompt_len] or [0]
                    for p in prompts
                ]
                # Optional shared system prompt.  With the prefix cache
                # on, its block is prefilled once and copied into each
                # request's cache; otherwise (cache off, prefix too long)
                # it is plain concatenation — same tokens, full prefill.
                # The combined context is capped at --max-prompt-len on
                # every path, so the tokens do not depend on the path.
                prefix_ids = [int(t) % args.vocab_size
                              for t in (req.get("prefix_ids") or [])]
                use_prefix = (run.prefix_cache is not None
                              and 0 < len(prefix_ids) < args.max_prompt_len)
                if prefix_ids and not use_prefix:
                    clean = [(prefix_ids + ids)[: args.max_prompt_len]
                             for ids in clean]
                if use_prefix:
                    room = args.max_prompt_len - len(prefix_ids)
                    key = tuple(prefix_ids)
                    rows = [ids[:room] for ids in clean]
                    # The prefix travels as its ids, and its block is
                    # looked up inside the step (on every rank of a
                    # mesh), so requests that miss it together build it
                    # once.
                    if engine_loop is not None:
                        # The lanes start from copies of the block (the
                        # speculative engine's draft lanes from the
                        # draft's); sampled rows on seed + i, as below.
                        outs = engine_loop.generate_many(
                            rows, max_new, prefix_ids=key,
                            temperature=temperature,
                            seeds=[seed + i for i in range(len(rows))])
                        toks = [prefix_ids + ids + gen[:max_new]
                                for ids, gen in zip(rows, outs)]
                    else:
                        toks = []
                        for i, ids in enumerate(rows):
                            padded, plen = pad_row(ids)
                            out = run(padded, plen, temperature, seed + i,
                                      temperature > 0, key)
                            toks.append(prefix_ids
                                        + out[0][: plen + max_new].tolist())
                elif engine_loop is not None:
                    # Continuous batching: the request's rows join the
                    # shared fleet concurrently, sampled rows as lanes on
                    # their own generators (seed + i, as below).
                    outs = engine_loop.generate_many(
                        clean, max_new, temperature=temperature,
                        seeds=[seed + i for i in range(len(clean))])
                    toks = [ids + gen[:max_new]
                            for ids, gen in zip(clean, outs)]
                else:
                    toks = []
                    for i, ids in enumerate(clean):
                        padded, plen = pad_row(ids)
                        out = run(padded, plen, temperature, seed + i,
                                  temperature > 0)
                        toks.append(out[0][: plen + max_new].tolist())
                dt = (time.perf_counter() - t0) * 1e3
                self._send(200, {"tokens": toks,
                                 "latency_ms": round(dt, 2)})
            except Exception as e:  # noqa: BLE001 — serving surface
                log.exception("generate failed")
                self._send(400, {"error": str(e)})

    return Handler


def follow(run, engine=None):
    """A follower rank's loop: take each step rank 0 broadcasts — a
    per-request ``run`` (``run.local``) or an engine advance
    (``models/batching.py::follow_advance`` on ``engine``, what
    :func:`start_engine` returned here) — until the shutdown (None).  A
    request that raises here raised on rank 0 too (the same call on the
    same inputs), where the handler answers 400: the loop goes on."""
    from container_engine_accelerators_tpu_torch.models.batching import (
        follow_advance,
    )
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        broadcast_control,
    )

    while True:
        msg = broadcast_control(None)
        if msg is None:
            return
        kind, payload = msg
        if kind == "advance":
            follow_advance(engine, payload, run.engine_prefix)
            continue
        try:
            run.local(*payload)
        except Exception:  # noqa: BLE001 — rank 0 answers it with a 400
            log.exception("request failed on this rank, as on rank 0")


def stop_followers(run, engine_loop=None):
    """Rank 0: stop the engine's stepper, then broadcast the shutdown
    (under ``run``'s lock, so it cannot interleave with a request's
    broadcast)."""
    if engine_loop is not None:
        engine_loop.close()
    if run.mesh is None:
        return
    from container_engine_accelerators_tpu_torch.parallel.mesh import (
        broadcast_control,
    )

    with run.lock:
        broadcast_control(None)


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    validate_args(args)
    mesh = serving_mesh(args)
    run = build_generate(args, mesh)
    engine_loop = start_engine(run, args)
    if not _leader(run):
        follow(run, engine_loop)
        return
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(run, args, engine_loop))
    log.info("serving LM on :%d", server.server_address[1])
    try:
        server.serve_forever()
    finally:
        stop_followers(run, engine_loop)


if __name__ == "__main__":
    main()
