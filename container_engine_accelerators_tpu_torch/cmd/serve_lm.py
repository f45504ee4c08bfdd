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
[--flash-decode] [--weights bf16] [--slots N] [--checkpoint-dir D] ...``.
With ``--checkpoint-dir`` it serves the newest step the port's trainer
saved there (``models/checkpoint.py``); without one, or before the first
save, random weights drawn from a seeded ``torch.Generator``.  The flags
of the JAX server that the port does not serve yet (speculative
decoding, the prefix cache, tensor parallelism, MoE, int8 weights,
chunked prefill) are accepted by the parser and rejected by
:func:`validate_args` with a message naming the slice that brings them.
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

_LATER = "is not ported yet: it comes with a later serving slice of the PyTorch port"


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
                   help="MoE-LM decode (not ported yet)")
    p.add_argument("--weights", choices=("f32", "bf16", "int8"),
                   default="f32",
                   help="serving weight precision (models/quant.py); "
                        "int8 is not ported yet")
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
                        "(0: one request at a time)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree (only 1 is ported)")
    p.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="speculative decoding (not ported yet)")
    p.add_argument("--draft-layers", type=int, default=0,
                   help="draft depth for --speculative")
    p.add_argument("--draft-checkpoint-dir", default=None,
                   help="checkpoint for the --speculative draft model")
    p.add_argument("--prefill-chunk", type=int, default=0, metavar="T",
                   help="chunked prefill (not ported yet)")
    p.add_argument("--prefix-cache", type=int, default=0, metavar="N",
                   help="prefix KV cache (not ported yet)")
    return p.parse_args(argv)


def validate_args(args):
    """Flag gates: the JAX server's composition rules, plus every feature
    this slice of the port does not serve yet."""
    if args.speculative and args.tp > 1:
        raise SystemExit("--speculative and --tp > 1 are mutually "
                         "exclusive (the draft runs single-device)")
    if args.prefill_chunk < 0:
        raise SystemExit("--prefill-chunk must be >= 0")
    if args.slots < 0:
        raise SystemExit("--slots must be >= 0")
    unported = [
        ("--slots with --prefix-cache", args.slots and args.prefix_cache),
        ("--slots with --speculative", args.slots and args.speculative),
        ("--slots with --tp > 1", args.slots and args.tp > 1),
        ("--speculative", args.speculative),
        ("--prefix-cache", args.prefix_cache),
        ("--tp > 1 (tensor parallelism)", args.tp > 1),
        ("--num-experts (MoE)", args.num_experts),
        ("--weights int8", args.weights == "int8"),
        ("--prefill-chunk", args.prefill_chunk),
    ]
    for flag, on in unported:
        if on:
            raise SystemExit(f"{flag} {_LATER}")


def load_params(args, model) -> dict:
    """The f32 weights to serve, as a state dict on the CPU: the newest
    step under ``--checkpoint-dir``, else random (seed 0).  The
    checkpoint is read as the JAX server reads it, into the train-shaped
    state the port's trainer saves (the model and its AdamW), whose
    weights are then taken."""
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
        init_params,
    )

    if args.checkpoint_dir:
        from container_engine_accelerators_tpu_torch.models.checkpoint import (
            TrainCheckpointer,
        )
        from container_engine_accelerators_tpu_torch.models.lm_train import (
            create_lm_train_state,
        )

        train_model = TransformerLM(
            vocab_size=args.vocab_size, num_layers=args.num_layers,
            num_heads=args.num_heads, head_dim=args.head_dim,
            mlp_dim=args.mlp_dim, num_kv_heads=args.kv_heads or None,
            device="cpu")
        # The optimizer must match cmd/train_lm.py's (AdamW) so the
        # checkpoint's optimizer state loads; serving reads the weights.
        state = create_lm_train_state(
            train_model, optimizer=torch.optim.AdamW(
                train_model.parameters(), lr=3e-4, weight_decay=0.1))
        ck = TrainCheckpointer(os.path.abspath(args.checkpoint_dir))
        state, step = ck.restore_latest(state)
        ck.close()
        if step is not None:
            log.info("loaded step-%d params from %s", step,
                     args.checkpoint_dir)
            return {k: v.detach() for k, v in
                    train_model.state_dict().items()}
        log.info("no checkpoint found; serving random params")
    else:
        log.info("serving randomly-initialized params (demo mode)")
    return init_params(model, torch.Generator().manual_seed(0))


def build_generate(args):
    """Build the decode model on ``args.device`` with the weights of
    :func:`load_params` and return ``run(prompt, prompt_len, temperature,
    seed, sample) -> [1, bucket + max_new] tokens`` (on the CPU).  Calls
    are serialized under one lock: the handler threads share the device.
    ``run.model`` is the model and ``run.params`` its f32 weights (before
    ``--weights``)."""
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )
    from container_engine_accelerators_tpu_torch.models.quant import (
        serving_params,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    device = resolve_device(args.device)
    model = TransformerLM(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, head_dim=args.head_dim,
        mlp_dim=args.mlp_dim, num_kv_heads=args.kv_heads or None,
        decode=True, use_flash_decode=args.flash_decode, device=device,
    )
    params = f32_params = load_params(args, model)
    if args.weights != "f32":
        params = serving_params(params, args.weights)
        log.info("serving weights cast to %s", args.weights)
    model.load_state_dict(params)  # casts to the compute dtype once
    model.eval()

    lock = threading.Lock()

    def run(prompt, prompt_len, temperature, seed, sample):
        with lock, torch.inference_mode():
            gen = (torch.Generator(device=device).manual_seed(seed)
                   if sample else None)
            out = generate(model, prompt.to(device), args.max_new_tokens,
                           temperature=temperature if sample else 0.0,
                           generator=gen, prompt_len=prompt_len)
            return out.cpu()

    run.model = model
    run.params = f32_params
    # Warm up (builds the CUDA kernel with --flash-decode) before traffic.
    warm = bucket_len(1, args.max_prompt_len)
    run(torch.zeros((1, warm), dtype=torch.long), 1, 0.0, 0, False)
    return run


def build_engine(run, args):
    """Continuous-batching engine over ``run.model``, sized for this
    server's admission bound: a lane holds the largest prompt bucket plus
    ``--max-new-tokens``."""
    from container_engine_accelerators_tpu_torch.models.batching import (
        DecodeEngine,
    )

    prompt_bucket = bucket_len(args.max_prompt_len, args.max_prompt_len)
    return DecodeEngine(run.model, max_slots=args.slots,
                        max_len=prompt_bucket + args.max_new_tokens)


def start_engine(run, args):
    """With ``--slots``: the engine's stepper (an ``EngineLoop``), warmed
    before traffic (max_new 2, so that a fleet step runs: a 1-token
    request retires inside submit).  None without ``--slots``."""
    if not args.slots:
        return None
    from container_engine_accelerators_tpu_torch.models.batching import (
        EngineLoop,
    )

    engine_loop = EngineLoop(build_engine(run, args))
    engine_loop.generate([0], 2)
    log.info("continuous batching: %d decode slots", args.slots)
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
                # Optional shared system prompt: without the prefix cache
                # it is plain concatenation — same tokens, full prefill.
                # The combined context is capped at --max-prompt-len.
                prefix_ids = [int(t) % args.vocab_size
                              for t in (req.get("prefix_ids") or [])]
                if prefix_ids:
                    clean = [(prefix_ids + ids)[: args.max_prompt_len]
                             for ids in clean]
                if engine_loop is not None:
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


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    validate_args(args)
    run = build_generate(args)
    engine_loop = start_engine(run, args)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(run, args, engine_loop))
    log.info("serving LM on :%d", server.server_address[1])
    server.serve_forever()


if __name__ == "__main__":
    main()
