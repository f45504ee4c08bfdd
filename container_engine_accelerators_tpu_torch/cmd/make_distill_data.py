#!/usr/bin/env python3
"""Generate a distillation corpus from a trained target LM — PyTorch
counterpart of the root ``cmd/make_distill_data.py``.

Speculative decoding's speedup is acceptance rate times draft price
(``models/speculative.py``): a random draft accepts ~1/vocab, and a
trained draft is what makes the k-token gamble pay.  The recipe is
compositional — no new training loop, no teacher hooks:

1. this tool samples the TARGET model autoregressively (batched
   ``models/generate.py::generate``: one prefill, then single-token
   decode steps) and writes the sampled sequences in the token-shard
   format (``data/tokens.py``);
2. the draft then trains on that corpus with plain ``cmd/train_lm.py
   --data-dir`` — next-token cross-entropy against target-generated text
   IS distillation onto the target's conditional distribution;
3. serve with ``cmd/serve_lm.py --speculative K
   --draft-checkpoint-dir``.

The same flags and defaults as the JAX tool, plus ``--device`` (default
``cuda``).  The target is built in decode mode at the compute dtype
(bf16), without flash decode, as the JAX tool builds it; batch ``i``
samples from ``torch.Generator(device).manual_seed(seed + i)`` on prompts
drawn from ``np.random.default_rng(seed)``.  At ``--temperature 0`` the
corpus is greedy, and in f32 it is the JAX tool's, byte for byte.

Usage (``M=container_engine_accelerators_tpu_torch.cmd``):
  python -m $M.make_distill_data --checkpoint-dir CK --out DIR \\
      --tokens 2000000 [model shape flags as in serve_lm]
  python -m $M.train_lm --num-layers 3 --data-dir DIR --checkpoint-dir D
  python -m $M.serve_lm --checkpoint-dir CK --speculative 4 \\
      --draft-checkpoint-dir D --flash-decode
"""

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

log = logging.getLogger("make-distill-data")

# Buffer on the host and flush few LARGE shards: one tiny shard and an
# index rebuild per batch would be O(n^2) directory scans and hundreds
# of KB-sized files.
SHARD_TOKENS = 1 << 22  # 16 MiB of uint32 a shard


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--mlp-dim", type=int, default=2048)
    p.add_argument("--kv-heads", type=int, default=0)
    p.add_argument("--num-experts", type=int, default=0)
    p.add_argument("--checkpoint-dir", required=True,
                   help="the target LM's checkpoint (cmd/train_lm.py)")
    p.add_argument("--out", required=True,
                   help="token-shard output dir (data/tokens.py format)")
    p.add_argument("--tokens", type=int, default=1_000_000,
                   help="total corpus size (prompt + sampled tokens)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--prompt-len", type=int, default=8,
                   help="random seed-prompt length per sequence")
    p.add_argument("--gen-len", type=int, default=120,
                   help="sampled tokens per sequence")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="sampling temperature (1.0 keeps the target's "
                        "own distribution — what the draft must learn; "
                        "0 would collapse coverage to one greedy path "
                        "per prompt)")
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def sample_corpus(model, out, tokens, batch, prompt_len, gen_len,
                  temperature, seed, shard_tokens=SHARD_TOKENS):
    """Sample ``model`` (decode mode, on its device) into token shards
    under ``out`` -> (tokens written, shards).

    ``ceil(tokens / (batch x (prompt_len + gen_len)))`` batches, at
    least one: batch ``i`` is ``batch`` prompts of ``prompt_len`` tokens
    from ``np.random.default_rng(seed)``, each followed by ``gen_len``
    tokens sampled at ``temperature`` from a generator seeded
    ``seed + i``.  Rows are written whole, in order, buffered on the
    host into shards of at least ``shard_tokens`` (the last may be
    shorter) through ``write_token_shards(name_offset=...)``."""
    from container_engine_accelerators_tpu_torch.data.tokens import (
        write_token_shards,
    )
    from container_engine_accelerators_tpu_torch.models.generate import (
        generate,
    )

    device = model.embed.device
    per_batch = batch * (prompt_len + gen_len)
    n_batches = max(1, -(-tokens // per_batch))
    rng = np.random.default_rng(seed)
    buffer, buffered, shard_idx, written = [], 0, 0, 0

    def flush():
        nonlocal buffer, buffered, shard_idx
        if not buffer:
            return
        write_token_shards(out, [np.concatenate(buffer)],
                           name_offset=shard_idx)
        shard_idx += 1
        buffer, buffered = [], 0

    for i in range(n_batches):
        prompts = torch.from_numpy(
            rng.integers(0, model.vocab_size, (batch, prompt_len))).to(device)
        with torch.inference_mode():
            rows = generate(model, prompts, gen_len, temperature=temperature,
                            generator=torch.Generator(device=device)
                            .manual_seed(seed + i)).cpu().numpy()
        buffer.append(rows.reshape(-1).astype(np.uint32))
        buffered += rows.size
        written += rows.size
        if buffered >= shard_tokens:
            flush()
        if (i + 1) % 10 == 0 or i + 1 == n_batches:
            log.info("batch %d/%d: %d tokens sampled", i + 1, n_batches,
                     written)
    flush()
    return written, shard_idx


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)

    from container_engine_accelerators_tpu_torch.models.checkpoint import (
        TrainCheckpointer,
    )
    from container_engine_accelerators_tpu_torch.models.lm_train import (
        create_lm_train_state,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )

    # write_token_shards rebuilds the index from directory contents, so
    # stale shards from a previous run would silently blend into this
    # corpus — refuse (like native/tokpack and the array writer), and
    # do it BEFORE the expensive checkpoint restore.
    if os.path.isdir(args.out) and any(
            f.endswith(".tokens") for f in os.listdir(args.out)):
        raise SystemExit(
            f"{args.out} already holds token shards — refusing to mix "
            f"corpora (sample into a fresh dir)")

    cfg = dict(
        vocab_size=args.vocab_size,
        num_layers=args.num_layers,
        num_heads=args.num_heads,
        head_dim=args.head_dim,
        mlp_dim=args.mlp_dim,
        num_kv_heads=args.kv_heads or None,
        num_experts=args.num_experts,
    )
    # The train-shaped state (the model and the trainer's AdamW) on the
    # CPU, so that the checkpoint's optimizer state loads.
    train_model = TransformerLM(**cfg, device="cpu")
    state = create_lm_train_state(train_model, optimizer=torch.optim.AdamW(
        train_model.parameters(), lr=3e-4, weight_decay=0.1))
    ck = TrainCheckpointer(os.path.abspath(args.checkpoint_dir))
    state, step = ck.restore_latest(state)
    ck.close()
    if step is None:
        raise SystemExit(
            f"{args.checkpoint_dir}: no checkpoint found — distilling "
            f"from random weights would teach the draft noise")
    log.info("target: step-%d params from %s", step, args.checkpoint_dir)
    # Only the params sample; dropping the state frees the restored
    # Adam moments (2x params) before the decode model is built.
    params = {k: v.detach() for k, v in train_model.state_dict().items()}
    del state, train_model

    model = TransformerLM(**cfg, decode=True,
                          device=resolve_device(args.device))
    model.load_state_dict(params)  # casts to the compute dtype once
    model.eval()
    t0 = time.perf_counter()
    written, shards = sample_corpus(
        model, args.out, args.tokens, args.batch, args.prompt_len,
        args.gen_len, args.temperature, args.seed)
    seconds = time.perf_counter() - t0
    log.info("done: %d tokens in %d shards -> %s in %.3f s (%.0f tokens/s; "
             "train the draft with cmd/train_lm.py --data-dir)", written,
             shards, args.out, seconds, written / max(seconds, 1e-9))
    return 0


if __name__ == "__main__":
    sys.exit(main())
