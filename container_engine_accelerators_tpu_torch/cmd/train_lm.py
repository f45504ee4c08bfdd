"""Transformer-LM trainer — PyTorch counterpart of ``cmd/train_lm.py``.

Trains the LM on one CUDA device (``--device cpu`` for tests) in bf16
compute with f32 params and AdamW, through the hand-written
flash-attention kernels (``ops/flash_attention.py``) wherever the shape
allows, on synthetic token streams (four rotated batches from a seeded
numpy generator) or a token-shard dataset (``--data-dir``, the
``data/tokens.py`` format).

With ``--checkpoint-dir`` it saves the step, the weights and the AdamW
state every ``--checkpoint-interval`` steps and at the end
(``models/checkpoint.py``), and a restart resumes at the newest saved
step, on the batches that step would have seen.  SIGTERM finishes the
current step, saves, and exits 80 so a Kubernetes Job reschedules the
pod (``utils/preempt.py``).  With ``--profile-dir`` it traces steps
10-20 with ``torch.profiler`` and writes a Chrome trace there, which
``cmd/trace_summary.py`` reads.

With ``--num-experts E`` it trains the MoE-LM (a Switch top-1 FFN of E
experts in every block, capacity factor 1.25, the load-balance loss at
weight 0.01 in the objective; ``ops/moe.py``).

Across GPUs it runs one process a GPU, over a (data, model) mesh
(``parallel/``): launch it with ``torchrun --nproc-per-node N -m
container_engine_accelerators_tpu_torch.cmd.train_lm`` (or under the K8s
env contract of ``parallel/dcn.py``).  ``--model-par M`` shards every
weight over the model axis by the JAX rule, ``--param-sharding fsdp``
also over the data axis (with the AdamW moments), and the batch splits
by rows over the data axis.  The mesh path runs when a launcher started
more than one rank, or with ``--model-par > 1`` or ``--param-sharding
fsdp`` (on one rank, the (1, 1) mesh); one rank without them is the
single-device trainer, launcher or not.  Every rank builds the same global
batch and keeps its rows (``--data-dir``: reads only its rows); rank 0
logs and writes the checkpoints.  ``--num-experts`` runs on the mesh
too, under either layout: the experts' F split over the model axis, the
routing over the global batch (``ops/moe.py``).

``--seq-parallel ring|ring-zigzag|ulysses`` splits the SEQUENCE over the
ranks instead (the JAX trainer's long-context mode; a (world, 1) mesh,
also on one rank): the weights stay replicated, every rank builds the
same global batch, reorders it into zigzag storage order for
``ring-zigzag`` (labels and mask from the original order), and keeps its
``--seq-len / world`` columns; attention is the ring, its blocks on the
flash-attention kernels, or Ulysses' all-to-all (``parallel/seq.py``).

Run: ``python -m container_engine_accelerators_tpu_torch.cmd.train_lm
[--train-steps N] [--num-experts E] ...``.  It takes the JAX trainer's
flags.
"""

import argparse
import contextlib
import logging
import os
import time

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.parallel.launch import (
    seq_mesh,
    stop_agreed,
    trainer_mesh,
    wants_mesh,
)
from container_engine_accelerators_tpu_torch.utils.profile import ProfileWindow

log = logging.getLogger("train-lm")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PyTorch transformer-LM trainer")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    p.add_argument("--vocab-size", type=int, default=32000)
    p.add_argument("--num-layers", type=int, default=12)
    p.add_argument("--num-heads", type=int, default=8)
    p.add_argument("--head-dim", type=int, default=64)
    p.add_argument("--mlp-dim", type=int, default=2048)
    p.add_argument("--kv-heads", type=int, default=0,
                   help="GQA KV heads (0 = MHA)")
    p.add_argument("--num-experts", type=int, default=0,
                   help="MoE-LM: Switch top-1 FFN with this many experts "
                        "in every block (0 = dense)")
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--train-batch-size", type=int, default=8)
    p.add_argument("--seq-parallel", default="none",
                   choices=("none", "ring", "ring-zigzag", "ulysses"),
                   help="sequence/context parallelism over the ranks "
                        "(ring-zigzag = causal-balanced ring; inputs are "
                        "reordered automatically)")
    p.add_argument("--param-sharding", default="megatron",
                   choices=("megatron", "fsdp"),
                   help="weight layout over the mesh: megatron (model "
                        "axis) or fsdp (also the data axis, with the "
                        "AdamW moments)")
    p.add_argument("--model-par", type=int, default=1,
                   help="tensor-parallel degree (ranks on the model axis)")
    p.add_argument("--learning-rate", type=float, default=3e-4)
    p.add_argument("--train-steps", type=int, default=100)
    p.add_argument("--steps-per-eval", type=int, default=20)
    p.add_argument("--data-dir", default=None,
                   help="token-shard dataset dir (data/tokens.py format). "
                        "Default: synthetic token streams")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir: save every --checkpoint-interval "
                        "steps and at the end, resume from the newest step")
    p.add_argument("--checkpoint-interval", type=int, default=100)
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of steps "
                        "10-20 here (read it with cmd/trace_summary.py)")
    return p.parse_args(argv)


def validate_args(args):
    """The JAX trainer's own checks."""
    if args.checkpoint_interval < 1:
        raise SystemExit("--checkpoint-interval must be >= 1")
    if args.num_experts and args.seq_parallel != "none":
        raise SystemExit(
            "--num-experts with --seq-parallel is not validated: MoE "
            "capacity routing under sequence sharding changes the "
            "global token-drop semantics; drop one of the flags")
    if args.model_par < 1:
        raise SystemExit("--model-par must be >= 1")
    if args.seq_parallel != "none":
        if args.model_par > 1:
            raise SystemExit(
                "--model-par does not compose with --seq-parallel yet: "
                "the sequence shards occupy the whole data axis and "
                "params are replicated; drop one of the flags")
        if args.param_sharding != "megatron":
            raise SystemExit(
                "--param-sharding fsdp applies to dense mode only: the "
                "sequence-parallel path runs with replicated params; drop "
                "one of the flags")


def synthetic_batches(args, n_batches=4):
    """The JAX trainer's synthetic data: ``n_batches`` distinct batches
    from ``np.random.default_rng(0)``, rotated (identical batches could
    let a measurement short-circuit), with next-token labels and the last
    position masked."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n_batches):
        toks = rng.integers(0, args.vocab_size,
                            (args.train_batch_size, args.seq_len)
                            ).astype(np.int32)
        labels = np.roll(toks, -1, axis=1)
        mask = np.ones(toks.shape, np.float32)
        mask[:, -1] = 0.0
        out.append((toks, labels, mask))
    return out


def main(argv=None, on_step=None):
    """Train; return the losses of the steps this run took (from the
    restored step on), as floats.  ``on_step(step, loss, metrics)``, if
    given, is called after each step is enqueued, with the loss and the
    step's metrics (with ``--num-experts``, ``moe_aux`` and
    ``moe_dropped`` too) still device tensors."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    validate_args(args)
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import dcn

    # A process group this run creates, it destroys.
    owns_group = ((args.seq_parallel != "none"
                   or wants_mesh(args.model_par, args.param_sharding))
                  and not dist.is_initialized())
    try:
        return _train(args, on_step)
    finally:
        if owns_group:
            dcn.shutdown()


def _train(args, on_step):
    from container_engine_accelerators_tpu_torch.models.lm_train import (
        create_lm_train_state,
        make_lm_train_step,
    )
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel.seq import (
        zigzag_permutation,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )
    from container_engine_accelerators_tpu_torch.utils.preempt import (
        PreemptionGuard,
        checkpoint_and_exit,
    )

    seq_parallel = None if args.seq_parallel == "none" else args.seq_parallel
    mesh, rank = None, 0
    device = resolve_device(args.device)
    if seq_parallel:
        mesh, rank, device = seq_mesh(args.device, args.seq_len)
    elif wants_mesh(args.model_par, args.param_sharding):
        mesh, rank, device = trainer_mesh(args.device, args.model_par,
                                          args.train_batch_size)
    if rank:
        log.setLevel(logging.WARNING)  # rank 0 logs
    model = TransformerLM(
        vocab_size=args.vocab_size, num_layers=args.num_layers,
        num_heads=args.num_heads, head_dim=args.head_dim,
        mlp_dim=args.mlp_dim, num_kv_heads=args.kv_heads or None,
        num_experts=args.num_experts, seq_parallel=seq_parallel,
        device=device)
    state = create_lm_train_state(
        model, torch.Generator().manual_seed(0),
        torch.optim.AdamW(model.parameters(), lr=args.learning_rate,
                          weight_decay=0.1))
    step_fn, state = make_lm_train_step(mesh, state, seq_parallel,
                                        args.param_sharding)
    log.info("device %s, %d params, seq_len %d, batch %d%s%s", device,
             sum(p.numel() for p in model.parameters()), args.seq_len,
             args.train_batch_size,
             f", {args.num_experts} experts" if args.num_experts else "",
             f", seq_parallel={seq_parallel} over {mesh.size()} ranks"
             if seq_parallel else "")

    checkpointer = None
    start_step = 0
    if args.checkpoint_dir:
        from container_engine_accelerators_tpu_torch.models.checkpoint import (
            TrainCheckpointer,
        )

        checkpointer = TrainCheckpointer(os.path.abspath(args.checkpoint_dir))
        state, restored_step = checkpointer.restore_latest(state)
        if restored_step is not None:
            start_step = restored_step
            log.info("resuming from checkpoint at step %d", start_step)

    rows, cols, perm = slice(None), slice(None), None
    shard = (0, 1)
    if seq_parallel:
        # Every rank reads the whole batch and keeps its columns, after
        # the zigzag reorder for ring-zigzag (labels and mask come from
        # the original order: the batch sources build them first).
        n = mesh.size()
        width = args.seq_len // n
        cols = slice(rank * width, (rank + 1) * width)
        if seq_parallel == "ring-zigzag":
            perm = zigzag_permutation(args.seq_len, n).numpy()
    elif mesh is not None:
        from container_engine_accelerators_tpu_torch.parallel.mesh import (
            batch_rows,
            data_shard,
            from_local_batch,
        )

        start, n = batch_rows(mesh, args.train_batch_size)
        rows = slice(start, start + n)
        shard = data_shard(mesh)

    def on_device(toks, labels, mask, rows=rows):
        """A batch on the device: this rank's rows of the global batch,
        as the batch DTensor on a mesh; under --seq-parallel, its columns
        (of the zigzag order for ring-zigzag), as plain tensors."""
        if perm is not None:
            toks, labels, mask = (x[:, perm] for x in (toks, labels, mask))
        toks, labels, mask = (np.ascontiguousarray(x[rows, cols])
                              for x in (toks, labels, mask))
        out = (torch.from_numpy(toks).to(device, torch.long),
               torch.from_numpy(labels).to(device, torch.long),
               torch.from_numpy(mask).to(device))
        if mesh is None or seq_parallel:
            return out
        return tuple(from_local_batch(x, mesh) for x in out)

    # Both sources are pure functions of the step, so a resumed run sees
    # the batches the unbroken run would have seen from start_step on.
    batch_iter = batches = None
    if args.data_dir:
        from container_engine_accelerators_tpu_torch.data import (
            TokenBatchLoader,
            TokenShardReader,
        )

        reader = TokenShardReader(args.data_dir)
        loader = TokenBatchLoader(reader, args.train_batch_size, args.seq_len,
                                  vocab_size=args.vocab_size, shard=shard)
        log.info("dataset: %d tokens (%d steps/epoch) from %s",
                 reader.total_tokens, loader.steps_per_epoch(), args.data_dir)
        batch_iter = loader.iter_batches(start_step,
                                         args.train_steps - start_step)
    else:
        batches = [on_device(*b) for b in synthetic_batches(args)]

    losses = []
    tokens_per_batch = args.train_batch_size * args.seq_len
    profile = None
    t0 = time.perf_counter()
    try:
        with PreemptionGuard() as guard:
            for step in range(start_step, args.train_steps):
                # Trace steady-state steps (the JAX trainer's window).
                if args.profile_dir and step == max(
                        start_step, min(10, args.train_steps - 1)):
                    profile = ProfileWindow(args.profile_dir, device,
                                            "train_lm")
                if batch_iter is not None:
                    toks, labels, mask = on_device(*next(batch_iter),
                                                   rows=slice(None))
                else:
                    toks, labels, mask = batches[step % len(batches)]
                with (profile.step(step) if profile
                      else contextlib.nullcontext()):
                    state, metrics = step_fn(state, toks, labels, mask)
                losses.append(metrics["loss"])
                if on_step is not None:
                    on_step(step, metrics["loss"], metrics)
                if profile and step >= min(20, args.train_steps - 1):
                    profile.stop()
                    profile = None
                if (step + 1) % args.steps_per_eval == 0:
                    dt = time.perf_counter() - t0
                    log.info("step %d loss=%.4f tokens/sec=%.0f%s", step + 1,
                             float(metrics["loss"]),
                             (step + 1 - start_step) * tokens_per_batch / dt,
                             "".join(f" {k}={float(v):.4f}"
                                     for k, v in metrics.items()
                                     if k.startswith("moe_")))
                if checkpointer and (step + 1) % args.checkpoint_interval == 0:
                    checkpointer.save(state)
                if stop_agreed(guard.should_stop, mesh):
                    checkpoint_and_exit(checkpointer, state, step,
                                        args.checkpoint_interval, profile)
    finally:
        if batch_iter is not None:
            batch_iter.close()  # stops the prefetch thread
    losses = [float(x) for x in losses]  # waits for the last step
    total = time.perf_counter() - t0
    steps_run = args.train_steps - start_step
    log.info("done: %d steps, %.0f tokens/sec overall", steps_run,
             steps_run * tokens_per_batch / max(total, 1e-9))
    if checkpointer:
        if steps_run > 0:
            checkpointer.save(state)
        checkpointer.close()
    return losses


if __name__ == "__main__":
    main()
