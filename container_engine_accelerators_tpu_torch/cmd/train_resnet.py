"""Image-model trainer — PyTorch counterpart of ``cmd/train_resnet.py``.

Trains ResNet (``--resnet-depth`` 18/34/50/101/152, 50 by default) or
Inception-v3 (``--model inception-v3``) on one CUDA device (``--device
cpu`` for tests), in bf16 compute with f32 parameters, ``channels_last``
activations, and nesterov SGD on a warmup-cosine schedule
(``models/train.py``), on synthetic images (four rotated batches from
``np.random.default_rng(0)``, the JAX trainer's arrays) or an array-shard
dataset (``--data-dir``, the ``data/arrays.py`` format).

With ``--checkpoint-dir`` it saves the step, the weights with the
BatchNorm statistics and the momentum every ``--checkpoint-interval``
steps and at the end (``models/checkpoint.py``), and a restart resumes
at the newest saved step, on the batches that step would have seen.
SIGTERM finishes the current step, saves, and exits 80
(``utils/preempt.py``).  ``--profile-dir`` traces steps 10-20 for
``cmd/trace_summary.py``.  ``--model-dir`` receives the final parameters
(``params.pt``, a ``torch.save`` of the parameter tensors without the
BatchNorm statistics, as the JAX trainer writes ``state.params`` alone);
``cmd/serve_resnet.py --model-dir`` serves them.

Across GPUs it runs one process a GPU over a (data, model) mesh
(``torchrun --nproc-per-node N -m ...train_resnet [--model-par M]``, or
the K8s env contract of ``parallel/dcn.py``): the weights and their
momentum are laid out tensor parallel by the JAX rule, the batch splits
by rows over the data axis, and BatchNorm takes the global batch's
statistics (``models/train.py::make_sharded_train_step``).  The mesh
path runs when a launcher started more than one rank or with
``--model-par > 1``; one rank without it is the single-device trainer.
ResNet and Inception-v3 take the same step.  Each model rank convolves
with its shard of every weight (``models/resnet.py::Conv``: 1/M of the
output or of the input channels, the JAX rule's split), so ``--model-par
M`` splits the convolutions' compute and weight memory M ways and adds a
gather or an all-reduce of each convolution's output.  Each
data-parallel rank makes its own rows
(synthetic: ``np.random.default_rng(<data index>)``, the JAX trainer's
per-process stream; ``--data-dir``: its rows of the global batch); rank
0 logs and writes.

Run: ``python -m container_engine_accelerators_tpu_torch.cmd.train_resnet
[--train-steps N] ...``.  It takes the JAX trainer's flags.
"""

import argparse
import contextlib
import logging
import os
import time

import numpy as np
import torch

from container_engine_accelerators_tpu_torch.parallel.launch import (
    stop_agreed,
    trainer_mesh,
    wants_mesh,
)
from container_engine_accelerators_tpu_torch.utils.profile import ProfileWindow

log = logging.getLogger("train-resnet")

PARAMS_FILE = "params.pt"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PyTorch ResNet trainer")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, cuda:N or cpu)")
    p.add_argument("--model", default="resnet",
                   choices=("resnet", "inception-v3"),
                   help="model family")
    p.add_argument("--resnet-depth", type=int, default=50,
                   help="ResNet depth (18/34/50/101/152)")
    p.add_argument("--train-batch-size", type=int, default=128)
    p.add_argument("--base-learning-rate", type=float, default=0.1)
    p.add_argument("--train-steps", type=int, default=200)
    p.add_argument("--steps-per-eval", type=int, default=50,
                   help="metric log interval (steps)")
    p.add_argument("--num-classes", type=int, default=1000)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--model-par", type=int, default=1,
                   help="tensor-parallel degree (ranks on the model "
                        "axis).  Each model rank convolves with its 1/M "
                        "shard of every weight (output or input channels, "
                        "the JAX rule's split) and the ranks combine the "
                        "outputs; needs a multiple of M ranks")
    p.add_argument("--data-dir", default=None,
                   help="array-shard dataset dir (data/arrays.py format: "
                        "images + labels).  Default: synthetic images")
    p.add_argument("--model-dir", default=None,
                   help=f"directory for the final params ({PARAMS_FILE})")
    p.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint dir: save every --checkpoint-interval "
                        "steps and at the end, resume from the newest step")
    p.add_argument("--checkpoint-interval", type=int, default=100,
                   help="steps between checkpoints (>= 1)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of steps "
                        "10-20 here (read it with cmd/trace_summary.py)")
    return p.parse_args(argv)


def validate_args(args):
    """The JAX trainer's own checks."""
    if args.checkpoint_interval < 1:
        raise SystemExit("--checkpoint-interval must be >= 1")
    if args.model_par < 1:
        raise SystemExit("--model-par must be >= 1")


def build_model(args, device):
    """The trainer's model, bf16 compute, on ``device`` (weights not yet
    drawn)."""
    from container_engine_accelerators_tpu_torch.models.inception import (
        inception_v3,
    )
    from container_engine_accelerators_tpu_torch.models.resnet import resnet

    if args.model == "inception-v3":
        return inception_v3(num_classes=args.num_classes, device=device)
    return resnet(args.resnet_depth, num_classes=args.num_classes,
                  device=device)


def synthetic_batches(args, n_batches=4, index=0, count=1):
    """The JAX trainer's synthetic data for process ``index`` of
    ``count``: ``n_batches`` NHWC f32 image batches of its
    ``batch / count`` rows from ``np.random.default_rng(index)``, then as
    many label batches (identical batches could let a measurement
    short-circuit, so they rotate)."""
    rng = np.random.default_rng(index)
    shape = (args.train_batch_size // count, args.image_size,
             args.image_size, 3)
    xs = [rng.standard_normal(shape, dtype=np.float32)
          for _ in range(n_batches)]
    ys = [rng.integers(0, args.num_classes, (shape[0],),
                       dtype=np.int32) for _ in range(n_batches)]
    return list(zip(xs, ys))


def params_state(model: torch.nn.Module) -> dict:
    """The model's parameters alone (no BatchNorm statistics), whole and
    on the CPU: what ``--model-dir`` receives."""
    from container_engine_accelerators_tpu_torch.parallel.mesh import full

    return {name: full(p.detach()).cpu()
            for name, p in model.named_parameters()}


def main(argv=None, on_step=None):
    """Train; return the losses of the steps this run took (from the
    restored step on), as floats.  ``on_step(step, loss)``, if given, is
    called after each step is enqueued, with the loss still a device
    tensor."""
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = parse_args(argv)
    validate_args(args)
    import torch.distributed as dist

    from container_engine_accelerators_tpu_torch.parallel import dcn

    # A process group this run creates, it destroys.
    owns_group = wants_mesh(args.model_par) and not dist.is_initialized()
    try:
        return _train(args, on_step)
    finally:
        if owns_group:
            dcn.shutdown()


def _train(args, on_step):
    from container_engine_accelerators_tpu_torch.models.train import (
        cosine_sgd,
        create_train_state,
        make_sharded_train_step,
        train_step,
    )
    from container_engine_accelerators_tpu_torch.utils.device import (
        resolve_device,
    )
    from container_engine_accelerators_tpu_torch.utils.preempt import (
        PreemptionGuard,
        checkpoint_and_exit,
    )

    mesh, rank = None, 0
    device = resolve_device(args.device)
    if wants_mesh(args.model_par):
        mesh, rank, device = trainer_mesh(args.device, args.model_par,
                                          args.train_batch_size)
        if rank:
            log.setLevel(logging.WARNING)  # rank 0 logs
    model = build_model(args, device)
    state = create_train_state(
        model, torch.Generator().manual_seed(0),
        cosine_sgd(base_lr=args.base_learning_rate,
                   total_steps=args.train_steps,
                   warmup_steps=min(500, max(1, args.train_steps // 10))))
    step_fn = train_step
    if mesh is not None:
        step_fn, state = make_sharded_train_step(mesh, state)
    name = (args.model if args.model != "resnet"
            else f"resnet-{args.resnet_depth}")
    log.info("device %s, %s, %d params, batch %d at %dx%d", device, name,
             sum(p.numel() for p in model.parameters()),
             args.train_batch_size, args.image_size, args.image_size)

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

    shard = (0, 1)
    if mesh is not None:
        from container_engine_accelerators_tpu_torch.parallel.mesh import (
            data_shard,
            from_local_batch,
        )

        shard = data_shard(mesh)

    def on_device(images, labels):
        """This rank's rows on the device (the batch DTensor on a
        mesh).  NHWC permuted to NCHW is channels_last: no copy on the
        device."""
        out = (torch.from_numpy(images).to(device).permute(0, 3, 1, 2),
               torch.from_numpy(labels).to(device, torch.long))
        if mesh is None:
            return out
        return tuple(from_local_batch(x, mesh) for x in out)

    # Both sources are pure functions of the step, so a resumed run sees
    # the batches the unbroken run would have seen from start_step on.
    batch_iter = batches = None
    if args.data_dir:
        from container_engine_accelerators_tpu_torch.data import (
            ArrayShardReader,
            ImageBatchLoader,
        )

        reader = ArrayShardReader(args.data_dir)
        want = (args.image_size, args.image_size, 3)
        if reader.sample_shape != want:
            raise SystemExit(
                f"--data-dir samples are {reader.sample_shape}, model "
                f"expects {want} (set --image-size to match)")
        loader = ImageBatchLoader(reader, args.train_batch_size,
                                  num_classes=args.num_classes, shard=shard)
        log.info("dataset: %d samples (%d steps/epoch) from %s",
                 reader.total_samples, loader.steps_per_epoch(),
                 args.data_dir)
        batch_iter = loader.iter_batches(start_step,
                                         args.train_steps - start_step)
    else:
        batches = [on_device(*b) for b in synthetic_batches(args, 4,
                                                            *shard)]

    losses = []
    profile = None
    t0 = time.perf_counter()
    try:
        with PreemptionGuard() as guard:
            for step in range(start_step, args.train_steps):
                # Trace steady-state steps (the JAX trainer's window).
                if args.profile_dir and step == max(
                        start_step, min(10, args.train_steps - 1)):
                    profile = ProfileWindow(args.profile_dir, device,
                                            "train_resnet")
                if batch_iter is not None:
                    images, labels = on_device(*next(batch_iter))
                else:
                    images, labels = batches[step % len(batches)]
                with (profile.step(step) if profile
                      else contextlib.nullcontext()):
                    state, metrics = step_fn(state, images, labels)
                losses.append(metrics["loss"])
                if on_step is not None:
                    on_step(step, metrics["loss"])
                if profile and step >= min(20, args.train_steps - 1):
                    profile.stop()
                    profile = None
                if (step + 1) % args.steps_per_eval == 0:
                    dt = time.perf_counter() - t0
                    log.info("step %d loss=%.4f acc=%.4f images/sec=%.1f",
                             step + 1, float(metrics["loss"]),
                             float(metrics["accuracy"]),
                             (step + 1 - start_step) * args.train_batch_size
                             / dt)
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
    log.info("done: %d steps, %.1f images/sec overall", steps_run,
             steps_run * args.train_batch_size / max(total, 1e-9))
    if checkpointer:
        if steps_run > 0:
            checkpointer.save(state)
        checkpointer.close()
    if args.model_dir:
        params = params_state(state.model)  # every rank: a collective
        if rank == 0:
            os.makedirs(args.model_dir, exist_ok=True)
            path = os.path.join(args.model_dir, PARAMS_FILE)
            torch.save(params, path)
            log.info("wrote final params to %s", path)
    return losses


if __name__ == "__main__":
    main()
