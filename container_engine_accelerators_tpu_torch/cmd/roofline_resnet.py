#!/usr/bin/env python3
"""ResNet train-step roofline: where is the card's ceiling for the step?
Counterpart of ``cmd/roofline_resnet.py``.

For each batch size it counts the step's FLOPs and HBM bytes and takes
the classic roofline bound

    t_lower >= max(flops / peak_flops, bytes / hbm_bw)
    mfu_ceiling = flops / (t_lower * peak_flops)

with the peak and the bandwidth of the card (``utils/chip.py``).  PyTorch
has no counterpart of XLA's compiled cost analysis, so both counts are
analytic:

- FLOPs: 2 x the multiply-adds of every convolution and dense layer in
  the forward (``models/resnet.py::forward_flops``), times 3 for the
  train step (forward, and a backward of twice its work); every row says
  so (``flops_model``);
- bytes: the JAX tool's fusion-optimistic model (``_analytic_bytes``),
  always (``bytes_model: analytic-optimistic``); ``--analytic`` is
  accepted and changes nothing.

On the card it also times real steps of ``models/train.py::train_step``
(bf16, ``channels_last``, cuDNN, as ``cmd/train_resnet.py`` runs it) over
4 rotating device batches, synchronized before and after the timed
window, and reports the MFU and its fraction of the ceiling.

Usage:
  python -m container_engine_accelerators_tpu_torch.cmd.roofline_resnet \\
      [--batches 128,256,512] [--steps 50] [--device cuda]
Prints one JSON line per batch size.
"""

import argparse
import json
import sys
import time

from container_engine_accelerators_tpu_torch.utils.device import (
    resolve_device,
    synchronize,
)

# Train step = forward + backward (the backward does the forward's
# products twice: activations' and weights' gradients).
TRAIN_FLOPS_FACTOR = 3
FLOPS_MODEL = ("analytic: 3 x forward, 2 x the multiply-adds of every "
               "convolution and dense layer")
# Convolutions whose outputs the byte model counts: flax auto-names a
# block's convolutions Conv_0..Conv_2 and the JAX tool keeps the
# intermediates under path keys starting with "Conv" or "Dense", so the
# stem (conv_init), the shortcuts (conv_proj) and the head (head) fall
# outside it.  The port's blocks call them conv0..conv2.
_COUNTED_CONVS = ("conv0", "conv1", "conv2")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, or cpu for a smoke run)")
    p.add_argument("--batches", default="128,256,512")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--no-time", action="store_true",
                   help="count only (no timed steps)")
    p.add_argument("--analytic", action="store_true",
                   help="accepted for the JAX tool's command lines: the "
                        "byte model is always the fusion-optimistic hand "
                        "model here (no compiled cost analysis)")
    return p.parse_args(argv)


def analytic_counts(model, x):
    """-> (forward FLOPs, counted activation elements, parameter
    elements) of ``model`` on the batch ``x``.  FLOPs:
    ``models/resnet.py::forward_flops`` (2 x the multiply-adds of every
    convolution and dense layer) times the batch.  Activations: the
    outputs of the blocks' convolutions (``_COUNTED_CONVS``), from one
    eval forward with hooks (no state changes).  Parameters: every
    trainable leaf (BatchNorm running statistics are buffers, as flax
    keeps them out of ``params``)."""
    import torch

    from container_engine_accelerators_tpu_torch.models.resnet import (
        Conv,
        forward_flops,
    )

    act = 0

    def count(module, args, output):
        nonlocal act
        act += output.numel()

    hooks = [m.register_forward_hook(count)
             for name, m in model.named_modules()
             if isinstance(m, Conv)
             and name.rsplit(".", 1)[-1] in _COUNTED_CONVS]
    was_training = model.training
    try:
        model.eval()
        with torch.inference_mode():
            model(x)
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    p_elems = sum(p.numel() for p in model.parameters() if p.requires_grad)
    return forward_flops(model, x.shape[-1]) * x.shape[0], act, p_elems


def _analytic_bytes(model, x):
    """Fusion-optimistic per-step HBM traffic -> (bytes, activation
    elements, parameter elements), the JAX tool's model: the forward
    writes each counted activation once and reads it once (~2A), the
    backward re-reads it and streams its gradient in and out (~3A), so
    ~5A at bf16; parameters are read in the forward and the backward,
    their gradient written, the momentum read and written and the
    parameter written, ~6P at f32.  An OPTIMISTIC bound a measured step
    is judged against, not a prediction."""
    _, act_elems, p_elems = analytic_counts(model, x)
    return _bytes_of(act_elems, p_elems), act_elems, p_elems


def _bytes_of(act_elems, p_elems):
    act_bytes = 2  # bf16 activations
    return 5 * act_elems * act_bytes + 6 * p_elems * 4


def synthetic_batches(batch, size, dev, nonce, n=4, num_classes=1000):
    """``n`` NHWC f32 image batches on ``dev`` viewed as NCHW (a
    ``channels_last`` view, no copy) and their labels, drawn from
    ``nonce``: each timed step sees a batch the previous step did not."""
    import torch

    gen = torch.Generator().manual_seed(nonce)
    xs = [torch.randn((batch, size, size, 3), generator=gen).to(dev)
          .permute(0, 3, 1, 2) for _ in range(n)]
    ys = [torch.randint(0, num_classes, (batch,), generator=gen).to(dev)
          for _ in range(n)]
    return xs, ys


def build_state(depth, dev):
    """A fresh ResNet of ``depth`` on ``dev`` (bf16 compute, f32 weights
    drawn from seed 0) and its train state (``cosine_sgd``, 1000 steps),
    as the JAX tool builds it."""
    import torch

    from container_engine_accelerators_tpu_torch.models.resnet import resnet
    from container_engine_accelerators_tpu_torch.models.train import (
        cosine_sgd,
        create_train_state,
    )

    model = resnet(depth, device=dev)
    return create_train_state(model, torch.Generator().manual_seed(0),
                              cosine_sgd(total_steps=1000))


def main(argv=None):
    args = parse_args(argv)
    import torch

    from container_engine_accelerators_tpu_torch.models.train import (
        train_step,
    )
    from container_engine_accelerators_tpu_torch.utils.chip import (
        _chip_hbm_bw,
        _chip_peak_flops,
        _validate_mfu,
        chip_generation,
    )

    dev = resolve_device(args.device)
    on_accel = dev.type == "cuda"
    peak, peak_src = _chip_peak_flops(dev, "bfloat16")
    bw, _ = _chip_hbm_bw(dev)
    chip, source = chip_generation(dev)
    kind = torch.cuda.get_device_name(dev) if on_accel else "cpu"
    print(f"roofline: {kind} peak={peak / 1e12:.0f}TF/s "
          f"hbm={bw / 1e9:.0f}GB/s ({chip}, from {source})", file=sys.stderr)

    size = args.image_size
    for batch in (int(b) for b in args.batches.split(",")):
        state = build_state(args.depth, dev)
        xs, ys = synthetic_batches(batch, size, dev,
                                   time.time_ns() & 0x7FFFFFFF)
        fwd_flops, act_elems, p_elems = analytic_counts(state.model, xs[0])
        flops = TRAIN_FLOPS_FACTOR * fwd_flops
        nbytes = _bytes_of(act_elems, p_elems)
        t_c = flops / peak
        t_m = nbytes / bw
        ceiling = flops / (max(t_c, t_m) * peak)
        row = {"batch": batch, "image_size": size,
               "flops_per_step_T": round(flops / 1e12, 3),
               "bytes_per_step_G": round(nbytes / 1e9, 3),
               "flops_model": FLOPS_MODEL,
               "bytes_model": "analytic-optimistic",
               "activation_melems": round(act_elems / 1e6, 2),
               "param_melems": round(p_elems / 1e6, 1),
               "bound": "memory" if t_m > t_c else "compute",
               "arith_intensity": round(flops / nbytes, 1),
               "mfu_ceiling": round(ceiling, 4),
               "peak_source": peak_src}
        if on_accel and not args.no_time:
            st, m = train_step(state, xs[0], ys[0])
            for i in range(4):
                st, m = train_step(st, xs[i % 4], ys[i % 4])
            # Drain the warm-up before the clock starts.
            float(m["loss"])
            synchronize(dev)
            t0 = time.perf_counter()
            for i in range(args.steps):
                st, m = train_step(st, xs[i % 4], ys[i % 4])
            final_loss = float(m["loss"])  # waits for the last step
            synchronize(dev)
            dt = time.perf_counter() - t0
            mfu = _validate_mfu(flops * args.steps / dt / peak, on_accel)
            row.update({
                "images_per_sec": round(batch * args.steps / dt, 1),
                "step_ms": round(dt / args.steps * 1e3, 3),
                "mfu": round(mfu, 4),
                "final_loss": round(final_loss, 4),
                "fraction_of_ceiling": round(mfu / ceiling, 3),
            })
        print(json.dumps(row), flush=True)
        del state, xs, ys
        if on_accel:
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
