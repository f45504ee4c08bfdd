"""Training cells: the port's LM trained on the flash kernels.

Set-up builds one training step (``models/lm_train.py``:
``create_lm_train_state``, ``make_lm_train_step``) over the
architecture's model for training (``arch/<architecture>.py``:
``build(cfg, device, "train")``; SmolLM's trains in bf16 on the flash
kernels with remat) with f32 master weights, draws the weights and the
mix's device-resident batches from the seed, and drives that same step
through its first ``check_steps`` steps on batches whose rows all
differ.  Those steps are the warm-up, and they leave what the check
compares: each step's loss, the first gradient's norm by leaf (from
AdamW's first moment after one step, ``(1 - beta1) g``) and each leaf's
change over the steps.  The window then runs the same step on the
batches in turn until ``--seconds`` have passed and ends on a
``synchronize``.

After the window (and the traced slice of ``--trace 1``) the program is
freed, and the plain reference takes the same steps from the same
weights on the same batches in f32.
"""

import math

import torch

from harness import clock, compare, free_device, sync, tracing, traffic
from harness import weights


def check_optimizer(optimizer, opt: dict) -> None:
    """The program's AdamW has to be the one the mix states, which the
    reference takes."""
    d = optimizer.defaults
    have = {"lr": d["lr"], "betas": list(d["betas"]), "eps": d["eps"],
            "weight_decay": d["weight_decay"]}
    if type(optimizer).__name__ != "AdamW" or have != opt:
        raise ValueError(f"the program's optimizer {type(optimizer).__name__}"
                         f" {have} is not the mix's AdamW {opt}")


@torch.no_grad()
def change_norms(model, kinds, seed, device) -> dict:
    """Each leaf's distance from the drawn start (drawn again, a kind at
    a time)."""
    params = dict(model.named_parameters())
    names, norms = [], []
    for kind, start in weights.stacks(kinds, seed, device, torch.float32):
        for name, leaf in weights.leaves(kind, start):
            names.append(name)
            norms.append((params[name].float() - leaf).norm())
        del start
    return dict(zip(names, torch.stack(norms).tolist()))


def run(ctx):
    return check(ctx, measure(ctx))


def measure(ctx):
    """Set-up, the window and the traced slice; frees the program and
    returns what the check compares: (losses, first gradient's norms,
    changes' norms)."""
    from container_engine_accelerators_tpu_torch.models import lm_train

    cfg, mix, dev, rec = ctx.cfg, ctx.mix, ctx.device, ctx.record
    arch = ctx.arch()
    kinds = arch.kinds(cfg)
    model = arch.build(cfg, dev, "train")
    weights.load_into(dict(model.named_parameters()), kinds, ctx.seed, dev,
                      torch.float32)
    state = lm_train.create_lm_train_state(model)
    check_optimizer(state.optimizer, mix["optimizer"])
    step, state = lm_train.make_lm_train_step(state=state)
    batches = traffic.train_batches(mix, arch.sizes(cfg)["V"], ctx.seed,
                                    dev)
    feed = [(batches[i],) + tuple(lm_train.next_token_targets(batches[i]))
            for i in range(mix["batches"])]

    # The first steps: the warm-up, and the readings the check compares.
    n_check = mix["check_steps"]
    beta1 = mix["optimizer"]["betas"][0]
    losses, grads, check_s = [], None, 0.0
    for k in range(n_check):
        state, metrics = step(state, *feed[k % len(feed)])
        losses.append(metrics["loss"].item())
        if k == 0:
            t = clock()
            opt_state = state.optimizer.state
            named = list(model.named_parameters())
            # A leaf the step left without a first moment did not move.
            norms = torch.stack([
                opt_state[p]["exp_avg"].norm() / (1 - beta1)
                if "exp_avg" in opt_state.get(p, {})
                else torch.zeros((), device=dev) for _, p in named])
            grads = dict(zip([n for n, _ in named], norms.tolist()))
            check_s += clock() - t
    t = clock()
    changes = change_norms(model, kinds, ctx.seed, dev)
    check_s += clock() - t

    tokens_per_step = mix["batch"] * mix["seq_len"]
    sync(dev)
    t0 = clock()
    rec.setup_s = t0 - ctx.t_start - check_s
    k = n_check
    while clock() - t0 < ctx.seconds:
        state, metrics = step(state, *feed[k % len(feed)])
        k += 1
    sync(dev)
    rec.window_s = clock() - t0
    steps = k - n_check
    rec.attempted = steps
    rec.failed = 0 if math.isfinite(metrics["loss"].item()) else 1
    rec.counters.update(steps=steps, tokens=steps * tokens_per_step)
    if dev.type == "cuda":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated(dev)

    if ctx.trace:
        from torch.profiler import record_function

        with tracing.capture(dev) as cap:
            for _ in range(mix["trace_steps"]):
                with record_function("train_step"):
                    state, metrics = step(state, *feed[k % len(feed)])
                k += 1
        rec.trace = cap.trace

    del state, step, model, metrics, feed, batches
    free_device(dev)
    return losses, grads, changes


def reference_readings(ctx, quant="exact"):
    """The plain reference's (losses, gradient norms, change norms) over
    the checked steps, from the same weights and batches; ``quant``
    names the reference's rounding (``exact`` or the control's
    ``fp8``)."""
    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    arch = ctx.arch()
    s = arch.sizes(cfg)
    ref = ctx.reference()
    ref.no_tf32()
    batches = list(traffic.train_batches(mix, s["V"], ctx.seed, dev)
                   [:mix["check_steps"]].unbind(0))
    params = weights.draw(arch.kinds(cfg), ctx.seed, dev, torch.float32)
    out = ref.train(s, params, batches, mix["optimizer"],
                    mix["check_micro_batch"], getattr(ref, quant))
    del params, batches
    free_device(dev)
    return out


def numbers(readings, reference) -> dict:
    """Readings against the reference's, the negligible leaves left
    out."""
    loss, grad, change = readings
    r_loss, r_grad, r_change = reference
    kept = compare.kept_leaves(r_grad)
    return {"loss_gap": compare.loss_gap(loss, r_loss),
            "grad_gap": compare.leaf_gap(grad, r_grad, kept)[0],
            "change_gap": compare.leaf_gap(change, r_change, kept)[0]}


def check(ctx, readings):
    """The reference's steps, and with ``--control 1`` the reference's
    in float8 too; each set of readings against the f32 reference's."""
    t0 = clock()
    reference = reference_readings(ctx)
    r_grad = reference[1]
    ctx.record.counters["leaves_left_out"] = \
        len(r_grad) - len(compare.kept_leaves(r_grad))
    ctx.record.counters["check_s"] = clock() - t0
    control = None
    if ctx.control:
        control = numbers(reference_readings(ctx, "fp8"), reference)
    return numbers(readings, reference), control
