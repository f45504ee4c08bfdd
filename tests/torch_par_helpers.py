"""Rank workers for the port's pipeline, expert-parallel, mesh MoE-LM,
mesh serving-feature and dry-run tests, run under gloo on the CPU
through ``torch_dist_helpers.spawn``.  No jax here: a spawned child
re-imports its function's module, so the JAX references are computed in
the parent and handed in as numpy."""

import numpy as np
import torch

from torch_dist_helpers import _np


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---- pipeline ----------------------------------------------------------------


def _pp_layer(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def pipeline_case(rank, world, pipe, data, microbatches, params, x, tgt):
    """The port's GPipe apply of ``params`` (``w`` [L, D, D], ``b`` [L,
    D], numpy) over a (pipe, data) mesh on ``x``, and the gradient of the
    mean squared error to ``tgt`` -> (y, unstaged grads of w and b, the
    grad of x, the placements of the staged w, and the messages of the
    rejections: a batch the microbatches do not divide, a mesh that is
    not the world)."""
    from container_engine_accelerators_tpu_torch.parallel import pipeline as pp

    mesh = pp.create_pipeline_mesh(pipe, data)
    staged = pp.place_staged(mesh, pp.stage_params(
        {k: _t(v) for k, v in params.items()}, pipe))
    apply = pp.make_pipeline_apply(_pp_layer, mesh, microbatches)
    xt = _t(x).requires_grad_()
    y = apply(staged, xt)
    ((y - _t(tgt)) ** 2).mean().backward()
    grads = pp.unstage_params({k: v.grad.full_tensor()
                               for k, v in staged.items()})
    rejected = []
    try:
        pp.make_pipeline_apply(_pp_layer, mesh, 3)(staged, xt)
    except ValueError as e:
        rejected.append(str(e))
    try:
        pp.create_pipeline_mesh(pipe + 1, data)
    except ValueError as e:
        rejected.append(str(e))
    return (_np(y), {k: _np(g) for k, g in grads.items()}, _np(xt.grad),
            [str(p) for p in staged["w"].placements], rejected)


# ---- the MoE FFN on a mesh -------------------------------------------------


def moe_ffn_cases(rank, world, cases, params, x, w):
    """For each ``(mesh_shape, layout, sharded_x, kw)`` of ``cases``: the
    port's f32 ``MoEFFN`` from ``params`` (flax layouts, numpy) laid out
    by ``layout`` — "expert" (``expert_sharding`` on the model axis) or
    "megatron" / "fsdp" (``shard_params`` / ``shard_params_fsdp``, the
    trainer's rule) — on ``x`` [B, T, D], whole on every rank or, with
    ``sharded_x``, split by rows over the data axis as a DTensor; then
    the backward of ``sum(out * w) + 0.3 * aux`` -> per case (out, aux,
    dropped, grads of the four weights (whole), x's grad — of this rank's
    rows with ``sharded_x`` —, the first of those rows, the placements of
    wo)."""
    from torch import nn

    from container_engine_accelerators_tpu_torch.ops import moe
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    out = []
    for shape, layout, sharded_x, kw in cases:
        mesh = pm.create_mesh(*shape)
        layer = moe.MoEFFN(
            x.shape[-1], params["wi_gate"].shape[0],
            params["wi_gate"].shape[2], torch.float32,
            lambda *s, dtype: nn.Parameter(torch.empty(s, dtype=dtype)),
            **kw)
        layer.load_state_dict({k: _t(v) for k, v in params.items()})
        if layout == "expert":
            moe.expert_sharding(mesh, layer)
        elif layout == "megatron":
            pm.shard_params(layer, mesh)
        else:
            pm.shard_params_fsdp(layer, mesh)
        xt, start = _t(x), 0
        if sharded_x:
            start, rows = pm.batch_rows(mesh, x.shape[0])
            xt = xt[start:start + rows].clone().requires_grad_()
            y, aux, dropped = layer(pm.from_local_batch(xt, mesh))
            wt = pm.from_local_batch(_t(w)[start:start + rows], mesh)
            loss = (y * wt).sum() + 0.3 * aux
            y, aux, dropped = (t.full_tensor() for t in (y, aux, dropped))
        else:
            xt.requires_grad_()
            y, aux, dropped = layer(xt)
            loss = (y * _t(w)).sum() + 0.3 * aux
        loss.backward()
        out.append((_np(y), aux.item(), dropped.item(),
                    {k: _np(p.grad.full_tensor())
                     for k, p in layer.named_parameters()},
                    _np(xt.grad), start,
                    [str(p) for p in layer.wo.placements]))
    return out


# ---- the model-parallel convolution and head --------------------------------


def sharded_layers(rank, world, mesh_shapes, cases):
    """For each mesh shape of ``mesh_shapes`` (each over every rank) and
    each ``(kind, kw, weight, x, g)`` of ``cases`` — kind "conv"
    (``Conv(**kw)``, an OIHW weight, NHWC ``x``) or "dense"
    (``Dense(**kw)``, ``[out, in]`` weight, ``[N, in]`` x, a zero-free
    bias drawn from the weight) — the f64 layer with its parameters laid
    out by the JAX rule (``shard_params``) on that mesh, on this rank's
    rows of ``x``, and the backward of ``sum(y * g)`` -> {mesh shape:
    per case (y whole, this rank's rows of dx, the whole gradient of each
    parameter after ``sync_grads``, the rank's first row, the weight's
    placements, the shapes of every weight the layer handed to
    ``F.conv2d`` / ``F.linear``)}."""
    import torch.nn.functional as F

    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    seen = []
    conv2d, linear = F.conv2d, F.linear

    def record(fn):
        def wrapped(x, w, *a, **k):
            seen.append(tuple(w.shape))
            return fn(x, w, *a, **k)
        return wrapped

    out = {}
    F.conv2d, F.linear = record(conv2d), record(linear)
    try:
        for shape in mesh_shapes:
            mesh = pm.create_mesh(*shape)
            out[shape] = [_sharded_layer(mesh, *case, seen)
                          for case in cases]
    finally:
        F.conv2d, F.linear = conv2d, linear
    return out


def _sharded_layer(mesh, kind, kw, weight, x, g, seen):
    """One case of :func:`sharded_layers` on ``mesh``."""
    from container_engine_accelerators_tpu_torch.models import resnet
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    seen.clear()
    if kind == "conv":
        layer = resnet.Conv(**kw).double()
        layer.load_state_dict({"weight": _t(weight)})
        x, g = _t(x).permute(0, 3, 1, 2), _t(g).permute(0, 3, 1, 2)
    else:
        layer = resnet.Dense(**kw).double()
        layer.load_state_dict({"weight": _t(weight),
                               "bias": _t(weight[:, 0] + 1.0)})
        x, g = _t(x), _t(g)
    pm.shard_params(layer, mesh)
    start, rows = pm.batch_rows(mesh, x.shape[0])
    xl = x[start:start + rows].clone().requires_grad_()
    y = layer(pm.from_local_batch(xl, mesh))
    (y * pm.from_local_batch(g[start:start + rows], mesh)).sum() \
        .backward()
    pm.sync_grads(layer)
    return (_np(y.full_tensor()), _np(xl.grad),
            {n: _np(p.grad.full_tensor())
             for n, p in layer.named_parameters()},
            start, [str(p) for p in layer.weight.placements],
            list(seen))


def image_step(rank, world, model, kw, state_dict, batches, mesh_shape, tx):
    """The sharded step (``make_sharded_train_step``) of ``model``
    ("resnet-18" or "inception-v3", built with ``kw``) in f64 from
    ``state_dict`` (numpy) with ``cosine_sgd(**tx)``, on ``batches``
    [(images NHWC, labels)], each rank feeding its rows -> {"losses",
    "accuracy", "state" (whole parameters and BatchNorm statistics),
    "momentum" (whole, by parameter name), "local" (this rank's shape of
    each parameter and of its momentum), "plain_buffers" (whether every
    BatchNorm statistic is a plain, replicated tensor)}, numpy."""
    from torch.distributed.tensor import DTensor

    from container_engine_accelerators_tpu_torch.models.inception import (
        inception_v3,
    )
    from container_engine_accelerators_tpu_torch.models.resnet import resnet
    from container_engine_accelerators_tpu_torch.models.train import (
        cosine_sgd,
        create_train_state,
        make_sharded_train_step,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    mesh = pm.create_mesh(*mesh_shape)
    if model == "inception-v3":
        net = inception_v3(dtype=torch.float64, device="cpu", **kw)
    else:
        net = resnet(18, dtype=torch.float64, device="cpu", **kw)
    net = net.double()
    net.load_state_dict({k: _t(v) for k, v in state_dict.items()})
    step, state = make_sharded_train_step(
        mesh, create_train_state(net, None, cosine_sgd(**tx)))
    start, rows = pm.batch_rows(mesh, batches[0][0].shape[0])
    losses, accuracy = [], []
    for x, y in batches:
        x = _t(x[start:start + rows]).double().permute(0, 3, 1, 2)
        y = _t(y[start:start + rows]).long()
        state, m = step(state, pm.from_local_batch(x, mesh),
                        pm.from_local_batch(y, mesh))
        losses.append(float(m["loss"]))
        accuracy.append(float(m["accuracy"]))
    params = dict(state.model.named_parameters())
    moments = {n: state.optimizer.state[p]["momentum_buffer"]
               for n, p in params.items()}
    return {"losses": losses, "accuracy": accuracy,
            "state": {n: _np(pm.full(t))
                      for n, t in state.model.state_dict().items()},
            "momentum": {n: _np(pm.full(t)) for n, t in moments.items()},
            "local": {n: (tuple(p.to_local().shape),
                          tuple(moments[n].to_local().shape))
                      for n, p in params.items()},
            "plain_buffers": not any(isinstance(b, DTensor)
                                     for b in state.model.buffers())}


def resnet_trainer_runs(rank, world, argvs):
    """``cmd/train_resnet.py``'s ``main`` on every rank for each of
    ``argvs``, under the launcher env torchrun would set -> each run's
    losses."""
    import os

    from container_engine_accelerators_tpu_torch.cmd import train_resnet

    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    return [train_resnet.main(argv) for argv in argvs]


# ---- the collectives sweep --------------------------------------------------


def collective_runs(rank, world, cases, sweep, verdict_argv):
    """The port's ``collectives/bench.py`` on gloo ranks -> (for each
    ``(op, reps, x)`` of ``cases`` — ``x`` the GLOBAL f32 input, of which
    this rank feeds its block — this rank's block after ``reps`` chained
    collectives; for each op, the ``size_bytes`` of ``run_sweep(**sweep,
    op=op)``; ``main(verdict_argv)``'s exit code on this rank)."""
    from container_engine_accelerators_tpu_torch.collectives import bench

    values = []
    for op, reps, x in cases:
        width = x.shape[0] // world
        block = _t(x[rank * width:(rank + 1) * width])
        before = block.clone()
        out = bench.make_collective(op)(block, reps)
        assert torch.equal(block, before), op  # the input is left alone
        values.append(_np(out))
    sizes = {op: [r.size_bytes for r in bench.run_sweep(op=op, **sweep)]
             for op in bench.OPS}
    return values, sizes, bench.main(verdict_argv)


# ---- the MoE-LM across layouts in bf16 --------------------------------------


def lm_bf16_first_loss(rank, world, cfg, params, batch, mesh_shape):
    """The port's bf16 LM (f32 parameters from ``params``, numpy) on a
    ``mesh_shape`` mesh under megatron: the loss of its first train step,
    before any update, each rank feeding its rows of ``batch`` (tokens,
    labels, mask)."""
    from container_engine_accelerators_tpu_torch.models import lm_train as lt
    from container_engine_accelerators_tpu_torch.models.transformer import (
        TransformerLM,
    )
    from container_engine_accelerators_tpu_torch.parallel import mesh as pm

    mesh = pm.create_mesh(*mesh_shape)
    model = TransformerLM(**cfg, dtype=torch.bfloat16, device="cpu")
    model.load_state_dict({k: _t(v) for k, v in params.items()})
    step, state = lt.make_lm_train_step(mesh, lt.create_lm_train_state(model))
    start, rows = pm.batch_rows(mesh, batch[0].shape[0])
    toks, labels, mask = (_t(x[start:start + rows]) for x in batch)
    _, m = step(state, *(pm.from_local_batch(x, mesh) for x in
                         (toks.long(), labels.long(), mask)))
    return float(m["loss"])
