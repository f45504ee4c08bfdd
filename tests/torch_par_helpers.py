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
