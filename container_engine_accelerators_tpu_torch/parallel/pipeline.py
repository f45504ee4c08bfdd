"""Pipeline parallelism, a GPipe microbatch schedule — PyTorch counterpart
of ``container_engine_accelerators_tpu/parallel/pipeline.py``.

Layer weights arrive stacked on a leading axis (``[L, ...]``), are
reshaped to ``[S, L/S, ...]`` (:func:`stage_params`) and placed with the
stage axis sharded over the mesh's ``pipe`` axis (:func:`staged_sharding`,
:func:`place_staged`): each pipe rank holds its stage's ``L/S`` layers.

:func:`make_pipeline_apply` runs JAX's schedule step for step, on every
rank of a ``(pipe, data)`` mesh:

- ``M + S - 1`` steps; at step t stage 0 feeds microbatch ``min(t,
  M-1)``, every other stage the activation that arrived from the stage
  before it, and each stage runs its layers in order;
- the last stage writes microbatch ``t - (S-1)`` into the output once it
  is real; warm-up and drain bubbles compute on zeros (or on the clamped
  last microbatch), and their results reach no output;
- each step's activation hops one stage down (:class:`_Hop`: a send to
  the next stage and a receive from the previous, posted together with
  ``dist.batch_isend_irecv``); its backward is the reverse hop, the
  backward schedule JAX gets by transposing ``ppermute``;
- the output, held by the last stage, reaches every pipe rank through
  the masked sum over the pipe axis, and microbatch rows are split over
  ``data`` (JAX's ``in_specs=P(None, DATA_AXIS)``) and gathered back.

JAX writes both selections with ``jnp.where`` on device values, so every
device runs the same program forward and backward.  The port keeps them
as ``torch.where`` on tensor conditions for the same reason: every rank's
autograd graph then holds every hop, so every rank runs every reverse
hop in the same order (a rank that dropped one would leave its neighbour
waiting), and a bubble's cotangent is an exact zero, never a value from
another step.  The output's sum and gather go through DTensor, whose
backward hands every rank the replicated cotangent once (the backward of
``torch.distributed.nn.functional.all_reduce`` sums the cotangents of
every rank again, which counts a replicated loss S times).

Composes with data parallelism: the weights' gradients are partial sums
over ``data`` and come back summed, as ``Replicate`` DTensor gradients.
"""

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from container_engine_accelerators_tpu_torch.parallel.mesh import DATA_AXIS

PIPE_AXIS = "pipe"


def create_pipeline_mesh(pipe: int, data: int = 1) -> DeviceMesh:
    """A ``(pipe, data)`` mesh over every rank of the process group,
    laid out row-major as JAX reshapes its devices: rank ``p * data +
    d``, so with ``data = 1`` consecutive ranks form the stage ring."""
    n = dist.get_world_size()
    if pipe * data != n:
        raise ValueError(f"mesh {pipe}x{data} != {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (pipe, data),
                            mesh_dim_names=(PIPE_AXIS, DATA_AXIS))


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stage_params(stacked_params, num_stages: int):
    """Reshape every stacked-layer tensor ``[L, ...]`` (a dict, nested or
    not) to ``[S, L/S, ...]``."""

    def r(x):
        if x.shape[0] % num_stages != 0:
            raise ValueError(f"{x.shape[0]} layers not divisible by "
                             f"{num_stages} stages")
        return x.reshape(num_stages, x.shape[0] // num_stages,
                         *x.shape[1:])

    return _tree_map(r, stacked_params)


def unstage_params(staged_params):
    """Inverse of :func:`stage_params`: ``[S, L/S, ...] -> [L, ...]``."""
    return _tree_map(lambda x: x.reshape(x.shape[0] * x.shape[1],
                                         *x.shape[2:]), staged_params)


def staged_sharding(mesh: DeviceMesh, staged_params):
    """DTensor placements of each staged tensor: the leading stage axis
    on ``pipe``, the same on every ``data`` coordinate."""
    pl = tuple(Shard(0) if n == PIPE_AXIS else Replicate()
               for n in mesh.mesh_dim_names)
    return _tree_map(lambda x: pl, staged_params)


def place_staged(mesh: DeviceMesh, staged_params, requires_grad=True):
    """Every staged tensor (the same whole value on every rank) as a
    DTensor leaf with :func:`staged_sharding`'s placements."""
    pl = staged_sharding(mesh, staged_params)

    def place(x, p):
        return distribute_tensor(x.detach(), mesh, p).requires_grad_(
            requires_grad)

    def walk(x, p):
        if isinstance(x, dict):
            return {k: walk(x[k], p[k]) for k in x}
        return place(x, p)

    return walk(staged_params, pl)


class _Hop(torch.autograd.Function):
    """One stage-down hop of the activation ``y`` -> what arrived from
    the previous stage (zeros on stage 0, which receives nothing; the
    last stage sends nothing).  Backward: the reverse hop of the
    cotangent."""

    @staticmethod
    def forward(ctx, y, prev, nxt, group):
        ctx.prev, ctx.nxt, ctx.group = prev, nxt, group
        return _exchange(y, send_to=nxt, recv_from=prev, group=group)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, send_to=ctx.prev, recv_from=ctx.nxt,
                          group=ctx.group), None, None, None)


def _exchange(x, send_to, recv_from, group):
    """Send ``x`` to global rank ``send_to`` and receive a tensor of its
    shape from ``recv_from`` (either may be None), both posted before
    either is waited on."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops = []
    if send_to is not None:
        ops.append(dist.P2POp(dist.isend, x, send_to, group))
    if recv_from is not None:
        ops.append(dist.P2POp(dist.irecv, out, recv_from, group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def make_pipeline_apply(layer_fn: Callable, mesh: DeviceMesh,
                        num_microbatches: int):
    """``apply(staged_params, x) -> y`` running all L layers as an
    S-stage pipeline.

    ``layer_fn(layer_params, h) -> h`` is one shape-preserving layer
    (``layer_params`` this layer's tensors, a dict like the staged one);
    ``staged_params`` are :func:`place_staged`'s DTensors; ``x`` is the
    whole batch ``[B, ...]`` on every rank, B divisible by
    ``num_microbatches`` and each microbatch by the data-axis size.  The
    result is the whole ``[B, ...]`` on every rank."""
    names = mesh.mesh_dim_names
    s_dim, d_dim = names.index(PIPE_AXIS), names.index(DATA_AXIS)
    S, D = mesh.size(s_dim), mesh.size(d_dim)
    M = num_microbatches
    coord = mesh.get_coordinate()
    s, d = coord[s_dim], coord[d_dim]
    ranks = mesh.mesh  # global rank at each (pipe, data) coordinate
    group = mesh.get_group(PIPE_AXIS)

    def peer(stage):
        if not 0 <= stage < S:
            return None
        idx = [0, 0]
        idx[s_dim], idx[d_dim] = stage, d
        return int(ranks[tuple(idx)])

    prev, nxt = peer(s - 1), peer(s + 1)
    # Each stage's weights: Shard(0) on pipe; the data ranks' gradients
    # are partial sums over their rows.
    grad_pl = tuple(Shard(0) if n == PIPE_AXIS else Partial() for n in names)
    xs_pl = tuple(Partial() if n == PIPE_AXIS else Shard(1) for n in names)

    def local_stage(chunk, h):
        n_local = next(iter(_leaves(chunk))).shape[0]
        for i in range(n_local):
            h = layer_fn(_tree_map(lambda a: a[i], chunk), h)
        return h

    def apply(staged_params, x):
        b = x.shape[0]
        if b % M != 0:
            raise ValueError(f"batch {b} not divisible by {M} microbatches")
        if (b // M) % D:
            raise ValueError(f"microbatch {b // M} not divisible by {D} "
                             f"data-parallel ranks")
        chunk = _tree_map(lambda a: a.to_local(grad_placements=grad_pl)[0],
                          staged_params)
        xs = x.reshape(M, b // M, *x.shape[1:])
        # This rank's rows of every microbatch; x's gradient is the sum
        # over stages (only stage 0 reads x) of each data rank's rows.
        xs = DTensor.from_local(xs, mesh, tuple(
            Replicate() for _ in names), run_check=False).redistribute(
            mesh, tuple(Replicate() if n == PIPE_AXIS else Shard(1)
                        for n in names)).to_local(grad_placements=xs_pl)
        first = torch.tensor(s == 0, device=xs.device)
        buf = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        for t in range(M + S - 1):
            inp = torch.where(first, xs[min(t, M - 1)], buf)
            y = local_stage(chunk, inp)
            oidx = t - (S - 1)
            emit = torch.tensor(s == S - 1 and oidx >= 0, device=xs.device)
            updated = outs.index_copy(
                0, torch.tensor([min(max(oidx, 0), M - 1)],
                                device=xs.device), y[None])
            outs = torch.where(emit, updated, outs)
            if S > 1:
                buf = _Hop.apply(y, prev, nxt, group)
        last = torch.tensor(s == S - 1, device=xs.device)
        held = torch.where(last, outs, torch.zeros_like(outs))
        ys = DTensor.from_local(held, mesh, xs_pl, run_check=False)
        ys = ys.full_tensor()
        return ys.reshape(b, *x.shape[1:])

    return apply


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
