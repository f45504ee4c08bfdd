"""Device mesh and parameter layouts of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/parallel/mesh.py``.

The JAX package lays a ``jax.sharding.Mesh`` over the chips and lets
GSPMD insert the collectives.  The port lays a ``DeviceMesh`` over the
ranks of the process group (``parallel/dcn.py``) and stores every weight
as a DTensor whose placements are the JAX rule's, so DTensor's sharding
propagation inserts them:

- :func:`create_mesh` — a (data, model) mesh over the world;
  :func:`create_hybrid_mesh` adds an outer ``dcn`` axis.
- :func:`_param_spec` — tensor parallelism: shard the largest weight axis
  divisible by the model-axis size (ties toward the trailing, output
  axis); :func:`_param_spec_fsdp` also shards the largest remaining axis
  over the data axis (ZeRO-3).  Both are pure functions of a FLAX shape
  and return the axis names JAX's ``PartitionSpec`` holds.  A port
  tensor stored transposed against flax (a convolution's OIHW against
  HWIO, a dense ``[out, in]`` against ``[in, out]``) names its axis map
  in its module's ``FLAX_AXES``; the rule runs on the flax shape and the
  placement lands on the port's axis.
- :func:`shard_params` / :func:`shard_params_fsdp` — replace a module's
  parameters by DTensors with those placements (``distribute_tensor``).
  AdamW's and SGD's state is made from the parameters, so it takes the
  same placements.  Tensors too small to divide stay replicated.
- :func:`batch_sharding` / :func:`replicated` — the placements of a
  batch (rows over ``dcn`` and ``data``) and of a replicated value.
- Megatron's conjugate operators over the ``model`` group, for the
  layers DTensor has no sharded strategy for (the convolution, the
  image head): *split* / *gather* and *reduce* / *copy*, autograd
  Functions composed by :func:`model_parallel` around a rank's product
  with its weight shard (:func:`local_shard`).

Collectives run on the default process group's ranks: NCCL on the card,
gloo on the CPU.
"""

from typing import Optional, Sequence, Tuple

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

DATA_AXIS = "data"
MODEL_AXIS = "model"
DCN_AXIS = "dcn"
BATCH_AXES = (DCN_AXIS, DATA_AXIS)


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(data: int = -1, model: int = 1) -> DeviceMesh:
    """A (data, model) mesh over every rank of the process group.
    ``data=-1`` means all remaining ranks.  Neighbouring model
    coordinates are consecutive ranks, so with one process a GPU the
    model axis stays inside a host (NVLink)."""
    n = dist.get_world_size()
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return init_device_mesh(_device_type(), (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def create_hybrid_mesh(ici_data: int, ici_model: int = 1,
                       num_slices: int = 1) -> DeviceMesh:
    """A (dcn, data, model) mesh, the dcn axis outermost: ranks are
    slice-major, so only the data-parallel gradient sum crosses slices
    and tensor-parallel traffic stays inside one."""
    if num_slices <= 1:
        return create_mesh(ici_data, ici_model)
    need = num_slices * ici_data * ici_model
    if dist.get_world_size() != need:
        raise ValueError(f"hybrid mesh needs {need} ranks, have "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(),
                            (num_slices, ici_data, ici_model),
                            mesh_dim_names=(DCN_AXIS, DATA_AXIS, MODEL_AXIS))


def axis_size(mesh: DeviceMesh, name: str) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def batch_sharding(mesh: DeviceMesh) -> Tuple:
    """Placements of a batch: rows over ``data`` (and ``dcn``), the same
    rows on every model coordinate."""
    return tuple(Shard(0) if n in BATCH_AXES else Replicate()
                 for n in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh) -> Tuple:
    return (Replicate(),) * mesh.ndim


def _largest_divisible_axis(shape, size, taken=(), prefer_trailing=True):
    """Index of the largest axis divisible by ``size`` (and >= 2*size,
    so a shard never degenerates below 2 rows), skipping ``taken``
    axes; None if nothing qualifies.  ``prefer_trailing`` breaks ties
    toward the output-feature axis (the Megatron convention)."""
    best_axis, best_dim = None, 0
    for axis in range(len(shape)):
        dim = shape[axis]
        better = dim >= best_dim if prefer_trailing else dim > best_dim
        if (axis not in taken and dim % size == 0 and better
                and dim >= 2 * size):
            best_axis, best_dim = axis, dim
    return best_axis


def _param_spec(shape: Tuple[int, ...], model_size: int) -> Tuple:
    """The JAX ``_param_spec``: ``()`` (replicated), or one entry an axis
    with ``"model"`` on the sharded one."""
    if model_size <= 1 or not shape:
        return ()
    best_axis = _largest_divisible_axis(shape, model_size)
    if best_axis is None:
        return ()
    spec = [None] * len(shape)
    spec[best_axis] = MODEL_AXIS
    return tuple(spec)


def _param_spec_fsdp(shape, data_size: int, model_size: int) -> Tuple:
    """The JAX ``_param_spec_fsdp``: the model-axis rule first, then the
    largest remaining axis divisible by the data-axis size carries
    ``"data"``.  Parameters and their same-shaped optimizer buffers then
    occupy 1/(dp*tp) of each rank's memory."""
    base = _param_spec(shape, model_size)
    spec = list(base) + [None] * (len(shape) - len(base))
    taken = tuple(i for i, s in enumerate(spec) if s is not None)
    best_axis = _largest_divisible_axis(shape, data_size, taken=taken,
                                        prefer_trailing=True)
    if best_axis is not None:
        spec[best_axis] = DATA_AXIS
    return tuple(spec)


def flax_axes(module: torch.nn.Module, name: str, ndim: int
              ) -> Sequence[int]:
    """For each axis of the port's tensor ``name`` of ``module``, the
    flax axis it holds (identity unless the module's ``FLAX_AXES`` maps
    it)."""
    return getattr(module, "FLAX_AXES", {}).get(name, tuple(range(ndim)))


def flax_spec(module: torch.nn.Module, name: str, shape, data_size: int,
              model_size: int, fsdp: bool = False) -> Tuple:
    """The JAX rule's spec for tensor ``name`` (port ``shape``) of
    ``module``, over the FLAX axes: what the JAX package gives the same
    leaf."""
    axes = flax_axes(module, name, len(shape))
    flax_shape = [0] * len(shape)
    for port_axis, fax in enumerate(axes):
        flax_shape[fax] = shape[port_axis]
    if fsdp:
        return _param_spec_fsdp(tuple(flax_shape), data_size, model_size)
    return _param_spec(tuple(flax_shape), model_size)


def placements_for(module: torch.nn.Module, name: str, shape,
                   mesh: DeviceMesh, fsdp: bool = False) -> Tuple:
    """The DTensor placements the JAX rule gives tensor ``name`` of
    ``module`` on ``mesh``: each named flax axis of :func:`flax_spec` is
    sharded on the port axis that holds it."""
    axes = flax_axes(module, name, len(shape))
    spec = flax_spec(module, name, shape, axis_size(mesh, DATA_AXIS),
                     axis_size(mesh, MODEL_AXIS), fsdp)
    out = []
    for mesh_name in mesh.mesh_dim_names:
        fax = spec.index(mesh_name) if mesh_name in spec else None
        out.append(Replicate() if fax is None else Shard(axes.index(fax)))
    return tuple(out)


def _shard(model: torch.nn.Module, mesh: DeviceMesh, fsdp: bool):
    for module in model.modules():
        for name, p in list(module.named_parameters(recurse=False)):
            if isinstance(p, DTensor):
                raise ValueError(f"{name} is sharded already")
            pl = placements_for(module, name, p.shape, mesh, fsdp)
            module.register_parameter(name, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh, pl),
                requires_grad=p.requires_grad))
    return model


def shard_params(model: torch.nn.Module, mesh: DeviceMesh):
    """Tensor parallelism over ``model``: every parameter of ``model``
    becomes a DTensor with :func:`_param_spec`'s placement, replicated
    along the data axis.  In place; returns ``model``.  Every rank must
    hold the same values (the same seed, or the same checkpoint)."""
    return _shard(model, mesh, fsdp=False)


def shard_params_fsdp(model: torch.nn.Module, mesh: DeviceMesh):
    """Fully sharded data parallelism (+ tp): :func:`_param_spec_fsdp`'s
    placements.  In place; returns ``model``."""
    return _shard(model, mesh, fsdp=True)


def data_shard(mesh: DeviceMesh) -> Tuple[int, int]:
    """(index, count) of this rank's block of batch rows under
    :func:`batch_sharding`: the batch axes split a batch, slice-major
    (the loaders' ``shard=`` argument)."""
    index, count = 0, 1
    coord = mesh.get_coordinate()
    for dim, name in enumerate(mesh.mesh_dim_names):
        if name in BATCH_AXES:
            index = index * mesh.size(dim) + coord[dim]
            count *= mesh.size(dim)
    return index, count


def batch_rows(mesh: DeviceMesh, batch: int) -> Tuple[int, int]:
    """(first row, row count) of a global batch this rank holds under
    :func:`batch_sharding`."""
    index, count = data_shard(mesh)
    if batch % count:
        raise ValueError(f"batch {batch} not divisible by {count} "
                         f"data-parallel ranks")
    rows = batch // count
    return index * rows, rows


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """A batch this rank holds whole (every rank the same) as a DTensor
    under :func:`batch_sharding`: each rank keeps its own rows, with no
    communication."""
    start, rows = batch_rows(mesh, x.shape[0])
    return from_local_batch(x[start:start + rows], mesh)


def from_local_batch(local: torch.Tensor, mesh: DeviceMesh) -> DTensor:
    """This rank's rows (as the loaders' ``shard=`` argument reads them)
    as the global batch DTensor."""
    return DTensor.from_local(local, mesh, batch_sharding(mesh),
                              run_check=False)


def drop_unit_shards(x: DTensor) -> DTensor:
    """``x`` with each ``Shard`` on a mesh dim of one rank made
    ``Replicate``: the same layout (that rank holds everything), which
    DTensor's matmul and view rules take at a batch of one row, where a
    sharded dim of size 1 is refused."""
    mesh = x.device_mesh
    pl = tuple(Replicate() if p.is_shard() and mesh.size(i) == 1 else p
               for i, p in enumerate(x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(mesh, pl)


def settle_partial(x):
    """``x`` with each ``Partial`` placement summed (made ``Replicate``), in
    x's own dtype; anything else passes through."""
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                             for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def splits_contraction(w, dims) -> bool:
    """Whether the DTensor ``w`` is split over more than one rank on one
    of ``dims`` (the dims a product contracts): then each rank's product
    is a partial sum."""
    if not isinstance(w, DTensor):
        return False
    return any(p.is_shard() and p.dim in dims and w.device_mesh.size(i) > 1
               for i, p in enumerate(w.placements))


def replicate(x, mesh: DeviceMesh):
    """A value every rank holds alike, as a replicated DTensor (a DTensor
    passes through)."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, replicated(mesh), run_check=False)


def full(x):
    """The whole value of a DTensor on every rank, as a plain tensor (a
    plain tensor passes through)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def weight_grad_placements(mesh: DeviceMesh) -> Tuple:
    """The grad placements of a weight gathered whole (replicated) and
    used on this rank's batch rows: a partial sum over the batch axes,
    the same on every model coordinate."""
    return tuple(Partial() if n in BATCH_AXES else Replicate()
                 for n in mesh.mesh_dim_names)


def model_shard_dim(w: DTensor) -> Optional[int]:
    """The port axis the model axis shards ``w`` on, when that is its
    only split (every other mesh dim replicated); else None (replicated,
    or also split over a batch axis, as under fsdp)."""
    dim = None
    for name, p in zip(w.device_mesh.mesh_dim_names, w.placements):
        if name == MODEL_AXIS and p.is_shard():
            dim = p.dim
        elif not p.is_replicate():
            return None
    return dim


def local_shard(w: DTensor) -> torch.Tensor:
    """This rank's shard of a weight split on the model axis alone, as a
    plain tensor used on this rank's batch rows: its grad is a partial
    sum over the batch axes and this rank's piece on ``model``
    (``sync_grads`` then all-reduces it over the batch axes).  No
    communication either way."""
    pl = tuple(Partial() if n in BATCH_AXES else p
               for n, p in zip(w.device_mesh.mesh_dim_names, w.placements))
    return w.to_local(grad_placements=pl)


# ---- Megatron's conjugate operators over the model axis ---------------------
#
# Each takes plain tensors (this rank's batch rows) and the model axis's
# process group.  Everything downstream of a gather or a reduce is the same
# on every model rank, so the gradient arriving there is whole on each:
# gather's backward takes this rank's slice (a reduce-scatter would make it
# M times too large), reduce's passes it through.


def _slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    m = dist.get_world_size(group)
    width = x.shape[dim] // m
    return x.narrow(dim, dist.get_rank(group) * width, width)


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The model ranks' slices of ``dim`` concatenated in rank order.
    ``dim`` is moved last first, a free view of an NCHW tensor in
    ``channels_last`` memory, so the result keeps that layout."""
    m = dist.get_world_size(group)
    xt = x.movedim(dim, -1).contiguous()
    out = xt.new_empty((m * xt.shape[0],) + tuple(xt.shape[1:]))
    dist.all_gather_into_tensor(out, xt, group=group)
    out = out.view(m, *xt.shape).movedim(0, -2).reshape(
        *xt.shape[:-1], m * xt.shape[-1])
    return out.movedim(-1, dim)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


class _Split(torch.autograd.Function):
    """Forward: this rank's slice of ``dim``; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _slice(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.dim, ctx.group), None, None


class _Gather(torch.autograd.Function):
    """Forward: all-gather the slices of ``dim``; backward: this rank's
    slice of the (whole, replicated) gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.dim, ctx.group), None, None


class _Reduce(torch.autograd.Function):
    """Forward: all-reduce the partial sums; backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """Forward: identity; backward: all-reduce the partial gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None


def model_parallel(local_fn, x: torch.Tensor, w: DTensor, dim: int
                   ) -> torch.Tensor:
    """``local_fn(x, w_shard)`` on this rank's rows ``x`` with its shard of
    ``w``, combined over the model axis into the whole result.
    ``dim`` 0, the output features split (``w`` ``[out, in, ...]``): a
    local product of the output slice, then *gather* the slices along
    dim 1; *copy* in front, since x's gradient is a partial sum over the
    model ranks.  ``dim`` 1, the input features split: *split* x's dim 1,
    a local partial product, then *reduce*.  A model axis of one rank
    takes no collective."""
    group = w.device_mesh.get_group(MODEL_AXIS)
    shard = local_shard(w)
    if dist.get_world_size(group) == 1:
        return local_fn(x, shard)
    if dim == 0:
        return _Gather.apply(local_fn(_Copy.apply(x, group), shard), 1,
                             group)
    return _Reduce.apply(local_fn(_Split.apply(x, 1, group), shard), group)


def gather_weight(w: DTensor) -> torch.Tensor:
    """The whole weight on every rank, as a plain tensor that autograd
    ties back to the shard: the backward sums this rank's weight grad
    over the batch axes into the weight's own placements (a
    reduce-scatter or an all-reduce).  Where an operator has no DTensor
    strategy for a sharded weight, it runs on this."""
    mesh = w.device_mesh
    return w.redistribute(mesh, replicated(mesh)).to_local(
        grad_placements=weight_grad_placements(mesh))


def sync_grads(model: torch.nn.Module) -> None:
    """Bring every DTensor grad to its parameter's placements: DTensor's
    backward leaves a batch-summed grad Partial, and the optimizer's
    in-place updates need the parameter's layout.  Partial to Replicate
    is the data-parallel all-reduce, Partial to Shard the FSDP
    reduce-scatter."""
    for p in model.parameters():
        g = p.grad
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(
                p.placements):
            p.grad = g.redistribute(p.device_mesh, p.placements)


def broadcast_control(obj=None, src: int = 0):
    """Send ``obj`` from rank ``src`` to every rank of the default group
    and return it on each (the serving ranks' command channel)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]



def head_sharding(mesh: DeviceMesh, kv_heads: int) -> Tuple:
    """Placements of attention's ``[B, T, heads, hd]`` tensors: rows over
    the batch axes and, when the model axis divides the KV heads, heads
    over it (each rank then holds whole GQA groups: its query heads and
    the KV heads they read), else every head on every model rank."""
    tp = axis_size(mesh, MODEL_AXIS)
    split = kv_heads % tp == 0
    # (A batch axis of one rank holds every row: Replicate, the layout
    # DTensor's reshape takes at a batch of one.)
    return tuple(Shard(0) if n in BATCH_AXES and mesh.size(i) > 1
                 else Shard(2) if n == MODEL_AXIS and split
                 else Replicate()
                 for i, n in enumerate(mesh.mesh_dim_names))


def local_heads(mesh: Optional[DeviceMesh], kv_heads: int) -> int:
    """The KV heads one rank's decode cache holds (all of them off a
    mesh, or when the model axis does not divide them)."""
    if mesh is None:
        return kv_heads
    tp = axis_size(mesh, MODEL_AXIS)
    return kv_heads // tp if kv_heads % tp == 0 else kv_heads


def batch_local(fn, x: DTensor, *more: DTensor) -> DTensor:
    """Run ``fn`` on this rank's batch rows of ``x`` (and of ``more``;
    every feature of them) and return the result as the batch-split
    DTensor: for the operators DTensor has no strategy for at the layout
    given, and for those that need no collective on batch rows."""
    mesh = x.device_mesh
    rows = batch_sharding(mesh)
    y = fn(*(t.redistribute(mesh, rows).to_local() for t in (x, *more)))
    return DTensor.from_local(y, mesh, rows, run_check=False)
