"""Switch (top-1) mixture-of-experts FFN — PyTorch counterpart of
``container_engine_accelerators_tpu/ops/moe.py::MoEFFN``.

Same function, other formulation.  The JAX layer dispatches and combines
with dense one-hot einsums over ``[N, E, C]`` tensors (static-shape MXU
work on the TPU); on the card those are products that are almost all
multiplications by zero (at the trainer's defaults 335 M elements and
two 343 GFLOP einsums per layer, 2.7x the expert MLP).  The port moves
the tokens by index instead:

- **dispatch**: each kept token is written into row ``e * C + pos`` of an
  ``[E * C + N, D]`` buffer; dropped token ``n`` goes to scratch row
  ``E * C + n``, past the slots, which is discarded;
- **expert MLP**: the gated SiLU MLP over the ``[E, C, D]`` slots as three
  batched matmuls, in the compute dtype;
- **combine**: each kept token reads its slot's row back and scales it by
  its gate (cast to the compute dtype); a dropped token reads its own
  zero row, so its output is zero and the caller's residual carries it.

Each slot holds at most one token with weight exactly 1 and each token
has at most one nonzero combine term, so the one-hot einsums add only
exact zeros: the index form gives the same values (bit for bit in f32,
drops included; ``tests/test_torch_moe.py`` holds the two forms
together).  No two tokens, kept or dropped, share a row, so the
backward's scatters never add two tokens together; that also keeps the
card's deterministic scatter-add off its slow path (with every dropped
token on one shared row it serialized them: 5.8 ms of a layer's
backward on an H100 at a third dropped).  Shapes stay static (no
``nonzero``, no ``item``, no loop over experts): a step makes no host
sync.

Drop-free routing (``no_drop``, the decode path) is the same code with
C = N.

On a mesh (the weights are DTensors) the layer leaves DTensor for local
tensors, as attention does, and routes as GSPMD routes the JAX layer:
over the GLOBAL tokens.  The capacity is ``ceil(cf * N / E)`` of the
global N, and a token's queue position counts the tokens routed to its
expert before it on the global token axis: the ranks that hold earlier
rows (a data-parallel batch is split by rows) come first, so each rank
adds the exclusive prefix of the per-expert counts gathered across them
(:func:`_route_on_mesh`).  The aux loss and the drop share are the
global ones, from sums over those ranks.  Two layouts:

- **expert parallel** (:func:`expert_sharding`, JAX ``ops/moe.py:145-155``:
  each expert weight's leading E axis on an axis, the router
  replicated): each rank of that axis routes 1/m of its rows with the
  replicated router and packs its ``[E, C, D]`` slots; an
  ``all_to_all_single`` sends each expert's slots to the rank that
  holds it, which runs its E/m experts on the slots of all m senders; a
  second all-to-all brings the outputs back, they are combined, and the
  rows are gathered over the axis (:func:`_moe_expert_parallel`);
- **the trainer's rule** (``parallel/mesh.py::shard_params``, the layout
  JAX's ``make_lm_train_step`` gives ``[E, D, F]`` / ``[E, F, D]``: the
  largest divisible axis, ``mlp_dim`` at the trainer's widths): a
  Megatron split of every expert's F over the model axis, whose partial
  sums reduce before the combine (:func:`_moe_megatron`; weights not
  split on F are gathered whole, and the model ranks then repeat the
  expert MLP).
"""

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Replicate,
    Shard,
    distribute_tensor,
)

from container_engine_accelerators_tpu_torch.parallel.mesh import (
    BATCH_AXES,
    MODEL_AXIS,
    replicate,
)

EXPERT_WEIGHTS = ("wi_gate", "wi_up", "wo")


class Routing(NamedTuple):
    """Top-1 routing of N tokens: ``probs`` [N, E] f32 (softmax of the
    router logits), ``expert`` [N] int64 (argmax, first on ties),
    ``gate`` [N] f32 (the top probability), ``pos`` [N] int64 (the
    token's place in its expert's queue, tokens taken batch-major) and
    ``keep`` [N] bool (``pos < capacity``)."""

    probs: torch.Tensor
    expert: torch.Tensor
    gate: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor


def capacity(n: int, num_experts: int, capacity_factor: float,
             no_drop: bool) -> int:
    """Slots per expert: N drop-free, else ``ceil(factor * N / E)``
    (at least 1), as the JAX layer computes it."""
    if no_drop:
        return n
    return max(1, math.ceil(capacity_factor * n / num_experts))


def route(flat: torch.Tensor, router: torch.Tensor, cap: int) -> Routing:
    """Route ``flat`` [N, D] with the ``router`` kernel [D, E] in f32, as
    the JAX router does (in f64 for f64 inputs, which the JAX model has
    no mode for)."""
    acc = torch.promote_types(flat.dtype, torch.float32)
    probs = torch.softmax(flat.to(acc) @ router.to(acc), dim=-1)
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None]).squeeze(1)
    # Queue position: the count of earlier tokens routed to the same
    # expert (an integer cumsum over the one-hot, exact at any N), scanned
    # as [E, N] along N: the card scans a tensor's last dim in parallel,
    # its first dim one thread a column (2.9 ms at N 16,384 on an H100).
    onehot = F.one_hot(expert, probs.shape[1]).t()
    pos = onehot.cumsum(1).gather(0, expert[None]).squeeze(0) - 1
    return Routing(probs, expert, gate, pos, pos < cap)


def switch_aux_loss(r: Routing) -> torch.Tensor:
    """Switch load-balance loss ``E * sum_e frac_routed_e * mean_gate_e``
    (f32); its gradient reaches the router through ``mean_gate``."""
    e = r.probs.shape[1]
    frac_routed = F.one_hot(r.expert, e).float().mean(0)
    return e * (frac_routed * r.probs.mean(0)).sum()


def _expert_mlp(slots, wi_gate, wi_up, wo, dtype, partial=False):
    """The gated SiLU MLP of every expert over its slots ``[E, C, D]``.
    ``partial``: ``wo`` is this rank's share of F, so the output is a
    partial sum over ranks; below f32 it is returned in f32 (the products
    of ``dtype`` values are exact there) for the sum to round once."""
    h = F.silu(torch.bmm(slots, wi_gate.to(dtype))) * torch.bmm(
        slots, wi_up.to(dtype))
    if partial and dtype.itemsize < 4:
        return torch.bmm(h.float(), wo.to(dtype).float())
    return torch.bmm(h, wo.to(dtype))


def _dispatch(flat, r, cap, e, dtype):
    """(``[E, cap, D]`` slots of the kept tokens, each token's row in the
    ``[E * cap + n]`` buffer): a kept token at ``e * cap`` plus its place
    among this block's tokens of expert e, a dropped one at its own
    scratch row past the slots."""
    n, d = flat.shape
    slot = torch.where(r.keep, r.expert * cap + r.pos,
                       e * cap + torch.arange(n, device=flat.device))
    buf = flat.new_zeros(e * cap + n, d, dtype=dtype)
    buf = buf.index_put((slot,), flat.to(dtype))
    return buf[:e * cap].view(e, cap, d), slot


def _combine(out_slots, slot, r, n, dtype):
    """Each kept token's slot row scaled by its gate; a dropped token reads
    its zero row past the slots."""
    rows = torch.cat([out_slots, out_slots.new_zeros(n, out_slots.shape[1])])
    return rows[slot] * r.gate.to(dtype)[:, None]


def moe_ffn(x: torch.Tensor, router: torch.Tensor, wi_gate: torch.Tensor,
            wi_up: torch.Tensor, wo: torch.Tensor, dtype: torch.dtype,
            capacity_factor: float = 1.25, no_drop: bool = False):
    """The plain function behind :class:`MoEFFN`: ``x`` [..., D] ->
    (out [..., D] in ``dtype``, aux loss f32, share of tokens dropped
    f32; both f64 for f64 inputs).  ``router`` [D, E]; ``wi_gate``,
    ``wi_up`` [E, D, H]; ``wo`` [E, H, D] (the flax layouts), cast to
    ``dtype`` for the MLP."""
    *lead, d = x.shape
    n = math.prod(lead)
    e = router.shape[1]
    cap = capacity(n, e, capacity_factor, no_drop)
    flat = x.reshape(n, d)
    r = route(flat, router, cap)
    slots, slot = _dispatch(flat, r, cap, e, dtype)
    out_slots = _expert_mlp(slots, wi_gate, wi_up, wo, dtype).view(
        e * cap, d)
    out = _combine(out_slots, slot, r, n, dtype)
    dropped = (~r.keep).float().mean().detach()
    return out.view(*lead, d), switch_aux_loss(r), dropped


class MoEFFN(nn.Module):
    """Top-1 (Switch) MoE feed-forward: ``forward(x [..., D]) -> (out,
    aux, dropped)`` (:func:`moe_ffn`).  The router kernel ``router`` [D,
    E] stays f32 whatever the compute dtype, as the JAX router, a
    ``Dense(dtype=float32)``, multiplies its stored weights in f32 (bf16
    serving weights load into it exactly); the expert weights follow
    ``make_param`` (f32 leaves in training, the compute dtype in
    decode)."""

    def __init__(self, dim, num_experts, mlp_dim, dtype, make_param,
                 capacity_factor=1.25, no_drop=False):
        super().__init__()
        self.dtype = dtype
        self.capacity_factor = capacity_factor
        self.no_drop = no_drop
        self.router = make_param(dim, num_experts, dtype=torch.float32)
        self.wi_gate = make_param(num_experts, dim, mlp_dim, dtype=dtype)
        self.wi_up = make_param(num_experts, dim, mlp_dim, dtype=dtype)
        self.wo = make_param(num_experts, mlp_dim, dim, dtype=dtype)

    def forward(self, x):
        if isinstance(self.wi_gate, DTensor):
            return moe_ffn_mesh(self, x)
        return moe_ffn(x, self.router, self.wi_gate, self.wi_up, self.wo,
                       self.dtype, self.capacity_factor, self.no_drop)


def expert_sharding(mesh, module: MoEFFN, axis: str = MODEL_AXIS) -> MoEFFN:
    """Expert parallelism over ``mesh``'s ``axis`` (JAX's
    ``expert_sharding``): every 3-D expert weight of ``module`` becomes a
    DTensor with its leading expert axis sharded on ``axis``, the router
    a replicated one.  In place; returns ``module``.  Every rank must
    hold the same values."""
    if module.wi_gate.shape[0] % mesh.size(
            mesh.mesh_dim_names.index(axis)):
        raise ValueError(f"{module.wi_gate.shape[0]} experts not divisible "
                         f"by the {axis} axis")
    for name, p in list(module.named_parameters(recurse=False)):
        if isinstance(p, DTensor):
            raise ValueError(f"{name} is sharded already")
        pl = tuple(Shard(0) if n == axis and name in EXPERT_WEIGHTS
                   else Replicate() for n in mesh.mesh_dim_names)
        module.register_parameter(name, nn.Parameter(
            distribute_tensor(p.detach(), mesh, pl),
            requires_grad=p.requires_grad))
    return module


def _sum_over(mesh, split, t):
    """The sum of ``t`` over the ranks of the mesh dims ``split``, whole on
    every rank; its backward hands each rank the cotangent once."""
    if not split:
        return t
    pl = tuple(Partial() if d in split else Replicate()
               for d in range(mesh.ndim))
    return DTensor.from_local(t, mesh, pl, run_check=False).full_tensor()


def _route_on_mesh(flat, router, cap, mesh, split, n_total):
    """:func:`route` of this rank's token block ``flat`` as the JAX layer
    routes the global tokens -> (Routing whose ``keep`` is the global
    capacity test on the GLOBAL queue position and whose ``pos`` is the
    token's place among this block's tokens of its expert — below the
    capacity wherever ``keep`` holds, and what the block's slot buffer
    is indexed by —, global aux loss, global share dropped).  ``split``
    lists the mesh dims over which the tokens are split, outer first, in
    the order the blocks take on the global token axis; ``n_total`` is
    the global N."""
    r = route(flat, router, cap)
    if not split:
        # One block holds every token: the single-device arithmetic.
        return r, switch_aux_loss(r), (~r.keep).float().mean().detach()
    e = r.probs.shape[1]
    onehot = F.one_hot(r.expert, e)
    # One row a rank: its block's index and per-expert counts; the
    # ranks that repeat a block (split over fewer dims than the mesh
    # has) repeat its row, so each block counts world / blocks times.
    coord = mesh.get_coordinate()
    idx, blocks = 0, 1
    for d in split:
        idx, blocks = idx * mesh.size(d) + coord[d], blocks * mesh.size(d)
    row = torch.cat([torch.tensor([idx], device=flat.device),
                     onehot.sum(0)])[None]
    table = DTensor.from_local(row, mesh, (Shard(0),) * mesh.ndim,
                               run_check=False).full_tensor()
    earlier = (table[:, 0] < idx).to(table.dtype)[:, None]
    offset = (table[:, 1:] * earlier).sum(0) // (mesh.size() // blocks)
    r = r._replace(keep=r.pos + offset[r.expert] < cap)
    frac_routed = _sum_over(mesh, split, onehot.to(r.probs.dtype).sum(0))
    mean_gate = _sum_over(mesh, split, r.probs.sum(0))
    aux = e * ((frac_routed / n_total) * (mean_gate / n_total)).sum()
    dropped = _sum_over(mesh, split, (~r.keep).to(r.probs.dtype).sum()
                        ).detach() / n_total
    return r, aux, dropped


def _mesh_layout(module, x):
    """(mesh, x as a DTensor, the placements of x's rows: split over the
    batch axes where x is, the same on the other dims, and the indices of
    the dims of more than one rank that split them)."""
    mesh = module.wi_gate.device_mesh
    xd = x if isinstance(x, DTensor) else replicate(x, mesh)
    names = mesh.mesh_dim_names
    rows = tuple(Shard(0) if n in BATCH_AXES and p.is_shard(0)
                 else Replicate() for n, p in zip(names, xd.placements))
    # Dims of one rank split nothing: no collective for them.
    split = [i for i, p in enumerate(rows)
             if p.is_shard() and mesh.size(i) > 1]
    return mesh, xd, rows, split


def _local_weight(w, mesh, keep, grad):
    """``w`` as a local tensor: sharded as ``keep`` says (a placement a
    dim, None = gathered), its gradient placed ``grad``."""
    target = tuple(Replicate() if k is None else k for k in keep)
    return w.redistribute(mesh, target).to_local(grad_placements=grad)


def _finish(out, xd, rows, plain, mesh):
    """This rank's output rows as the caller's kind: the row-split DTensor
    for a DTensor input, the whole tensor for a plain one."""
    out = DTensor.from_local(out, mesh, rows, run_check=False)
    return out.full_tensor() if plain else out


def moe_ffn_mesh(module: MoEFFN, x):
    """:class:`MoEFFN`'s forward with DTensor weights -> (out, aux,
    dropped), out of x's kind (a DTensor split as x is, or a plain
    tensor whole on every rank), aux and dropped whole on every rank (a
    replicated DTensor for a DTensor input)."""
    plain = not isinstance(x, DTensor)
    if any(p.is_shard(0) for p in module.wi_gate.placements):
        out, aux, dropped = _moe_expert_parallel(module, x)
    else:
        out, aux, dropped = _moe_megatron(module, x)
    if not plain:
        mesh = module.wi_gate.device_mesh
        aux, dropped = (DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                                           run_check=False)
                        for t in (aux, dropped))
    return out, aux, dropped


def _moe_megatron(module, x):
    """The trainer's layout: every rank routes its data rows (the same rows
    on every model rank) and runs its model rank's share of every expert's
    F; the partial sums over F reduce over the model axis before the
    combine."""
    mesh, xd, rows, split = _mesh_layout(module, x)
    names = mesh.mesh_dim_names
    m_dim = names.index(MODEL_AXIS) if MODEL_AXIS in names else None
    dtype = module.dtype
    *lead, d = x.shape
    # F is split when the rule put the model axis on mlp_dim in all three.
    f_split = m_dim is not None and mesh.size(m_dim) > 1 and all(
        getattr(module, n).placements[m_dim] == Shard(a)
        for n, a in (("wi_gate", 2), ("wi_up", 2), ("wo", 1)))
    batch_grad = tuple(Partial() if i in split else Replicate()
                       for i in range(mesh.ndim))

    def expert(name, f_axis):
        keep = [None] * mesh.ndim
        grad = list(batch_grad)
        if f_split:
            keep[m_dim] = grad[m_dim] = Shard(f_axis)
        return _local_weight(getattr(module, name), mesh, keep, tuple(grad))

    wi_gate, wi_up, wo = (expert("wi_gate", 2), expert("wi_up", 2),
                          expert("wo", 1))
    router = _local_weight(module.router, mesh, [None] * mesh.ndim,
                           batch_grad)
    # Routing reads x the same on every model rank; the expert products
    # read it through one F share each, so their x gradient is a partial
    # sum over the model axis.
    x_route = xd.redistribute(mesh, rows).to_local()
    exp_grad = tuple(Partial() if f_split and i == m_dim else p
                     for i, p in enumerate(rows))
    x_exp = xd.redistribute(mesh, rows).to_local(grad_placements=exp_grad)
    n = math.prod(x_route.shape[:-1])
    blocks = math.prod(mesh.size(i) for i in split)
    e = router.shape[1]
    cap = capacity(n * blocks, e, module.capacity_factor, module.no_drop)
    r, aux, dropped = _route_on_mesh(x_route.reshape(n, d), router, cap,
                                     mesh, split, n * blocks)
    slots, slot = _dispatch(x_exp.reshape(n, d), r, cap, e, dtype)
    out_slots = _expert_mlp(slots, wi_gate, wi_up, wo, dtype,
                            partial=f_split).view(e * cap, d)
    if f_split:
        out_slots = _AllReduceForward.apply(
            out_slots, mesh.get_group(m_dim)).to(dtype)
    out = _combine(out_slots, slot, r, n, dtype)
    return (_finish(out.view(*x_route.shape[:-1], d), xd, rows,
                    not isinstance(x, DTensor), mesh), aux, dropped)


class _AllReduceForward(torch.autograd.Function):
    """Sum over ``group`` forward, identity backward: the partial sums of
    a Megatron split reduce, and each rank's cotangent of the (replicated)
    sum is already the whole one."""

    @staticmethod
    def forward(ctx, t, group):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        return g, None


def _moe_expert_parallel(module, x):
    """Expert parallelism: each rank of the expert axis routes 1/m of its
    rows, its slots go to the experts' ranks and back through two
    all-to-alls, and the rows are gathered over the axis."""
    import torch.distributed.nn.functional as dnn

    mesh, xd, rows, split = _mesh_layout(module, x)
    names = mesh.mesh_dim_names
    ax = next(i for i, p in enumerate(module.wi_gate.placements)
              if p.is_shard(0))
    m, j = mesh.size(ax), mesh.get_coordinate()[ax]
    group = mesh.get_group(ax)
    dtype = module.dtype
    *lead, d = x.shape
    # This rank's rows; the x gradient of each chunk lives on its rank.
    chunk_grad = tuple(Partial() if i == ax else p
                       for i, p in enumerate(rows))
    x_local = xd.redistribute(mesh, rows).to_local(
        grad_placements=chunk_grad)
    n = math.prod(x_local.shape[:-1])
    if n % m:
        raise ValueError(f"{n} token rows not divisible by the {names[ax]} "
                         f"axis ({m})")
    nc = n // m
    flat = x_local.reshape(n, d)[j * nc:(j + 1) * nc]
    tok_split = split + ([ax] if m > 1 else [])
    tok_grad = tuple(Partial() if i in tok_split else Replicate()
                     for i in range(mesh.ndim))
    router = _local_weight(module.router, mesh, [None] * mesh.ndim,
                           tok_grad)
    experts = []
    for name in EXPERT_WEIGHTS:
        keep = [None] * mesh.ndim
        keep[ax] = Shard(0)
        grad = tuple(Shard(0) if i == ax else Partial() if i in split
                     else Replicate() for i in range(mesh.ndim))
        experts.append(_local_weight(getattr(module, name), mesh, keep,
                                     grad))
    e = router.shape[1]
    n_total = nc * m * math.prod(mesh.size(i) for i in split)
    cap = capacity(n_total, e, module.capacity_factor, module.no_drop)
    r, aux, dropped = _route_on_mesh(flat, router, cap, mesh, tok_split,
                                     n_total)
    # A sender keeps at most min(cap, nc) tokens of one expert: its place
    # among this chunk's tokens of that expert is below both.
    c = min(cap, nc)
    slots, slot = _dispatch(flat, r, c, e, dtype)
    # [m senders' worth of my E/m experts] <- all-to-all over the axis.
    # (One rank holds every expert: nothing to exchange.)
    send = slots.reshape(m, e // m, c, d).contiguous()
    recv = send if m == 1 else dnn.all_to_all_single(
        torch.empty_like(send), send, group=group)
    mine = recv.permute(1, 0, 2, 3).reshape(e // m, m * c, d)
    out_mine = _expert_mlp(mine, *experts, dtype)
    back = out_mine.reshape(e // m, m, c, d).permute(1, 0, 2, 3).contiguous()
    out_slots = (back if m == 1 else dnn.all_to_all_single(
        torch.empty_like(back), back, group=group)).reshape(e * c, d)
    out = _combine(out_slots, slot, r, nc, dtype)
    # Gather the chunks over the axis: each rank's rows whole again.
    chunks = tuple(Shard(0) if i == ax else p for i, p in enumerate(rows))
    out = DTensor.from_local(out, mesh, chunks, run_check=False).redistribute(
        mesh, rows).to_local()
    return (_finish(out.view(*x_local.shape[:-1], d), xd, rows,
                    not isinstance(x, DTensor), mesh), aux, dropped)

