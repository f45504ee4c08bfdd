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
C = N.  Expert parallelism (``expert_sharding``) belongs to the next
multi-GPU slice of the port.
"""

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


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

    # Row of each token in the [E * C + N, D] buffer: its slot, or when
    # dropped its own scratch row past the slots.
    slot = torch.where(r.keep, r.expert * cap + r.pos,
                       e * cap + torch.arange(n, device=x.device))
    buf = flat.new_zeros(e * cap + n, d, dtype=dtype)
    buf = buf.index_put((slot,), flat.to(dtype))
    slots = buf[:e * cap].view(e, cap, d)

    h = F.silu(torch.bmm(slots, wi_gate.to(dtype))) * torch.bmm(
        slots, wi_up.to(dtype))
    out_slots = torch.bmm(h, wo.to(dtype)).view(e * cap, d)

    # A dropped token reads its zero row appended past the slots.
    rows = torch.cat([out_slots, out_slots.new_zeros(n, d)])
    out = rows[slot] * r.gate.to(dtype)[:, None]
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
        return moe_ffn(x, self.router, self.wi_gate, self.wi_up, self.wo,
                       self.dtype, self.capacity_factor, self.no_drop)
