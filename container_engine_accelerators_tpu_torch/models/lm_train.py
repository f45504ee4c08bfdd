"""Training step of the transformer LM on one device — PyTorch
counterpart of ``container_engine_accelerators_tpu/models/lm_train.py``,
dense or MoE (the Switch load-balance loss joins the objective).

Next-token labels are built for the whole sequence before the step, as
the JAX module does, so the step takes (tokens, labels, mask).

Dense mode and the MoE-LM run on one device or over a (data, model)
mesh (``parallel/mesh.py``): the weights become DTensors laid out by the
JAX rule ("megatron" or "fsdp"; an MoE block's ``[E, D, F]`` and ``[E, F,
D]`` experts by the same largest-axis pick, ``mlp_dim`` at the trainer's
widths), the batch is split by rows over the data axis, and the loss is
the global one — the masked sum over the whole batch over the global
mask count, a single replicated value, not a mean of per-rank means.
An MoE block routes the global tokens, as GSPMD routes the JAX model's
(``ops/moe.py``): capacity and queue positions over the whole batch, the
aux loss the global one.

Sequence-parallel mode (``seq_parallel`` "ring", "ring-zigzag" or
"ulysses") splits the sequence over the mesh's data axis instead: the
parameters stay plain tensors, replicated (DTensor would cost host time
on every op), each rank feeds its T/n columns of the whole batch at
their global positions (:func:`prepare_seq_parallel_batch` builds the
batch), the loss is the masked sum over every rank's columns over the
global mask count, and each gradient is summed over the ranks with one
all-reduce — the sum JAX's shard_map autodiff inserts implicitly.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from container_engine_accelerators_tpu_torch.models.train import (
    TrainState,
    rebuild_optimizer,
)
from container_engine_accelerators_tpu_torch.models.transformer import (
    init_params,
)
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_size,
    drop_unit_shards,
    full,
    shard_batch,
    shard_params,
    shard_params_fsdp,
    sync_grads,
)
from container_engine_accelerators_tpu_torch.parallel.seq import (
    ring_positions,
    to_zigzag,
)
from container_engine_accelerators_tpu_torch.utils.profile import span

MOE_AUX_WEIGHT = 0.01  # Switch load-balance coefficient


def next_token_targets(tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, mask) for causal LM: predict token t+1 at position t."""
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


def prepare_seq_parallel_batch(tokens: torch.Tensor,
                               seq_parallel: Optional[str] = None,
                               n_shards: Optional[int] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """(tokens', labels', mask') of a whole batch for the
    sequence-parallel step: labels and mask from the ORIGINAL order (a
    shard's last label lives in the next shard), then, for
    ``ring-zigzag``, all three reordered into zigzag storage order over
    ``n_shards`` ranks, so rank i's contiguous columns hold chunks i and
    2n-1-i."""
    labels, mask = next_token_targets(tokens)
    if seq_parallel == "ring-zigzag":
        if n_shards is None:
            raise ValueError("ring-zigzag batch prep needs n_shards")
        tokens, labels, mask = (to_zigzag(x, n_shards)
                                for x in (tokens, labels, mask))
    return tokens, labels, mask


def create_lm_train_state(model: torch.nn.Module,
                          generator: Optional[torch.Generator] = None,
                          optimizer: Optional[torch.optim.Optimizer] = None
                          ) -> TrainState:
    """A train-mode ``TransformerLM``'s state at step 0.  With a
    ``generator``, the weights are first drawn from it
    (``models/transformer.py::init_params``, the flax initializers' law);
    without one, the model keeps the weights it holds.  The default
    optimizer is ``optax.adamw(3e-4, weight_decay=0.1)``'s counterpart,
    AdamW over EVERY parameter with no mask, norm scales and the embedding
    included, as optax applies it."""
    if generator is not None:
        model.load_state_dict(init_params(model, generator))
    if optimizer is None:
        optimizer = torch.optim.AdamW(model.parameters(), lr=3e-4,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=0.1)
    return TrainState(step=0, model=model, optimizer=optimizer)


def _loss(model, tokens, labels, mask, positions, with_aux=False):
    """(sum of masked per-token cross entropy + the MoE aux term, mask
    sum), as the JAX ``_loss``: the aux term is the Switch load-balance
    loss summed over the layers, ``MOE_AUX_WEIGHT * aux * denom`` (zero
    for a dense model).  ``with_aux`` adds the model's ``MoEAux`` as a
    third value."""
    logits, aux = model(tokens, positions, return_aux=True)
    per_tok = F.cross_entropy(logits.flatten(0, 1), labels.flatten().long(),
                              reduction="none").view(labels.shape)
    denom = mask.sum()
    num = (per_tok * mask).sum() + MOE_AUX_WEIGHT * aux.loss * denom
    return (num, denom, aux) if with_aux else (num, denom)


def make_lm_train_step(mesh=None, state: Optional[TrainState] = None,
                       seq_parallel: Optional[str] = None,
                       param_sharding: str = "megatron"):
    """``(step_fn, placed_state)``; ``step_fn(state, tokens, labels, mask)
    -> (state, metrics)`` takes one optimizer step on the mean masked
    next-token cross entropy (plus the MoE aux term), updating ``state``
    in place.  ``metrics`` holds ``loss`` and, for an MoE model,
    ``moe_aux`` (the summed load-balance loss) and ``moe_dropped`` (the
    share of token routings dropped), device tensors all (reading one
    waits for the device).

    Without a ``mesh`` the state stays where it is (one device).  With
    one, ``param_sharding`` "megatron" shards every weight over the model
    axis and replicates it along the data axis; "fsdp" also shards it
    (and its AdamW moments) over the data axis (``parallel/mesh.py``).
    The step then takes the batch as DTensors split by rows
    (``parallel/mesh.py::from_local_batch``), or whole on every rank,
    and each rank keeps its rows; its ``loss`` is the global loss, whole
    on every rank.

    With ``seq_parallel`` the model must have been built with the same
    scheme; the mesh's data axis carries the sequence shards (its model
    axis must be 1), and the step takes this rank's columns ``[B, T/n]``
    of the whole batch (in zigzag storage order for "ring-zigzag")."""
    if param_sharding not in ("megatron", "fsdp"):
        raise ValueError(f"unknown param_sharding {param_sharding!r}")
    if seq_parallel is not None:
        return _seq_parallel_step(mesh, state, seq_parallel, param_sharding)
    if mesh is None and param_sharding == "fsdp":
        raise ValueError("param_sharding='fsdp' shards over a mesh: pass "
                         "one (parallel/mesh.py::create_mesh)")
    if mesh is not None:
        shard = (shard_params_fsdp if param_sharding == "fsdp"
                 else shard_params)
        shard(state.model, mesh)
        state.optimizer = rebuild_optimizer(state.optimizer,
                                            state.model.parameters())

    def step(s: TrainState, tokens, labels, mask):
        if mesh is not None:
            tokens, labels, mask = (drop_unit_shards(
                x if isinstance(x, DTensor) else shard_batch(x, mesh))
                for x in (tokens, labels, mask))
        with span("lm.train.forward"):
            s.optimizer.zero_grad(set_to_none=True)
            positions = torch.arange(tokens.shape[1], device=tokens.device)
            num, den, aux = _loss(s.model, tokens, labels, mask, positions,
                                  with_aux=True)
            loss = num / den
        with span("lm.train.backward"):
            loss.backward()
            if mesh is not None:
                sync_grads(s.model)
        with span("lm.train.optimizer"):
            s.optimizer.step()
        s.step += 1
        metrics = {"loss": full(loss.detach())}
        if s.model.num_experts:
            metrics.update(moe_aux=full(aux.loss.detach()),
                           moe_dropped=full(aux.dropped))
        return s, metrics

    return step, state


def _seq_parallel_step(mesh, state: TrainState, seq_parallel: str,
                       param_sharding: str):
    """The sequence-parallel step over ``mesh``'s data group (the JAX
    ``shard_map`` step, ``models/lm_train.py:198-245``)."""
    import torch.distributed as dist

    if param_sharding != "megatron":
        raise ValueError(
            f"param_sharding={param_sharding!r} applies to dense mode "
            f"only — the sequence-parallel path runs with replicated "
            f"params")
    if mesh is None:
        raise ValueError("sequence parallelism shards over a mesh's data "
                         "axis: pass one (parallel/mesh.py::create_mesh)")
    if axis_size(mesh, MODEL_AXIS) != 1:
        raise ValueError("sequence parallelism takes a mesh with model=1: "
                         "the sequence shards occupy the whole data axis "
                         "and the params are replicated")
    model = state.model
    if model.seq_parallel != seq_parallel:
        raise ValueError(f"the model was built with seq_parallel="
                         f"{model.seq_parallel!r}, the step asks for "
                         f"{seq_parallel!r}")
    group = mesh.get_group(DATA_AXIS)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    model.bind_seq_group(group)
    layout = "zigzag" if seq_parallel == "ring-zigzag" else "contiguous"

    def step(s: TrainState, tokens, labels, mask):
        with span("lm.train.forward"):
            s.optimizer.zero_grad(set_to_none=True)
            # Rotary and the ring's mask both read these global positions.
            positions = ring_positions(layout, rank, tokens.shape[1], n).to(
                tokens.device)
            num, den = _loss(s.model, tokens, labels, mask, positions)
            sums = torch.stack([num.detach(), den]).float()
            dist.all_reduce(sums, group=group)
            loss = num / sums[1]
        with span("lm.train.backward"):
            loss.backward()
            grads = [p.grad for p in s.model.parameters()
                     if p.grad is not None]
            flat = torch.cat([g.flatten() for g in grads])
            dist.all_reduce(flat, group=group)  # the one sum over the ranks
            for g, x in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(x.view_as(g))
        with span("lm.train.optimizer"):
            s.optimizer.step()
        s.step += 1
        return s, {"loss": sums[0] / sums[1]}

    return step, state
