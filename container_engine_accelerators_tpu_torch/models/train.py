"""The training state and the image-model train step of the PyTorch port —
counterpart of ``container_engine_accelerators_tpu/models/train.py``.

flax's ``TrainState`` is an immutable pytree of step, params, batch
statistics, optimizer state, optimizer and apply function, replaced at
every step.  Here the model owns its parameters and BatchNorm buffers and
the optimizer its state, and a step updates both in place, so the state
is the model, the optimizer, the step and (for a scheduled optimizer)
the learning-rate schedule together.

:func:`cosine_sgd` is ``optax.chain(add_decayed_weights(wd),
sgd(warmup_cosine_decay_schedule(0, base_lr, warmup, total),
momentum, nesterov=True))``: ``torch.optim.SGD(nesterov=True,
weight_decay=wd)`` adds ``wd * p`` to every gradient (BatchNorm scales
and biases and the head's bias included, as optax's chain does) and then
takes the same Nesterov step.  :func:`train_step` sets the learning rate
from ``state.step`` before each update, the count optax's schedule reads
before it increments — so step 0 trains at lr 0, and a resumed run needs
no scheduler state.  :func:`make_sharded_train_step` runs the same step
over a (data, model) mesh.
"""

import dataclasses
import inspect
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from container_engine_accelerators_tpu_torch.models.resnet import init_params
from container_engine_accelerators_tpu_torch.parallel.mesh import (
    full,
    shard_batch,
    shard_params,
    sync_grads,
)


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    # lr as a function of the step, set before each update; None leaves
    # the optimizer's own.
    schedule: Optional[Callable[[int], float]] = None


@dataclasses.dataclass(frozen=True)
class CosineSGD:
    """The demo sweep's optimizer family (batch-scaled SGD momentum):
    :meth:`lr` is the schedule, :meth:`optimizer` the update."""

    base_lr: float = 0.1
    momentum: float = 0.9
    total_steps: int = 10_000
    warmup_steps: int = 500
    weight_decay: float = 1e-4

    def __post_init__(self):
        if not self.total_steps - self.warmup_steps > 0:
            # optax's cosine_decay_schedule refuses it the same way.
            raise ValueError(
                f"the cosine decay needs total_steps > warmup_steps, got "
                f"{self.total_steps} and {self.warmup_steps}")

    def lr(self, step: int) -> float:
        """``warmup_cosine_decay_schedule(0, base_lr, warmup, total)`` at
        ``step``, in optax's f32 arithmetic operation for operation; the
        cosine itself is computed in f64 and rounded to f32 (XLA's f32
        cosine is not correctly rounded, so the result may differ from
        optax's by an f32 ulp)."""
        f32 = np.float32
        peak = f32(self.base_lr)
        if step < self.warmup_steps:
            frac = f32(1) - f32(step) / f32(self.warmup_steps)
            return float(f32(-self.base_lr) * frac + peak)
        decay = self.total_steps - self.warmup_steps
        count = f32(min(step - self.warmup_steps, decay))
        cos = f32(math.cos(f32(math.pi) * count / f32(decay)))
        return float(peak * (f32(0.5) * (f32(1) + cos)))

    def optimizer(self, params) -> torch.optim.SGD:
        return torch.optim.SGD(params, lr=0.0, momentum=self.momentum,
                               nesterov=True, weight_decay=self.weight_decay)


def cosine_sgd(base_lr: float = 0.1, momentum: float = 0.9,
               total_steps: int = 10_000, warmup_steps: int = 500,
               weight_decay: float = 1e-4) -> CosineSGD:
    return CosineSGD(base_lr, momentum, total_steps, warmup_steps,
                     weight_decay)


def create_train_state(model: torch.nn.Module,
                       generator: Optional[torch.Generator] = None,
                       tx: Optional[CosineSGD] = None) -> TrainState:
    """An image model's state at step 0.  With a ``generator``, the
    weights and BatchNorm statistics are first drawn from it
    (``models/resnet.py::init_params``, flax's initializers); without
    one, the model keeps what it holds.  ``tx`` defaults to
    ``cosine_sgd()``."""
    if generator is not None:
        model.load_state_dict(init_params(model, generator))
    tx = tx or cosine_sgd()
    return TrainState(step=0, model=model,
                      optimizer=tx.optimizer(model.parameters()),
                      schedule=tx.lr)


def train_step(state: TrainState, images: torch.Tensor,
               labels: torch.Tensor) -> Tuple[TrainState, dict]:
    """One optimizer step in train mode (batch statistics, running
    statistics updated), in place: f32 mean cross-entropy over integer
    labels.  ``images`` are ``[N, 3, H, W]`` (NHWC data permuted is
    ``channels_last`` already).  Returns the state and ``{"loss",
    "accuracy"}`` as device tensors (reading them waits for the
    device)."""
    model, opt = state.model, state.optimizer
    model.train()
    if state.schedule is not None:
        lr = state.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
    opt.zero_grad(set_to_none=True)
    logits = model(images)
    loss = F.cross_entropy(logits, labels.long())
    loss.backward()
    if isinstance(loss, DTensor):
        sync_grads(model)
    opt.step()
    state.step += 1
    accuracy = (logits.detach().argmax(-1) == labels).float().mean()
    return state, {"loss": full(loss.detach()), "accuracy": full(accuracy)}


def rebuild_optimizer(optimizer: torch.optim.Optimizer,
                      params) -> torch.optim.Optimizer:
    """The same optimizer, with its hyperparameters, over ``params`` (the
    model's parameters after they were replaced by DTensors).  It must
    hold no state yet: restore a checkpoint after placing the state."""
    if optimizer.state:
        raise ValueError("place the train state before it takes a step or "
                         "a checkpoint: the optimizer already holds state")
    accepted = inspect.signature(type(optimizer)).parameters
    return type(optimizer)(params, **{k: v for k, v in
                                      optimizer.defaults.items()
                                      if k in accepted})


def make_sharded_train_step(mesh, state: TrainState):
    """:func:`train_step` over ``mesh`` -> ``(step_fn, placed_state)``:
    the parameters (and the momentum made from them) laid out tensor
    parallel by the JAX rule (``parallel/mesh.py::shard_params``), the
    BatchNorm statistics replicated, the batch split by rows over the
    data axis.  ``step_fn(state, images, labels)`` takes the batch as
    DTensors split by rows (``parallel/mesh.py::from_local_batch``), or
    whole on every rank, of which each rank keeps its rows.  BatchNorm
    normalises with the global batch's statistics, and the loss and
    accuracy are the global batch's, whole on every rank."""
    model = shard_params(state.model, mesh)
    state.optimizer = rebuild_optimizer(state.optimizer, model.parameters())

    def step(s: TrainState, images, labels):
        images, labels = (x if isinstance(x, DTensor)
                          else shard_batch(x, mesh) for x in (images, labels))
        return train_step(s, images, labels)

    return step, state
