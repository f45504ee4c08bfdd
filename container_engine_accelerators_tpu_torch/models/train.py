"""The training state of the PyTorch port — counterpart of
``container_engine_accelerators_tpu/models/train.py::TrainState``.

flax's ``TrainState`` is an immutable pytree of step, params, optimizer
state, optimizer and apply function, replaced at every step.  Here the
model owns its parameters and the optimizer its state, and a step
updates both in place, so the state is the three objects together.
"""

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
