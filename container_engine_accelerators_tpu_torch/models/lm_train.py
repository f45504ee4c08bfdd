"""Training step of the transformer LM on one device — PyTorch
counterpart of ``container_engine_accelerators_tpu/models/lm_train.py``,
dense or MoE (the Switch load-balance loss joins the objective).

Next-token labels are built for the whole sequence before the step, as
the JAX module does, so the step takes (tokens, labels, mask).  The
sequence-parallel step (ring, ring-zigzag, Ulysses) and FSDP parameter
sharding come with the multi-GPU slice of the port and raise here.
"""

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from container_engine_accelerators_tpu_torch.models.train import TrainState
from container_engine_accelerators_tpu_torch.models.transformer import (
    init_params,
)

MOE_AUX_WEIGHT = 0.01  # Switch load-balance coefficient
_MULTI_GPU = "comes with the multi-GPU slice of the PyTorch port"


def next_token_targets(tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels, mask) for causal LM: predict token t+1 at position t."""
    labels = torch.roll(tokens, -1, dims=1)
    mask = torch.ones(tokens.shape, dtype=torch.float32, device=tokens.device)
    mask[:, -1] = 0.0
    return labels, mask


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


def make_lm_train_step(seq_parallel: Optional[str] = None,
                       param_sharding: str = "megatron"):
    """``step_fn(state, tokens, labels, mask) -> (state, metrics)``: one
    optimizer step on the mean masked next-token cross entropy (plus the
    MoE aux term), updating ``state`` in place.  ``metrics`` holds
    ``loss`` and, for an MoE model, ``moe_aux`` (the summed load-balance
    loss) and ``moe_dropped`` (the share of token routings dropped),
    device tensors all (reading one waits for the device).  Unlike the
    JAX function, there is no mesh to place the state on, so it takes no
    state and returns only the step."""
    if param_sharding not in ("megatron", "fsdp"):
        raise ValueError(f"unknown param_sharding {param_sharding!r}")
    if seq_parallel is not None:
        raise NotImplementedError(f"sequence parallelism ({seq_parallel}) "
                                  f"{_MULTI_GPU}")
    if param_sharding == "fsdp":
        raise NotImplementedError(f"param_sharding='fsdp' {_MULTI_GPU}")

    def step(s: TrainState, tokens, labels, mask):
        s.optimizer.zero_grad(set_to_none=True)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        num, den, aux = _loss(s.model, tokens, labels, mask, positions,
                              with_aux=True)
        loss = num / den
        loss.backward()
        s.optimizer.step()
        s.step += 1
        metrics = {"loss": loss.detach()}
        if s.model.num_experts:
            metrics.update(moe_aux=aux.loss.detach(), moe_dropped=aux.dropped)
        return s, metrics

    return step
