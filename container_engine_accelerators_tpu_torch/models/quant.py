"""Serving weight precision — ``serving_params`` of
``container_engine_accelerators_tpu/models/quant.py`` for ``f32`` and
``bf16``.  int8 weights (``QDenseGeneral`` with f32 scales) come with a
later serving slice of the port."""

import torch


def serving_params(params: dict, weights: str) -> dict:
    """State dict -> serving weights (``f32`` | ``bf16``).  ``bf16`` casts
    every float tensor, norm scales included, as the JAX package does."""
    if weights == "f32":
        return params
    if weights == "bf16":
        return {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                for k, v in params.items()}
    if weights == "int8":
        raise NotImplementedError("int8 serving weights come with a later "
                                  "serving slice of the PyTorch port")
    raise ValueError(f"unknown weights mode {weights!r}")
