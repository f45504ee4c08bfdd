"""The JAX distillation test's initial weights, in the port's layout.

``tests/test_distill.py`` trains its target and its draft with the JAX
trainer, which draws each model's weights from ``jax.random.PRNGKey(0)``
(``cmd/train_lm.py``), and compares the distilled draft with a random
one drawn from ``PRNGKey(123)``.  Its acceptance margin rests on those
draws: over draft seeds 0-7 on its own target and corpus the distilled
draft accepts 0.008-0.549, above the random draft's + 0.1 for seed 0
alone.  So the port runs that recipe from the same three draws,
converted with ``from_flax_params`` and stored in ``PATH`` (numpy
only, so that ``chip_smoke.py`` reads them on the card without JAX).

Regenerate with ``JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/torch_distill_inits.py`` from the repo root;
``tests/test_torch_distill.py`` holds the file to JAX's draws.
"""

import os

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "distill_jax_inits.npz")
TARGET_CFG = dict(vocab_size=32, num_layers=2, num_heads=2, head_dim=8,
                  mlp_dim=64)
DRAFT_CFG = dict(vocab_size=32, num_layers=1, num_heads=2, head_dim=8,
                 mlp_dim=32)
# name -> (config, the PRNGKey seed the JAX test draws it from)
DRAWS = {"target": (TARGET_CFG, 0), "draft": (DRAFT_CFG, 0),
         "random": (DRAFT_CFG, 123)}


def jax_inits() -> dict:
    """``{"<name>/<port state-dict key>": f32 array}`` of the three
    draws, as the JAX trainer and test make them."""
    import jax
    import jax.numpy as jnp
    import optax

    from container_engine_accelerators_tpu.models.lm_train import (
        create_lm_train_state,
    )
    from container_engine_accelerators_tpu.models.transformer import (
        transformer_lm,
    )
    from container_engine_accelerators_tpu_torch.models.convert import (
        from_flax_params,
    )

    out = {}
    for name, (cfg, seed) in DRAWS.items():
        state = create_lm_train_state(
            transformer_lm(**cfg), jax.random.PRNGKey(seed),
            jnp.zeros((1, 8), jnp.int32),
            tx=optax.adamw(3e-4, weight_decay=0.1))
        for key, value in from_flax_params(state.params).items():
            out[f"{name}/{key}"] = value.numpy()
    return out


def load(name: str) -> dict:
    """One draw as a port state dict (CPU tensors)."""
    import torch

    with np.load(PATH) as f:
        return {k.split("/", 1)[1]: torch.from_numpy(f[k])
                for k in f.files if k.startswith(f"{name}/")}


if __name__ == "__main__":
    os.makedirs(os.path.dirname(PATH), exist_ok=True)
    np.savez(PATH, **jax_inits())
    print(PATH)
