"""container_engine_accelerators_tpu_torch — the PyTorch / CUDA port of the
workload layer, for NVIDIA H100s.

It sits beside ``container_engine_accelerators_tpu`` (the JAX package,
which stays the reference) and mirrors its module names.  It imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package.  Entry
points run on the card unless the caller passes ``device="cpu"``
(``utils/device.py``).

Ported so far: per-request LM serving in decode mode —
``cmd/serve_lm.py`` -> ``models/generate.py`` -> ``models/transformer.py``
-> ``ops/flash_decode.py`` — and single-GPU LM training —
``cmd/train_lm.py`` -> ``models/lm_train.py`` -> ``models/transformer.py``
in train mode -> ``ops/flash_attention.py``.  Their kernels are
hand-written CUDA in ``ops/csrc/``, built together by ``ops/build.py``.
"""
