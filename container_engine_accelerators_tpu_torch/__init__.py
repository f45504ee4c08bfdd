"""container_engine_accelerators_tpu_torch — the PyTorch / CUDA port of the
workload layer, for NVIDIA H100s.

It sits beside ``container_engine_accelerators_tpu`` (the JAX package,
which stays the reference) and mirrors its module names.  It imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package.  Entry
points run on the card unless the caller passes ``device="cpu"``
(``utils/device.py``).

Ported so far: LM serving in decode mode, per request or continuously
batched — ``cmd/serve_lm.py`` -> ``models/generate.py`` /
``models/batching.py`` -> ``models/transformer.py`` ->
``ops/flash_decode.py`` — and single-GPU LM training that checkpoints,
resumes and profiles itself — ``cmd/train_lm.py`` ->
``models/lm_train.py`` (``models/checkpoint.py``) ->
``models/transformer.py`` in train mode -> ``ops/flash_attention.py``,
with ``cmd/trace_summary.py`` to read its traces — and the image models,
trained and served on cuDNN — ``cmd/train_resnet.py`` ->
``models/train.py`` -> ``models/resnet.py`` / ``models/inception.py``,
and ``cmd/serve_resnet.py`` — and the same trainers and the LM server
across GPUs, one process a GPU over a (data, model) mesh of DTensor
weights (``parallel/``).  The kernels are hand-written CUDA in
``ops/csrc/``, built together by ``ops/build.py``.
"""
