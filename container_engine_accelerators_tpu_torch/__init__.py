"""container_engine_accelerators_tpu_torch — the PyTorch / CUDA port of the
stack, for NVIDIA H100s.

It sits beside ``container_engine_accelerators_tpu`` (the JAX package,
which stays the reference) and mirrors its module names.  It imports
``torch`` and numpy, never ``jax`` and nothing of the JAX package; the
node layer and ``obs/`` import no torch either.  Entry points run on the
card unless the caller passes ``device="cpu"`` (``utils/device.py``).

Ported so far:

- LM serving, per request or continuously batched, with int8 weights,
  chunked prefill, the prefix cache and speculative decoding
  (``cmd/serve_lm.py`` -> ``models/generate.py`` / ``models/batching.py``
  -> ``models/transformer.py`` -> ``ops/flash_decode.py``), and LM
  training that checkpoints, resumes and profiles itself
  (``cmd/train_lm.py`` -> ``models/lm_train.py`` ->
  ``ops/flash_attention.py``; ``cmd/trace_summary.py``), both also as
  the Switch MoE-LM (``ops/moe.py``);
- the image models, trained and served on cuDNN
  (``cmd/train_resnet.py``, ``cmd/serve_resnet.py``; ResNet and
  Inception-v3);
- the same trainers and the LM server across GPUs, one process a GPU:
  the (data, model) mesh of DTensor weights and the Megatron pairs
  (``parallel/mesh.py``), sequence parallelism (ring, ring-zigzag,
  Ulysses: ``parallel/seq.py``), the GPipe pipeline
  (``parallel/pipeline.py``), expert parallelism, the dry run
  (``entry.py``) and the NCCL collectives sweep (``collectives/``);
- the node layer for ``nvidia.com/gpu``: the device plugin daemon with
  its Xid health checker and metrics server on NVML
  (``cmd/gpu_device_plugin.py``, ``deviceplugin/``, ``health/``,
  ``metrics/``, ``gpulib/``), MIG and MPS, the maintenance watcher, the
  topology-aware scheduler and node labeler (``scheduler/``) and the NRI
  device injector (``nri/``);
- observability (``obs/``): spans, latency histograms, windowed rates,
  the flight recorder and the stack sampler, wired into the node daemon
  and served beside ``/metrics`` as ``/spans`` and ``/profile``, read by
  ``cmd/agent_{trace,top,prof,trend}.py``;
- the DCN transfer plane, host code that imports no torch: the node
  daemon ``fleet/xferd.py::PyXferd``, its client
  (``parallel/dcn_client.py``), the shm lanes and descriptor ring
  (``parallel/dcn_shm.py``), the pipelined lanes and their tuner
  (``parallel/dcn_pipeline.py``, ``parallel/dcn_tune.py``),
  ``parallel/dcn.py::exchange_shard``, ``cmd/dcn_bench.py``, and the
  lock-order race detector (``analysis/lockwatch.py``).

The kernels are hand-written CUDA in ``ops/csrc/``, built together by
``ops/build.py``.
"""

# Concurrency shim (analysis/lockwatch.py): with TPU_LOCKWATCH=1, patch
# the lock allocators before any submodule constructs its locks, so every
# module (and every subprocess, which inherits the env) is watched with
# no code changes.  Stdlib-only at import; a no-op otherwise.
import os as _os

if _os.environ.get("TPU_LOCKWATCH") == "1":
    from container_engine_accelerators_tpu_torch.analysis import (
        lockwatch as _lockwatch,
    )

    _lockwatch.install()
