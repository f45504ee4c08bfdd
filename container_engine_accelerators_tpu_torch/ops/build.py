"""Build of the port's hand-written CUDA kernels.

Every kernel source under ``csrc/`` — flash decode (two ``.cu``: bf16
and f32 instantiations of one template), flash attention (two ``.cu``:
the CUDA-core kernels and the tensor-core ones) and the LM head's
gradient split (one ``.cu``), each header-free beside a small
``*_op.cpp`` that registers the ops with ``TORCH_LIBRARY`` — goes into
ONE library, compiled for
``sm_90a`` by one ``torch.utils.cpp_extension.load`` call (ninja runs
one compiler per source, all at once) at first use into
``.torch_ext_build/`` beside the package.  The ops then live under
``torch.ops.cea_tpu_torch``.  Any build or load failure raises: the
callers have no fallback.
"""

import threading
import time
from pathlib import Path

import torch

from container_engine_accelerators_tpu_torch.utils.profile import span

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_decode.cu", "flash_decode_f32.cu", "flash_decode_op.cpp",
           "flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_op.cpp", "lm_head_split.cu", "lm_head_op.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"

_ops = None
_lock = threading.Lock()
# Seconds the process's first load took, build included (None before it):
# set-up is not profiled, so this is read without a profiler.
LOAD_S = None


def load_ops():
    """Compile and load every kernel once per process (``load`` itself
    skips the compile when the sources are unchanged since the last build
    in ``BUILD_DIR``) and return ``torch.ops.cea_tpu_torch``."""
    global _ops, LOAD_S
    if _ops is not None:
        return _ops
    with _lock:
        if _ops is None:
            from torch.utils import cpp_extension

            t0 = time.perf_counter()
            with span("lm.ops.load"):
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                cpp_extension.load(
                    name="cea_tpu_torch_kernels",
                    sources=[str(_CSRC / s) for s in SOURCES],
                    extra_cflags=["-O3"],
                    extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
                    build_directory=str(BUILD_DIR), is_python_module=False)
            LOAD_S = time.perf_counter() - t0
            _ops = torch.ops.cea_tpu_torch
    return _ops
