"""Build of the port's hand-written CUDA kernels.

Every kernel source under ``csrc/`` — flash decode (two ``.cu``: bf16
and f32 instantiations of one template) and flash attention (two
``.cu``: the CUDA-core kernels and the tensor-core ones), each
header-free beside a small ``*_op.cpp`` that registers the ops with
``TORCH_LIBRARY`` — goes into ONE library, compiled for
``sm_90a`` by one ``torch.utils.cpp_extension.load`` call (ninja runs
one compiler per source, all at once) at first use into
``.torch_ext_build/`` beside the package.  The ops then live under
``torch.ops.cea_tpu_torch``.  Any build or load failure raises: the
callers have no fallback.
"""

import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("flash_decode.cu", "flash_decode_f32.cu", "flash_decode_op.cpp",
           "flash_attention.cu", "flash_attention_sm90.cu",
           "flash_attention_op.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / ".torch_ext_build"

_ops = None
_lock = threading.Lock()


def load_ops():
    """Compile and load every kernel once per process (``load`` itself
    skips the compile when the sources are unchanged since the last build
    in ``BUILD_DIR``) and return ``torch.ops.cea_tpu_torch``."""
    global _ops
    if _ops is not None:
        return _ops
    with _lock:
        if _ops is None:
            from torch.utils import cpp_extension

            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cpp_extension.load(
                name="cea_tpu_torch_kernels",
                sources=[str(_CSRC / s) for s in SOURCES],
                extra_cflags=["-O3"],
                extra_cuda_cflags=["-O3", "-gencode=arch=compute_90a,code=sm_90a"],
                build_directory=str(BUILD_DIR), is_python_module=False)
            _ops = torch.ops.cea_tpu_torch
    return _ops
