"""Device kernels told apart by the names the trace gives them on the
card: the port's own (``ops/csrc``) and cuBLAS's f32 GEMMs."""

# cuBLAS's f32 GEMMs on CUDA cores (TF32 is off): SIMT sgemm kernels.
F32_GEMM_MARKS = ("sgemm", "f32f32_f32f32", "ffma")
FLASH_KINDS = {"fwd": "fa_fwd", "dq": "fa_bwd_dq", "dkv": "fa_bwd_dkv"}


def is_f32_gemm(name: str) -> bool:
    n = name.lower()
    return any(m in n for m in F32_GEMM_MARKS)


def flash_attention(kind):
    """A matcher of one flash-attention kernel kind, or (``None``) of
    every kernel the flash-attention ops launch (the delta pre-pass
    included)."""
    if kind is None:
        return lambda name: "fa_fwd" in name or "fa_bwd" in name
    mark = FLASH_KINDS[kind]
    return lambda name: mark in name


def is_flash_decode(name: str) -> bool:
    return "flash_decode_kernel" in name
