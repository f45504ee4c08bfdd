"""f32_gemm_ms: device milliseconds a training step spends in f32 GEMM
kernels (in train mode only the tied head ``lm_head`` multiplies in
f32), from the traced steps.  Kernels are told apart by the names
cuBLAS gives them on the card."""

from harness import kernels


def read(run):
    t = run.trace
    if t is None or run.mix["kind"] != "train":
        return None
    if not t.launches(kernels.is_f32_gemm):
        return None
    return 1e3 * t.time_s(kernels.is_f32_gemm) / run.mix["trace_steps"]
