// PyTorch binding of the LM head's gradient split: registers
// torch.ops.cea_tpu_torch.lm_head_split(g, out) for CUDA tensors.  It
// checks what the kernel takes (g [rows, V] f32, out [rows, 3V] bf16, both
// contiguous on one CUDA device), launches on PyTorch's current stream
// into the caller's buffer, and raises if the launch failed.  The caller
// is ops/lm_head.py.
//
// Only the few headers below, not torch/extension.h, so the host compiler
// builds this file while nvcc builds the kernel.

#include <ATen/core/Tensor.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

cudaError_t lm_head_split_launch(const float* g, void* out, int64_t rows, int64_t V,
                                 cudaStream_t stream);

namespace {

// Numbers go into TORCH_CHECK messages as strings (see flash_decode_op.cpp).
using std::to_string;

void lm_head_split(const at::Tensor& g, const at::Tensor& out) {
  TORCH_CHECK_VALUE(g.dim() == 2, "lm_head_split: g must be [rows, V]");
  const int64_t rows = g.size(0), V = g.size(1);
  TORCH_CHECK_TYPE(g.scalar_type() == at::kFloat, "lm_head_split: g must be float32");
  TORCH_CHECK_TYPE(out.scalar_type() == at::kBFloat16, "lm_head_split: out must be bfloat16");
  TORCH_CHECK_VALUE(out.dim() == 2 && out.size(0) == rows && out.size(1) == 3 * V,
                    "lm_head_split: out must be [rows, 3V] = [", to_string(rows), ", ",
                    to_string(3 * V), "]");
  TORCH_CHECK(g.is_cuda() && out.device() == g.device(),
              "lm_head_split: g and out must be on one CUDA device");
  TORCH_CHECK(g.is_contiguous() && out.is_contiguous(),
              "lm_head_split: g and out must be contiguous");
  const c10::cuda::CUDAGuard guard(g.device());
  const cudaError_t err =
      lm_head_split_launch(g.data_ptr<float>(), out.data_ptr(), rows, V,
                           c10::cuda::getCurrentCUDAStream(g.get_device()).stream());
  TORCH_CHECK(err == cudaSuccess, "lm_head_split kernel launch failed: ",
              cudaGetErrorString(err), " (cudaError ", to_string((int)err), ")");
}

}  // namespace

// flash_decode_op.cpp holds the namespace's TORCH_LIBRARY block; this file
// adds to it.
TORCH_LIBRARY_FRAGMENT(cea_tpu_torch, m) {
  m.def("lm_head_split(Tensor g, Tensor(a!) out) -> ()");
}

TORCH_LIBRARY_IMPL(cea_tpu_torch, CUDA, m) { m.impl("lm_head_split", &lm_head_split); }
