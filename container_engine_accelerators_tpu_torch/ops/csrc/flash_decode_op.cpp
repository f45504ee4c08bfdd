// PyTorch binding of the flash-decode kernel (flash_decode.cu): registers
// torch.ops.cea_tpu_torch.flash_decode for CUDA tensors.  It checks what the
// kernel takes, allocates the output on the input's device, launches on
// PyTorch's current stream, and raises if the launch failed.  The kernel's
// launcher makes the plan (make_plan in flash_decode_plan.h);
// flash_decode_plan reports it for given shapes on the current device.
//
// Only the few headers below, not torch/extension.h, so the host compiler
// builds this file while nvcc builds the kernel.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cuda_runtime.h>

#include <cstdint>
#include <string>
#include <vector>

cudaError_t flash_decode_launch(bool bf16, const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int B, int H, int KVH, int L, int D,
                                float scale, cudaStream_t stream);
int flash_decode_plan(bool bf16, int B, int H, int KVH, int L, int D, const void* k,
                      const void* v, int* rows);

namespace {

constexpr int64_t kMaxD = 256;

// Numbers go into TORCH_CHECK messages as strings: on the card's PyTorch
// build, streaming an integer (or sizes()) into a message from this
// extension crashed the process, while strings, devices and dtypes did not.
using std::to_string;

// "[2, 64, 2, 16]"
std::string shape(const at::Tensor& t) {
  std::string s = "[";
  for (int64_t i = 0; i < t.dim(); ++i) s += (i ? ", " : "") + to_string(t.size(i));
  return s + "]";
}

at::Tensor flash_decode_cuda(const at::Tensor& q, const at::Tensor& k_cache,
                             const at::Tensor& v_cache, const at::Tensor& lengths, double scale) {
  TORCH_CHECK_VALUE(q.dim() == 3 && k_cache.dim() == 4,
                    "flash_decode: q must be [B, H, D] and the caches [B, L, KVH, D]");
  const int64_t B = q.size(0), H = q.size(1), D = q.size(2);
  const int64_t L = k_cache.size(1), KVH = k_cache.size(2);
  TORCH_CHECK_VALUE(k_cache.sizes() == v_cache.sizes() && k_cache.size(0) == B &&
                        k_cache.size(3) == D,
                    "flash_decode: cache shapes ", shape(k_cache), " / ", shape(v_cache),
                    " do not match q ", shape(q));
  TORCH_CHECK_VALUE(KVH > 0 && H % KVH == 0, "flash_decode: H=", to_string(H),
                    " not divisible by KVH=", to_string(KVH));
  TORCH_CHECK_VALUE(D <= kMaxD, "flash_decode: head dim ", to_string(D), " > ",
                    to_string(kMaxD));
  TORCH_CHECK_VALUE(lengths.dim() == 1 && lengths.size(0) == B,
                    "flash_decode: lengths must be [B]");
  TORCH_CHECK_TYPE(lengths.scalar_type() == at::kInt, "flash_decode: lengths must be int32");
  TORCH_CHECK_TYPE(
      (q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16) &&
          k_cache.scalar_type() == q.scalar_type() && v_cache.scalar_type() == q.scalar_type(),
      "flash_decode: q/k/v must share float32 or bfloat16, got ", q.scalar_type(), "/",
      k_cache.scalar_type(), "/", v_cache.scalar_type());
  for (const at::Tensor* t : {&q, &k_cache, &v_cache, &lengths}) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device(),
                "flash_decode: every input must be on q's CUDA device, got ", t->device(),
                " and ", q.device());
    TORCH_CHECK(t->is_contiguous(), "flash_decode: inputs must be contiguous");
  }

  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor out = at::empty_like(q);
  const cudaError_t err = flash_decode_launch(
      q.scalar_type() == at::kBFloat16, q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
      lengths.data_ptr<int>(), out.data_ptr(), (int)B, (int)H, (int)KVH, (int)L, (int)D,
      (float)scale, c10::cuda::getCurrentCUDAStream(q.get_device()).stream());
  TORCH_CHECK(err == cudaSuccess, "flash_decode kernel launch failed: ",
              cudaGetErrorString(err), " (cudaError ", to_string((int)err), ")");
  return out;
}

// (rows a CTA, CTAs a row block) that flash_decode would launch with on
// these tensors; (0, 0) for sizes the kernel does not take.
std::vector<int64_t> flash_decode_plan_cuda(const at::Tensor& q, const at::Tensor& k_cache,
                                            const at::Tensor& v_cache) {
  TORCH_CHECK_VALUE(q.dim() == 3 && k_cache.dim() == 4,
                    "flash_decode_plan: q must be [B, H, D] and the caches [B, L, KVH, D]");
  const c10::cuda::CUDAGuard guard(q.device());
  int rows = 0;
  const int splits = flash_decode_plan(
      q.scalar_type() == at::kBFloat16, (int)q.size(0), (int)q.size(1), (int)k_cache.size(2),
      (int)k_cache.size(1), (int)q.size(2), k_cache.data_ptr(), v_cache.data_ptr(), &rows);
  return {rows, splits};
}

}  // namespace

TORCH_LIBRARY(cea_tpu_torch, m) {
  m.def(
      "flash_decode(Tensor q, Tensor k_cache, Tensor v_cache, Tensor lengths, float scale) "
      "-> Tensor");
  m.def("flash_decode_plan(Tensor q, Tensor k_cache, Tensor v_cache) -> int[]");
}

TORCH_LIBRARY_IMPL(cea_tpu_torch, CUDA, m) {
  m.impl("flash_decode", &flash_decode_cuda);
  m.impl("flash_decode_plan", &flash_decode_plan_cuda);
}
