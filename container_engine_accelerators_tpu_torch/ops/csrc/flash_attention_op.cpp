// PyTorch binding of the flash-attention kernels: registers
// torch.ops.cea_tpu_torch.flash_attention_fwd, _bwd_dq and _bwd_dkv for
// CUDA tensors.  Each op checks what the kernels take, allocates its
// outputs (and the backward's delta) on the input's device, launches on
// PyTorch's current stream, and raises if a launch failed.  The autograd
// wrapper is ops/flash_attention.py.
//
// Routing: bf16 forward (D 64/128/256) and bf16 dQ and dK/dV at D 64/128
// go to the tensor-core kernels of flash_attention_sm90.cu; f32, and bf16
// dQ and dK/dV at D 256, go to flash_attention.cu's CUDA-core kernels.  A
// call never falls back from one to the other.
//
// Delta once per backward: on the tensor-core route the dQ op runs the
// delta pre-pass and returns delta beside dQ, and the dK/dV op takes it
// (its optional last argument) instead of running the pre-pass again.  On
// the CUDA-core route each kernel computes delta itself: the dQ op returns
// None for it and the dK/dV op ignores a given one.
//
// Only the few headers below, not torch/extension.h, so the host compiler
// builds this file while nvcc builds the kernels.

#include <ATen/core/Tensor.h>
#include <ATen/ops/empty.h>
#include <ATen/ops/empty_like.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <torch/library.h>

#include <cuda_runtime.h>

#include <cstdint>
#include <optional>
#include <string>
#include <tuple>

cudaError_t flash_attention_sm90_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                            float* lse, int B, int seq, int heads, int D,
                                            float scale, bool causal, cudaStream_t stream);
cudaError_t flash_attention_sm90_bwd_delta_launch(const void* o, const void* dout, float* delta,
                                                  int B, int seq, int heads, int D,
                                                  cudaStream_t stream);
cudaError_t flash_attention_sm90_bwd_dq_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const float* lse,
                                               const float* delta, void* dq, int B, int seq,
                                               int heads, int D, float scale, bool causal,
                                               cudaStream_t stream);
cudaError_t flash_attention_sm90_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                                const void* dout, const float* lse,
                                                const float* delta, void* dk, void* dv, int B,
                                                int seq, int heads, int D, float scale,
                                                bool causal, cudaStream_t stream);
bool flash_attention_sm90_bwd_takes(int D);
cudaError_t flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int seq, int heads, int D, float scale,
                                       bool causal, cudaStream_t stream);
cudaError_t flash_attention_bwd_dq_launch(bool bf16, const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          void* dq, int B, int seq, int heads, int D, float scale,
                                          bool causal, cudaStream_t stream);
cudaError_t flash_attention_bwd_dkv_launch(bool bf16, const void* q, const void* k,
                                           const void* v, const void* o, const void* dout,
                                           const float* lse, void* dk, void* dv, int B, int seq,
                                           int heads, int D, float scale, bool causal,
                                           cudaStream_t stream);

namespace {

// Numbers go into TORCH_CHECK messages as strings: on the card's PyTorch
// build, streaming an integer into a message from an extension crashed the
// process (see flash_decode_op.cpp).
using std::to_string;

std::string shape(const at::Tensor& t) {
  std::string s = "[";
  for (int64_t i = 0; i < t.dim(); ++i) s += (i ? ", " : "") + to_string(t.size(i));
  return s + "]";
}

// q and every other [B, T, H, D] operand: same shape and dtype (f32 or
// bf16), same CUDA device, contiguous, 16-byte aligned; T a multiple of
// 128 (so of every tile), D in {64, 128, 256}.
void check_bthd(const char* op, const at::Tensor& q, std::initializer_list<const at::Tensor*> rest) {
  const std::string name(op);
  TORCH_CHECK_VALUE(q.dim() == 4, name, ": q must be [B, T, H, D], got ", shape(q));
  const int64_t T = q.size(1), D = q.size(3);
  TORCH_CHECK_VALUE(T >= 128 && T % 128 == 0, name, ": T=", to_string(T),
                    " must be a positive multiple of 128");
  TORCH_CHECK_VALUE(D == 64 || D == 128 || D == 256, name, ": head dim ", to_string(D),
                    " not in {64, 128, 256}");
  TORCH_CHECK_VALUE(q.size(0) * q.size(2) <= 65535, name, ": B*H=",
                    to_string(q.size(0) * q.size(2)), " > 65535");
  TORCH_CHECK_TYPE(q.scalar_type() == at::kFloat || q.scalar_type() == at::kBFloat16, name,
                   ": dtype must be float32 or bfloat16, got ", q.scalar_type());
  TORCH_CHECK(q.is_cuda(), name, ": q must be a CUDA tensor, got ", q.device());
  auto placed = [&](const at::Tensor& t) {
    TORCH_CHECK(t.device() == q.device(), name, ": every input must be on q's device ",
                q.device(), ", got ", t.device());
    TORCH_CHECK(t.is_contiguous() && reinterpret_cast<uintptr_t>(t.data_ptr()) % 16 == 0, name,
                ": inputs must be contiguous and 16-byte aligned");
  };
  placed(q);
  for (const at::Tensor* t : rest) {
    TORCH_CHECK_VALUE(t->sizes() == q.sizes(), name, ": shape ", shape(*t), " != q's ",
                      shape(q));
    TORCH_CHECK_TYPE(t->scalar_type() == q.scalar_type(), name, ": dtype ", t->scalar_type(),
                     " != q's ", q.scalar_type());
    placed(*t);
  }
}

// lse and delta: [B*H, T] f32, contiguous on q's device.
void check_rows(const char* op, const char* what, const at::Tensor& q, const at::Tensor& t) {
  const std::string name = std::string(op) + ": " + what;
  TORCH_CHECK_VALUE(t.dim() == 2 && t.size(0) == q.size(0) * q.size(2) && t.size(1) == q.size(1),
                    name, " must be [B*H, T], got ", shape(t));
  TORCH_CHECK_TYPE(t.scalar_type() == at::kFloat, name, " must be float32");
  TORCH_CHECK(t.is_cuda() && t.device() == q.device() && t.is_contiguous(), name,
              " must be contiguous on q's CUDA device");
}

void check_launch(const char* op, cudaError_t err) {
  TORCH_CHECK(err == cudaSuccess, std::string(op), " kernel launch failed: ",
              cudaGetErrorString(err), " (cudaError ", to_string((int)err), ")");
}

cudaStream_t stream_of(const at::Tensor& q) {
  return c10::cuda::getCurrentCUDAStream(q.get_device()).stream();
}

std::tuple<at::Tensor, at::Tensor> fwd(const at::Tensor& q, const at::Tensor& k,
                                       const at::Tensor& v, bool causal, double scale) {
  check_bthd("flash_attention_fwd", q, {&k, &v});
  const c10::cuda::CUDAGuard guard(q.device());
  const int64_t B = q.size(0), T = q.size(1), H = q.size(2), D = q.size(3);
  at::Tensor o = at::empty_like(q);
  at::Tensor lse = at::empty({B * H, T}, q.options().dtype(at::kFloat));
  const bool bf16 = q.scalar_type() == at::kBFloat16;
  check_launch("flash_attention_fwd",
               bf16 ? flash_attention_sm90_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                      o.data_ptr(), lse.data_ptr<float>(), (int)B,
                                                      (int)T, (int)H, (int)D, (float)scale,
                                                      causal, stream_of(q))
                    : flash_attention_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                 o.data_ptr(), lse.data_ptr<float>(), (int)B,
                                                 (int)T, (int)H, (int)D, (float)scale, causal,
                                                 stream_of(q)));
  return {o, lse};
}

// (dq, delta): delta = rowsum(dO * O) on the tensor-core route, for the
// dK/dV op; None on the CUDA-core route.
std::tuple<at::Tensor, std::optional<at::Tensor>> bwd_dq(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v, const at::Tensor& o,
    const at::Tensor& dout, const at::Tensor& lse, bool causal, double scale) {
  check_bthd("flash_attention_bwd_dq", q, {&k, &v, &o, &dout});
  check_rows("flash_attention_bwd_dq", "lse", q, lse);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor dq = at::empty_like(q);
  const int B = (int)q.size(0), T = (int)q.size(1), H = (int)q.size(2), D = (int)q.size(3);
  const bool bf16 = q.scalar_type() == at::kBFloat16;
  if (bf16 && flash_attention_sm90_bwd_takes(D)) {
    at::Tensor delta = at::empty_like(lse);
    check_launch("flash_attention_bwd_dq",
                 flash_attention_sm90_bwd_delta_launch(o.data_ptr(), dout.data_ptr(),
                                                       delta.data_ptr<float>(), B, T, H, D,
                                                       stream_of(q)));
    check_launch("flash_attention_bwd_dq",
                 flash_attention_sm90_bwd_dq_launch(
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                     lse.data_ptr<float>(), delta.data_ptr<float>(), dq.data_ptr(), B, T, H, D,
                     (float)scale, causal, stream_of(q)));
    return {dq, delta};
  }
  check_launch("flash_attention_bwd_dq",
               flash_attention_bwd_dq_launch(bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                             o.data_ptr(), dout.data_ptr(),
                                             lse.data_ptr<float>(), dq.data_ptr(), B, T, H, D,
                                             (float)scale, causal, stream_of(q)));
  return {dq, std::nullopt};
}

std::tuple<at::Tensor, at::Tensor> bwd_dkv(const at::Tensor& q, const at::Tensor& k,
                                           const at::Tensor& v, const at::Tensor& o,
                                           const at::Tensor& dout, const at::Tensor& lse,
                                           bool causal, double scale,
                                           const std::optional<at::Tensor>& delta) {
  check_bthd("flash_attention_bwd_dkv", q, {&k, &v, &o, &dout});
  check_rows("flash_attention_bwd_dkv", "lse", q, lse);
  const c10::cuda::CUDAGuard guard(q.device());
  at::Tensor dk = at::empty_like(k);
  at::Tensor dv = at::empty_like(v);
  const int B = (int)q.size(0), T = (int)q.size(1), H = (int)q.size(2), D = (int)q.size(3);
  const bool bf16 = q.scalar_type() == at::kBFloat16;
  if (bf16 && flash_attention_sm90_bwd_takes(D)) {
    at::Tensor d;
    if (delta.has_value()) {
      check_rows("flash_attention_bwd_dkv", "delta", q, *delta);
      d = *delta;
    } else {  // not given: the pre-pass fills it
      d = at::empty_like(lse);
      check_launch("flash_attention_bwd_dkv",
                   flash_attention_sm90_bwd_delta_launch(o.data_ptr(), dout.data_ptr(),
                                                         d.data_ptr<float>(), B, T, H, D,
                                                         stream_of(q)));
    }
    check_launch("flash_attention_bwd_dkv",
                 flash_attention_sm90_bwd_dkv_launch(
                     q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                     lse.data_ptr<float>(), d.data_ptr<float>(), dk.data_ptr(), dv.data_ptr(), B,
                     T, H, D, (float)scale, causal, stream_of(q)));
  } else {
    check_launch("flash_attention_bwd_dkv",
                 flash_attention_bwd_dkv_launch(bf16, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                                o.data_ptr(), dout.data_ptr(),
                                                lse.data_ptr<float>(), dk.data_ptr(),
                                                dv.data_ptr(), B, T, H, D, (float)scale, causal,
                                                stream_of(q)));
  }
  return {dk, dv};
}

}  // namespace

// flash_decode_op.cpp holds the namespace's TORCH_LIBRARY block; this file
// adds to it.
TORCH_LIBRARY_FRAGMENT(cea_tpu_torch, m) {
  m.def("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, float scale) "
        "-> (Tensor, Tensor)");
  m.def("flash_attention_bwd_dq(Tensor q, Tensor k, Tensor v, Tensor o, Tensor dout, "
        "Tensor lse, bool causal, float scale) -> (Tensor, Tensor?)");
  m.def("flash_attention_bwd_dkv(Tensor q, Tensor k, Tensor v, Tensor o, Tensor dout, "
        "Tensor lse, bool causal, float scale, Tensor? delta=None) -> (Tensor, Tensor)");
}

TORCH_LIBRARY_IMPL(cea_tpu_torch, CUDA, m) {
  m.impl("flash_attention_fwd", &fwd);
  m.impl("flash_attention_bwd_dq", &bwd_dq);
  m.impl("flash_attention_bwd_dkv", &bwd_dkv);
}
