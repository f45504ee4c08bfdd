// The exact three-way split of the tied LM head's f32 logit gradient into
// bf16 parts (sm_90a), so that the head's backward GEMMs run on the tensor
// cores with exact products and f32 sums.
//
// Replaces no TPU kernel: the JAX package leaves the head to XLA, whose
// MXU takes the f32 cotangent as it is.  On this card cuBLAS multiplies an
// f32 operand on the CUDA cores (67 TFLOP/s); split into bf16 parts it
// runs at the tensor cores' rate.  ops/lm_head.py is the caller.
//
// What it computes: for each f32 value g of a row block [rows, V] of the
// gradient, three bf16 values by truncation of the bit pattern,
//
//   hi  = the top 16 bits of g,
//   mid = the top 16 bits of r1 = g - hi   (exact in f32),
//   lo  = the top 16 bits of r2 = r1 - mid (exact in f32),
//
// so that hi + mid + lo == g bit for bit wherever g's significant bits lie
// at or above 2^-133, bf16's finest step (every |g| >= 2^-110, and zero):
// g's 24-bit significand falls into three 8-bit pieces.  Truncation, not
// rounding, keeps every part finite next to f32's largest values, where
// rounding hi to the nearest bf16 would give infinity.  A non-finite g
// goes whole into hi (NaN as bf16's quiet NaN), with mid = lo = 0.  The
// three parts are written side by side, out[row] = [hi | mid | lo] of
// width 3V: against E stacked three times ([3V, D]) the block gives
// dX = G.E in one GEMM, and viewed as [3 rows, V] (rows interleaved hi_i,
// mid_i, lo_i) against X's rows repeated three times it gives E's share
// G^T.X in another.
//
// Bound on this card: bytes.  Each value is read once (4 bytes) and
// written as 6, with no arithmetic to speak of: at the 1.7B's head
// (49,152 rows of 49,152) that is 24 GB a step, ~7 ms at 3.35 TB/s.  One
// CTA walks whole rows (no division per element), its threads on
// neighbouring float4 columns: 16-byte loads and 8-byte stores of each
// part; rows whose width or addresses are not multiples of four values
// take a scalar loop.
//
// Interface: this file includes no PyTorch header.  lm_head_op.cpp
// registers the op (TORCH_LIBRARY_FRAGMENT), checks what it takes and
// calls lm_head_split_launch, which returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

// The three bf16 bit patterns of one f32 value.
__device__ __forceinline__ void split_one(float g, uint16_t& hi, uint16_t& mid, uint16_t& lo) {
  const uint32_t gb = __float_as_uint(g);
  if ((gb & 0x7F800000u) == 0x7F800000u) {  // inf or NaN
    hi = (gb & 0x007FFFFFu) ? uint16_t(0x7FC0) : uint16_t(gb >> 16);
    mid = lo = 0;
    return;
  }
  const float r1 = g - __uint_as_float(gb & 0xFFFF0000u);
  const uint32_t r1b = __float_as_uint(r1);
  const float r2 = r1 - __uint_as_float(r1b & 0xFFFF0000u);
  hi = uint16_t(gb >> 16);
  mid = uint16_t(r1b >> 16);
  lo = uint16_t(__float_as_uint(r2) >> 16);
}

// Four values at once: 16-byte load, three 8-byte stores.
__global__ void __launch_bounds__(kThreads)
    split_vec4_kernel(const float* __restrict__ g, uint16_t* __restrict__ out, int64_t rows,
                      int64_t V) {
  const int64_t groups = V / 4;
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const float4* src = reinterpret_cast<const float4*>(g + row * V);
    uint16_t* dst = out + row * 3 * V;
    for (int64_t c = threadIdx.x; c < groups; c += blockDim.x) {
      const float4 v = src[c];
      uint16_t h[4], m[4], l[4];
      split_one(v.x, h[0], m[0], l[0]);
      split_one(v.y, h[1], m[1], l[1]);
      split_one(v.z, h[2], m[2], l[2]);
      split_one(v.w, h[3], m[3], l[3]);
      uint2 hv, mv, lv;
      hv.x = h[0] | (uint32_t(h[1]) << 16);
      hv.y = h[2] | (uint32_t(h[3]) << 16);
      mv.x = m[0] | (uint32_t(m[1]) << 16);
      mv.y = m[2] | (uint32_t(m[3]) << 16);
      lv.x = l[0] | (uint32_t(l[1]) << 16);
      lv.y = l[2] | (uint32_t(l[3]) << 16);
      reinterpret_cast<uint2*>(dst)[c] = hv;
      reinterpret_cast<uint2*>(dst + V)[c] = mv;
      reinterpret_cast<uint2*>(dst + 2 * V)[c] = lv;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    split_scalar_kernel(const float* __restrict__ g, uint16_t* __restrict__ out, int64_t rows,
                        int64_t V) {
  for (int64_t row = blockIdx.x; row < rows; row += gridDim.x) {
    const float* src = g + row * V;
    uint16_t* dst = out + row * 3 * V;
    for (int64_t c = threadIdx.x; c < V; c += blockDim.x) {
      uint16_t h, m, l;
      split_one(src[c], h, m, l);
      dst[c] = h;
      dst[V + c] = m;
      dst[2 * V + c] = l;
    }
  }
}

}  // namespace

// g: [rows, V] f32, out: [rows, 3V] bf16, both contiguous on one device.
cudaError_t lm_head_split_launch(const float* g, void* out, int64_t rows, int64_t V,
                                 cudaStream_t stream) {
  if (rows <= 0 || V <= 0) return rows == 0 ? cudaSuccess : cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t most = int64_t(sms) * kBlocksPerSm;
  const int blocks = int(rows < most ? rows : most);
  uint16_t* o = static_cast<uint16_t*>(out);
  const bool vec4 = V % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (vec4)
    split_vec4_kernel<<<blocks, kThreads, 0, stream>>>(g, o, rows, V);
  else
    split_scalar_kernel<<<blocks, kThreads, 0, stream>>>(g, o, rows, V);
  return cudaGetLastError();
}
