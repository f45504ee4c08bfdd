// Flash attention on the CUDA cores (sm_90a): the forward and the two
// backward kernels of causal / non-causal attention on [B, T, H, D], for
// the calls flash_attention_sm90.cu's tensor-core kernels do not take:
// every f32 call (f32 stays true f32 here, where the tensor cores would
// round it to TF32), and bf16 dQ and dK/dV at D = 256.
//
// Replaces the Pallas TPU kernels of container_engine_accelerators_tpu/
// ops/flash_attention.py and computes what they compute:
//
//   forward (_fa_kernel):  s = (q . k) in f32 from input-dtype operands,
//     times `scale` (on the f32 scores; q is not pre-scaled); causal mode
//     masks with -1e30 inside the diagonal block and skips the blocks
//     above it; online softmax with m, l and acc in f32; p is cast to V's
//     dtype before P.V, which accumulates in f32; o = acc / l in the input
//     dtype, lse = m + log(l) in f32, stored [B*H, T].
//   dQ (_fa_bwd_dq_kernel):  delta = rowsum(dO * O) in f32 from dO and O
//     as stored; P = exp(s - lse); dS = P * (dP - delta) * scale with
//     dP = dO . V^T; dS cast to K's dtype before dQ = dS . K (f32
//     accumulation); the causal loop stops at the diagonal block.
//   dK/dV (_fa_bwd_dkv_kernel):  per K block, a loop over Q blocks from
//     the diagonal (causal) or 0; P cast to dO's dtype before
//     dV = P^T . dO, dS cast to Q's dtype before dK = dS^T . Q; delta is
//     recomputed for every Q block, as the TPU kernel does.
//
// Design.  The TPU kernels walk a sequential grid axis on one core; here
// one CTA owns one output tile and loops over the other axis itself:
// forward and dQ one CTA per (b*h, Q block) looping over K blocks, dK/dV
// one CTA per (b*h, K block) looping over Q blocks, so nothing crosses
// CTAs and nothing needs atomics.  Tiles are 64 x 64 (32 x 32 at
// D = 256, so that the f32 tiles fit in shared memory) and are staged in
// shared memory as f32 (bf16 converts exactly), rows padded to D + 1
// floats so the column reads below are free of bank conflicts.  256
// threads form a 16 x 16 grid; each thread owns the rows ty + 16 i and
// the columns tx + 16 j of every [rows, keys] and [rows, D] tile, so the
// running max, denominator and rescale of a row stay in the registers of
// the 16 threads that share it (a row reduction is four shuffles).  Every
// product is a true f32 FMA (no TF32, no tensor cores): the f32 path
// meets the JAX kernels' 2e-5 / 2e-4 tolerances, and the bf16 path has
// the TPU's arithmetic (exact bf16 products, f32 sums) in another order.
// Inputs are read in their [B, T, H, D] layout (row stride H*D), so the
// wrapper transposes nothing.
//
// Bound on this card: operations.  At the training shape (B=8, H=8,
// T=2048, D=64, causal) dQ does 52 GFLOP against 101 MB of inputs and
// outputs in bf16, above the H100's ~295 bf16 FLOP per byte ridge.  These
// kernels run their FLOPs on the CUDA cores in f32 from shared memory,
// far from the tensor-core peak; the bf16 calls of the main path run
// flash_attention_sm90.cu's tensor-core kernels instead.
//
// Interface: this file includes no PyTorch header, so nvcc builds it in
// seconds.  flash_attention_op.cpp registers the ops with PyTorch
// (TORCH_LIBRARY_FRAGMENT), checks device, dtype, shape, alignment and
// contiguity, allocates the outputs, and calls the *_launch functions
// below, which return cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;  // the TPU kernels' mask fill

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// x rounded to T and back: the kernels' casts before a product.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// Sum / max over the 16 lanes that share ty (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Rows per tile (Q and K alike) for a head dim.
template <int D> struct Tile {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128 or 256");
  static constexpr int kRows = D == 256 ? 32 : 64;
};

// Copy `rows` rows of D elements (row stride `stride` elements) into
// shared memory as f32, rows padded to D + 1.  16-byte loads: D is a
// multiple of 64 and the binding checks 16-byte alignment of the base.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src, size_t stride,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i - r * kPerRow) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * stride + c);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; ++u) dst[r * (D + 1) + c + u] = to_f32(e[u]);
  }
}

// Element offset of (b*h, t = 0, d = 0) in a [B, T, H, D] tensor.
__device__ __forceinline__ size_t head_base(int bh, int seq, int heads, int d) {
  return ((size_t)(bh / heads) * seq * heads + bh % heads) * d;
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              T* __restrict__ o, float* __restrict__ lse, int seq, int heads, float scale,
              int causal) {
  constexpr int LD = D + 1, LP = BK + 16;  // LP: the two rows of a warp 16 banks apart
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;             // [BQ][LD]
  float* k_s = q_s + BQ * LD;    // [BK][LD]
  float* v_s = k_s + BK * LD;    // [BK][LD]
  float* p_s = v_s + BK * LD;    // [BQ][LP], p in V's dtype
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = (size_t)heads * D;
  const size_t base = head_base(bh, seq, heads, D);

  load_tile<T, D>(q_s, q + base + q0 * rs, rs, BQ);
  float m[RQ], l[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }
  // Causal: stop at the block holding this Q tile's last row.
  const int nk = causal ? (q0 + BQ - 1) / BK + 1 : seq / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the previous block's readers of k_s, v_s, p_s are done
    load_tile<T, D>(k_s, k + base + k0 * rs, rs, BK);
    load_tile<T, D>(v_s, v + base + k0 * rs, rs, BK);
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < RK; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], b[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = q_s[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int c = 0; c < RK; ++c) b[c] = k_s[(tx + 16 * c) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RK; ++c) s[i][c] = fmaf(a[i], b[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        float x = scale * s[i][c];
        if (causal && k0 + tx + 16 * c > row) x = kNegInf;
        s[i][c] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        const float p = expf(s[i][c] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * LP + tx + 16 * c] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < RD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[RQ], b[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) p[i] = p_s[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) b[c] = v_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] = fmaf(p[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + 16 * i;
    T* out = o + base + row * rs;
#pragma unroll
    for (int c = 0; c < RD; ++c) out[tx + 16 * c] = from_f32<T>(acc[i][c] / l[i]);
    if (tx == 0) lse[(size_t)bh * seq + row] = m[i] + logf(l[i]);
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const T* __restrict__ o, const T* __restrict__ dout,
                 const float* __restrict__ lse, T* __restrict__ dq, int seq, int heads,
                 float scale, int causal) {
  constexpr int LD = D + 1, LP = BK + 16;
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;              // [BQ][LD]
  float* do_s = q_s + BQ * LD;    // [BQ][LD]
  float* k_s = do_s + BQ * LD;    // [BK][LD]
  float* v_s = k_s + BK * LD;     // [BK][LD]
  float* ds_s = v_s + BK * LD;    // [BQ][LP], dS in K's dtype
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = (size_t)heads * D;
  const size_t base = head_base(bh, seq, heads, D);

  load_tile<T, D>(q_s, q + base + q0 * rs, rs, BQ);
  load_tile<T, D>(do_s, dout + base + q0 * rs, rs, BQ);
  __syncthreads();
  float delta[RQ], row_lse[RQ], acc[RQ][RD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    const T* o_row = o + base + (q0 + r) * rs;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < RD; ++c) part += do_s[r * LD + tx + 16 * c] * to_f32(o_row[tx + 16 * c]);
    delta[i] = row_sum(part);
    row_lse[i] = lse[(size_t)bh * seq + q0 + r];
#pragma unroll
    for (int c = 0; c < RD; ++c) acc[i][c] = 0.f;
  }

  const int nk = causal ? (q0 + BQ - 1) / BK + 1 : seq / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK;
    __syncthreads();
    load_tile<T, D>(k_s, k + base + k0 * rs, rs, BK);
    load_tile<T, D>(v_s, v + base + k0 * rs, rs, BK);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int c = 0; c < RK; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ], g[RQ], kb[RK], vb[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        a[i] = q_s[(ty + 16 * i) * LD + d];
        g[i] = do_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        kb[c] = k_s[(tx + 16 * c) * LD + d];
        vb[c] = v_s[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RK; ++c) {
          s[i][c] = fmaf(a[i], kb[c], s[i][c]);
          dp[i][c] = fmaf(g[i], vb[c], dp[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        float x = scale * s[i][c];
        if (causal && k0 + tx + 16 * c > row) x = kNegInf;
        const float p = expf(x - row_lse[i]);  // 0 where masked
        ds_s[(ty + 16 * i) * LP + tx + 16 * c] = round_to<T>(p * (dp[i][c] - delta[i]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[RQ], b[RD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = ds_s[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < RD; ++c) b[c] = k_s[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < RD; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    T* out = dq + base + (q0 + ty + 16 * i) * rs;
#pragma unroll
    for (int c = 0; c < RD; ++c) out[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ o, const T* __restrict__ dout,
                  const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv,
                  int seq, int heads, float scale, int causal) {
  constexpr int LD = D + 1, LP = BQ + 16;
  constexpr int RQ = BQ / 16, RK = BK / 16, RD = D / 16;
  constexpr int kRowThreads = kThreads / BQ;  // threads per row of the delta pass
  static_assert(kThreads % BQ == 0 && kRowThreads <= 32, "delta pass layout");
  extern __shared__ float smem[];
  float* k_s = smem;               // [BK][LD]
  float* v_s = k_s + BK * LD;      // [BK][LD]
  float* q_s = v_s + BK * LD;      // [BQ][LD]
  float* do_s = q_s + BQ * LD;     // [BQ][LD]
  float* p_s = do_s + BQ * LD;     // [BK][LP], P^T in dO's dtype
  float* ds_s = p_s + BK * LP;     // [BK][LP], dS^T in Q's dtype
  float* lse_s = ds_s + BK * LP;   // [BQ]
  float* delta_s = lse_s + BQ;     // [BQ]
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t rs = (size_t)heads * D;
  const size_t base = head_base(bh, seq, heads, D);

  load_tile<T, D>(k_s, k + base + k0 * rs, rs, BK);
  load_tile<T, D>(v_s, v + base + k0 * rs, rs, BK);
  float dk_acc[RK][RD], dv_acc[RK][RD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < RD; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Causal: Q blocks above this K block's diagonal see none of its keys.
  for (int qi = causal ? k0 / BQ : 0; qi < seq / BQ; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();  // the previous block's readers are done
    load_tile<T, D>(q_s, q + base + q0 * rs, rs, BQ);
    load_tile<T, D>(do_s, dout + base + q0 * rs, rs, BQ);
    {
      // delta = rowsum(dO * O) in f32, kRowThreads threads per row.
      const int r = threadIdx.x / kRowThreads, part = threadIdx.x % kRowThreads;
      const T* o_row = o + base + (q0 + r) * rs;
      const T* do_row = dout + base + (q0 + r) * rs;
      float sum = 0.f;
      for (int d = part; d < D; d += kRowThreads) sum += to_f32(do_row[d]) * to_f32(o_row[d]);
#pragma unroll
      for (int w = kRowThreads / 2; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      if (part == 0) {
        delta_s[r] = sum;
        lse_s[r] = lse[(size_t)bh * seq + q0 + r];
      }
    }
    __syncthreads();

    // S^T and dP^T: rows are this block's keys, columns the Q block's rows.
    float st[RK][RQ], dpt[RK][RQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int c = 0; c < RQ; ++c) st[i][c] = dpt[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kb[RK], vb[RK], a[RQ], g[RQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kb[i] = k_s[(ty + 16 * i) * LD + d];
        vb[i] = v_s[(ty + 16 * i) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < RQ; ++c) {
        a[c] = q_s[(tx + 16 * c) * LD + d];
        g[c] = do_s[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < RQ; ++c) {
          st[i][c] = fmaf(kb[i], a[c], st[i][c]);
          dpt[i][c] = fmaf(vb[i], g[c], dpt[i][c]);
        }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int c = 0; c < RQ; ++c) {
        const int r = tx + 16 * c;
        float x = scale * st[i][c];
        if (causal && key > q0 + r) x = kNegInf;
        const float p = expf(x - lse_s[r]);  // 0 where masked
        p_s[(ty + 16 * i) * LP + r] = round_to<T>(p);
        ds_s[(ty + 16 * i) * LP + r] = round_to<T>(p * (dpt[i][c] - delta_s[r]) * scale);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float p[RK], ds[RK], g[RD], a[RD];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        p[i] = p_s[(ty + 16 * i) * LP + qq];
        ds[i] = ds_s[(ty + 16 * i) * LP + qq];
      }
#pragma unroll
      for (int c = 0; c < RD; ++c) {
        g[c] = do_s[qq * LD + tx + 16 * c];
        a[c] = q_s[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int c = 0; c < RD; ++c) {
          dv_acc[i][c] = fmaf(p[i], g[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds[i], a[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const size_t off = base + (k0 + ty + 16 * i) * rs;
#pragma unroll
    for (int c = 0; c < RD; ++c) {
      dk[off + tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

// Shared memory of each kernel, in floats.
template <int D, int BQ, int BK> constexpr size_t fwd_floats() {
  return (size_t)(BQ + 2 * BK) * (D + 1) + BQ * (BK + 16);
}
template <int D, int BQ, int BK> constexpr size_t dq_floats() {
  return (size_t)(2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 16);
}
template <int D, int BQ, int BK> constexpr size_t dkv_floats() {
  return (size_t)(2 * BK + 2 * BQ) * (D + 1) + 2 * BK * (BQ + 16) + 2 * BQ;
}

// Lift the 48 KB default for `kernel` once per instantiation (the first
// call is made outside any CUDA graph capture: chip_smoke.py and the
// tests warm up first).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int seq,
                int heads, float scale, bool causal, cudaStream_t stream) {
  constexpr int R = Tile<D>::kRows;
  constexpr size_t smem = fwd_floats<D, R, R>() * sizeof(float);
  static bool ready = false;
  cudaError_t err = allow_smem(fa_fwd_kernel<T, D, R, R>, smem, &ready);
  if (err != cudaSuccess) return err;
  fa_fwd_kernel<T, D, R, R><<<dim3(seq / R, B * heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, heads, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, void* dq, int B, int seq, int heads, float scale,
                   bool causal, cudaStream_t stream) {
  constexpr int R = Tile<D>::kRows;
  constexpr size_t smem = dq_floats<D, R, R>() * sizeof(float);
  static bool ready = false;
  cudaError_t err = allow_smem(fa_bwd_dq_kernel<T, D, R, R>, smem, &ready);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_kernel<T, D, R, R><<<dim3(seq / R, B * heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dq), seq,
      heads, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* o, const void* dout,
                    const float* lse, void* dk, void* dv, int B, int seq, int heads, float scale,
                    bool causal, cudaStream_t stream) {
  constexpr int R = Tile<D>::kRows;
  constexpr size_t smem = dkv_floats<D, R, R>() * sizeof(float);
  static bool ready = false;
  cudaError_t err = allow_smem(fa_bwd_dkv_kernel<T, D, R, R>, smem, &ready);
  if (err != cudaSuccess) return err;
  fa_bwd_dkv_kernel<T, D, R, R><<<dim3(seq / R, B * heads), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(o), static_cast<const T*>(dout), lse, static_cast<T*>(dk),
      static_cast<T*>(dv), seq, heads, scale, causal);
  return cudaGetLastError();
}

// Sizes the kernels take: T a positive multiple of 128 (so of every tile
// height), D in {64, 128, 256}, B*H within the grid's y limit.
bool takes(int B, int seq, int heads, int D) {
  return B >= 1 && heads >= 1 && (long long)B * heads <= 65535 && seq >= 128 &&
         seq % 128 == 0 && (D == 64 || D == 128 || D == 256);
}

}  // namespace

// Called by flash_attention_op.cpp.  q, k, v, o, dout, dq, dk, dv are
// contiguous [B, T, H, D] in f32 (bf16 = false) or bf16; lse is [B*H, T]
// f32.  Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for sizes and dtypes it does not take.

// f32 only: bf16 forwards run on the tensor cores (flash_attention_sm90.cu).
cudaError_t flash_attention_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                       float* lse, int B, int seq, int heads, int D, float scale,
                                       bool causal, cudaStream_t stream) {
  if (!takes(B, seq, heads, D)) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return fwd<float, 64>(q, k, v, o, lse, B, seq, heads, scale, causal, stream);
    case 128: return fwd<float, 128>(q, k, v, o, lse, B, seq, heads, scale, causal, stream);
    default: return fwd<float, 256>(q, k, v, o, lse, B, seq, heads, scale, causal, stream);
  }
}

// f32 at any D, bf16 at D = 256 only: bf16 at D = 64 and 128 runs on the
// tensor cores (flash_attention_sm90.cu).  The same for dK/dV below.
cudaError_t flash_attention_bwd_dq_launch(bool bf16, const void* q, const void* k, const void* v,
                                          const void* o, const void* dout, const float* lse,
                                          void* dq, int B, int seq, int heads, int D, float scale,
                                          bool causal, cudaStream_t stream) {
  if (!takes(B, seq, heads, D) || (bf16 && D != 256)) return cudaErrorInvalidValue;
  if (bf16)
    return bwd_dq<__nv_bfloat16, 256>(q, k, v, o, dout, lse, dq, B, seq, heads, scale, causal,
                                      stream);
  switch (D) {
    case 64:
      return bwd_dq<float, 64>(q, k, v, o, dout, lse, dq, B, seq, heads, scale, causal, stream);
    case 128:
      return bwd_dq<float, 128>(q, k, v, o, dout, lse, dq, B, seq, heads, scale, causal, stream);
    default:
      return bwd_dq<float, 256>(q, k, v, o, dout, lse, dq, B, seq, heads, scale, causal, stream);
  }
}

cudaError_t flash_attention_bwd_dkv_launch(bool bf16, const void* q, const void* k,
                                           const void* v, const void* o, const void* dout,
                                           const float* lse, void* dk, void* dv, int B, int seq,
                                           int heads, int D, float scale, bool causal,
                                           cudaStream_t stream) {
  if (!takes(B, seq, heads, D) || (bf16 && D != 256)) return cudaErrorInvalidValue;
  if (bf16)
    return bwd_dkv<__nv_bfloat16, 256>(q, k, v, o, dout, lse, dk, dv, B, seq, heads, scale,
                                       causal, stream);
  switch (D) {
    case 64:
      return bwd_dkv<float, 64>(q, k, v, o, dout, lse, dk, dv, B, seq, heads, scale, causal,
                                stream);
    case 128:
      return bwd_dkv<float, 128>(q, k, v, o, dout, lse, dk, dv, B, seq, heads, scale, causal,
                                 stream);
    default:
      return bwd_dkv<float, 256>(q, k, v, o, dout, lse, dk, dv, B, seq, heads, scale, causal,
                                 stream);
  }
}
