// Flash decode for Hopper (sm_90a): single-query GQA attention over a
// KV cache with a per-sequence visible length.
//
// Replaces the Pallas TPU kernel container_engine_accelerators_tpu/ops/
// flash_decode.py::_fd_kernel and computes what it computes:
//
//   q [B, H, D], k/v cache [B, L, KVH, D] (storage layout, no copy),
//   lengths [B] int32; query head kv*G + j reads KV head kv;
//   s = (q . k) in f32, times `scale` (applied to the f32 scores);
//   slots >= length are masked with -1e30; online softmax in f32;
//   p is cast to V's dtype before P.V, which accumulates in f32;
//   the divide by the softmax denominator happens once at the end;
//   output [B, H, D] in q's dtype.
//
// Design.  The TPU kernel walks the cache in order on one core, carrying
// m/l/acc across its K-block grid axis.  Here the cache is split across
// CTAs instead ("split-K", as flash-decoding does on GPUs): one CTA per
// (sequence, KV head, block of up to 8 query rows of that head's group,
// chunk of the cache), with the chunk sized on the host (split_plan in
// ops/flash_decode.py) for about four CTAs per SM even at batch 1.  Each
// CTA stages its query rows in shared memory as f32 and walks 32-key
// tiles of its chunk up to `length`, never reading a slot >= length
// (the TPU kernel skips whole blocks beyond the length; here the last
// tile is cut at the length itself, and chunks wholly past it exit at
// once).  Per tile: K
// and V rows are copied into shared memory (16-byte vector loads when the
// row allows), one warp per key computes the G dot products with a
// shuffle reduction, one warp per query row updates the running max and
// denominator and writes p, and every thread updates its own f32
// accumulators of the [rows, D] output tile.  Every CTA writes its (m, l,
// acc) partial to an f32 workspace, and a second kernel rescales the
// partials of every chunk to their common max, sums them and divides once
// (with one chunk, that is the single divide).
//
// Bound on this card: bytes.  A decode step reads each visible K/V row
// once and does 4 flops per byte pair, far below the ~295 flop/byte ridge
// of an H100, so the kernel's floor is the cache read over HBM bandwidth.
// At batch 1 that read is small (1.5 MB at the server's 1056-slot cache
// with 732 keys visible), so launch latency and each tile's chain of a
// load and three barriers dominate; the tile copy is not overlapped with
// compute (no cp.async / TMA double buffering) — later work.
//
// Interface: this file includes no PyTorch header, so nvcc builds it in
// seconds.  flash_decode_op.cpp registers the op with PyTorch
// (TORCH_LIBRARY), checks device, dtype, shape and contiguity with
// TORCH_CHECK, allocates the output and workspace, and calls
// flash_decode_launch below, which returns cudaGetLastError() after the
// launches.  ops/flash_decode.py picks the chunking (split_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;        // keys per tile: one per lane in the softmax step
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr int kMaxRows = 8;      // query rows per CTA (<= kWarps)
constexpr int kAccPerThread = kMaxRows * kMaxD / kThreads;
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask fill
constexpr int kMergeThreads = 128;
constexpr int kMaxSplits = 8192;   // merge weights fit the default 48 KB of shared memory

static_assert(kMaxRows <= kWarps, "one warp per query row in the softmax step");
static_assert(kTile == 32, "one lane per key in the softmax step");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__host__ __device__ constexpr size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// Shared memory: K tile, V tile (input dtype), then f32 q rows, scores/p,
// and the per-row running max, denominator and rescale factor.
template <typename T>
__host__ __device__ size_t smem_bytes(int d) {
  return 2 * align16(sizeof(T) * kTile * d) + align16(sizeof(float) * kMaxRows * d) +
         align16(sizeof(float) * kMaxRows * kTile) + 3 * align16(sizeof(float) * kMaxRows);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ workspace, int L,
                    int KVH, int G, int D, float scale, int chunk, int vec_ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + align16(sizeof(T) * kTile * D));
  float* q_s = reinterpret_cast<float*>(smem + 2 * align16(sizeof(T) * kTile * D));
  float* p_s = q_s + align16(sizeof(float) * kMaxRows * D) / sizeof(float);
  float* m_s = p_s + align16(sizeof(float) * kMaxRows * kTile) / sizeof(float);
  float* l_s = m_s + align16(sizeof(float) * kMaxRows) / sizeof(float);
  float* a_s = l_s + align16(sizeof(float) * kMaxRows) / sizeof(float);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row_blocks = (G + kMaxRows - 1) / kMaxRows;
  const int kvh = blockIdx.x / row_blocks;
  const int g0 = (blockIdx.x % row_blocks) * kMaxRows;
  const int rows = min(kMaxRows, G - g0);
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int b = blockIdx.z;
  const int H = KVH * G;
  // Visible keys; the TPU kernel treats a length past the buffer as "all".
  const int len = min(max(lengths[b], 0), L);
  const int start = split * chunk;
  if (start >= len) return;  // chunk wholly past the length
  const int end = min(start + chunk, len);
  const size_t q_row0 = (size_t)b * H + (size_t)kvh * G + g0;  // first query row of this CTA

  for (int i = tid; i < rows * D; i += kThreads) q_s[i] = to_f32(q[q_row0 * D + i]);
  if (tid < kMaxRows) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  const size_t row_stride = (size_t)KVH * D;  // elements between consecutive key slots
  const T* k_base = k + ((size_t)b * L * KVH + kvh) * D;
  const T* v_base = v + ((size_t)b * L * KVH + kvh) * D;

  for (int t0 = start; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);  // rows of this tile that are visible

    // 1. Copy the visible K/V rows of the tile into shared memory.
    if (vec_ok) {
      constexpr int kVec = 16 / sizeof(T);
      const int per_row = D / kVec;
      for (int i = tid; i < n * per_row; i += kThreads) {
        const int r = i / per_row, c = (i - r * per_row) * kVec;
        const size_t off = (size_t)(t0 + r) * row_stride + c;
        *reinterpret_cast<uint4*>(k_s + r * D + c) = *reinterpret_cast<const uint4*>(k_base + off);
        *reinterpret_cast<uint4*>(v_s + r * D + c) = *reinterpret_cast<const uint4*>(v_base + off);
      }
    } else {
      for (int i = tid; i < n * D; i += kThreads) {
        const int r = i / D, c = i - r * D;
        const size_t off = (size_t)(t0 + r) * row_stride + c;
        k_s[r * D + c] = k_base[off];
        v_s[r * D + c] = v_base[off];
      }
    }
    __syncthreads();

    // 2. Scores: one warp per key, lanes split D, f32 products and sums.
    for (int r = warp; r < n; r += kWarps) {
      float part[kMaxRows];
#pragma unroll
      for (int g = 0; g < kMaxRows; ++g) part[g] = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float kd = to_f32(k_s[r * D + d]);
#pragma unroll
        for (int g = 0; g < kMaxRows; ++g)
          if (g < rows) part[g] = fmaf(q_s[g * D + d], kd, part[g]);
      }
#pragma unroll
      for (int g = 0; g < kMaxRows; ++g) {
        if (g < rows) {
          const float s = warp_sum(part[g]);
          if (lane == 0) p_s[g * kTile + r] = s * scale;
        }
      }
    }
    __syncthreads();

    // 3. Online softmax: one warp per query row, one lane per key.
    if (warp < rows) {
      const int g = warp;
      const float s = lane < n ? p_s[g * kTile + lane] : kNegInf;
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float alpha = expf(m_prev - m_new);
      const float p = lane < n ? expf(s - m_new) : 0.f;
      const float p_sum = warp_sum(p);
      p_s[g * kTile + lane] = to_f32(from_f32<T>(p));  // P.V operand in V's dtype
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + p_sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + P.V over this tile, f32.
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int idx = tid + i * kThreads;
      if (idx < rows * D) {
        const int g = idx / D, d = idx - g * D;
        float a = acc[i] * a_s[g];
        for (int r = 0; r < n; ++r) a = fmaf(p_s[g * kTile + r], to_f32(v_s[r * D + d]), a);
        acc[i] = a;
      }
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

  // 5. This chunk's partial: workspace = m [B*H, splits], l [B*H, splits],
  // acc [B*H, splits, D], all f32.
  const size_t n_rows = (size_t)gridDim.z * H;
  float* ws_m = workspace;
  float* ws_l = ws_m + n_rows * splits;
  float* ws_acc = ws_l + n_rows * splits;
  if (tid < rows) {
    ws_m[(q_row0 + tid) * splits + split] = m_s[tid];
    ws_l[(q_row0 + tid) * splits + split] = l_s[tid];
  }
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int idx = tid + i * kThreads;
    if (idx < rows * D) {
      const int g = idx / D, d = idx - g * D;
      ws_acc[((q_row0 + g) * splits + split) * D + d] = acc[i];
    }
  }
}

// Reduce `x` over a block of kMergeThreads threads (max or sum); every
// thread gets the result.  `red` holds one float per warp.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* red) {
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();  // a previous reduction may still be reading `red`
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < kMergeThreads / 32; ++w) x = kMax ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// Merge the chunks' partials of one query row: rescale each to the common
// max, sum, divide once.  Grid (H, B).  The threads load the chunks'
// (m, l) in parallel and keep each chunk's weight exp(m - max) in shared
// memory, so the acc pass is one independent load and FMA per chunk.
// Chunks past the length never ran and are not read (an empty sequence
// gives 0/0 = NaN, as on the TPU).
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
flash_decode_combine_kernel(const float* __restrict__ workspace, const int* __restrict__ lengths,
                            T* __restrict__ out, int H, int L, int D, int chunk, int splits) {
  extern __shared__ float w_s[];  // [splits] chunk weights, then the reduction scratch
  float* red = w_s + splits;
  const int b = blockIdx.y;
  const size_t row = (size_t)b * H + blockIdx.x;
  const size_t n_rows = (size_t)gridDim.y * H;
  const float* m = workspace + row * splits;
  const float* l = workspace + n_rows * splits + row * splits;
  const float* acc = workspace + 2 * n_rows * splits + row * splits * D;
  const int len = min(max(lengths[b], 0), L);
  const int live = (len + chunk - 1) / chunk;

  float m_max = kNegInf;
  for (int s = threadIdx.x; s < live; s += kMergeThreads) m_max = fmaxf(m_max, m[s]);
  m_max = block_reduce<true>(m_max, red);
  float l_tot = 0.f;
  for (int s = threadIdx.x; s < live; s += kMergeThreads) {
    const float w = expf(m[s] - m_max);
    w_s[s] = w;
    l_tot = fmaf(l[s], w, l_tot);
  }
  l_tot = block_reduce<false>(l_tot, red);  // its barriers also publish w_s
  for (int d = threadIdx.x; d < D; d += kMergeThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < live; ++s) o = fmaf(acc[(size_t)s * D + d], w_s[s], o);
    out[row * D + d] = from_f32<T>(o / l_tot);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   float* workspace, int B, int H, int KVH, int L, int D, float scale, int chunk,
                   int splits, cudaStream_t stream) {
  const int G = H / KVH;
  const int row_blocks = (G + kMaxRows - 1) / kMaxRows;
  const size_t smem = smem_bytes<T>(D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int vec_ok = (D % (16 / (int)sizeof(T)) == 0) && ((uintptr_t)k % 16 == 0) &&
                     ((uintptr_t)v % 16 == 0);
  dim3 grid(KVH * row_blocks, splits, B);
  flash_decode_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      workspace, L, KVH, G, D, scale, chunk, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_combine_kernel<T>
      <<<dim3(H, B), kMergeThreads, (splits + kMergeThreads / 32) * sizeof(float), stream>>>(
          workspace, lengths, static_cast<T*>(out), H, L, D, chunk, splits);
  return cudaGetLastError();
}

}  // namespace

// Called by flash_decode_op.cpp.  The cache is cut into `splits` chunks of
// `chunk` keys (a multiple of 32, splits = ceil(L / chunk)); `workspace`
// holds B*H*splits*(D+2) floats.  Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for sizes the kernels do not take.
cudaError_t flash_decode_launch(bool bf16, const void* q, const void* k, const void* v,
                                const int* lengths, void* out, float* workspace, int B, int H,
                                int KVH, int L, int D, float scale, int chunk, int splits,
                                cudaStream_t stream) {
  if (B < 1 || B > 65535 || KVH < 1 || H < KVH || H % KVH != 0 || L < 1 || D < 1 ||
      D > kMaxD || chunk < kTile || chunk % kTile != 0 || splits < 1 || splits > kMaxSplits ||
      (long long)(splits - 1) * chunk >= L || (long long)splits * chunk < L)
    return cudaErrorInvalidValue;
  return bf16 ? launch<__nv_bfloat16>(q, k, v, lengths, out, workspace, B, H, KVH, L, D, scale,
                                      chunk, splits, stream)
              : launch<float>(q, k, v, lengths, out, workspace, B, H, KVH, L, D, scale, chunk,
                              splits, stream);
}
