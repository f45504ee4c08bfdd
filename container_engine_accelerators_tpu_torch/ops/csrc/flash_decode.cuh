// The flash-decode kernel and its launch, as templates: flash_decode.cu
// (bf16, and the entry point) and flash_decode_f32.cu (f32) instantiate
// them, so nvcc builds the two in parallel.  flash_decode.cu's header note
// describes the design.  No PyTorch header.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "flash_decode_plan.h"  // the grid: lanes a key, rows a CTA, CTAs a row block
#include "sm90_async.cuh"        // smem_addr, mbarriers, the tensor-map encoder

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's mask fill

// LPK lanes per key, each holding CPL 16-byte chunks of its row; ROWS
// query rows per CTA, a compile-time count so that no instruction is
// issued for a row the CTA does not have (1 at G = 1).
template <typename T, int LPK, int CPL, int ROWS>
struct Cfg {
  static constexpr int kVec = 16 / sizeof(T);        // elements in 16 bytes
  static constexpr int kPerLane = CPL * kVec;        // a lane's elements of a row
  static constexpr int kKeysPerPass = 32 / LPK;
  static constexpr int kKeys = kPasses * kKeysPerPass;  // keys per tile: one TMA box
  static constexpr int kRows = ROWS;
  // Warps per CTA: 16 at one row (at most 128 registers a thread), else 8.
  static constexpr int kWarps = ROWS == 1 ? 16 : 8;
  static constexpr int kThreads = kWarps * 32;
  // Tiles in flight per warp: 32 tiles a CTA, 2 a warp for 2-chunk rows.
  static constexpr int kStages = CPL == 2 ? 2 : 32 / kWarps;
  static_assert(ROWS * kPerLane <= 64, "a lane holds at most 64 f32 of the accumulator");
};

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// A partial (m [rows], l [rows], acc [rows, D], f32) of `rows` query rows.
__host__ __device__ constexpr int part_floats(int rows, int d) { return rows * (d + 2); }

// Shared memory, from a 128-byte aligned base: one region per warp (its
// ring of kStages K and V tiles of d-element rows, then its partial once
// the ring is done), the warps' mbarriers, and CTA 0's slots for the
// `slots` CTAs' partials.
template <typename C>
__host__ __device__ size_t tile_bytes(int d, int elem) {
  return align128(static_cast<size_t>(C::kKeys) * d * elem);
}
template <typename C>
__host__ __device__ size_t warp_bytes(int d, int elem) {
  const size_t ring = C::kStages * 2 * tile_bytes<C>(d, elem);
  const size_t part = sizeof(float) * part_floats(C::kRows, d);
  return align128(ring > part ? ring : part);
}
template <typename C>
__host__ __device__ size_t smem_bytes(int d, int elem, int slots) {
  return 128 + C::kWarps * warp_bytes<C>(d, elem) + align128(C::kWarps * C::kStages * 8) +
         sizeof(float) * slots * part_floats(C::kRows, d);  // 128: room to align
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// 16 bytes of shared memory as f32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x, f[2 * i + 1] = x.y;
  }
}

// A tile of `keys` cache rows of KV head `head` from row `row` of the
// [B*L, KVH, D] view into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map, uint64_t* bar, int head,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(0), "r"(head), "r"(row)
      : "memory");
}

// Combine the first `n` (of at most N) partials at element (g, d): rescale
// each to the common max, sum.  at(i, offset) reads partial i.  Every load
// is issued before the first is used.
template <int N, typename At>
__device__ __forceinline__ void combine(At at, int n, int rows, int g, int d, int D, float* m_out,
                                        float* l_out, float* a_out) {
  float mi[N], li[N], ai[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mi[i] = i < n ? at(i, g) : kNegInf;
    li[i] = i < n ? at(i, rows + g) : 0.f;
    ai[i] = i < n ? at(i, 2 * rows + g * D + d) : 0.f;
  }
  float m = kNegInf;
#pragma unroll
  for (int i = 0; i < N; ++i) m = fmaxf(m, mi[i]);
  float l = 0.f, a = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float w = expf(mi[i] - m);  // 0 for a partial that saw no key (m = -1e30)
    l = fmaf(li[i], w, l);
    a = fmaf(ai[i], w, a);
  }
  *m_out = m, *l_out = l, *a_out = a;
}

// kTma: tiles arrive by TMA (rows of whole 16-byte chunks, 16-byte aligned
// caches); else the warp copies them with plain loads.
template <typename T, int LPK, int CPL, int ROWS, bool kTma>
__global__ void __launch_bounds__(Cfg<T, LPK, CPL, ROWS>::kThreads)
flash_decode_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
                    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, T* __restrict__ out, int L, int KVH, int G,
                    int D, float scale) {
  using C = Cfg<T, LPK, CPL, ROWS>;
  constexpr int R = C::kRows, kStages = C::kStages, kWarps = C::kWarps, kThreads = C::kThreads;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  // TMA writes to 128-byte aligned shared memory.
  uint8_t* smem = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int splits = gridDim.x, rank = blockIdx.x;
  const int row_blocks = (G + R - 1) / R;
  const int kvh = blockIdx.y / row_blocks;
  const int g0 = (blockIdx.y % row_blocks) * R;
  const int rows = min(R, G - g0);
  const int b = blockIdx.z;
  const int nc = (D + C::kVec - 1) / C::kVec;  // 16-byte chunks of a row
  const int Dp = kTma ? D : nc * C::kVec;     // a tile row's elements, padded without TMA
  const int PF = part_floats(R, D);
  const size_t tb = tile_bytes<C>(Dp, sizeof(T)), wb = warp_bytes<C>(Dp, sizeof(T));
  uint8_t* ring = smem + warp * wb;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kWarps * wb) + warp * kStages;
  float* slots = reinterpret_cast<float*>(smem + kWarps * wb + align128(kWarps * kStages * 8));

  // Phase 1 of the cluster barrier: this CTA has started.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // This warp's steps: first, first + stride, ...; step i is keys
  // (first + i stride) kKeys onwards.
  const int first = rank + splits * warp, stride = splits * kWarps;
  auto n_steps = [&](int keys) {  // steps that start below `keys`
    const int total = (keys + C::kKeys - 1) / C::kKeys;
    return first < total ? (total - first + stride - 1) / stride : 0;
  };
  const uint32_t tx = 2u * C::kKeys * D * sizeof(T);
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto issue = [&](int i) {  // lane 0, TMA: step i into stage i % kStages
    const int s = i % kStages;
    const int row = b * L + (first + i * stride) * C::kKeys;
    mbar_expect_tx(&bars[s], tx);
    tma_rows(ring + 2 * s * tb, map_k, &bars[s], kvh, row);
    tma_rows(ring + (2 * s + 1) * tb, map_v, &bars[s], kvh, row);
  };

  // 1. With TMA, the first tiles, before the length is known: only steps
  //    that start inside the buffer.
  const int n_pre = kTma ? min(kStages, n_steps(L)) : 0;
  if (kTma && lane == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_k)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map_v)) : "memory");
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < n_pre; ++i) issue(i);
  }
  __syncwarp();

  // 2. Meanwhile: the length, and this lane's slices of the q rows as f32
  //    (lane holds chunks c0, c0 + LPK, ... of each row; kgrp is its key).
  const int len = min(max(lengths[b], 0), L);
  const int kgrp = lane / LPK, c0 = lane % LPK;
  const size_t row0 = (static_cast<size_t>(b) * KVH + kvh) * G + g0;  // first query row
  float qr[R][C::kPerLane];
#pragma unroll
  for (int g = 0; g < R; ++g)
#pragma unroll
    for (int cc = 0; cc < CPL; ++cc) {
      const int c = c0 + cc * LPK;
#pragma unroll
      for (int e = 0; e < C::kVec; ++e)
        qr[g][cc * C::kVec + e] = g < rows && (kTma ? c < nc : c * C::kVec + e < D)
                                      ? to_f32(q[(row0 + g) * D + c * C::kVec + e])
                                      : 0.f;
    }

  // Without TMA: the warp copies step i's tile into stage s with plain
  // loads, the row's padding and keys past the length as 0.
  auto copy = [&](int i, int s) {
    const int key0 = (first + i * stride) * C::kKeys;
    T* kt = reinterpret_cast<T*>(ring + 2 * s * tb);
    T* vt = reinterpret_cast<T*>(ring + (2 * s + 1) * tb);
    for (int idx = lane; idx < C::kKeys * Dp; idx += 32) {
      const int r = idx / Dp, d = idx - r * Dp;
      const bool in = d < D && key0 + r < len;
      const size_t at = ((static_cast<size_t>(b) * L + key0 + r) * KVH + kvh) * D + d;
      kt[idx] = in ? k[at] : from_f32<T>(0.f);
      vt[idx] = in ? v[at] : from_f32<T>(0.f);
    }
    __syncwarp();
  };

  float m[R], l[R], acc[R][C::kPerLane];
#pragma unroll
  for (int g = 0; g < R; ++g) {
    m[g] = kNegInf, l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < C::kPerLane; ++e) acc[g][e] = 0.f;
  }

  // 3. The key loop, one tile a step: no block-wide barrier.  The tile's
  //    kPasses x rows scores are independent until its max, which the
  //    warp shares; then p, l and P.V.
  const int n_mine = n_steps(len);
  for (int i = 0; i < n_mine; ++i) {
    const int s = i % kStages;
    if constexpr (kTma)
      mbar_wait(&bars[s], (i / kStages) & 1);
    else
      copy(i, s);
    const T* kt = reinterpret_cast<const T*>(ring + 2 * s * tb);
    const T* vt = reinterpret_cast<const T*>(ring + (2 * s + 1) * tb);
    const int key0 = (first + i * stride) * C::kKeys;
    bool vis[kPasses];
    float sc[R][kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * C::kKeysPerPass + kgrp;  // this lane's key in the tile
      vis[p] = key0 + r < len;
      float kf[C::kPerLane];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = c0 + cc * LPK;
        if (c < nc) {
          load16(kt + r * Dp + c * C::kVec, &kf[cc * C::kVec]);
        } else {
#pragma unroll
          for (int e = 0; e < C::kVec; ++e) kf[cc * C::kVec + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < R; ++g) {
        if (g < rows) {
          float a0 = 0.f, a1 = 0.f;
#pragma unroll
          for (int e = 0; e < C::kPerLane; e += 2) {
            a0 = fmaf(qr[g][e], kf[e], a0);
            a1 = fmaf(qr[g][e + 1], kf[e + 1], a1);
          }
          sc[g][p] = a0 + a1;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < R; ++g) {
      if (g < rows) {
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
#pragma unroll
          for (int o = LPK / 2; o > 0; o >>= 1)
            sc[g][p] += __shfl_xor_sync(0xffffffffu, sc[g][p], o);
          sc[g][p] = vis[p] ? sc[g][p] * scale : kNegInf;  // masked by selection
        }
        float mx = sc[g][0];
#pragma unroll
        for (int p = 1; p < kPasses; ++p) mx = fmaxf(mx, sc[g][p]);
#pragma unroll
        for (int o = LPK; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[g], mx);
        const float alpha = expf(m[g] - m_new);
        float p_sum = 0.f;
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          const float pr = vis[p] ? expf(sc[g][p] - m_new) : 0.f;
          p_sum += pr;
          sc[g][p] = to_f32(from_f32<T>(pr));  // the P.V operand in V's dtype
        }
        l[g] = fmaf(l[g], alpha, p_sum);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < C::kPerLane; ++e) acc[g][e] *= alpha;
      }
    }
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int r = p * C::kKeysPerPass + kgrp;
      float vf[C::kPerLane];
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = c0 + cc * LPK;
        if (c < nc) {
          load16(vt + r * Dp + c * C::kVec, &vf[cc * C::kVec]);
        } else {
#pragma unroll
          for (int e = 0; e < C::kVec; ++e) vf[cc * C::kVec + e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < R; ++g)
        if (g < rows)
#pragma unroll
          for (int e = 0; e < C::kPerLane; ++e)  // a key past the length never touches acc
            acc[g][e] = vis[p] ? fmaf(sc[g][p], vf[e], acc[g][e]) : acc[g][e];
    }
    __syncwarp();  // every lane has read stage s
    if (kTma && lane == 0 && i + kStages < n_mine) issue(i + kStages);
  }
  // Tiles issued before the length was known that lie past it.
  for (int i = n_mine; i < n_pre; ++i) mbar_wait(&bars[i], 0);

  // 4. The warp's partial, into its own (now idle) ring region: sum l and
  //    acc over its lane groups (they share m); lane group 0 writes it.
#pragma unroll
  for (int g = 0; g < R; ++g) {
    if (g < rows) {
#pragma unroll
      for (int o = LPK; o < 32; o <<= 1) {
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < C::kPerLane; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    }
  }
  float* wp = reinterpret_cast<float*>(ring);
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < R; ++g)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int c = c0 + cc * LPK;
#pragma unroll
        for (int e = 0; e < C::kVec; ++e)
          if (g < rows && (kTma ? c < nc : c * C::kVec + e < D))
            wp[2 * R + g * D + c * C::kVec + e] = acc[g][cc * C::kVec + e];
      }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < R; ++g) wp[g] = m[g], wp[R + g] = l[g];
  }
  __syncthreads();

  // 5. The CTA's partial from its warps', into CTA 0's slot `rank` through
  //    distributed shared memory.  Phase 1 of the cluster barrier completes
  //    once every CTA of the cluster has started, so CTA 0's shared memory
  //    exists.
  auto warps_at = [&](int w, int off) {
    return reinterpret_cast<const float*>(smem + w * wb)[off];
  };
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  float* dst = cluster.map_shared_rank(slots, 0) + rank * PF;
  for (int idx = tid; idx < rows * D; idx += kThreads) {
    const int g = idx / D, d = idx - g * D;
    float mm, ll, aa;
    combine<kWarps>(warps_at, kWarps, R, g, d, D, &mm, &ll, &aa);
    dst[2 * R + g * D + d] = aa;
    if (d == 0) dst[g] = mm, dst[R + g] = ll;
  }

  // 6. The CTAs' partials into the output: divide once.
  cluster.sync();  // every CTA's partial has landed in CTA 0's slots
  if (rank == 0) {
    T* o = out + row0 * D;
    auto slot_at = [&](int r, int off) { return slots[r * PF + off]; };
    for (int idx = tid; idx < rows * D; idx += kThreads) {
      const int g = idx / D, d = idx - g * D;
      float mm, ll, aa;
      combine<kMaxSplits>(slot_at, splits, R, g, d, D, &mm, &ll, &aa);
      o[idx] = from_f32<T>(aa / ll);
    }
  }
}

// Tensor map of a [B, L, KVH, D] cache viewed as [B*L, KVH, D], box
// (keys rows, 1 head, D), no swizzle.
cudaError_t cache_map(CUtensorMap* map, const void* base, bool bf16, int BL, int KVH, int D,
                      int keys) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t elem = bf16 ? 2 : 4;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(KVH),
                              static_cast<cuuint64_t>(BL)};
  const cuuint64_t strides[2] = {D * elem, static_cast<cuuint64_t>(KVH) * D * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), 1, static_cast<cuuint32_t>(keys)};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                            3, const_cast<void*>(base), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int LPK, int CPL, int ROWS, bool kTma>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   int B, int H, int KVH, int L, int D, float scale, int splits,
                   cudaStream_t stream) {
  using C = Cfg<T, LPK, CPL, ROWS>;
  const auto kernel = flash_decode_kernel<T, LPK, CPL, ROWS, kTma>;
  static bool ready = false;  // attributes set once per instantiation, outside graph capture
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<C>(LPK * C::kPerLane, sizeof(T), kMaxSplits)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const bool bf16 = sizeof(T) == 2;
  CUtensorMap tm_k = {}, tm_v = {};  // unused without TMA
  if constexpr (kTma) {
    cudaError_t err = cache_map(&tm_k, k, bf16, B * L, KVH, D, C::kKeys);
    if (err == cudaSuccess) err = cache_map(&tm_v, v, bf16, B * L, KVH, D, C::kKeys);
    if (err != cudaSuccess) return err;
  }
  const int G = H / KVH;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, KVH * ((G + ROWS - 1) / ROWS), B);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = smem_bytes<C>(row_bytes(D, sizeof(T)) / sizeof(T), sizeof(T), splits);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, tm_k, tm_v, static_cast<const T*>(q), static_cast<const T*>(k),
                         static_cast<const T*>(v), lengths, static_cast<T*>(out), L, KVH, G, D,
                         scale);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The kernel for T, the copy path, the row's lanes and the plan's rows
// and splits (make_plan).  tma: rows of whole 16-byte chunks and 16-byte
// aligned caches; without it the plan takes one-row CTAs, the only ones
// built with the plain-load copy.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                     int B, int H, int KVH, int L, int D, float scale, Plan plan, bool tma,
                     cudaStream_t stream) {
  constexpr int elem = sizeof(T);
  const int rb = row_bytes(D, elem);
  const int rows = plan.rows, splits = plan.splits;
#define FD_LAUNCH(LPK, CPL, ROWS, TMA)                                                      \
  return launch<T, LPK, CPL, ROWS, TMA>(q, k, v, lengths, out, B, H, KVH, L, D, scale, splits, \
                                        stream)
#define FD_ROWS(LPK, CPL)                                   \
  do {                                                      \
    constexpr int kMax = max_rows(LPK * 16 * CPL, elem);    \
    if (!tma) FD_LAUNCH(LPK, CPL, 1, false);                \
    if (rows == 1) FD_LAUNCH(LPK, CPL, 1, true);            \
    if (rows == 4) FD_LAUNCH(LPK, CPL, 4, true);            \
    FD_LAUNCH(LPK, CPL, kMax, true);                        \
  } while (0)
  if constexpr (elem == 4) {
    if (rb > 512) FD_ROWS(32, 2);  // f32 rows past 128 values: 2 chunks a lane
  }
  switch (lanes_per_key(rb)) {
    case 4: FD_ROWS(4, 1);
    case 8: FD_ROWS(8, 1);
    case 16: FD_ROWS(16, 1);
    default: FD_ROWS(32, 1);
  }
#undef FD_ROWS
#undef FD_LAUNCH
}

}  // namespace
