// Flash decode for Hopper (sm_90a): single-query GQA attention over a
// KV cache with a per-sequence visible length, in one launch.
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
//   output [B, H, D] in q's dtype; a length past L counts as L, and an
//   empty sequence gives 0/0 = NaN, as on the TPU.
//
// Bound on this card: bytes, and at batch 1 latency.  A decode step does
// 4 flops per pair of K/V bytes it reads, against the H100's ~295
// flop-per-byte ridge, so the floor is the visible cache read over HBM
// bandwidth and the tensor cores would buy nothing: the products run on
// the CUDA cores in f32.  At the server's batch 1 that read is small (1.5
// MB at a 1056-slot cache with 731 keys visible, 0.45 us at 3.35 TB/s), so
// what counts is the chain of dependent steps between the launch and the
// output: the design keeps it short and overlaps what it can.
//
// Design (templates in flash_decode.cuh; this file instantiates bf16 and
// holds the entry point, flash_decode_f32.cu instantiates f32).
//
// - Grid (splits, KVH x row blocks, B).  A row block is 1 query row of a
//   KV head's group at G = 1, 4 at G <= 4, else 8 (16 in f32 up to D 128):
//   the count is a template parameter, so no instruction is issued for a
//   row the CTA does not have.  A CTA has 16 warps at one row, else 8.
//   The `splits` CTAs of one (sequence, KV head, row block) split that
//   sequence's VISIBLE keys: the keys are cut into tiles (kKeys keys, 8 at
//   D = 64 in bf16), and warp w of CTA r takes tiles r + splits (w + W i),
//   i = 0, 1, ...  make_plan (flash_decode_plan.h) picks the rows and
//   `splits` from the shapes and the SM count (one-row CTAs where the
//   row blocks are too few to fill the card); it is the only place the
//   plan lives.  Each
//   CTA reads lengths[b] itself, so the grid depends only on the shapes (a
//   CUDA graph captures it), every CTA gets a near-equal share of [0,
//   length), and a CTA with no keys still reaches every cluster barrier
//   (there is no early exit).
// - Asynchronous copies, several in flight.  Each warp owns a ring of
//   kStages tiles in shared memory (32 tiles a CTA), one mbarrier each;
//   lane 0 brings K and V tiles in with TMA, from a 3-D tensor map over the
//   cache viewed as [B*L, KVH, D] with box (kKeys keys, 1 head, D), no
//   swizzle.  TMA takes rows of whole 16-byte chunks from 16-byte aligned
//   caches: bf16 at D a multiple of 8 (D = 40 is 80 bytes), f32 at D a
//   multiple of 4.  The warp's first tiles are issued before lengths[b] is
//   read: their addresses depend only on the CTA's place in the grid, and
//   only tiles that start inside the buffer are issued, so the length
//   read, the q load and the first tiles overlap instead of chaining.
//   Tiles that then lie wholly past the length are waited for and dropped.
//   Warps consume and refill their own ring, so the key loop has no
//   block-wide barrier.  Any other row (bf16 D not a multiple of 8, f32 D
//   not a multiple of 4) or an unaligned cache has no TMA box: there the
//   warp copies each tile into the same ring stage with plain loads, its
//   rows padded with zeros to whole 16-byte chunks, with nothing in flight.
//   The copy path is a template parameter (kTma), so the TMA kernels carry
//   nothing of it, and it is built for one-row CTAs only (make_plan takes
//   one row a CTA there): no configuration of the port has such a head
//   dim.  The
//   flash-attention kernels' ring (init_ring / ring_fill / ring_take) is a
//   producer warpgroup feeding consumer warpgroups; here each warp is its
//   own producer, so only the building blocks below it are shared
//   (sm90_async.cuh).
// - Arithmetic.  A lane group of LPK lanes holds one key's row, 16 bytes a
//   lane (8 lanes cover a 64-wide bf16 row, so a warp scores 4 keys a pass
//   with 3 shuffles per query row); each lane keeps its slice of the f32 q
//   rows and of the [rows, D] accumulator in registers.  A tile is 2
//   passes: its scores are independent until the tile's max (2 shuffles),
//   which the warp shares, then p, l and P.V, so every thread works even
//   at G = 1.  Slots >= length are masked by selection: s = -1e30, p = 0
//   and the V update skipped for that key, never a multiply by 0 (0 x NaN
//   is NaN).  A TMA box may bring slots >= length into shared memory; the
//   kernel never computes with them (the plain-load copy does not read
//   them at all).
// - The merge, inside the kernel.  Each warp leaves its partial (m, l,
//   acc) in its idle ring; after one __syncthreads the CTA combines them.
//   The CTAs of a row block form one thread-block cluster
//   (cudaLaunchKernelEx with a cluster dimension of `splits`, up to 16
//   with the non-portable size allowed).  Each CTA writes its partial into
//   CTA 0's shared memory through distributed shared memory (the cluster
//   barrier's first phase, arrived at on entry, guarantees that CTA 0 has
//   started); after cluster.sync() CTA 0 merges them and writes the
//   output.  No workspace, no atomics, nothing to reset.  A merge by the
//   CTA that finishes last (partials in an L2 workspace, an atomic counter
//   per row block) was measured against it and was slower at every timed
//   shape, so it is not built (PERF.md).
//
// Interface: no PyTorch header.  flash_decode_op.cpp checks the inputs,
// allocates the output, and calls flash_decode_launch below, which makes
// the plan and returns the launch's error.

#include "flash_decode.cuh"

// flash_decode_f32.cu: the f32 kernels.
cudaError_t flash_decode_f32_launch(const void* q, const void* k, const void* v,
                                    const int* lengths, void* out, int B, int H, int KVH, int L,
                                    int D, float scale, int rows, int splits, bool tma,
                                    cudaStream_t stream);

namespace {

// TMA takes rows of whole 16-byte chunks from 16-byte aligned caches.
bool tma_fits(int D, int elem, const void* k, const void* v) {
  return (D * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

// The plan (make_plan) for these sizes and caches on the current device;
// {0, 0} for sizes the kernel does not take.
Plan plan_for(bool bf16, int B, int H, int KVH, int L, int D, const void* k, const void* v) {
  const int elem = bf16 ? 2 : 4;
  if (B < 1 || B > 65535 || KVH < 1 || H < KVH || H % KVH != 0 || L < 1 || D < 1 || D > kMaxD ||
      static_cast<long long>(B) * L > (1ll << 31) - 1)
    return {0, 0};
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return {0, 0};
  const Plan plan = make_plan(B, H, KVH, D, elem, L, sms, tma_fits(D, elem, k, v));
  if (static_cast<long long>(KVH) * ((H / KVH + plan.rows - 1) / plan.rows) > 65535) return {0, 0};
  return plan;
}

}  // namespace

// The plan for flash_decode_op.cpp: the CTAs a row block, and the rows a
// CTA in *rows; 0 for sizes the kernel does not take.
int flash_decode_plan(bool bf16, int B, int H, int KVH, int L, int D, const void* k,
                      const void* v, int* rows) {
  const Plan plan = plan_for(bf16, B, H, KVH, L, D, k, v);
  *rows = plan.rows;
  return plan.splits;
}

// Called by flash_decode_op.cpp on the current device.  Returns the
// launch's error, or cudaErrorInvalidValue for sizes the kernel does not
// take.
cudaError_t flash_decode_launch(bool bf16, const void* q, const void* k, const void* v,
                                const int* lengths, void* out, int B, int H, int KVH, int L, int D,
                                float scale, cudaStream_t stream) {
  const Plan plan = plan_for(bf16, B, H, KVH, L, D, k, v);
  if (plan.splits < 1) return cudaErrorInvalidValue;
  const bool tma = tma_fits(D, bf16 ? 2 : 4, k, v);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, lengths, out, B, H, KVH, L, D, scale, plan, tma,
                                        stream)
              : flash_decode_f32_launch(q, k, v, lengths, out, B, H, KVH, L, D, scale, plan.rows,
                                        plan.splits, tma, stream);
}
