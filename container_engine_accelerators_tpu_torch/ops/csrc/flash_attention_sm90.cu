// Flash attention on Hopper's tensor cores (sm_90a): the bf16 forward, dQ
// and dK/dV kernels, built from TMA tile loads, an mbarrier ring between a
// producer warpgroup and two consumer warpgroups, and wgmma.
//
// Replaces, for bf16 inputs, the Pallas TPU kernels of
// container_engine_accelerators_tpu/ops/flash_attention.py:
//
//   fa_fwd_sm90_kernel      <- _fa_kernel (:67-117), called by _fa_forward
//   fa_bwd_dq_sm90_kernel   <- _fa_bwd_dq_kernel (:160-217)
//   fa_bwd_dkv_sm90_kernel  <- _fa_bwd_dkv_kernel (:220-278)
//   fa_bwd_delta_kernel        delta = rowsum(dO * O) in f32, once per
//                              backward for both kernels (the TPU kernels
//                              recompute it in every block step)
//
// and computes what they compute: S is the f32 product of bf16 operands,
// the scale multiplies the f32 scores (q is not pre-scaled), masked scores
// are -1e30; the forward's online softmax keeps m, l and acc in f32, p is
// rounded to bf16 before P.V, o = acc / l is rounded once, and lse =
// m + log(l) is stored [B*H, T] f32; in the backward, P = exp(s - lse),
// dS = P (dP - delta) scale, dS is rounded to K's dtype before dS.K and to
// Q's before dS^T.Q, P to dO's before P^T.dO, and dQ, dK, dV accumulate in
// f32 and are rounded once.
//
// Which kernel takes a call (the routing is flash_attention_op.cpp's):
//
//   dtype  D    forward               dQ                     dK/dV
//   bf16   64   fa_fwd_sm90_kernel    fa_bwd_dq_sm90_kernel  fa_bwd_dkv_sm90_kernel
//   bf16   128  fa_fwd_sm90_kernel    fa_bwd_dq_sm90_kernel  fa_bwd_dkv_sm90_kernel
//   bf16   256  fa_fwd_sm90_kernel    flash_attention.cu     flash_attention.cu
//   f32    any  flash_attention.cu    flash_attention.cu     flash_attention.cu
//
// f32 stays on flash_attention.cu's CUDA-core kernels, which keep true f32
// (the tensor cores would take f32 only as TF32).  dK/dV at D = 256 would
// need two 64 x 256 f32 accumulators, 256 registers a thread, past the
// 255 a thread can hold; dQ at D = 256 (a 64 x 256 f32 accumulator
// beside S and dP) spilled and had its wgmma serialised when built (ptxas
// -v), and its two ring stages would need 256 KB of shared memory.
//
// Bound on this card: operations.  At the training shape (B=8, T=2048,
// H=8, D=64, causal) the forward does 34 GFLOP against 68 MB, dQ 52 GFLOP
// against 101 MB, dK/dV 69 GFLOP against 118 MB, far above the H100's
// ~295 bf16 FLOP per byte ridge, so the products must run on the tensor
// cores at their rate.
//
// Design.
//
// - CTA: three warpgroups.  Warpgroup 0 is the producer: it gives most of
//   its registers away (setmaxnreg) and one of its threads issues every
//   TMA load.  Warpgroups 1 and 2 are consumers with 240 registers each,
//   each owning 64 rows of the CTA's 128 (query rows in the forward and
//   dQ, keys in dK/dV).  Their products are wgmma m64nNk16 bf16 -> f32.
// - TMA: one 4-D tensor map over each [B, T, H, D] input (innermost D,
//   rows H*D*2 bytes apart), box 64 columns x 1 head x rows x 1 batch, in
//   128-byte-swizzled shared memory.  A swizzle row holds 64 bf16, so a
//   tile of D = 128 or 256 is 2 or 4 column boxes one after the other and
//   the wgmma K loop walks them.  The host encodes the maps per call with
//   cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint (no link
//   flag for libcuda), and passes them by value as __grid_constant__
//   parameters, so a captured CUDA graph holds them too.
// - Ring: kStages buffers, each with a "full" mbarrier (the producer's
//   expected bytes, completed by TMA) and an "empty" one (one arrival per
//   consumer warp once its products have read the buffer).
// - Forward: Q (128 rows) is loaded once; K and V tiles of BK keys stream
//   through the ring.  S = Q.K^T is wgmma with both operands from shared
//   memory, K-major.  Scale, mask and the online softmax run on the
//   accumulator fragment in place: in each warp's 16 rows thread t holds
//   rows t/4 and t/4 + 8 and columns 8j + 2(t%4) + {0, 1}, so a row's max
//   and sum are two quad shuffles.  P is rounded to bf16 in registers,
//   and those pairs are already the A fragment of the next wgmma: O += P.V
//   takes A from registers and V's [BK, D] tile as an MN-major B operand.
//   The two consumer warpgroups take turns issuing S = Q.K^T (two named
//   barriers), so one's softmax, which at D = 64 costs about as long as
//   its products, runs while the other's products use the tensor cores.
//   Causal: the loop stops at the diagonal block, a warpgroup skips a
//   block whose keys all lie past its rows, and the heaviest Q blocks are
//   launched first.
// - dK/dV: K and V (128 keys) are loaded once; Q and dO tiles of 64 rows,
//   with their lse and delta slices, stream through the ring from the
//   diagonal block.  S^T = K.Q^T and dP^T = V.dO^T are shared-memory
//   wgmma; P^T and dS^T are formed in registers, rounded to bf16, and
//   feed dV += P^T.dO and dK += dS^T.Q as register A fragments with dO and
//   Q as MN-major B operands.  dK and dV stay in registers over the whole
//   loop; no atomics.
// - dQ: Q and dO (128 rows) are loaded once; K and V tiles of 64 keys
//   stream through the ring.  S = Q.K^T and dP = dO.V^T are shared-memory
//   wgmma, both operands K-major; P and dS are formed on the accumulator
//   fragment in place (each thread's two rows' lse and delta sit in
//   registers for the whole loop), dS is rounded to bf16 into A fragments,
//   and dQ += dS.K takes K's tile as an MN-major B operand, as the forward
//   reads V for P.V.  dQ stays in registers and is written once: no
//   atomics, so it is deterministic.  Causal as in the forward.
// - The delta pre-pass runs once per backward: the dQ op launches it and
//   hands its result to the dK/dV op.
// - A wait on an mbarrier that is never completed traps after ~10 s of
//   clock instead of hanging the card.
//
// Interface: no PyTorch header.  flash_attention_op.cpp checks the inputs,
// allocates the outputs and the delta, and calls the *_launch functions at
// the end of this file, which return cudaGetLastError().

#include <cuda_bf16.h>

#include "sm90_async.cuh"  // smem_addr, mbarriers, the tensor-map encoder

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernels' mask fill
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kStages = 2;         // ring buffers
constexpr int kConsumerWarps = 8;
constexpr int kRowBytes = 128;     // one swizzle row: 64 bf16 columns
constexpr int kSlack = 1024;       // room to align the dynamic shared memory to 1024

// ---------------------------------------------------------------------------
// Building blocks shared by the kernels.

// The dynamic shared memory rounded up to 1024 bytes, the 128-byte
// swizzle's period.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// A [rows, D] tile of a [B, T, H, D] bf16 tensor (rows from `row`, head
// `head`, batch `batch`) into shared memory: D / 64 column boxes of
// rows x 128 bytes, 128-byte swizzled, completing on `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(uint8_t* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row, int batch, int rows) {
#pragma unroll
  for (int box = 0; box < D / 64; ++box)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst + box * rows * kRowBytes)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(box * 64), "r"(head),
        "r"(row), "r"(batch)
        : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global to
// shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading byte offset, stride byte offset 1024 (eight 128-byte
// rows), layout "128B swizzle".
__device__ __forceinline__ uint64_t smem_desc(const uint8_t* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

// K-major operand (rows x D, D contiguous, as TMA stored it), step kk of
// the K loop (16 columns): the kk/4-th column box, 32 bytes into its row.
template <int ROWS>
__device__ __forceinline__ uint64_t kmajor_desc(const uint8_t* tile, int kk) {
  return smem_desc(tile + (kk >> 2) * ROWS * kRowBytes + (kk & 3) * 32, 16);
}

// MN-major B operand (K rows x N columns, N contiguous), step kk (16
// rows): 2048 bytes per step; the next 64 columns lie one box further.
template <int ROWS>
__device__ __forceinline__ uint64_t mnmajor_desc(const uint8_t* tile, int kk) {
  return smem_desc(tile + kk * 16 * kRowBytes, ROWS * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving accesses of an accumulator across the
// asynchronous products that write it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Two f32 rounded to nearest even bf16 (as astype), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragments (k16 steps) of an m64 x N accumulator read as the left
// operand of the next product: step kk is columns 16kk .. 16kk + 15.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&d)[N], uint32_t (&a)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// wgmma m64nNk16, bf16 x bf16 -> f32.  wgmma_ss: A and B from shared
// memory, both K-major.  wgmma_rs: A from registers, B from shared memory
// MN-major.  `acc` = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "
      "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "
      "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// Turns between the two consumer warpgroups (named barriers 1 and 2, 256
// threads): a warpgroup issues its S = Q.K^T only in its turn, so one
// warpgroup's softmax runs while the other's products use the tensor
// cores.  Warpgroup 0 takes the first turn without waiting; each turn ends
// by handing the next one to the other warpgroup, except warpgroup 1's
// last, so no arrival is left pending at exit.
__device__ __forceinline__ void turn_begin(int wg, int j) {
  if (wg == 1 || j > 0) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_end(int wg, int j, int n) {
  if (wg == 0 || j < n - 1) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// The mbarriers at `at`: `once` completes when the CTA's own tiles (loaded
// once) have landed; each ring stage has a "full" barrier (the producer's
// expected bytes, completed by TMA) and an "empty" one (one arrival per
// consumer warp).  Thread 0 initialises them, then the CTA syncs.
struct Ring {
  uint64_t* once;
  uint64_t* full;
  uint64_t* empty;
};
constexpr int kRingBarBytes = (1 + 2 * kStages) * 8;

__device__ __forceinline__ Ring init_ring(uint8_t* at) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(at);
  const Ring ring{bars, bars + 1, bars + 1 + kStages};
  if (threadIdx.x == 0) {
    mbar_init(ring.once, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return ring;
}

// Producer, step `it` of its loop: wait until the step's stage is free,
// announce `bytes` of TMA traffic into it; returns the stage.
__device__ __forceinline__ int ring_fill(const Ring& r, int it, uint32_t bytes) {
  const int s = it % kStages;
  mbar_wait(&r.empty[s], ((it / kStages) & 1) ^ 1);
  mbar_expect_tx(&r.full[s], bytes);
  return s;
}

// Consumer, step `it`: wait until the step's stage has landed; returns it.
__device__ __forceinline__ int ring_take(const Ring& r, int it) {
  const int s = it % kStages;
  mbar_wait(&r.full[s], (it / kStages) & 1);
  return s;
}

// The forward's and dQ's producer: K and V tiles of BK keys, blocks 0 ..
// nk - 1, into the stages at k_ring and v_ring.
template <int D, int BK>
__device__ __forceinline__ void produce_kv(const Ring& r, uint8_t* k_ring, uint8_t* v_ring,
                                           const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                           int h, int b, int nk) {
  constexpr int kTileBytes = BK * D * 2;
  for (int j = 0; j < nk; ++j) {
    const int s = ring_fill(r, j, 2 * kTileBytes);
    tma_tile<D>(k_ring + s * kTileBytes, tm_k, &r.full[s], h, j * BK, b, BK);
    tma_tile<D>(v_ring + s * kTileBytes, tm_v, &r.full[s], h, j * BK, b, BK);
  }
}

// A consumer thread's place in the CTA's 128 rows from r0 (query rows in
// the forward and dQ, keys in dK/dV): warpgroup wg owns rows first ..
// first + 63; in its warp's 16 the thread holds rows `row` and `row + 8`
// of the accumulator fragment, columns c0, c0 + 1 of every 8.
struct Frag {
  int wg, lane, c0, first, row;
};

__device__ __forceinline__ Frag frag_at(int r0) {
  Frag f;
  f.wg = threadIdx.x / 128 - 1;
  f.lane = threadIdx.x % 32;
  f.c0 = 2 * (f.lane % 4);
  f.first = r0 + 64 * f.wg;
  f.row = f.first + 16 * ((threadIdx.x / 32) % 4) + f.lane / 4;
  return f;
}

// Causal, the forward and dQ: a warpgroup's query rows against keys k0 ..
// k0 + bk - 1.  The block is live unless every key lies past every row;
// it needs the mask when some key lies past some row.
__device__ __forceinline__ bool block_live(bool causal, const Frag& f, int k0) {
  return !causal || k0 <= f.first + 63;
}
__device__ __forceinline__ bool block_diag(bool causal, const Frag& f, int k0, int bk) {
  return causal && k0 + bk - 1 > f.first;
}
// Whether element i of the fragment of an S block from key k0 is masked:
// its key lies past its query row.
__device__ __forceinline__ bool key_past_row(const Frag& f, int i, int k0) {
  return k0 + 8 * (i >> 2) + f.c0 + (i & 1) > f.row + 8 * ((i >> 1) & 1);
}

// This thread's fragment of a 64 x D f32 accumulator, row r's values
// divided by den[r], as bf16 pairs into rows f.row and f.row + 8 of head
// h, batch b of a [B, T, H, D] tensor.
template <int D>
__device__ __forceinline__ void store_frag(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           const float (&den)[2], const Frag& f, int b, int h,
                                           int seq, int heads) {
  const size_t rs = static_cast<size_t>(heads) * D;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __nv_bfloat16* at =
        out + (static_cast<size_t>(b) * seq + f.row + 8 * half) * rs + static_cast<size_t>(h) * D;
#pragma unroll
    for (int jn = 0; jn < D / 8; ++jn)
      *reinterpret_cast<uint32_t*>(at + 8 * jn + f.c0) =
          pack_bf16(acc[4 * jn + 2 * half] / den[half], acc[4 * jn + 2 * half + 1] / den[half]);
  }
}

// ---------------------------------------------------------------------------
// Forward.

// One block of the online softmax on this thread's fragment of S (rows
// f.row and f.row + 8, columns k0 + 8j + f.c0 + {0, 1}), in place: the
// f32 scores become p = exp(scale * s - m_new), masked ones (under `diag`,
// keys past the row) -1e30 before the exp; m and l move to the new
// running max and sum, and corr gets exp(m_old - m_new), the factor the
// accumulator must be rescaled by.
template <int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], float scale, bool diag, int k0,
                                               const Frag& f) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int half = (i >> 1) & 1;
    float x = scale * sc[i];
    if (diag && key_past_row(f, i, k0)) x = kNegInf;
    sc[i] = x;
    mx[half] = fmaxf(mx[half], x);
  }
  float ml[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp2f((m[r] - m_new) * kLog2e);
    m[r] = m_new;
    ml[r] = m_new * kLog2e;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int half = (i >> 1) & 1;
    sc[i] = exp2f(fmaf(sc[i], kLog2e, -ml[half]));  // exp(s - m), f32
    sum[half] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
    l[r] = l[r] * corr[r] + sum[r];
  }
}

template <int D>
struct Fwd {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128 or 256");
  static constexpr int kRows = 128;               // query rows per CTA
  static constexpr int kBK = D == 256 ? 64 : 128;  // keys per ring buffer
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kK = kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kSmem = kBar + kRingBarBytes + kSlack;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int seq, int heads, float scale, int causal) {
  using C = Fwd<D>;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Ring ring = init_ring(smem + C::kBar);
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;  // heaviest causal blocks first
  const int nk = causal ? (q0 + C::kRows - 1) / BK + 1 : seq / BK;

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.once, C::kQBytes);
      tma_tile<D>(smem, &tm_q, ring.once, h, q0, b, C::kRows);
      produce_kv<D, BK>(ring, smem + C::kK, smem + C::kV, &tm_k, &tm_v, h, b, nk);
    }
  } else {  // consumer warpgroups
    regs_inc<240>();
    const Frag f = frag_at(q0);
    const uint8_t* q_tile = smem + f.wg * 64 * kRowBytes;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(ring.once, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = ring_take(ring, j), k0 = j * BK;
      turn_begin(f.wg, j);
      if (block_live(causal, f, k0)) {
        const uint8_t* k_tile = smem + C::kK + s * C::kTileBytes;
        const uint8_t* v_tile = smem + C::kV + s * C::kTileBytes;
        float sc[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(sc, kmajor_desc<C::kRows>(q_tile, kk), kmajor_desc<BK>(k_tile, kk), kk > 0);
        wgmma_commit();
        turn_end(f.wg, j, nk);
        wgmma_wait_all();
        fence_regs(sc);

        float corr[2];
        online_softmax(sc, m, l, corr, scale, block_diag(causal, f, k0, BK), k0, f);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        uint32_t pa[BK / 16][4];
        to_a_frags(sc, pa);  // p rounded to V's dtype

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, pa[kk], mnmajor_desc<BK>(v_tile, kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      } else {
        turn_end(f.wg, j, nk);
      }
      if (f.lane == 0) mbar_arrive(&ring.empty[s]);
    }

    store_frag<D>(o, acc, l, f, b, h, seq, heads);
    if (f.lane % 4 == 0) {
      lse[static_cast<size_t>(bh) * seq + f.row] = m[0] + logf(l[0]);
      lse[static_cast<size_t>(bh) * seq + f.row + 8] = m[1] + logf(l[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward: delta pre-pass, dQ and dK/dV.

// delta[b*H + h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d] in f32; D / 8
// threads per (b, t, h) row, one 16-byte load of each input each.
template <int D>
__global__ void __launch_bounds__(256)
    fa_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
                        float* __restrict__ delta, int rows, int seq, int heads) {
  constexpr int kPerRow = D / 8;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gid / kPerRow, part = gid % kPerRow;  // row = (b * seq + t) * heads + h
  float sum = 0.f;
  if (row < rows) {
    const uint4 a = reinterpret_cast<const uint4*>(o + static_cast<size_t>(row) * D)[part];
    const uint4 g = reinterpret_cast<const uint4*>(dout + static_cast<size_t>(row) * D)[part];
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 x = __bfloat1622float2(a2[u]), y = __bfloat1622float2(g2[u]);
      sum += y.x * x.x;
      sum += y.y * x.y;
    }
  }
#pragma unroll
  for (int w = kPerRow / 2; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (row < rows && part == 0) {
    const int h = row % heads, t = (row / heads) % seq, b = row / (heads * seq);
    delta[(static_cast<size_t>(b) * heads + h) * seq + t] = sum;
  }
}

template <int D>
struct Dq {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int kRows = 128;  // query rows per CTA
  static constexpr int kBK = 64;     // keys per ring buffer
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kDO = kQBytes;
  static constexpr int kK = 2 * kQBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kTileBytes;
  static constexpr int kSmem = kBar + kRingBarBytes + kSlack;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int seq, int heads, float scale,
                          int causal) {
  using C = Dq<D>;
  constexpr int BK = C::kBK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const Ring ring = init_ring(smem + C::kBar);
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::kRows;  // heaviest causal blocks first
  const int nk = causal ? (q0 + C::kRows - 1) / BK + 1 : seq / BK;

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.once, 2 * C::kQBytes);
      tma_tile<D>(smem, &tm_q, ring.once, h, q0, b, C::kRows);
      tma_tile<D>(smem + C::kDO, &tm_do, ring.once, h, q0, b, C::kRows);
      produce_kv<D, BK>(ring, smem + C::kK, smem + C::kV, &tm_k, &tm_v, h, b, nk);
    }
  } else {  // consumer warpgroups
    regs_inc<240>();
    const Frag f = frag_at(q0);
    const uint8_t* q_tile = smem + f.wg * 64 * kRowBytes;
    const uint8_t* do_tile = smem + C::kDO + f.wg * 64 * kRowBytes;
    const size_t at = static_cast<size_t>(bh) * seq + f.row;
    const float row_lse[2] = {lse[at], lse[at + 8]};
    const float row_delta[2] = {delta[at], delta[at + 8]};
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(ring.once, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = ring_take(ring, j), k0 = j * BK;
      if (block_live(causal, f, k0)) {
        const uint8_t* k_tile = smem + C::kK + s * C::kTileBytes;
        const uint8_t* v_tile = smem + C::kV + s * C::kTileBytes;
        float sc[BK / 2], dp[BK / 2];  // S and dP: rows query rows, columns keys
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(sc, kmajor_desc<C::kRows>(q_tile, kk), kmajor_desc<BK>(k_tile, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dp, kmajor_desc<C::kRows>(do_tile, kk), kmajor_desc<BK>(v_tile, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        fence_regs(dp);

        const bool diag = block_diag(causal, f, k0, BK);
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int half = (i >> 1) & 1;
          float x = scale * sc[i];
          if (diag && key_past_row(f, i, k0)) x = kNegInf;
          const float p = exp2f((x - row_lse[half]) * kLog2e);  // exp(s - lse)
          dp[i] = p * (dp[i] - row_delta[half]) * scale;       // dS
        }
        uint32_t dsa[BK / 16][4];
        to_a_frags(dp, dsa);  // dS rounded to K's dtype

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs(acc, dsa[kk], mnmajor_desc<BK>(k_tile, kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }
      if (f.lane == 0) mbar_arrive(&ring.empty[s]);
    }

    const float one[2] = {1.f, 1.f};
    store_frag<D>(dq, acc, one, f, b, h, seq, heads);
  }
}

template <int D>
struct Dkv {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int kKeys = 128;  // keys per CTA
  static constexpr int kBQ = 64;     // query rows per ring buffer
  static constexpr int kKVBytes = kKeys * D * 2;
  static constexpr int kTileBytes = kBQ * D * 2;
  static constexpr int kV = kKVBytes;
  static constexpr int kQ = 2 * kKVBytes;
  static constexpr int kDO = kQ + kStages * kTileBytes;
  static constexpr int kLse = kDO + kStages * kTileBytes;
  static constexpr int kDelta = kLse + kStages * kBQ * 4;
  static constexpr int kBar = kDelta + kStages * kBQ * 4;
  static constexpr int kSmem = kBar + kRingBarBytes + kSlack;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    fa_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int seq,
                           int heads, float scale, int causal) {
  using C = Dkv<D>;
  constexpr int BQ = C::kBQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  float* lse_s = reinterpret_cast<float*>(smem + C::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + C::kDelta);
  const Ring ring = init_ring(smem + C::kBar);
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.y * C::kKeys;  // the lowest (heaviest causal) K blocks first
  const int first = causal ? k0 / BQ : 0, nq = seq / BQ;

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<24>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(ring.once, 2 * C::kKVBytes);
      tma_tile<D>(smem, &tm_k, ring.once, h, k0, b, C::kKeys);
      tma_tile<D>(smem + C::kV, &tm_v, ring.once, h, k0, b, C::kKeys);
      for (int i = first; i < nq; ++i) {
        const int s = ring_fill(ring, i - first, 2 * C::kTileBytes + 2 * BQ * 4);
        tma_tile<D>(smem + C::kQ + s * C::kTileBytes, &tm_q, &ring.full[s], h, i * BQ, b, BQ);
        tma_tile<D>(smem + C::kDO + s * C::kTileBytes, &tm_do, &ring.full[s], h, i * BQ, b, BQ);
        const size_t off = static_cast<size_t>(bh) * seq + i * BQ;
        bulk_copy(lse_s + s * BQ, lse + off, BQ * 4, &ring.full[s]);
        bulk_copy(delta_s + s * BQ, delta + off, BQ * 4, &ring.full[s]);
      }
    }
  } else {  // consumer warpgroups
    regs_inc<240>();
    const Frag f = frag_at(k0);  // the fragment's rows are keys: f.row and f.row + 8
    const uint8_t* k_tile = smem + f.wg * 64 * kRowBytes;
    const uint8_t* v_tile = smem + C::kV + f.wg * 64 * kRowBytes;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    mbar_wait(ring.once, 0);
    for (int i = first; i < nq; ++i) {
      const int s = ring_take(ring, i - first), q0 = i * BQ;
      if (!causal || q0 + BQ - 1 >= f.first) {  // else every row precedes every key
        const uint8_t* q_tile = smem + C::kQ + s * C::kTileBytes;
        const uint8_t* do_tile = smem + C::kDO + s * C::kTileBytes;
        float st[BQ / 2], dpt[BQ / 2];  // S^T and dP^T: rows keys, columns query rows
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(st, kmajor_desc<C::kKeys>(k_tile, kk), kmajor_desc<BQ>(q_tile, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss(dpt, kmajor_desc<C::kKeys>(v_tile, kk), kmajor_desc<BQ>(do_tile, kk), kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        const bool diag = causal && q0 < f.first + 63;  // some key past some row
        const float* lse_q = lse_s + s * BQ;
        const float* delta_q = delta_s + s * BQ;
#pragma unroll
        for (int jn = 0; jn < BQ / 8; ++jn) {
          const float2 lq = *reinterpret_cast<const float2*>(lse_q + 8 * jn + f.c0);
          const float2 dl = *reinterpret_cast<const float2*>(delta_q + 8 * jn + f.c0);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jn + e, half = e >> 1, col = e & 1;
            float x = scale * st[i];
            if (diag && f.row + 8 * half > q0 + 8 * jn + f.c0 + col) x = kNegInf;
            const float p = exp2f((x - (col ? lq.y : lq.x)) * kLog2e);  // exp(s - lse)
            st[i] = p;
            dpt[i] = p * (dpt[i] - (col ? dl.y : dl.x)) * scale;  // dS
          }
        }
        uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
        to_a_frags(st, pa);    // P rounded to dO's dtype
        to_a_frags(dpt, dsa);  // dS rounded to Q's dtype

        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dv_acc, pa[kk], mnmajor_desc<BQ>(do_tile, kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          wgmma_rs(dk_acc, dsa[kk], mnmajor_desc<BQ>(q_tile, kk), 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      if (f.lane == 0) mbar_arrive(&ring.empty[s]);
    }

    const float one[2] = {1.f, 1.f};
    store_frag<D>(dk, dk_acc, one, f, b, h, seq, heads);
    store_frag<D>(dv, dv_acc, one, f, b, h, seq, heads);
  }
}

// ---------------------------------------------------------------------------
// Host side.

// Tensor map of a [B, T, H, D] bf16 tensor, box 64 columns x 1 head x
// `rows` rows x 1 batch, 128-byte swizzle.
cudaError_t tile_map(CUtensorMap* map, const void* base, int B, int seq, int heads, int D,
                     int rows) {
  EncodeTiled encode;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(heads) * D * 2,
                                 static_cast<cuuint64_t>(seq) * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// tile_map of each input base[i] with boxes of rows[i] rows.
template <int N>
cudaError_t tile_maps(CUtensorMap (&maps)[N], const void* const (&base)[N], const int (&rows)[N],
                      int B, int seq, int heads, int D) {
  for (int i = 0; i < N; ++i) {
    const cudaError_t err = tile_map(&maps[i], base[i], B, seq, heads, D, rows[i]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Lift the 48 KB default for `kernel` once per instantiation (the first
// call is made outside any CUDA graph capture).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

template <int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o, float* lse, int B, int seq,
                int heads, float scale, bool causal, cudaStream_t stream) {
  using C = Fwd<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(fa_fwd_sm90_kernel<D>, C::kSmem, &ready);
  CUtensorMap m[3];  // q, k, v
  if (err == cudaSuccess)
    err = tile_maps(m, {q, k, v}, {C::kRows, C::kBK, C::kBK}, B, seq, heads, D);
  if (err != cudaSuccess) return err;
  fa_fwd_sm90_kernel<D><<<dim3(B * heads, seq / C::kRows), kThreads, C::kSmem, stream>>>(
      m[0], m[1], m[2], static_cast<__nv_bfloat16*>(o), lse, seq, heads, scale, causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_delta(const void* o, const void* dout, float* delta, int B, int seq, int heads,
                      cudaStream_t stream) {
  const int rows = B * seq * heads;
  const int blocks = (rows * (D / 8) + 255) / 256;
  fa_bwd_delta_kernel<D><<<blocks, 256, 0, stream>>>(static_cast<const __nv_bfloat16*>(o),
                                                      static_cast<const __nv_bfloat16*>(dout),
                                                      delta, rows, seq, heads);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int B, int seq, int heads,
                   float scale, bool causal, cudaStream_t stream) {
  using C = Dq<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(fa_bwd_dq_sm90_kernel<D>, C::kSmem, &ready);
  CUtensorMap m[4];  // q, k, v, dout
  if (err == cudaSuccess)
    err = tile_maps(m, {q, k, v, dout}, {C::kRows, C::kBK, C::kBK, C::kRows}, B, seq, heads, D);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_sm90_kernel<D><<<dim3(B * heads, seq / C::kRows), kThreads, C::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), seq, heads, scale,
      causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                    const float* lse, const float* delta, void* dk, void* dv, int B, int seq,
                    int heads, float scale, bool causal, cudaStream_t stream) {
  using C = Dkv<D>;
  static bool ready = false;
  cudaError_t err = allow_smem(fa_bwd_dkv_sm90_kernel<D>, C::kSmem, &ready);
  CUtensorMap m[4];  // q, k, v, dout
  if (err == cudaSuccess)
    err = tile_maps(m, {q, k, v, dout}, {C::kBQ, C::kKeys, C::kKeys, C::kBQ}, B, seq, heads, D);
  if (err != cudaSuccess) return err;
  fa_bwd_dkv_sm90_kernel<D><<<dim3(B * heads, seq / C::kKeys), kThreads, C::kSmem, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), seq, heads, scale, causal);
  return cudaGetLastError();
}

// Sizes the kernels take: T a positive multiple of 128, B*H within the
// grid's x limit and D in {64, 128, 256} (64 or 128 for the backward).
bool takes(int B, int seq, int heads) {
  return B >= 1 && heads >= 1 && static_cast<long long>(B) * heads <= 65535 && seq >= 128 &&
         seq % 128 == 0;
}

}  // namespace

// True when the backward launches below (delta, dQ, dK/dV) take head dim D.
bool flash_attention_sm90_bwd_takes(int D) { return D == 64 || D == 128; }

// Called by flash_attention_op.cpp.  q, k, v, o, dout, dq, dk, dv are
// contiguous, 16-byte aligned [B, T, H, D] bf16; lse and delta are
// [B*H, T] f32 (the delta launch fills delta, which the dQ and dK/dV
// launches read).  Each returns cudaGetLastError() after its launch, or
// cudaErrorInvalidValue for sizes the kernels do not take.
cudaError_t flash_attention_sm90_fwd_launch(const void* q, const void* k, const void* v, void* o,
                                            float* lse, int B, int seq, int heads, int D,
                                            float scale, bool causal, cudaStream_t stream) {
  if (!takes(B, seq, heads)) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return fwd<64>(q, k, v, o, lse, B, seq, heads, scale, causal, stream);
    case 128: return fwd<128>(q, k, v, o, lse, B, seq, heads, scale, causal, stream);
    case 256: return fwd<256>(q, k, v, o, lse, B, seq, heads, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_attention_sm90_bwd_delta_launch(const void* o, const void* dout, float* delta,
                                                  int B, int seq, int heads, int D,
                                                  cudaStream_t stream) {
  if (!takes(B, seq, heads)) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return bwd_delta<64>(o, dout, delta, B, seq, heads, stream);
    case 128: return bwd_delta<128>(o, dout, delta, B, seq, heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_attention_sm90_bwd_dq_launch(const void* q, const void* k, const void* v,
                                               const void* dout, const float* lse,
                                               const float* delta, void* dq, int B, int seq,
                                               int heads, int D, float scale, bool causal,
                                               cudaStream_t stream) {
  if (!takes(B, seq, heads)) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return bwd_dq<64>(q, k, v, dout, lse, delta, dq, B, seq, heads, scale, causal, stream);
    case 128:
      return bwd_dq<128>(q, k, v, dout, lse, delta, dq, B, seq, heads, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t flash_attention_sm90_bwd_dkv_launch(const void* q, const void* k, const void* v,
                                                const void* dout, const float* lse,
                                                const float* delta, void* dk, void* dv, int B,
                                                int seq, int heads, int D, float scale,
                                                bool causal, cudaStream_t stream) {
  if (!takes(B, seq, heads)) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, seq, heads, scale, causal, stream);
    case 128:
      return bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, seq, heads, scale, causal,
                          stream);
    default: return cudaErrorInvalidValue;
  }
}
