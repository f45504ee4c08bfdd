// The f32 instantiations of the flash-decode kernel (flash_decode.cuh;
// the design is described in flash_decode.cu), in a translation unit of
// their own so that nvcc builds them beside the bf16 ones.

#include "flash_decode.cuh"

// Called by flash_decode_launch (flash_decode.cu) once it has checked the
// sizes and made the plan (make_plan).
cudaError_t flash_decode_f32_launch(const void* q, const void* k, const void* v,
                                    const int* lengths, void* out, int B, int H, int KVH, int L,
                                    int D, float scale, int rows, int splits, bool tma,
                                    cudaStream_t stream) {
  return dispatch<float>(q, k, v, lengths, out, B, H, KVH, L, D, scale, Plan{rows, splits}, tma,
                         stream);
}
