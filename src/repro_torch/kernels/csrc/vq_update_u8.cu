// VQ-Update's uint8 emit.
// Replaces the TPU kernel src/repro/kernels/vq_update.py:
// vq_assign_update_pallas with a uint8 / uint4 emit_dtype; the kernel and
// its notes are in vq_update.cuh.
#include "vq_update.cuh"

// As repro_vq_update_f32 with idx: [nb, n] uint8 (k <= 256).
extern "C" cudaError_t repro_vq_update_u8_f32(const float* x, const float* cw,
                                              uint8_t* idx, float* qerr,
                                              float* counts, float* sums,
                                              int nb, int n, int k, int f,
                                              cudaStream_t stream) {
  if (k > 256) return cudaErrorInvalidValue;
  return dispatch<uint8_t>(x, cw, idx, qerr, counts, sums, nb, n, k, f,
                           stream);
}

// As repro_vq_update_wide_f32 with idx: [nb, n] uint8 (k <= 256).
extern "C" cudaError_t repro_vq_update_wide_u8_f32(
    const float* x, const float* cw, float* scratch, uint8_t* idx, float* qerr,
    float* counts, float* sums, int nb, int n, int k, int f,
    cudaStream_t stream) {
  if (k > 256) return cudaErrorInvalidValue;
  return launch_wide<uint8_t, true>(x, (long long)n * f, f, cw, scratch, idx,
                                    qerr, counts, sums, nb, n, k, f, stream);
}

// The same with the row tile set by the caller (wgs consumer warpgroups of
// 64 rows a block, 1 or 2), as repro_vq_update_wide_tiles_f32.
extern "C" cudaError_t repro_vq_update_wide_tiles_u8_f32(
    const float* x, const float* cw, float* scratch, uint8_t* idx,
    float* qerr, float* counts, float* sums, int nb, int n, int k, int f,
    int wgs, cudaStream_t stream) {
  if (k > 256 || wgs < 1) return cudaErrorInvalidValue;
  return launch_wide<uint8_t, true>(x, (long long)n * f, f, cw, scratch, idx,
                                    qerr, counts, sums, nb, n, k, f, stream,
                                    wgs);
}
