// VQ-Update's int32 entries.
// Replaces the TPU kernel src/repro/kernels/vq_update.py:
// vq_assign_update_pallas with its int32 emit; the kernel and its notes
// are in vq_update.cuh.  The uint8 emit is
// built from vq_update_u8.cu, in parallel with this file (one file took
// twice as long to compile as any other source).
#include "vq_update.cuh"

// x: [nb, n, f] contiguous fp32; cw: [nb, k, f] contiguous fp32; idx: [nb, n]
// int32; qerr: [nb, n] fp32; counts: [nb, k] and sums: [nb, k, f] fp32,
// zeroed by the caller (the kernel accumulates into them).
extern "C" cudaError_t repro_vq_update_f32(const float* x, const float* cw,
                                           int* idx, float* qerr,
                                           float* counts, float* sums, int nb,
                                           int n, int k, int f,
                                           cudaStream_t stream) {
  return dispatch<int>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
}

// The generic-width instantiation at any f <= 32, the same contract as
// repro_vq_update_f32: for comparing it with the fixed-width builds.
extern "C" cudaError_t repro_vq_update_generic_f32(
    const float* x, const float* cw, int* idx, float* qerr, float* counts,
    float* sums, int nb, int n, int k, int f, cudaStream_t stream) {
  if (f < 1 || f > kMaxF || k < 1 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
  return launch<0, int, true>(x, (long long)n * f, f, cw, idx, qerr, counts,
                             sums, nb, n, k, f, stream);
}

// The wide build (vq_update.cuh): any f <= kWideMaxF and any k, the same
// contract as repro_vq_update_f32; scratch: wide_scratch_floats(nb, k, f)
// fp32 that the launch fills (the queued-row counter, |c|^2, the split
// codewords).
extern "C" cudaError_t repro_vq_update_wide_f32(
    const float* x, const float* cw, float* scratch, int* idx, float* qerr,
    float* counts, float* sums, int nb, int n, int k, int f,
    cudaStream_t stream) {
  return launch_wide<int, true>(x, (long long)n * f, f, cw, scratch, idx,
                                qerr, counts, sums, nb, n, k, f, stream);
}

// The same with the row tile set by the caller: wgs consumer warpgroups of
// 64 rows a block (1 or 2), the tuner's knob (kernels/autotune.py).
extern "C" cudaError_t repro_vq_update_wide_tiles_f32(
    const float* x, const float* cw, float* scratch, int* idx, float* qerr,
    float* counts, float* sums, int nb, int n, int k, int f, int wgs,
    cudaStream_t stream) {
  if (wgs < 1) return cudaErrorInvalidValue;
  return launch_wide<int, true>(x, (long long)n * f, f, cw, scratch, idx,
                                qerr, counts, sums, nb, n, k, f, stream, wgs);
}
