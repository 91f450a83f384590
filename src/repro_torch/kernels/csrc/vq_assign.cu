// Nearest-codeword assignment for every product-VQ branch in one launch.
//
// Replaces the TPU kernel src/repro/kernels/vq_assign.py:vq_assign_pallas
// (_vq_assign_kernel), which core/codebook.py:assign_features_only vmaps
// over the branches.  For branch b and row i it returns
//     argmin_c  |cw[b, c]|^2 - 2 x[b, i] . cw[b, c]
// with the first (lowest) index winning ties, like jnp.argmin and the
// Pallas kernel's strict-< tile combine, and optionally (the Pallas
// kernel's want_min) each row's squared distance to that codeword,
// max(min + |x|^2, 0), |x|^2 summed over j in order.  Both are the plain
// version's (ref.vq_assign) bit for bit.
//
// What bounds it on an H100.  At the served widths (n = 169,343 nodes,
// k = 1024, 32 branches of width 4, or 8 of width 16) a call computes
// nb*n*k = 5.55e9 or 1.39e9 distances: 44 GFLOP of products, ~90 MB of
// input.  The first version (one thread a row, every codeword scanned on
// the CUDA cores with each multiply and add rounded on its own, as the
// plain version rounds) issued ~11 fp32 instructions a distance at f 4 and
// took 2.93 ms there, 2.34 ms at f 16: issue-bound.  Here the distances
// run on the tensor cores and what is left is the products (3xTF32: 0.27
// ms at the 495 TFLOP/s TF32 peak for either served shape; mma.sync, not
// wgmma, reaches well under that peak) beside the compare-selects that
// fold the approximate distances and the loads that feed both.
//
// Design: vq_update's scan (vq_update.cuh, whose header gives the argument
// for exactness and the bound E) instantiated without the cluster
// statistics: 3xTF32 mma.sync products accumulated onto |c|^2, the fold of
// a lane's distances over groups of codewords, rows settled by the bound E
// (the winning group rescored exactly) or queued per warp and every
// codeword within 2E rescored exactly in index order with a strict <.  So
// idx, and the minimum that want_min completes, are the plain version's.
// What differs from vq_update:
//   * x is read through its strides: the caller passes the branch view
//     [nb, n, f] of an [n, nb * f] activation table (core/codebook.py), with
//     no transposing copy; a warp stages its rows in shared memory;
//   * no statistics: a row's idx (and min) is written by the lane that
//     settles or rescores it;
//   * its own kernel, vq_assign_kernel, two blocks an SM at the served
//     widths (one block's 8 warps left the latencies exposed);
//   * the served widths have scans of their own shape (Cfg in
//     vq_update.cuh), each picked by timing the alternatives on the card.
//     f 4: 4-deep k-steps, which need no padding (8-deep steps
//     would be half zeros), the two small products of a step in one
//     m16n8k8 and hi * hi in an m16n8k4; the codewords' hi / lo parts
//     staged in shared memory once per branch, one 8-byte read a tile and
//     lane; groups of 4 tiles, a lane's 8 codewords a row folded at once
//     (1.5 instructions a distance where pairs of tiles took 2).  f 16:
//     m16n8k8 over 2 k-steps with pairs of tiles, each pair folded before
//     the next one's mmas (vq_update's pipelining of the pairs kept more
//     distances live than 2 blocks' registers hold, and spilled), and its
//     codewords swizzled against the 4-way bank conflicts of their
//     fragment loads.  Any other f <= 32 takes the generic instantiation.
// k is bounded by shared memory alone (vq_assign.py:smem_bytes mirrors
// smem_base): at f 4 the codewords, their hi / lo pairs and |c|^2 take
// 52 KiB at k 1024.
#include "vq_update.cuh"

// x: [nb, n, f] fp32 with strides (x_stride_branch, x_stride_row, 1) in
// elements; cw: [nb, k, f] contiguous fp32; out: [nb, n] contiguous int32;
// min_out: nullptr, or [nb, n] contiguous fp32 for the squared distances.
extern "C" cudaError_t repro_vq_assign_f32(const float* x,
                                           long long x_stride_branch,
                                           long long x_stride_row,
                                           const float* cw, int* out,
                                           float* min_out, int nb, int n,
                                           int k, int f,
                                           cudaStream_t stream) {
  if (f < 1 || f > kMaxF || k < 1 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
  switch (f) {
    case 4:
      return launch<4, int, false>(x, x_stride_branch, x_stride_row, cw, out,
                                   min_out, nullptr, nullptr, nb, n, k, f,
                                   stream);
    case 16:
      return launch<16, int, false>(x, x_stride_branch, x_stride_row, cw,
                                    out, min_out, nullptr, nullptr, nb, n, k,
                                    f, stream);
    default:
      return launch<0, int, false>(x, x_stride_branch, x_stride_row, cw, out,
                                   min_out, nullptr, nullptr, nb, n, k, f,
                                   stream);
  }
}

// The wide build (vq_update.cuh: f > 32, or a codebook beyond the narrow
// build's shared memory; any f <= kWideMaxF and any k), the same contract
// as repro_vq_assign_f32; scratch: wide_scratch_floats(nb, k, f) fp32 that
// the launch fills (the queued-row counter, |c|^2, the split codewords).
extern "C" cudaError_t repro_vq_assign_wide_f32(
    const float* x, long long x_stride_branch, long long x_stride_row,
    const float* cw, float* scratch, int* out, float* min_out, int nb, int n,
    int k, int f, cudaStream_t stream) {
  return launch_wide<int, false>(x, x_stride_branch, x_stride_row, cw,
                                 scratch, out, min_out, nullptr, nullptr, nb,
                                 n, k, f, stream);
}

// The wide scan's approximate distances d~ themselves, for probing the
// tensor cores' accumulation: x [nb, n, f] and cw [nb, k, f] contiguous,
// d_out [nb, n, k_pad] fp32 (k_pad = 128 ceil(k / 128)).
extern "C" cudaError_t repro_vq_wide_probe_f32(
    const float* x, const float* cw, float* scratch, float* d_out, int nb,
    int n, int k, int f, cudaStream_t stream) {
  return launch_wide<int, false, true>(x, (long long)n * f, f, cw, scratch,
                                       nullptr, nullptr, nullptr, d_out, nb,
                                       n, k, f, stream);
}

// The wide launch's plan at width f with wgs warpgroups of 64 rows:
// out[0..3] = {rows split once (1) or a chunk at a time (0), K chunk,
// stages, shared memory bytes} (vq_update.py:wide_plan mirrors it).
extern "C" cudaError_t repro_vq_wide_plan(int f, int wgs, int* out) {
  return wide_plan_query(f, wgs, out);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
