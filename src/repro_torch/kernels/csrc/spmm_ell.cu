// ELLPACK SpMM: out[i, :] = sum_d val[i, d] * x[idx[i, d], :], fp32.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell.py:spmm_ell_pallas
// (_spmm_ell_kernel, the f32 form): the exact intra-batch messages C_in X_B
// of core/message_passing.py:intra_messages, and the full-graph SpMM of
// the backbones' full_apply.
//
// What bounds it on an H100: memory traffic, and at the serving shape
// (b = 256 rows, D = 18 slots, f = 128) launch latency.  The work is
// 2*b*D*f = 1.2 MFLOP against ~0.3 MB (ids, values, the [b, f] source read
// once and the output): a fraction of a microsecond at 3.35 TB/s, so one
// launch costs more than the bytes do.
//
// Design: one block per output row, one thread per output column (column
// loads of a gathered source row are coalesced across the block).  The
// loop over the D slots runs in order with an fp32 accumulator, like the
// Pallas kernel's fori_loop, each multiply and add rounded on its own
// (no FMA contraction) -- the plain version's order, bit for bit.
// Padding slots (val == 0) are multiplied, not skipped, exactly as in the
// reference; an index outside [0, n_src) is clamped, which is also what a
// JAX gather does.  The source stays in L2
// (128 KiB at the serving shape), so no shared-memory staging is needed.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
spmm_ell_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const float* __restrict__ x, float* __restrict__ out,
                int deg, int n_src, int f) {
  const long long row = blockIdx.x;
  const int* ir = idx + row * deg;
  const float* vr = val + row * deg;
  for (int c = threadIdx.x; c < f; c += blockDim.x) {
    float acc = 0.f;
    for (int d = 0; d < deg; ++d) {
      const int j = min(max(ir[d], 0), n_src - 1);
      acc = __fadd_rn(acc, __fmul_rn(vr[d], x[(size_t)j * f + c]));
    }
    out[row * f + c] = acc;
  }
}

}  // namespace

// idx/val: [b, deg] contiguous int32/fp32; x: [n_src, f] contiguous fp32;
// out: [b, f] contiguous fp32.
extern "C" cudaError_t repro_spmm_ell_f32(const int* idx, const float* val,
                                          const float* x, float* out, int b,
                                          int deg, int n_src, int f,
                                          cudaStream_t stream) {
  if (b < 1 || f < 1 || deg < 0 || (deg > 0 && n_src < 1))
    return cudaErrorInvalidValue;
  int threads = ((f + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  spmm_ell_kernel<<<(unsigned)b, threads, 0, stream>>>(idx, val, x, out, deg,
                                                       n_src, f);
  return cudaGetLastError();
}
