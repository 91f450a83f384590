// Fused multi-branch VQ-context SpMM (the Eq. 6 out-of-batch term), fp32:
//     out[i, b*fb + j] = sum_d val[i, d] * cw[b, A[b, ids[i, d]], j]
//
// Replaces the TPU kernel src/repro/kernels/context_ell.py:
// context_ell_pallas in its _context_ell_kernel form (fp32 codewords,
// int32 assignment table, no w_t epilogue), called by
// core/message_passing.py:context_messages_reconstruct.
//
// What bounds it on an H100: memory latency of two dependent gathers per
// slot (node id -> codeword id -> codeword row) and, at the serving shape
// (b = 256, D = 18, 128 output columns), launch latency.  The bytes it
// needs are small: ids and values (37 KB), the assignment entries of the
// touched nodes (<= b*D*nb*4 = 590 KB at nb = 32) and the touched codeword
// rows (<= 512 KiB at nb = 32, k = 1024, fb = 4), well under 1 us of
// bandwidth.
//
// Design: one block per output row, one thread per output column c (nb*fb
// = 128 columns in every served layer).  Column c belongs to branch
// b = c / fb.  For every slot the thread reads A[b, id] from the [nb, n]
// table in place -- the Pallas kernel's transposed [n, nb] copy would cost
// 21.7 MB per layer per step at n = 169,343 -- then the codeword element.
// The fb threads of one branch share each assignment read, and the
// codeword tables stay resident in the 50 MB L2.  The D loop runs in
// order with an fp32 accumulator, each multiply and add rounded on its
// own (the plain version's order, bit for bit); padding slots (val == 0)
// are multiplied, not skipped; out-of-range ids are clamped as a JAX
// gather would.  D == 0 never reaches the kernel: the wrapper returns zeros.
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
context_ell_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                   const int* __restrict__ assign,
                   const float* __restrict__ cw, float* __restrict__ out,
                   int deg, int n, int nb, int k, int f_blk) {
  const long long row = blockIdx.x;
  const int ncol = nb * f_blk;
  const int* ir = ids + row * deg;
  const float* vr = vals + row * deg;
  for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
    const int br = c / f_blk;
    const int j = c - br * f_blk;
    const int* ab = assign + (size_t)br * n;
    const float* cb = cw + (size_t)br * k * f_blk;
    float acc = 0.f;
    for (int d = 0; d < deg; ++d) {
      const int id = min(max(ir[d], 0), n - 1);
      const int a = min(max(ab[id], 0), k - 1);
      acc = __fadd_rn(acc, __fmul_rn(vr[d], cb[(size_t)a * f_blk + j]));
    }
    out[row * ncol + c] = acc;
  }
}

}  // namespace

// ids/vals: [b, deg] contiguous int32/fp32 (deg >= 1); assign: [nb, n]
// contiguous int32; cw: [nb, k, f_blk] contiguous fp32; out: [b, nb*f_blk].
extern "C" cudaError_t repro_context_ell_f32(const int* ids, const float* vals,
                                             const int* assign,
                                             const float* cw, float* out,
                                             int b, int deg, int n, int nb,
                                             int k, int f_blk,
                                             cudaStream_t stream) {
  if (b < 1 || deg < 1 || n < 1 || nb < 1 || k < 1 || f_blk < 1)
    return cudaErrorInvalidValue;
  int threads = ((nb * f_blk + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  context_ell_kernel<<<(unsigned)b, threads, 0, stream>>>(
      ids, vals, assign, cw, out, deg, n, nb, k, f_blk);
  return cudaGetLastError();
}
