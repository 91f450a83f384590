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
//
// Second entry point, repro_context_ell_wt_f32: the same accumulate
// followed by the epilogue  out[i, :] = acc[i, :] @ w_t  (w_t [nb*fb,
// f_out]) -- the _context_ell_wt_kernel form of context_ell_pallas, called
// by the Eq. 7 backward injection (core/message_passing.py:
// inject_context_grad) with reverse-edge operands, the gradient codewords
// and w_t = W^T.  The Pallas kernel does the @ W^T on its MXU inside the
// kernel body, so the epilogue belongs here too, not in a matmul after it.
// What bounds it: at the training shape (b = 42,335 rows, Dr = 18 reverse
// slots, nb*fb = 128 or 40 columns, f_out = 128) the epilogue is 2*b*128*
// 128 = 1.4 GFLOP (0.02 ms at 67 TFLOP/s) and the [b, f_out] output 21.7
// MB (0.0065 ms at 3.35 TB/s): both small, so latency and the L2 reads of
// w_t bound it.  Design: one block per kWtRows = 8 output rows; the block
// accumulates the rows' [8, nb*fb] context into shared memory exactly as
// the forward kernel does (same order, padding multiplied, ids clamped),
// then thread o computes out[r, o] for all 8 rows, summing over the
// columns c in order with each multiply and add rounded on its own (the
// plain version's loop, bit for bit) -- every w_t element read from L2
// serves 8 rows.
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

constexpr int kWtRows = 8;   // output rows per block of the w_t form

__global__ void __launch_bounds__(kMaxThreads)
context_ell_wt_kernel(const int* __restrict__ ids,
                      const float* __restrict__ vals,
                      const int* __restrict__ assign,
                      const float* __restrict__ cw,
                      const float* __restrict__ w_t, float* __restrict__ out,
                      int b, int deg, int n, int nb, int k, int f_blk,
                      int f_out) {
  extern __shared__ float acc_s[];               // [kWtRows, nb * f_blk]
  const int ncol = nb * f_blk;
  const long long row0 = (long long)blockIdx.x * kWtRows;
  const int rows = b - row0 < kWtRows ? (int)(b - row0) : kWtRows;
  for (int t = threadIdx.x; t < kWtRows * ncol; t += blockDim.x) {
    const int r = t / ncol;
    const int c = t - r * ncol;
    if (r >= rows) {          // rows past the end of the last block
      acc_s[t] = 0.f;
      continue;
    }
    const int br = c / f_blk;
    const int j = c - br * f_blk;
    const int* ir = ids + (row0 + r) * deg;
    const float* vr = vals + (row0 + r) * deg;
    const int* ab = assign + (size_t)br * n;
    const float* cb = cw + (size_t)br * k * f_blk;
    float acc = 0.f;
    for (int d = 0; d < deg; ++d) {
      const int id = min(max(ir[d], 0), n - 1);
      const int a = min(max(ab[id], 0), k - 1);
      acc = __fadd_rn(acc, __fmul_rn(vr[d], cb[(size_t)a * f_blk + j]));
    }
    acc_s[r * ncol + c] = acc;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < f_out; o += blockDim.x) {
    float y[kWtRows];
#pragma unroll
    for (int r = 0; r < kWtRows; ++r) y[r] = 0.f;
    for (int c = 0; c < ncol; ++c) {
      const float w = w_t[(size_t)c * f_out + o];
#pragma unroll
      for (int r = 0; r < kWtRows; ++r)
        y[r] = __fadd_rn(y[r], __fmul_rn(acc_s[r * ncol + c], w));
    }
#pragma unroll
    for (int r = 0; r < kWtRows; ++r)
      if (r < rows) out[(row0 + r) * f_out + o] = y[r];
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

// As repro_context_ell_f32, then the epilogue with w_t: [nb*f_blk, f_out]
// contiguous fp32; out: [b, f_out] contiguous fp32.
extern "C" cudaError_t repro_context_ell_wt_f32(
    const int* ids, const float* vals, const int* assign, const float* cw,
    const float* w_t, float* out, int b, int deg, int n, int nb, int k,
    int f_blk, int f_out, cudaStream_t stream) {
  if (b < 1 || deg < 1 || n < 1 || nb < 1 || k < 1 || f_blk < 1 || f_out < 1)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)kWtRows * nb * f_blk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      context_ell_wt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((b + kWtRows - 1) / kWtRows);
  context_ell_wt_kernel<<<blocks, kMaxThreads, smem, stream>>>(
      ids, vals, assign, cw, w_t, out, b, deg, n, nb, k, f_blk, f_out);
  return cudaGetLastError();
}
