// Fused multi-branch VQ-context SpMM (the Eq. 6 out-of-batch term):
//     out[i, b*fb + j] = sum_d val[i, d] * cw[b, A[b, ids[i, d]], j]
//
// Replaces the TPU kernel src/repro/kernels/context_ell.py:
// context_ell_pallas in its _context_ell_kernel form (fp32 codewords,
// int32 assignment table, no w_t epilogue), called by
// core/message_passing.py:context_messages_reconstruct, and in the forms
// of the precision tiers (see "Precision tiers" below).
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
// Second form, repro_context_ell_wt_f32_i32: the same accumulate
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
//
// Precision tiers: _context_ell_q_kernel, _context_ell_q_wt_kernel and the
// uint8 and nibble-packed branches of _accumulate.  Both kernels are
// templates on the codeword type (float, int8_t, __nv_fp8_e4m3) and on the
// table (int32, uint8 [nb, n], or nibble-packed [nb, ceil(n/2)] uint8 with
// node v's id in the byte v >> 1 at bit (v & 1) * 4), with one extern "C"
// entry per pair: repro_context_ell[_wt]_<f32|i8|f8>_<i32|u8|a4>.  A 1-byte
// codeword widens to fp32 exactly, the slots accumulate in the fp32
// kernels' order, and the [nb, 1, fb] scale (read as the flat [nb*fb] row)
// multiplies once after the last slot -- before the w_t columns are summed,
// as the Pallas kernel dequantizes before its W^T matmul -- so every form
// is bit-equal to the plain version.  The table is read in place in its
// storage type, never widened: the uint8 table is 4x and the packed one 8x
// smaller than int32, which is what the tiers are for (21.7 MB -> 5.4 /
// 2.7 MB per layer at n = 169,343, nb = 32).  What bounds them is what
// bounds the fp32 forms: latency of the dependent gathers, now of 1-byte
// table entries and codeword elements.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kWtRows = 8;   // output rows per block of the w_t form

// table kinds
constexpr int kI32 = 0;      // int32 [nb, n]
constexpr int kU8 = 1;       // uint8 [nb, n]
constexpr int kA4 = 2;       // nibble-packed uint8 [nb, ceil(n / 2)]

template <int Tab>
__device__ __forceinline__ int table_id(const void* __restrict__ assign,
                                        int br, int n, int id) {
  if (Tab == kI32) {
    return static_cast<const int*>(assign)[(size_t)br * n + id];
  } else if (Tab == kU8) {
    return static_cast<const uint8_t*>(assign)[(size_t)br * n + id];
  } else {
    const int nbytes = (n + 1) >> 1;
    const int byte =
        static_cast<const uint8_t*>(assign)[(size_t)br * nbytes + (id >> 1)];
    return (byte >> ((id & 1) * 4)) & 0xF;
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) { return (float)v; }

// The dequantized accumulate of one output element (row, column c):
// sum_d val[d] * cw[br, A[br, id_d], j] in slot order, then * scale[c].
template <typename Cw, int Tab>
__device__ __forceinline__ float accumulate(
    const int* __restrict__ ir, const float* __restrict__ vr,
    const void* __restrict__ assign, const Cw* __restrict__ cw,
    const float* __restrict__ scale, int c, int deg, int n, int k,
    int f_blk) {
  const int br = c / f_blk;
  const int j = c - br * f_blk;
  const Cw* cb = cw + (size_t)br * k * f_blk;
  float acc = 0.f;
  for (int d = 0; d < deg; ++d) {
    const int id = min(max(ir[d], 0), n - 1);
    const int a = min(max(table_id<Tab>(assign, br, n, id), 0), k - 1);
    acc = __fadd_rn(acc, __fmul_rn(vr[d], widen(cb[(size_t)a * f_blk + j])));
  }
  return scale == nullptr ? acc : __fmul_rn(acc, scale[c]);
}

template <typename Cw, int Tab>
__global__ void __launch_bounds__(kMaxThreads)
context_ell_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                   const void* __restrict__ assign,
                   const Cw* __restrict__ cw, const float* __restrict__ scale,
                   float* __restrict__ out, int deg, int n, int nb, int k,
                   int f_blk) {
  const long long row = blockIdx.x;
  const int ncol = nb * f_blk;
  const int* ir = ids + row * deg;
  const float* vr = vals + row * deg;
  for (int c = threadIdx.x; c < ncol; c += blockDim.x)
    out[row * ncol + c] =
        accumulate<Cw, Tab>(ir, vr, assign, cw, scale, c, deg, n, k, f_blk);
}

template <typename Cw, int Tab>
__global__ void __launch_bounds__(kMaxThreads)
context_ell_wt_kernel(const int* __restrict__ ids,
                      const float* __restrict__ vals,
                      const void* __restrict__ assign,
                      const Cw* __restrict__ cw,
                      const float* __restrict__ scale,
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
    acc_s[t] = r >= rows  // rows past the end of the last block
        ? 0.f
        : accumulate<Cw, Tab>(ids + (row0 + r) * deg, vals + (row0 + r) * deg,
                              assign, cw, scale, c, deg, n, k, f_blk);
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

template <typename Cw, int Tab>
cudaError_t launch(const int* ids, const float* vals, const void* assign,
                   const Cw* cw, const float* scale, float* out, int b,
                   int deg, int n, int nb, int k, int f_blk,
                   cudaStream_t stream) {
  if (b < 1 || deg < 1 || n < 1 || nb < 1 || k < 1 || f_blk < 1)
    return cudaErrorInvalidValue;
  int threads = ((nb * f_blk + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  context_ell_kernel<Cw, Tab><<<(unsigned)b, threads, 0, stream>>>(
      ids, vals, assign, cw, scale, out, deg, n, nb, k, f_blk);
  return cudaGetLastError();
}

template <typename Cw, int Tab>
cudaError_t launch_wt(const int* ids, const float* vals, const void* assign,
                      const Cw* cw, const float* scale, const float* w_t,
                      float* out, int b, int deg, int n, int nb, int k,
                      int f_blk, int f_out, cudaStream_t stream) {
  if (b < 1 || deg < 1 || n < 1 || nb < 1 || k < 1 || f_blk < 1 || f_out < 1)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)kWtRows * nb * f_blk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      context_ell_wt_kernel<Cw, Tab>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((b + kWtRows - 1) / kWtRows);
  context_ell_wt_kernel<Cw, Tab><<<blocks, kMaxThreads, smem, stream>>>(
      ids, vals, assign, cw, scale, w_t, out, b, deg, n, nb, k, f_blk, f_out);
  return cudaGetLastError();
}

}  // namespace

// ids/vals: [b, deg] contiguous int32/fp32 (deg >= 1); assign: the [nb, n]
// int32 / uint8 table or the [nb, ceil(n/2)] packed one, contiguous; cw:
// [nb, k, f_blk] contiguous; scale: the [nb, 1, f_blk] fp32 scales of
// quantized codewords (nullptr for fp32 ones); out: [b, nb*f_blk] fp32.
// The _wt entries take w_t: [nb*f_blk, f_out] contiguous fp32 and write
// out: [b, f_out].
#define REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, TABN, TAB)                        \
  extern "C" cudaError_t repro_context_ell_##CWN##_##TABN(                    \
      const int* ids, const float* vals, const void* assign, const CWT* cw,   \
      const float* scale, float* out, int b, int deg, int n, int nb, int k,   \
      int f_blk, cudaStream_t stream) {                                       \
    return launch<CWT, TAB>(ids, vals, assign, cw, scale, out, b, deg, n, nb, \
                            k, f_blk, stream);                                \
  }                                                                           \
  extern "C" cudaError_t repro_context_ell_wt_##CWN##_##TABN(                 \
      const int* ids, const float* vals, const void* assign, const CWT* cw,   \
      const float* scale, const float* w_t, float* out, int b, int deg,       \
      int n, int nb, int k, int f_blk, int f_out, cudaStream_t stream) {      \
    return launch_wt<CWT, TAB>(ids, vals, assign, cw, scale, w_t, out, b,     \
                               deg, n, nb, k, f_blk, f_out, stream);          \
  }

#define REPRO_CONTEXT_ELL_TABLES(CWN, CWT)       \
  REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, i32, kI32) \
  REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, u8, kU8)   \
  REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, a4, kA4)

REPRO_CONTEXT_ELL_TABLES(f32, float)
REPRO_CONTEXT_ELL_TABLES(i8, int8_t)
REPRO_CONTEXT_ELL_TABLES(f8, __nv_fp8_e4m3)
