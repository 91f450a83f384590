// Fused nearest-codeword assignment + cluster statistics (VQ-Update, the
// per-layer hot loop of Alg. 2) for every product-VQ branch in one launch.
//
// Replaces the TPU kernel src/repro/kernels/vq_update.py:
// vq_assign_update_pallas (_vq_update_kernel, int32 emit), which
// core/codebook.py:update vmaps over the branches.  For branch b and row i
// it returns
//     idx[b, i]  = argmin_c  |cw[b, c]|^2 - 2 x[b, i] . cw[b, c]
//     qerr[b, i] = max(min_c(...) + |x[b, i]|^2, 0)
// and accumulates counts[b, idx] += 1, sums[b, idx, :] += x[b, i, :].
//
// What bounds it on an H100: arithmetic.  At the training shape (b =
// 42,335 rows, k = 1024) the distance scan is 2*nb*b*k*f = 22.2 GFLOP at
// (nb, f) = (32, 8) and 14.6 GFLOP at (8, 21): 0.33 and 0.22 ms at the
// 67 TFLOP/s non-tensor fp32 peak, against ~11 MB of operands (0.003 ms).
//
// Design: grid (row tiles, branches), as vq_assign.cu.  Each block copies
// its branch's [k, f] codewords into shared memory and computes their
// |c|^2 there once (32 KiB + 4 KiB at f = 8, 84 KiB + 4 KiB at f = 21 --
// dynamic shared memory above 48 KiB needs cudaFuncSetAttribute).  One
// thread owns one row, keeps it in registers and scans the codewords in
// increasing order (shared-memory broadcasts).  The distance and |x|^2 are
// the plain version's formulas in its order, each multiply and add rounded
// on its own (__fmul_rn/__fadd_rn: no FMA contraction), so idx and qerr
// agree with the plain version bit for bit; the strict < keeps the lowest
// index on ties, like jnp.argmin.  The Pallas kernel keeps counts and sums
// as VMEM accumulators revisited by its sequential grid; blocks here run in
// parallel, so each row adds its statistics with global atomicAdd into
// buffers the wrapper zeroed.  Counts are whole numbers and exact in any
// order; sums depend on the order of the adds (a stated tolerance).  When
// most rows pick a few codewords (early training) those atomics serialize
// on a few addresses: measured in chip_smoke.py, not redesigned here.
// f = 21 (the gradient half of the 40-class layer is 5 wide) is odd: rows
// are read element by element, so no width assumes vector alignment; the
// two training widths (8 and 21) are compile-time instantiations, any
// other f <= 32 takes the predicated generic one.  The generic one is also
// exported on its own (repro_vq_update_generic_f32) so that chip_smoke.py
// can time it at the training widths: on an H100 the fixed-width builds
// run 5.7x (f = 8) and 2.0x (f = 21) faster there (PERF.md).
//
// Narrow emit, repro_vq_update_u8_f32: the same kernel with the assignment
// written as uint8 (emit_dtype uint8, k <= 256, the int8 / fp8 tiers'
// table type; and uint4, k <= 16, whose ids the wrapper returns in the
// same uint8 tensor -- the Pallas kernel also writes uint4 through its
// uint8 block and narrows in the wrapper).  The index type is a template
// parameter; every other output is the int32 build's.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxF = 32;   // widest row the generic instantiation holds

// F > 0: the row width is a compile-time constant.  F == 0: generic width
// f <= kMaxF, predicated per element.
template <int F, typename Idx>
__global__ void __launch_bounds__(kThreads)
vq_update_kernel(const float* __restrict__ x, const float* __restrict__ cw,
                 Idx* __restrict__ idx, float* __restrict__ qerr,
                 float* __restrict__ counts, float* __restrict__ sums, int n,
                 int k, int f) {
  constexpr int W = F > 0 ? F : kMaxF;
  const int fd = F > 0 ? F : f;
  extern __shared__ float smem[];
  float* c_s = smem;                              // [k, fd]
  float* cn2_s = smem + (size_t)k * fd;           // [k]
  const int br = blockIdx.y;
  const float* cwb = cw + (size_t)br * k * fd;
  for (int i = threadIdx.x; i < k * fd; i += blockDim.x) c_s[i] = cwb[i];
  __syncthreads();
  for (int c = threadIdx.x; c < k; c += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < fd; ++j) {
      const float v = c_s[c * fd + j];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    cn2_s[c] = s;
  }
  __syncthreads();

  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const float* xr = x + ((size_t)br * n + row) * fd;
  float xv[W];
#pragma unroll
  for (int j = 0; j < W; ++j) xv[j] = (j < fd) ? xr[j] : 0.f;

  float best = INFINITY;
  int arg = 0;
  for (int c = 0; c < k; ++c) {
    const float* cr = c_s + c * fd;
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < fd) dot = __fadd_rn(dot, __fmul_rn(xv[j], cr[j]));
    }
    const float d = __fsub_rn(cn2_s[c], __fmul_rn(2.f, dot));
    if (d < best) {   // strict: the lowest index keeps a tie
      best = d;
      arg = c;
    }
  }
  float xn2 = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j < fd) xn2 = __fadd_rn(xn2, __fmul_rn(xv[j], xv[j]));
  }
  const size_t out = (size_t)br * n + row;
  idx[out] = (Idx)arg;
  qerr[out] = fmaxf(__fadd_rn(best, xn2), 0.f);
  const size_t cid = (size_t)br * k + arg;
  atomicAdd(counts + cid, 1.f);
  float* srow = sums + cid * fd;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    if (j < fd) atomicAdd(srow + j, xv[j]);
  }
}

template <int F, typename Idx>
cudaError_t launch(const float* x, const float* cw, Idx* idx, float* qerr,
                   float* counts, float* sums, int nb, int n, int k, int f,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)k * f + (size_t)k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vq_update_kernel<F, Idx>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)nb);
  vq_update_kernel<F, Idx><<<grid, kThreads, smem, stream>>>(
      x, cw, idx, qerr, counts, sums, n, k, f);
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t dispatch(const float* x, const float* cw, Idx* idx, float* qerr,
                     float* counts, float* sums, int nb, int n, int k, int f,
                     cudaStream_t stream) {
  if (f < 1 || f > kMaxF || k < 1 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
  switch (f) {
    case 8:
      return launch<8>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
    case 21:
      return launch<21>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
    default:
      return launch<0>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
  }
}

}  // namespace

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

// The generic-width instantiation at any f <= 32, the same contract as
// repro_vq_update_f32: for comparing it with the fixed-width builds.
extern "C" cudaError_t repro_vq_update_generic_f32(
    const float* x, const float* cw, int* idx, float* qerr, float* counts,
    float* sums, int nb, int n, int k, int f, cudaStream_t stream) {
  if (f < 1 || f > kMaxF || k < 1 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
  return launch<0, int>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
}
