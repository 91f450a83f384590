// Nearest-codeword assignment for every product-VQ branch in one launch.
//
// Replaces the TPU kernel src/repro/kernels/vq_assign.py:vq_assign_pallas
// (_vq_assign_kernel), which core/codebook.py:assign_features_only vmaps
// over the branches.  For branch b and row i it returns
//     argmin_c  |cw[b, c]|^2 - 2 x[b, i] . cw[b, c]
// with the first (lowest) index winning ties, like jnp.argmin and the
// Pallas kernel's strict-< tile combine.  Optionally (the Pallas kernel's
// want_min) also each row's squared distance to that codeword,
// max(min + |x|^2, 0), |x|^2 summed over j in order.
//
// What bounds it on an H100: arithmetic.  At the served width (n = 169,343
// nodes, k = 1024, 32 branches of width 4, or 8 of width 16) one call does
// 2*n*nb*k*f ~ 44 GFLOP in fp32 against ~90 MB of input: ~0.7 ms at the
// 67 TFLOP/s non-tensor fp32 peak versus ~0.03 ms for the bytes.
//
// Design: grid (row tiles, branches).  Each block copies its branch's
// [k, f] codewords into shared memory and computes their |c|^2 there once
// (16 KiB + 4 KiB at f = 4, 64 KiB + 4 KiB at f = 16 -- dynamic shared
// memory above 48 KiB needs cudaFuncSetAttribute).  One thread owns one
// row: it keeps the row in registers and scans the k codewords in
// increasing order; every thread of a warp reads the same codeword, so
// the shared-memory reads are broadcasts.  The distance is the plain
// version's formula in its order (sums over j = 0..f-1, each multiply and
// add rounded on its own: __fmul_rn/__fadd_rn keep nvcc from contracting
// them into FMAs), so kernel and plain version agree bit for bit.  The
// tensor cores (a [rows, f] x [f, k] product per tile, then a row argmin)
// are later work: with f = 4 the product is too thin for wgmma's 16-deep
// k-step without padding.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxF = 32;   // widest row the generic instantiation holds

// F > 0: the row width is a compile-time constant (the served widths 4, 8
// and 16).  F == 0: generic width f <= kMaxF, predicated per element.
template <int F>
__global__ void __launch_bounds__(kThreads)
vq_assign_kernel(const float* __restrict__ x, long long x_stride_branch,
                 long long x_stride_row, const float* __restrict__ cw,
                 int* __restrict__ out, float* __restrict__ min_out, int n,
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
  const float* xr = x + br * x_stride_branch + row * x_stride_row;
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
  out[(size_t)br * n + row] = arg;
  if (min_out != nullptr) {
    float xn2 = 0.f;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      if (j < fd) xn2 = __fadd_rn(xn2, __fmul_rn(xv[j], xv[j]));
    }
    min_out[(size_t)br * n + row] = fmaxf(__fadd_rn(best, xn2), 0.f);
  }
}

template <int F>
cudaError_t launch(const float* x, long long sb, long long sr, const float* cw,
                   int* out, float* min_out, int nb, int n, int k, int f,
                   cudaStream_t stream) {
  const size_t smem = ((size_t)k * f + (size_t)k) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      vq_assign_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)nb);
  vq_assign_kernel<F><<<grid, kThreads, smem, stream>>>(x, sb, sr, cw, out,
                                                         min_out, n, k, f);
  return cudaGetLastError();
}

}  // namespace

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
      return launch<4>(x, x_stride_branch, x_stride_row, cw, out, min_out,
                       nb, n, k, f, stream);
    case 8:
      return launch<8>(x, x_stride_branch, x_stride_row, cw, out, min_out,
                       nb, n, k, f, stream);
    case 16:
      return launch<16>(x, x_stride_branch, x_stride_row, cw, out, min_out,
                        nb, n, k, f, stream);
    default:
      return launch<0>(x, x_stride_branch, x_stride_row, cw, out, min_out,
                       nb, n, k, f, stream);
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
