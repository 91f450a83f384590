// ELLPACK SpMM: out[i, :] = sum_d val[i, d] * x[idx[i, d], :], fp32.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell.py:spmm_ell_pallas
// (_spmm_ell_kernel, the f32 form) and stands in for spmm_ell_hbm.py:
// spmm_ell_hbm_pallas, which the reference's dispatch (kernels/ops.py:241)
// picks for a source above its 8 MB VMEM budget and which stages the
// source from HBM in stripes: the exact intra-batch messages C_in X_B of
// core/message_passing.py:intra_messages, and the full-graph SpMM of the
// backbones' full_apply.
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
// JAX gather does.  Gathered rows are read straight from global memory,
// with no staging: the source fits the 50 MB L2 at the serving shape
// (128 KiB) and at the training batch (42,335 x 128, 21.7 MB), but not in
// the full-graph SpMM (169,343 x 128, 86.7 MB), whose gathers partly miss
// L2 and go to HBM -- the case the TPU's HBM variant exists for; here the
// same kernel serves it, and chip_smoke.py times it at that shape.
//
// Second entry point, repro_spmm_ell_t_f32: the transposed product
//     grad_x[idx[i, d], :] += val[i, d] * g[i, :]
// -- spmm_ell's backward in x, which the training step needs and which
// the reference gets from JAX autodiff of the same SpMM (it has no Pallas
// kernel of its own).  What bounds it: at the training shape (b = 42,335
// rows, D = 18, f = 128) the read of g (21.7 MB) and the [n_src, f] output
// written once take ~0.013 ms at 3.35 TB/s; the scattered adds land in L2.
// Design: one block per row i of g, one thread per column, a loop over
// the D slots with one atomicAdd per (slot, column) into an output the
// wrapper zeroed.  Slots with val == 0 are skipped in this kernel only:
// core/message_passing.py:intra_messages clamps every out-of-batch and
// padding slot to row 0 with val 0, and at b = n/4 most slots are such,
// so adding their 0 * g would serialize the atomics on row 0.  Skipping
// is exact for finite g (0 * g adds nothing); the forward kernel keeps
// multiplying its padding.  The adds land in no fixed order, so the
// result agrees with the plain version to a stated tolerance.
//
// Third and fourth entry points, repro_spmm_ell_q_i8 and repro_spmm_ell_q_f8:
// the _spmm_ell_q_kernel form of spmm_ell_pallas -- an int8 or fp8 e4m3
// source x [n_src, f] with per-channel scales x_scale [1, f] fp32.  The same
// template as the fp32 kernel: each 1-byte element widens to fp32 exactly,
// the slots accumulate in the same order, and the scale multiplies once
// after the last slot, so it is bit-equal to the plain version.  The source
// is read in place in its 1-byte type: a quarter of the fp32 bytes.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) { return (float)v; }

// scale: nullptr for an fp32 source, else the [f] per-channel scales
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
spmm_ell_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const T* __restrict__ x, const float* __restrict__ scale,
                float* __restrict__ out, int deg, int n_src, int f) {
  const long long row = blockIdx.x;
  const int* ir = idx + row * deg;
  const float* vr = val + row * deg;
  for (int c = threadIdx.x; c < f; c += blockDim.x) {
    float acc = 0.f;
    for (int d = 0; d < deg; ++d) {
      const int j = min(max(ir[d], 0), n_src - 1);
      acc = __fadd_rn(acc, __fmul_rn(vr[d], widen(x[(size_t)j * f + c])));
    }
    out[row * f + c] = scale == nullptr ? acc : __fmul_rn(acc, scale[c]);
  }
}

template <typename T>
cudaError_t launch(const int* idx, const float* val, const T* x,
                   const float* scale, float* out, int b, int deg, int n_src,
                   int f, cudaStream_t stream) {
  if (b < 1 || f < 1 || deg < 0 || (deg > 0 && n_src < 1))
    return cudaErrorInvalidValue;
  int threads = ((f + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  spmm_ell_kernel<T><<<(unsigned)b, threads, 0, stream>>>(
      idx, val, x, scale, out, deg, n_src, f);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kMaxThreads)
spmm_ell_t_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                  const float* __restrict__ g, float* __restrict__ out,
                  int deg, int n_src, int f) {
  const long long row = blockIdx.x;
  const int* ir = idx + row * deg;
  const float* vr = val + row * deg;
  const float* gr = g + row * f;
  for (int c = threadIdx.x; c < f; c += blockDim.x) {
    const float gv = gr[c];
    for (int d = 0; d < deg; ++d) {
      const float v = vr[d];
      if (v == 0.f) continue;
      const int j = min(max(ir[d], 0), n_src - 1);
      atomicAdd(out + (size_t)j * f + c, __fmul_rn(v, gv));
    }
  }
}

}  // namespace

// idx/val: [b, deg] contiguous int32/fp32; x: [n_src, f] contiguous fp32;
// out: [b, f] contiguous fp32.
extern "C" cudaError_t repro_spmm_ell_f32(const int* idx, const float* val,
                                          const float* x, float* out, int b,
                                          int deg, int n_src, int f,
                                          cudaStream_t stream) {
  return launch<float>(idx, val, x, nullptr, out, b, deg, n_src, f, stream);
}

// As repro_spmm_ell_f32 with x: [n_src, f] contiguous int8 / fp8 e4m3 and
// scale: [f] contiguous fp32.
extern "C" cudaError_t repro_spmm_ell_q_i8(const int* idx, const float* val,
                                           const int8_t* x,
                                           const float* scale, float* out,
                                           int b, int deg, int n_src, int f,
                                           cudaStream_t stream) {
  return launch<int8_t>(idx, val, x, scale, out, b, deg, n_src, f, stream);
}

extern "C" cudaError_t repro_spmm_ell_q_f8(const int* idx, const float* val,
                                           const __nv_fp8_e4m3* x,
                                           const float* scale, float* out,
                                           int b, int deg, int n_src, int f,
                                           cudaStream_t stream) {
  return launch<__nv_fp8_e4m3>(idx, val, x, scale, out, b, deg, n_src, f,
                               stream);
}

// idx/val: [b, deg] contiguous int32/fp32; g: [b, f] contiguous fp32;
// out: [n_src, f] contiguous fp32, zeroed by the caller.
extern "C" cudaError_t repro_spmm_ell_t_f32(const int* idx, const float* val,
                                            const float* g, float* out, int b,
                                            int deg, int n_src, int f,
                                            cudaStream_t stream) {
  if (b < 1 || f < 1 || deg < 1 || n_src < 1) return cudaErrorInvalidValue;
  int threads = ((f + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  spmm_ell_t_kernel<<<(unsigned)b, threads, 0, stream>>>(idx, val, g, out,
                                                         deg, n_src, f);
  return cudaGetLastError();
}
