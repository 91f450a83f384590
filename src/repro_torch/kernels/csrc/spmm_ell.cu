// ELLPACK SpMM: out[i, :] = sum_d val[i, d] * x[idx[i, d], :], fp32.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell.py:spmm_ell_pallas
// (_spmm_ell_kernel, the f32 form) and stands in for spmm_ell_hbm.py:
// spmm_ell_hbm_pallas, which the reference's dispatch (kernels/ops.py:241)
// picks for a source above its 8 MB VMEM budget and which stages the
// source from HBM in stripes: the exact intra-batch messages C_in X_B of
// core/message_passing.py:intra_messages, and the full-graph SpMM of the
// backbones' full_apply.  The port's dispatch sends a source that fits the
// H100's 50 MB L2 here and a larger one to spmm_ell_hbm.cu.
//
// What bounds it on an H100: memory traffic, and at the serving shape
// (b = 256 rows, D = 18 slots, f = 128) launch latency.  The work is
// 2*b*D*f = 1.2 MFLOP against ~0.3 MB (ids, values, the [b, f] source read
// once and the output): a fraction of a microsecond at 3.35 TB/s, so one
// launch costs more than the bytes do.  At the training batch (42,335
// rows) the ids, values, source and output are ~45 MB, 0.013 ms.
//
// Design: a warp per output row, kWarps rows a block.  Each lane holds CPL
// contiguous columns of the row (one 16-byte load a slot at f 128 fp32, 4
// bytes for the 1-byte sources: spmm_gather.cuh, shared with
// spmm_ell_hbm.cu; an unaligned or odd f takes the scalar tail; rows wider
// than 256 columns take several passes).  The row's ids and values are
// read once, one slot a lane, and a ballot marks the live slots (val !=
// 0); the warp then takes the live slots in slot order, issuing the
// gathers of up to kBatch of them (ids and values broadcast with
// __shfl_sync) before it adds any, each multiply and add rounded on its
// own (__fmul_rn / __fadd_rn, no FMA contraction) -- the plain version's
// order.  An index outside [0, n_src) is clamped, which is also what a JAX
// gather does.  Gathered rows are read through the L2 with no staging.
//
// Padding: core/message_passing.py:intra_messages clamps every
// out-of-batch slot to row 0 with val 0, and at batch n/4 most slots are
// such (at the serving batch nearly all).  A slot whose value is 0 (or
// -0) is not gathered.  For a finite source that is exact, so the kernel
// is bit-equal to the plain version, which multiplies every slot: the
// accumulator starts at +0 and, under round-to-nearest, a sum is -0 only
// when both terms are -0, so it is never -0; adding the padding's +-0
// product (0 * finite) then leaves it unchanged, bit for bit.  Where the
// source holds inf or NaN in a row that only padding names, the plain
// version's 0 * inf = NaN reaches the output and this kernel's does not:
// the one divergence (ROADMAP.md, queue 3).  It is kept because it is
// faster on the main path: chip_smoke.py times the other choice beside
// this one (`ms_padding_loaded`: the same kernel with every zero value
// replaced by the smallest subnormal, so every slot is gathered), and on
// an H100 that takes 1.8x as long at the training batch (PERF.md).
//
// Second entry point, repro_spmm_ell_t_f32: the transposed product
//     grad_x[idx[i, d], :] += val[i, d] * g[i, :]
// -- spmm_ell's backward in x, which the training step needs and which
// the reference gets from JAX autodiff of the same SpMM (it has no Pallas
// kernel of its own).  What bounds it: the bytes are g (21.7 MB at the
// training batch, b = 42,335 rows, D = 18, f = 128), the ids and values,
// and the [n_src, f] output written once: ~0.015 ms at 3.35 TB/s; but
// every live slot is a read-modify-write of a 512-byte output row in the
// L2, so the number of reductions and, where the output outgrows the
// 50 MB L2 (the NS-SAGE subgraph's 134 MB), their misses are what the
// first version paid for.  That version ran one block a row and one
// thread a column: every thread walked all D slots, reloading each
// slot's value and id and testing it on its own, and issued one scalar
// atomicAdd per (live slot, column).
// Design: the forward's layout.  A warp per row i of g, kWarps rows a
// block; each lane loads its CPL contiguous columns of g[i] once (one
// 16-byte load at f 128: spmm_gather.cuh's mapping), the row's ids and
// values are read once, one slot a lane, and a ballot marks the live
// slots (val != 0).  The warp takes them in slot order, the id and value
// broadcast with __shfl_sync, and each live slot is one vector reduction
// of 4 floats a lane (atomicAdd on a float4, a red.global.add.v4.f32 on
// sm_90): at f 128 a slot costs 32 reductions of 16 bytes where the
// first version issued 128 of 4 bytes, and a padding slot costs none.
// The reductions return nothing, so a warp issues one slot's after
// another without waiting.  Each product is __fmul_rn(v, g), uncontracted
// as in the plain version; the sums land in no fixed order, so the result
// agrees with the plain version to the scatter-order bound (chip_smoke.py's
// check_scatter).  An f that is not a multiple of 4, or an output row not
// 16-byte aligned, takes scalar reductions; a g row not aligned to its
// lanes' chunks is loaded a column at a time (gather_vec, checked at run
// time as for the forward).  An id outside [0, n_src) is clamped.
// Padding: a slot whose value is 0 adds nothing, which is exact for a
// finite g; where g holds inf or NaN in a row that only padding names,
// the plain version adds 0 * inf = NaN to output row idx[i, d] (row 0 for
// the clamped padding of core/message_passing.py) and this kernel adds
// nothing: the forward's divergence, the other way round (ROADMAP.md,
// queue 3).
// The output is zeroed by the wrapper (torch.zeros, one memset at the
// card's write rate) and should stay there: a scatter cannot zero its own
// output in the same launch, since any block may add to any row, so a
// kernel-side zeroing would need a second launch or a grid-wide barrier.
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

#include "spmm_gather.cuh"

namespace {

constexpr int kWarps = 8;                 // rows a block, one warp each
constexpr int kThreads = kWarps * 32;
constexpr int kBatch = 8;                 // live slots' gathers in flight

// scale: nullptr for an fp32 source, else the [f] per-channel scales.
// CPL: columns a lane; a row of f > 32 * CPL columns takes several passes.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                const T* __restrict__ x, const float* __restrict__ scale,
                float* __restrict__ out, int b, int deg, int n_src, int f,
                int vec) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;                   // a whole warp: no shuffle waits
  const int* ir = idx + row * deg;
  const float* vr = val + row * deg;
  float* orow = out + row * f;
  for (int cb = 0; cb < f; cb += 32 * CPL) {
    const int c0 = cb + lane * CPL;
    const bool active = c0 < f;
    float acc[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
    for (int d0 = 0; d0 < deg; d0 += 32) {
      // this chunk's slots, one a lane; lanes past the row's end hold 0
      int my_j = 0;
      float my_v = 0.f;
      if (d0 + lane < deg) {
        my_j = min(max(ir[d0 + lane], 0), n_src - 1);
        my_v = vr[d0 + lane];
      }
      unsigned live = __ballot_sync(~0u, my_v != 0.f);
      while (live) {                      // warp-uniform
        float xv[kBatch][CPL];
        float wv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int s = live ? __ffs(live) - 1 : 0;
          const bool take = live != 0u;
          live &= live - 1u;
          const int j = __shfl_sync(~0u, my_j, s);
          const float v = __shfl_sync(~0u, my_v, s);
          wv[u] = take ? v : 0.f;
          if (take && active)
            gather<T, CPL>(x + (size_t)j * f, c0, f, vec, xv[u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (wv[u] != 0.f) {             // a taken slot: live, so nonzero
#pragma unroll
            for (int q = 0; q < CPL; ++q)
              acc[q] = __fadd_rn(acc[q], __fmul_rn(wv[u], xv[u][q]));
          }
      }
    }
    if (active) {
#pragma unroll
      for (int q = 0; q < CPL; ++q)
        if (c0 + q < f)
          orow[c0 + q] = scale == nullptr ? acc[q]
                                          : __fmul_rn(acc[q], scale[c0 + q]);
    }
  }
}

template <typename T>
cudaError_t launch(const int* idx, const float* val, const T* x,
                   const float* scale, float* out, int b, int deg, int n_src,
                   int f, cudaStream_t stream) {
  if (b < 1 || f < 1 || deg < 0 || (deg > 0 && n_src < 1))
    return cudaErrorInvalidValue;
  const int cpl = cols_per_lane(f);
  const int vec = gather_vec(x, f, cpl);
  decltype(&spmm_ell_kernel<T, 1>) kern =
      cpl == 1   ? spmm_ell_kernel<T, 1>
      : cpl == 2 ? spmm_ell_kernel<T, 2>
      : cpl == 4 ? spmm_ell_kernel<T, 4>
                 : spmm_ell_kernel<T, 8>;
  const unsigned blocks = (unsigned)((b + kWarps - 1) / kWarps);
  kern<<<blocks, kThreads, 0, stream>>>(idx, val, x, scale, out, b, deg,
                                        n_src, f, vec);
  return cudaGetLastError();
}

// out[p + c0 .. c0 + CPL) += v * gv, the lane's columns of one output row:
// vec (f a multiple of 4, the output 16-byte aligned) takes a float4
// reduction for each of the chunk's 4-column parts inside the row, else
// one scalar reduction a column.
template <int CPL>
__device__ __forceinline__ void scatter_add(float* __restrict__ p, int c0,
                                            int f, bool vec, float v,
                                            const float (&gv)[CPL]) {
  if constexpr (CPL >= 4) {
    if (vec) {
#pragma unroll
      for (int i = 0; i < CPL / 4; ++i)
        if (c0 + 4 * i < f)
          atomicAdd(reinterpret_cast<float4*>(p + c0) + i,
                    make_float4(__fmul_rn(v, gv[4 * i]),
                                __fmul_rn(v, gv[4 * i + 1]),
                                __fmul_rn(v, gv[4 * i + 2]),
                                __fmul_rn(v, gv[4 * i + 3])));
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q)
    if (c0 + q < f) atomicAdd(p + c0 + q, __fmul_rn(v, gv[q]));
}

// gvec: every lane's chunk of g's rows loads whole (gather_vec); ovec: the
// output's rows take float4 reductions.
template <int CPL>
__global__ void __launch_bounds__(kThreads)
spmm_ell_t_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                  const float* __restrict__ g, float* __restrict__ out, int b,
                  int deg, int n_src, int f, int gvec, int ovec) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= b) return;                   // a whole warp: no shuffle waits
  const int* ir = idx + row * deg;
  const float* vr = val + row * deg;
  const float* gr = g + row * f;
  for (int cb = 0; cb < f; cb += 32 * CPL) {
    const int c0 = cb + lane * CPL;
    const bool active = c0 < f;
    float gv[CPL];
    if (active) gather<float, CPL>(gr, c0, f, gvec, gv);
    for (int d0 = 0; d0 < deg; d0 += 32) {
      // this chunk's slots, one a lane; lanes past the row's end hold 0
      int my_j = 0;
      float my_v = 0.f;
      if (d0 + lane < deg) {
        my_j = min(max(ir[d0 + lane], 0), n_src - 1);
        my_v = vr[d0 + lane];
      }
      unsigned live = __ballot_sync(~0u, my_v != 0.f);
      while (live) {                      // warp-uniform, slot order
        const int s = __ffs(live) - 1;
        live &= live - 1u;
        const int j = __shfl_sync(~0u, my_j, s);
        const float v = __shfl_sync(~0u, my_v, s);
        if (active) scatter_add<CPL>(out + (size_t)j * f, c0, f, ovec, v, gv);
      }
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
  const int cpl = cols_per_lane(f);
  const int gvec = gather_vec(g, f, cpl);
  const int ovec = f % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  decltype(&spmm_ell_t_kernel<1>) kern =
      cpl == 1   ? spmm_ell_t_kernel<1>
      : cpl == 2 ? spmm_ell_t_kernel<2>
      : cpl == 4 ? spmm_ell_t_kernel<4>
                 : spmm_ell_t_kernel<8>;
  const unsigned blocks = (unsigned)((b + kWarps - 1) / kWarps);
  kern<<<blocks, kThreads, 0, stream>>>(idx, val, g, out, b, deg, n_src, f,
                                        gvec, ovec);
  return cudaGetLastError();
}
