// Staged-stripe ELLPACK SpMM: out[i, :] = sum_d val[i, d] * x[idx[i, d], :]
// for a source x too large to stay on chip, fp32 / int8 / fp8 e4m3, each
// row's slots added in (stripe, slot) order.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell_hbm.py:
// spmm_ell_hbm_pallas (_spmm_ell_hbm_kernel), which keeps x in HBM and
// DMAs, for each tile of bb output rows, every stripe of `stripe`
// consecutive source rows that the tile's neighbours touch into a
// double-buffered VMEM scratch: on a TPU the only way a kernel reaches HBM
// rows.  Which stripes a tile touches comes in a StripeIndex: ids
// [tiles, max_stripes] (ascending, the first counts[t] of row t are live)
// and counts [tiles].  The dispatch (kernels/ops.py) sends a source here
// when it exceeds the budget, the H100's 50 MB L2 in the port: the
// full-graph SpMM (169,343 x 128 fp32, 86.7 MB) and the sampled subgraphs
// of NS-SAGE, LABOR and GraphSAINT.
//
// What bounds it on an H100: bytes.  The function needs each row's ids and
// values, each source row it names once (86.7 MB at the full graph) and
// the output: ~0.06 ms at 3.35 TB/s.  Any thread can gather a source row
// straight from device memory through the L2, so nothing is staged: the
// first version of this kernel copied whole stripes into shared memory as
// the TPU kernel does, and on ids without locality a tile touched ~590 of
// 1,323 stripes, 51 GB copied a call to use 0.2 GB (PERF.md).  Here the
// stripe is only the sort key of a row's slots and the unit of the index:
// the memory pattern is the resident spmm_ell.cu's, with the slots taken
// in the staged order.
//
// Design: one block of 8 warps per row tile.  The block loads the tile's
// ids and values into shared memory, and marks the stripes the tile lists
// (ids[t, :counts[t]]) in a bitmap of ceil(n_src / stripe) bits.  Then one
// thread a row keeps the row's live slots -- val != 0, in a listed stripe
// -- and sorts them in place by stripe, a stable insertion sort.  Without
// an index (sids and counts null) every stripe a live slot touches counts
// as listed, which is what an index built from the same ids lists: the
// wrapper then skips the index build, the bitmap and the lookups.  Then a
// warp owns a row: each lane holds CPL contiguous columns (one 16-byte
// load a slot at f 128 fp32, 4 bytes in int8 / fp8: the gather of
// spmm_gather.cuh, shared with spmm_ell.cu) and the warp issues
// the loads of up to kBatch slots before it adds them, in the sorted
// order, each multiply and add rounded on its own (__fmul_rn /
// __fadd_rn) -- the plain version's order, so the two agree bit for bit.
// An int8 / fp8 value widens to fp32 exactly and the scale multiplies once
// after the last slot.  A row with no live slot writes zeros.  Neighbour
// ids outside [0, n_src) are clamped, as in the resident kernel.  Shared
// memory holds the bitmap and the tile's slot lists (bb * deg * 8 bytes),
// so the slot count, not the stripe, is what it bounds.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "spmm_gather.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxBB = 128;               // rows a tile
constexpr int kMaxCols = 256;             // 8 columns a lane
constexpr int kBatch = 8;                 // gathers a lane keeps in flight

// scale: nullptr for an fp32 source, else the [f] per-channel scales.
// CPL: columns a lane, f <= 32 * CPL.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
spmm_ell_hbm_kernel(const int* __restrict__ idx,
                    const float* __restrict__ val, const T* __restrict__ x,
                    const float* __restrict__ scale,
                    const int* __restrict__ sids,
                    const int* __restrict__ counts, float* __restrict__ out,
                    int b, int deg, int n_src, int f, int bb, int stripe,
                    int max_stripes, int n_words, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* listed = reinterpret_cast<unsigned*>(smem);     // [n_words]
  int* slot_j = reinterpret_cast<int*>(listed + n_words);   // [bb, deg]
  float* slot_v = reinterpret_cast<float*>(slot_j + bb * deg);
  int* slot_n = reinterpret_cast<int*>(slot_v + bb * deg);  // [bb]

  const long long row0 = (long long)blockIdx.x * bb;
  const int rows = (int)min((long long)bb, (long long)b - row0);
  const int n_stripes = (n_src + stripe - 1) / stripe;

  const bool indexed = counts != nullptr;
  for (int w = threadIdx.x; w < n_words; w += kThreads) listed[w] = 0u;
  for (int e = threadIdx.x; e < rows * deg; e += kThreads) {
    slot_j[e] = idx[row0 * deg + e];
    slot_v[e] = val[row0 * deg + e];
  }
  __syncthreads();
  if (indexed) {
    const int nst = counts[blockIdx.x];
    const int* tile_ids = sids + (size_t)blockIdx.x * max_stripes;
    for (int i = threadIdx.x; i < nst; i += kThreads) {
      const int s = tile_ids[i];
      if (s >= 0 && s < n_stripes)
        atomicOr(listed + s / 32, 1u << (s % 32));
    }
    __syncthreads();
  }

  // each row's live slots, in place, stably sorted by stripe: position d
  // is read before any write reaches it (writes stay below the count)
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    int* jr = slot_j + r * deg;
    float* wr = slot_v + r * deg;
    int n = 0;
    for (int d = 0; d < deg; ++d) {
      const float v = wr[d];
      const int j = min(max(jr[d], 0), n_src - 1);
      const int key = j / stripe;
      if (v == 0.f ||
          (indexed && !((listed[key / 32] >> (key % 32)) & 1u)))
        continue;
      int p = n;
      while (p > 0 && jr[p - 1] / stripe > key) {
        jr[p] = jr[p - 1];
        wr[p] = wr[p - 1];
        --p;
      }
      jr[p] = j;
      wr[p] = v;
      ++n;
    }
    slot_n[r] = n;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c0 = lane * CPL;
  const bool active = c0 < f;
  for (int r = warp; r < rows; r += kWarps) {
    const int n = slot_n[r];
    const int* jr = slot_j + r * deg;
    const float* wr = slot_v + r * deg;
    float acc[CPL];
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
    if (active) {
      for (int s0 = 0; s0 < n; s0 += kBatch) {
        float xv[kBatch][CPL];
        float wv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (s0 + u < n) {
            wv[u] = wr[s0 + u];
            gather<T, CPL>(x + (size_t)jr[s0 + u] * f, c0, f, vec, xv[u]);
          }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (s0 + u < n) {
#pragma unroll
            for (int q = 0; q < CPL; ++q)
              acc[q] = __fadd_rn(acc[q], __fmul_rn(wv[u], xv[u][q]));
          }
      }
      float* orow = out + (row0 + r) * f;
#pragma unroll
      for (int q = 0; q < CPL; ++q)
        if (c0 + q < f)
          orow[c0 + q] = scale == nullptr
                             ? acc[q]
                             : __fmul_rn(acc[q], scale[c0 + q]);
    }
  }
}

template <typename T>
cudaError_t launch(const int* idx, const float* val, const T* x,
                   const float* scale, const int* sids, const int* counts,
                   float* out, int b, int deg, int n_src, int f, int bb,
                   int stripe, int max_stripes, cudaStream_t stream) {
  if (b < 1 || deg < 0 || n_src < 1 || f < 1 || f > kMaxCols || bb < 1 ||
      bb > kMaxBB || stripe < 1 || max_stripes < 0)
    return cudaErrorInvalidValue;
  const int n_stripes = (n_src + stripe - 1) / stripe;
  const int n_words = counts == nullptr ? 0 : (n_stripes + 31) / 32;
  const size_t smem =
      (size_t)n_words * 4 + (size_t)bb * deg * 8 + (size_t)bb * 4;
  const int cpl = cols_per_lane(f);
  const int vec = gather_vec(x, f, cpl);
  decltype(&spmm_ell_hbm_kernel<T, 1>) kern =
      cpl == 1   ? spmm_ell_hbm_kernel<T, 1>
      : cpl == 2 ? spmm_ell_hbm_kernel<T, 2>
      : cpl == 4 ? spmm_ell_hbm_kernel<T, 4>
                 : spmm_ell_hbm_kernel<T, 8>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned tiles = (unsigned)((b + bb - 1) / bb);
  kern<<<tiles, kThreads, smem, stream>>>(idx, val, x, scale, sids, counts,
                                          out, b, deg, n_src, f, bb, stripe,
                                          max_stripes, n_words, vec);
  return cudaGetLastError();
}

}  // namespace

// idx/val: [b, deg] contiguous int32/fp32; x: [n_src, f] contiguous fp32;
// sids: [ceil(b / bb), max_stripes] int32 and counts: [ceil(b / bb)] int32,
// the StripeIndex, or both null (every touched stripe listed); out: [b, f]
// contiguous fp32.
extern "C" cudaError_t repro_spmm_ell_hbm_f32(
    const int* idx, const float* val, const float* x, const float* scale,
    const int* sids, const int* counts, float* out, int b, int deg,
    int n_src, int f, int bb, int stripe, int max_stripes,
    cudaStream_t stream) {
  (void)scale;
  return launch<float>(idx, val, x, nullptr, sids, counts, out, b, deg,
                       n_src, f, bb, stripe, max_stripes, stream);
}

// As repro_spmm_ell_hbm_f32 with x: [n_src, f] contiguous int8 / fp8 e4m3
// and scale: [f] contiguous fp32.
extern "C" cudaError_t repro_spmm_ell_hbm_q_i8(
    const int* idx, const float* val, const int8_t* x, const float* scale,
    const int* sids, const int* counts, float* out, int b, int deg,
    int n_src, int f, int bb, int stripe, int max_stripes,
    cudaStream_t stream) {
  return launch<int8_t>(idx, val, x, scale, sids, counts, out, b, deg, n_src,
                        f, bb, stripe, max_stripes, stream);
}

extern "C" cudaError_t repro_spmm_ell_hbm_q_f8(
    const int* idx, const float* val, const __nv_fp8_e4m3* x,
    const float* scale, const int* sids, const int* counts, float* out,
    int b, int deg, int n_src, int f, int bb, int stripe, int max_stripes,
    cudaStream_t stream) {
  return launch<__nv_fp8_e4m3>(idx, val, x, scale, sids, counts, out, b, deg,
                               n_src, f, bb, stripe, max_stripes, stream);
}
