// Staged-stripe ELLPACK SpMM: out[i, :] = sum_d val[i, d] * x[idx[i, d], :]
// for a source x too large to stay on chip, fp32 / int8 / fp8 e4m3.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell_hbm.py:
// spmm_ell_hbm_pallas (_spmm_ell_hbm_kernel), which keeps x in HBM and
// DMAs, for each tile of bb output rows, every stripe of `stripe`
// consecutive source rows that the tile's neighbours touch into a
// double-buffered VMEM scratch, the copy of stripe j+1 overlapping the
// gather-accumulate over stripe j.  Which stripes a tile touches comes in
// a StripeIndex: ids [tiles, max_stripes] (ascending, the first counts[t]
// of row t are live) and counts [tiles].  The reference's dispatch sends a
// source there when it exceeds the on-chip budget; the port's dispatch
// (kernels/ops.py) does the same against the H100's 50 MB L2: the
// full-graph SpMM (169,343 x 128 fp32, 86.7 MB) and the sampled subgraphs
// of NS-SAGE, LABOR and GraphSAINT.
//
// What bounds it on an H100: the bytes it stages.  The function needs each
// source row once (86.7 MB at the full graph, 0.026 ms at 3.35 TB/s), but
// a tile stages whole stripes: on a graph whose ids have no locality a
// 128-row tile of ~18 slots a row touches hundreds of stripes, so one call
// stages tens of GB.  This kernel is the faithful first port, simple and
// exact; the staged bytes, not the arithmetic, are what a later redesign
// has to cut (PERF.md).
//
// Design: one block of 8 warps per row tile.  The block first sorts each
// of its rows' live slots (val != 0; padding slots touch no stripe, as in
// the index) by (stripe, slot) into shared memory, one thread a row, an
// insertion sort over the deg slots.  It then walks ids[t, :counts[t]] in
// ascending order, staging each stripe of x, in x's storage type, into one
// of two shared-memory buffers with cp.async (16-byte copies when the
// stripe's bytes are 16-byte aligned; a stripe's last bytes, and every
// byte of an unaligned stripe, by plain loads), commit_group / wait_group,
// so stripe j+1's copy is in flight while the block accumulates stripe j.
// The last stripe is bounded by n_src in the kernel: no padded copy of x
// is made.  Each warp owns up to 16 rows of the tile (rows warp, warp + 8,
// ...), each lane up to 8 columns (lane, lane + 32, ...), accumulated in
// registers across all stripes; a row keeps a cursor into its sorted
// slots and advances it as the stripes go by (slots of stripes the index
// does not list are skipped).  Every multiply and add is rounded on its
// own (__fmul_rn / __fadd_rn) in the order (stripe ascending, slot
// ascending) -- the plain version's order, so the two agree bit for bit.
// An int8 / fp8 value widens to fp32 exactly and the scale multiplies once
// after the last stripe.  A tile with count 0 writes zeros.  Neighbour ids
// outside [0, n_src) are clamped, as in the resident kernel.  The buffers
// are dynamic shared memory (cudaFuncSetAttribute above 48 KB).
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;          // bb <= kWarps * kRowsPerWarp
constexpr int kMaxCols = 256;             // 8 columns a lane

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) { return (float)v; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of stripe s -- rows [s * stripe, min((s + 1) * stripe,
// n_src)) of x -- into dst, and close this thread's copy group.
__device__ __forceinline__ void stage(unsigned char* dst,
                                      const unsigned char* x, int s,
                                      int stripe, int n_src,
                                      size_t row_bytes, bool vec) {
  const long long r0 = (long long)s * stripe;
  const long long r1 = min(r0 + stripe, (long long)n_src);
  const size_t nbytes = (size_t)(r1 - r0) * row_bytes;
  const unsigned char* src = x + (size_t)r0 * row_bytes;
  size_t body = 0;
  if (vec) {
    body = nbytes & ~(size_t)15;
    for (size_t o = (size_t)threadIdx.x * 16; o < body; o += kThreads * 16)
      cp_async16(dst + o, src + o);
  }
  for (size_t o = body + threadIdx.x; o < nbytes; o += kThreads)
    dst[o] = src[o];
  cp_async_commit();
}

// scale: nullptr for an fp32 source, else the [f] per-channel scales.
// CPL: columns per lane, f <= 32 * CPL.
template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
spmm_ell_hbm_kernel(const int* __restrict__ idx,
                    const float* __restrict__ val, const T* __restrict__ x,
                    const float* __restrict__ scale,
                    const int* __restrict__ sids,
                    const int* __restrict__ counts, float* __restrict__ out,
                    int b, int deg, int n_src, int f, int bb, int stripe,
                    int max_stripes, size_t buf_bytes, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const buf0 = smem;
  unsigned char* const buf1 = smem + buf_bytes;
  int* slot_j = reinterpret_cast<int*>(smem + 2 * buf_bytes);
  float* slot_v = reinterpret_cast<float*>(slot_j + bb * deg);
  int* slot_n = reinterpret_cast<int*>(slot_v + bb * deg);

  const long long row0 = (long long)blockIdx.x * bb;
  const int rows = (int)min((long long)bb, (long long)b - row0);
  const int nst = counts[blockIdx.x];
  const int* tile_ids = sids + (size_t)blockIdx.x * max_stripes;
  const size_t row_bytes = (size_t)f * sizeof(T);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  if (nst > 0) stage(buf0, xb, tile_ids[0], stripe, n_src, row_bytes, vec);

  // each row's live slots in (stripe, slot) order: a stable insertion sort
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int* ir = idx + (row0 + r) * deg;
    const float* vr = val + (row0 + r) * deg;
    int* jr = slot_j + r * deg;
    float* wr = slot_v + r * deg;
    int n = 0;
    for (int d = 0; d < deg; ++d) {
      const float v = vr[d];
      if (v == 0.f) continue;
      const int j = min(max(ir[d], 0), n_src - 1);
      const int key = j / stripe;
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

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc[kRowsPerWarp][CPL];
  int cur[kRowsPerWarp];
#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    cur[k] = 0;
#pragma unroll
    for (int q = 0; q < CPL; ++q) acc[k][q] = 0.f;
  }

  for (int js = 0; js < nst; ++js) {
    if (js + 1 < nst) {
      stage((js & 1) ? buf0 : buf1, xb, tile_ids[js + 1], stripe, n_src,
            row_bytes, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this stripe's bytes (and, the first time, the slot lists) visible
    __syncthreads();
    const int base = tile_ids[js] * stripe;
    const T* xs = reinterpret_cast<const T*>((js & 1) ? buf1 : buf0);
#pragma unroll
    for (int k = 0; k < kRowsPerWarp; ++k) {
      const int r = warp + k * kWarps;
      if (r < rows) {
        const int n = slot_n[r];
        const int* jr = slot_j + r * deg;
        const float* wr = slot_v + r * deg;
        int c = cur[k];
        while (c < n && jr[c] < base) ++c;     // a stripe the index omits
        while (c < n && jr[c] < base + stripe) {
          const float v = wr[c];
          const T* xr = xs + (size_t)(jr[c] - base) * f;
#pragma unroll
          for (int q = 0; q < CPL; ++q) {
            const int col = lane + 32 * q;
            if (col < f)
              acc[k][q] = __fadd_rn(acc[k][q], __fmul_rn(v, widen(xr[col])));
          }
          ++c;
        }
        cur[k] = c;
      }
    }
    // every warp is done with this buffer before the next copy reuses it
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kRowsPerWarp; ++k) {
    const int r = warp + k * kWarps;
    if (r < rows) {
      float* orow = out + (row0 + r) * f;
#pragma unroll
      for (int q = 0; q < CPL; ++q) {
        const int col = lane + 32 * q;
        if (col < f)
          orow[col] = scale == nullptr ? acc[k][q]
                                       : __fmul_rn(acc[k][q], scale[col]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const int* idx, const float* val, const T* x,
                   const float* scale, const int* sids, const int* counts,
                   float* out, int b, int deg, int n_src, int f, int bb,
                   int stripe, int max_stripes, cudaStream_t stream) {
  if (b < 1 || deg < 0 || n_src < 1 || f < 1 || f > kMaxCols || bb < 1 ||
      bb > kWarps * kRowsPerWarp || stripe < 1 || max_stripes < 0)
    return cudaErrorInvalidValue;
  const size_t stripe_bytes = (size_t)stripe * f * sizeof(T);
  const size_t buf_bytes = (stripe_bytes + 15) / 16 * 16;
  const size_t smem = 2 * buf_bytes + (size_t)bb * deg * 8 + (size_t)bb * 4;
  const int vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (stripe_bytes % 16 == 0);
  const int cpl = (f + 31) / 32;
  decltype(&spmm_ell_hbm_kernel<T, 1>) kern =
      cpl <= 1   ? spmm_ell_hbm_kernel<T, 1>
      : cpl <= 2 ? spmm_ell_hbm_kernel<T, 2>
      : cpl <= 4 ? spmm_ell_hbm_kernel<T, 4>
                 : spmm_ell_hbm_kernel<T, 8>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const unsigned tiles = (unsigned)((b + bb - 1) / bb);
  kern<<<tiles, kThreads, smem, stream>>>(idx, val, x, scale, sids, counts,
                                          out, b, deg, n_src, f, bb, stripe,
                                          max_stripes, buf_bytes, vec);
  return cudaGetLastError();
}

}  // namespace

// idx/val: [b, deg] contiguous int32/fp32; x: [n_src, f] contiguous fp32;
// sids: [ceil(b / bb), max_stripes] int32 and counts: [ceil(b / bb)] int32,
// the StripeIndex; out: [b, f] contiguous fp32.
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
