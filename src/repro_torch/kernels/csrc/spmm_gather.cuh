// Shared by the ELLPACK SpMM kernels (spmm_ell.cu, spmm_ell_hbm.cu): a warp
// owns an output row and each lane CPL contiguous columns of it; these
// helpers gather a lane's columns of one source row, widened to fp32, with
// one 16-byte load at f 128 fp32 (4 bytes for an int8 / fp8 source).
// Everything here is inline or a template, so each source includes it on
// its own.
#pragma once

#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) { return (float)v; }

// element e of a lane's chunk, from its raw 32-bit words
__device__ __forceinline__ float word_elem(const uint32_t* w, int e, float) {
  return __uint_as_float(w[e]);
}
__device__ __forceinline__ float word_elem(const uint32_t* w, int e,
                                           int8_t) {
  return (float)(int8_t)(w[e / 4] >> (8 * (e % 4)));
}
__device__ __forceinline__ float word_elem(const uint32_t* w, int e,
                                           __nv_fp8_e4m3) {
  __nv_fp8_e4m3 t;
  t.__x = (__nv_fp8_storage_t)(w[e / 4] >> (8 * (e % 4)));
  return (float)t;
}

// The CPL columns of source row p that start at column c0, widened.
// vec: the chunk is CPL * sizeof(T) >= 4 bytes, aligned, and whole.
template <typename T, int CPL>
__device__ __forceinline__ void gather(const T* __restrict__ p, int c0,
                                       int f, bool vec, float* o) {
  constexpr int kBytes = CPL * (int)sizeof(T);
  if constexpr (kBytes >= 4) {
    if (vec) {
      constexpr int NW = kBytes / 4;
      uint32_t w[NW];
      const T* src = p + c0;
      if constexpr (NW >= 4) {
#pragma unroll
        for (int i = 0; i < NW / 4; ++i) {
          const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + i);
          w[4 * i] = u.x;
          w[4 * i + 1] = u.y;
          w[4 * i + 2] = u.z;
          w[4 * i + 3] = u.w;
        }
      } else if constexpr (NW == 2) {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
        w[0] = u.x;
        w[1] = u.y;
      } else {
        w[0] = __ldg(reinterpret_cast<const unsigned int*>(src));
      }
#pragma unroll
      for (int q = 0; q < CPL; ++q) o[q] = word_elem(w, q, T());
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < CPL; ++q)
    o[q] = c0 + q < f ? widen(p[c0 + q]) : 0.f;
}

// Columns a lane owns for an f-column row (up to 8: wider rows take
// several 256-column passes).
inline int cols_per_lane(int f) {
  return f <= 32 ? 1 : f <= 64 ? 2 : f <= 128 ? 4 : 8;
}

// Whether every lane's chunk of every row of x [n_src, f] can be loaded
// whole: at least 4 bytes, f a multiple of the chunk, x aligned to it.
template <typename T>
bool gather_vec(const T* x, int f, int cpl) {
  const size_t chunk = (size_t)cpl * sizeof(T);
  return chunk >= 4 && f % cpl == 0 &&
         reinterpret_cast<uintptr_t>(x) % chunk == 0;
}
