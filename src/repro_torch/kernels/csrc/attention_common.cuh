// Shared by the attention kernels (vq_attention.cu, flash_attention.cu):
// widening f32 / bf16 elements to f32, rounding results back, and staging
// key or value rows into shared memory as f32.  Everything here is
// inline or a template, so each source includes it on its own.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of T widened to f32 (4 floats or 8 bf16, element 0 first)
__device__ __forceinline__ void widen16(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void widen16(const uint4& u, float* f,
                                        __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Stage rows t0 .. t0 + nt - 1 of a key sequence and of its value
// sequence, each [a (n_a rows); b], as f32 rows of k_stride / v_stride
// floats.  vec: every row starts 16-byte aligned and holds a whole number
// of 16-byte chunks; then each thread first issues kBatch loads of 16
// bytes for the keys and kBatch for the values, and only then widens and
// stores them (shared-memory stores through a plain pointer could alias
// the next load, which would leave one load in flight at a time).
template <typename T>
__device__ __forceinline__ void stage_kv(
    float* k_dst, int k_stride, float* v_dst, int v_stride,
    const T* __restrict__ ka, const T* __restrict__ kb,
    const T* __restrict__ va, const T* __restrict__ vb, int n_a, int t0,
    int nt, int d, bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    constexpr int kBatch = 4;
    const int vpr = d / E, total = nt * vpr;
    for (int e0 = threadIdx.x; e0 < total; e0 += kBatch * blockDim.x) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) {
          const int t = e / vpr, c = (e - t * vpr) * E, key = t0 + t;
          const size_t off = key < n_a ? (size_t)key * d + c
                                       : (size_t)(key - n_a) * d + c;
          kr[u] = *reinterpret_cast<const uint4*>((key < n_a ? ka : kb) + off);
          vr[u] = *reinterpret_cast<const uint4*>((key < n_a ? va : vb) + off);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < total) {
          const int t = e / vpr, c = (e - t * vpr) * E;
          float f[E];
          widen16(kr[u], f, T());
#pragma unroll
          for (int i = 0; i < E; ++i) k_dst[t * k_stride + c + i] = f[i];
          widen16(vr[u], f, T());
#pragma unroll
          for (int i = 0; i < E; ++i) v_dst[t * v_stride + c + i] = f[i];
        }
      }
    }
  } else {
    for (int e = threadIdx.x; e < nt * d; e += blockDim.x) {
      const int t = e / d, c = e - t * d, key = t0 + t;
      const size_t off = key < n_a ? (size_t)key * d + c
                                   : (size_t)(key - n_a) * d + c;
      k_dst[t * k_stride + c] = widen((key < n_a ? ka : kb)[off]);
      v_dst[t * v_stride + c] = widen((key < n_a ? va : vb)[off]);
    }
  }
}
