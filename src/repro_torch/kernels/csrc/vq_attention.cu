// VQ-Attention decode step: one softmax over k codeword keys and w exact
// window keys, for n GQA groups in one launch (paper Eq. 6 on the token
// graph):
//     s[j, c]   = (q[j] * scale) . cb_k[c] + log(max(mass[c], 1e-9)),
//                 masked where mass[c] <= 0
//     s[j, k+i] = (q[j] * scale) . win_k[i], masked where win_mask[i] <= 0
//     out[j]    = softmax_t(s[j, t]) . [cb_v; win_v][t]
//
// Replaces the TPU kernel src/repro/kernels/vq_attention.py:
// vq_attention_decode_pallas (_vq_attn_kernel), called every layer of
// every decode step by nn/vq_attention.py:vq_attention_decode.
//
// What bounds it on an H100: bytes.  Per group it reads (k + w) keys and
// values of d elements and does 4 * g * (k + w) * d operations: at the
// decode path's shape (n = batch 4 x 8 KV heads = 32, g 3, d 128, k 128,
// w 64, bf16) that is ~3.2 MB against ~10 MFLOP, a ~1 us bound, so one
// launch is bound by its launch latency; at the config defaults (k 1024,
// w 512) and decode_32k's batch 128 (n 1024) ~805 MB, a ~0.24 ms bound,
// and 2.4 GFLOP stay far below the ridge.
//
// Design: one block per group.  The g query rows, pre-scaled, sit in
// shared memory as f32.  The k + w keys are one sequence (codewords, then
// the window) streamed through shared memory in tiles of kTile keys and
// values, widened to f32; the whole codebook is never staged (at k 1024,
// d 128 cb_k alone is 256 KB, beyond the 227 KB a block may use).  Rows
// whose bytes are a multiple of 16 are staged with 16-byte loads, eight
// in flight per thread: with one block per group there are few warps to
// hide the load latency (a first version with one 2-byte load per
// element and thread took 0.082 ms for the 3 tiles of the path's shape
// on an H100).  Each tile: thread i scores key i % kTile against query
// rows i / kTile, i / kTile + kRowSets, ... (one shared-memory read of
// the key element serves all of them), adding the tile's bias; one warp
// per row takes the tile's max, rescales the running
// denominator by exp(m_old - m_new) and turns the scores into weights;
// then each thread owns C = ceil(d / kThreads) output columns of every
// row and adds weight x value into f32 registers, after rescaling them.
// The row count g and C are compile-time buckets (G 4 / 8 / 16, C 1 / 2).  A masked key
// gets weight exactly 0 (the plain version's -inf; the Pallas kernel's
// -1e30 gives the same whenever one key of the row is valid, which the
// decode path guarantees: its newest window slot is always valid).  The
// output is acc / denominator, stored in the input's type (round to
// nearest even for bf16); a row with no valid key gets 0 / 0 = NaN, as
// the plain version's softmax over -inf does.  All arithmetic is f32;
// tensor cores (wgmma over the [g, d] x [d, tile] products) are later
// work, since at g 3 the product is far below a 64-row tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;                        // keys per shared tile
constexpr int kMaxD = 256;
constexpr int kMaxG = 16;
constexpr int kRowSets = kThreads / kTile;       // query rows per key, apart

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

size_t smem_bytes(int g, int d) {
  return sizeof(float) * ((size_t)g * d + (size_t)kTile * (d + 1) +
                          (size_t)kTile * d + (size_t)g * kTile + kTile +
                          3 * (size_t)g);
}

// G: query rows a block holds (g <= G); C: output columns a thread owns
// (d <= C * kThreads).  Compile-time, so the per-row loops unroll with no
// dead rows: a first version with G = 16 for every g spent most of its
// issue slots on predicated-off rows at g 3.
template <typename T, int G, int C>
__global__ void __launch_bounds__(kThreads)
vq_attention_kernel(const T* __restrict__ q, const T* __restrict__ cb_k,
                    const T* __restrict__ cb_v,
                    const float* __restrict__ mass,
                    const T* __restrict__ win_k, const T* __restrict__ win_v,
                    const float* __restrict__ win_mask, T* __restrict__ out,
                    int g, int d, int kcb, int w, float scale, bool vec) {
  extern __shared__ float smem[];
  const int dp = d | 1;   // odd row stride: no bank conflicts across rows
  float* q_s = smem;                    // [g, d]
  float* k_s = q_s + g * d;             // [kTile, d + 1]
  float* v_s = k_s + kTile * dp;        // [kTile, d]
  float* s_s = v_s + kTile * d;         // [g, kTile] scores, then weights
  float* b_s = s_s + g * kTile;         // [kTile] bias, -inf where masked
  float* m_s = b_s + kTile;             // [g] running max
  float* l_s = m_s + g;                 // [g] running denominator
  float* a_s = l_s + g;                 // [g] this tile's rescale factor

  const int grp = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const T* qg = q + (size_t)grp * g * d;
  const T* ck = cb_k + (size_t)grp * kcb * d;
  const T* cv = cb_v + (size_t)grp * kcb * d;
  const float* ms = mass + (size_t)grp * kcb;
  const T* wk = win_k + (size_t)grp * w * d;
  const T* wv = win_v + (size_t)grp * w * d;
  const float* wm = win_mask + (size_t)grp * w;

  for (int i = tid; i < g * d; i += kThreads)
    q_s[i] = __fmul_rn(widen(qg[i]), scale);
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  constexpr int kRowsPer = G / kRowSets;         // score rows a thread
  float acc[G][C];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < C; ++i) acc[j][i] = 0.f;

  const int total = kcb + w;
  for (int t0 = 0; t0 < total; t0 += kTile) {
    const int nt = min(kTile, total - t0);
    // stage the tile's keys and values (codewords first, then the window)
    stage_kv(k_s, dp, v_s, d, ck, wk, cv, wv, kcb, t0, nt, d, vec);
    for (int t = tid; t < nt; t += kThreads) {
      const int key = t0 + t;
      float b;
      if (key < kcb) {
        const float m = ms[key];
        b = m > 0.f ? logf(fmaxf(m, 1e-9f)) : -INFINITY;
      } else {
        b = wm[key - kcb] > 0.f ? 0.f : -INFINITY;
      }
      b_s[t] = b;
    }
    __syncthreads();

    // scores: thread (r0, t) takes key t against rows r0, r0 + kRowSets..
    {
      const int t = tid % kTile, r0 = tid / kTile;
      const bool live = t < nt && b_s[t] != -INFINITY;
      float s[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) s[i] = 0.f;
      if (live) {
        const float* kr = k_s + t * dp;
        for (int c = 0; c < d; ++c) {
          const float kv = kr[c];
#pragma unroll
          for (int i = 0; i < kRowsPer; ++i) {
            const int j = r0 + i * kRowSets;
            if (j < g) s[i] = fmaf(q_s[j * d + c], kv, s[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        const int j = r0 + i * kRowSets;
        if (j < g) s_s[j * kTile + t] = live ? s[i] + b_s[t] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per row
    for (int j = warp; j < g; j += kThreads / 32) {
      float* sr = s_s + j * kTile;
      float mx = -INFINITY;
      for (int t = lane; t < nt; t += 32) mx = fmaxf(mx, sr[t]);
      mx = warp_max(mx);
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < nt; t += 32) {
        const float sv = sr[t];
        const float pv = sv == -INFINITY ? 0.f : expf(sv - m_new);
        sr[t] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        // m_new == -inf: nothing valid yet, keep the (zero) sums as they are
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        a_s[j] = alpha;
        m_s[j] = m_new;
        l_s[j] = l_s[j] * alpha + sum;
      }
    }
    __syncthreads();

    // acc[j, c] = acc[j, c] * alpha[j] + sum_t weight[j, t] * v[t, c]
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (j < g) {
        const float al = a_s[j];
#pragma unroll
        for (int i = 0; i < C; ++i) acc[j][i] *= al;
      }
    }
    for (int t = 0; t < nt; ++t) {
      float vv[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = tid + i * kThreads;
        vv[i] = c < d ? v_s[t * d + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (j < g) {
          const float pj = s_s[j * kTile + t];
#pragma unroll
          for (int i = 0; i < C; ++i) acc[j][i] = fmaf(pj, vv[i], acc[j][i]);
        }
      }
    }
    __syncthreads();   // the next tile overwrites k_s, v_s, s_s, b_s
  }

  T* og = out + (size_t)grp * g * d;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (j < g) {
      const float l = l_s[j];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int c = tid + i * kThreads;
        if (c < d) narrow(og + (size_t)j * d + c, acc[j][i] / l);
      }
    }
  }
}

template <typename T, int G, int C>
cudaError_t launch_gc(const T* q, const T* cb_k, const T* cb_v,
                      const float* mass, const T* win_k, const T* win_v,
                      const float* win_mask, T* out, int n, int g, int d,
                      int kcb, int w, float scale, cudaStream_t stream) {
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)cb_k | (uintptr_t)cb_v | (uintptr_t)win_k |
                    (uintptr_t)win_v) % 16 == 0;
  const size_t smem = smem_bytes(g, d);
  cudaError_t err = cudaFuncSetAttribute(
      vq_attention_kernel<T, G, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  vq_attention_kernel<T, G, C><<<n, kThreads, smem, stream>>>(
      q, cb_k, cb_v, mass, win_k, win_v, win_mask, out, g, d, kcb, w, scale,
      vec);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_g(const T* q, const T* cb_k, const T* cb_v,
                     const float* mass, const T* win_k, const T* win_v,
                     const float* win_mask, T* out, int n, int g, int d,
                     int kcb, int w, float scale, cudaStream_t stream) {
  if (d <= kThreads)
    return launch_gc<T, G, 1>(q, cb_k, cb_v, mass, win_k, win_v, win_mask,
                              out, n, g, d, kcb, w, scale, stream);
  return launch_gc<T, G, kMaxD / kThreads>(q, cb_k, cb_v, mass, win_k,
                                           win_v, win_mask, out, n, g, d,
                                           kcb, w, scale, stream);
}

template <typename T>
cudaError_t launch(const T* q, const T* cb_k, const T* cb_v,
                   const float* mass, const T* win_k, const T* win_v,
                   const float* win_mask, T* out, int n, int g, int d,
                   int kcb, int w, float scale, cudaStream_t stream) {
  if (n < 1 || g < 1 || g > kMaxG || d < 1 || d > kMaxD || kcb < 0 ||
      w < 0 || kcb + w < 1)
    return cudaErrorInvalidValue;
  if (g <= 4)
    return launch_g<T, 4>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out,
                          n, g, d, kcb, w, scale, stream);
  if (g <= 8)
    return launch_g<T, 8>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out,
                          n, g, d, kcb, w, scale, stream);
  return launch_g<T, kMaxG>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out,
                            n, g, d, kcb, w, scale, stream);
}

}  // namespace

// q [n, g, d], cb_k / cb_v [n, k, d], mass [n, k] f32, win_k / win_v
// [n, w, d], win_mask [n, w] f32, out [n, g, d]; all contiguous; the
// element type is f32 or bf16 (one entry each); scale = 1 / sqrt(d).
extern "C" cudaError_t repro_vq_attention_f32(
    const float* q, const float* cb_k, const float* cb_v, const float* mass,
    const float* win_k, const float* win_v, const float* win_mask,
    float* out, int n, int g, int d, int kcb, int w, float scale,
    cudaStream_t stream) {
  return launch<float>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out, n,
                       g, d, kcb, w, scale, stream);
}

extern "C" cudaError_t repro_vq_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* cb_k,
    const __nv_bfloat16* cb_v, const float* mass,
    const __nv_bfloat16* win_k, const __nv_bfloat16* win_v,
    const float* win_mask, __nv_bfloat16* out, int n, int g, int d, int kcb,
    int w, float scale, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, cb_k, cb_v, mass, win_k, win_v, win_mask,
                               out, n, g, d, kcb, w, scale, stream);
}
