// Block flash attention, forward:
//     out[bh, i] = softmax_j(scale * q[bh, i] . k[bh, j]) . v[bh, j]
// over the keys j <= i + (skv - sq) when causal (the queries are the last
// sq positions of the key sequence), over all skv keys otherwise.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_pallas (_flash_kernel), reached through
// kernels/ops.py:flash_attention.  The Pallas kernel's causal mask assumes
// sq == skv; this one takes the skv - sq offset of ref.flash_attention,
// which is the same function where sq == skv.  No model path of the
// reference calls it (its gqa_attend is a plain einsum); it is held on the
// card at llama3.2-3b's attention shapes.
//
// What bounds it on an H100: operations.  At llama3.2-3b's train_4k length
// ([1, 24, 4096, 128] bf16, causal) it does ~1.03e11 FLOP against ~100 MB
// of operands: ~0.10 ms at the 989 TFLOP/s bf16 tensor-core peak.  This
// kernel uses no tensor cores -- its products run as f32 FMAs (67 TFLOP/s
// peak) -- so it is many times slower than that bound; wgmma tiles fed by
// TMA are later work.
//
// Design: grid (query tiles of kBQ = 64 rows, batch x heads).  The block
// keeps its query tile, pre-scaled, in shared memory as f32 and streams
// the keys and values in tiles of kBK = 32 through shared memory, widened
// to f32 (16-byte loads where the rows allow, attention_common.cuh).
// 256 threads = 16 row groups of 4 rows x 16 column lanes.  For
// scores a thread computes its 4 rows against keys lane and lane + 16;
// the 16 lanes of a row group reduce each row's max and sum with warp
// shuffles, keep the running max and denominator in registers, rescale by
// exp(m_old - m_new) and write the weights to shared memory; then each
// thread adds weight x value for its 4 rows and the columns lane + 16 * i
// into f32 registers.  Key tiles past the last key a causal query tile
// can see are never loaded (the Pallas kernel's causal tile skipping); a
// masked key, or one past skv, gets weight exactly 0; query rows past sq
// are not stored (ragged tails at any sq, skv and d <= 256).  The output
// is acc / denominator in the input's type; a query that sees no key gets
// 0 / 0 = NaN, as ref.flash_attention's softmax over -inf does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;          // query rows per block
constexpr int kBK = 32;          // keys per shared tile
constexpr int kLanes = 16;       // threads per row group
constexpr int kRows = 4;         // rows per thread (16 groups x 4 = kBQ)
constexpr int kKeys = kBK / kLanes;
constexpr int kMaxD = 256;

// reductions over the 16 lanes of a row group (half a warp)
__device__ __forceinline__ float group_max(float v) {
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) +
                          (size_t)kBK * d + (size_t)kBQ * (kBK + 1));
}

// NC: output columns a thread owns (lane + 16 * i, i < NC), 16 * NC >= d
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int sq,
                       int skv, int d, int causal, float scale, bool vec) {
  extern __shared__ float smem[];
  const int dp = d | 1;   // odd row stride: no bank conflicts across rows
  float* q_s = smem;                    // [kBQ, d + 1]
  float* k_s = q_s + kBQ * dp;          // [kBK, d + 1]
  float* v_s = k_s + kBK * dp;          // [kBK, d]
  float* p_s = v_s + kBK * d;           // [kBQ, kBK + 1] weights

  const int tid = threadIdx.x;
  const int rg = tid / kLanes, lane = tid % kLanes;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* qb = q + bh * sq * d;
  const T* kb = k + bh * skv * d;
  const T* vb = v + bh * skv * d;
  const int off = skv - sq;             // query i sees keys j <= i + off

  const int nq = min(kBQ, sq - q0);
  for (int e = tid; e < kBQ * d; e += kThreads) {
    const int r = e / d, c = e - r * d;
    q_s[r * dp + c] = r < nq ? __fmul_rn(widen(qb[(size_t)(q0 + r) * d + c]),
                                         scale)
                             : 0.f;
  }

  // keys this tile needs: all of them, or up to the last row's horizon
  int n_keys = skv;
  if (causal) n_keys = max(0, min(skv, q0 + nq - 1 + off + 1));

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = 0; k0 < n_keys; k0 += kBK) {
    const int nk = min(kBK, n_keys - k0);
    __syncthreads();   // q_s written / the previous tile's reads done
    stage_kv(k_s, dp, v_s, d, kb, kb, vb, vb, skv, k0, nk, d, vec);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int u = 0; u < kKeys; ++u) s[r][u] = 0.f;
    for (int c = 0; c < d; ++c) {
      float kv[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) kv[u] = k_s[(lane + kLanes * u) * dp + c];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float qv = q_s[(rg * kRows + r) * dp + c];
#pragma unroll
        for (int u = 0; u < kKeys; ++u) s[r][u] = fmaf(qv, kv[u], s[r][u]);
      }
    }

    float alpha[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + rg * kRows + r;
      float mx = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int t = lane + kLanes * u;
        const bool ok = t < nk && (!causal || k0 + t <= qi + off);
        if (!ok) s[r][u] = -INFINITY;
        mx = fmaxf(mx, s[r][u]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const float pv = s[r][u] == -INFINITY ? 0.f : expf(s[r][u] - m_new);
        p_s[(rg * kRows + r) * (kBK + 1) + lane + kLanes * u] = pv;
        sum += pv;
      }
      sum = group_sum(sum);
      // m_new == -inf: nothing visible yet, the (zero) sums stay as they are
      alpha[r] = m_new == -INFINITY ? 1.f : expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[r][i] *= alpha[r];
    for (int t = 0; t < nk; ++t) {
      float vv[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const int c = lane + kLanes * i;
        vv[i] = c < d ? v_s[t * d + c] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = p_s[(rg * kRows + r) * (kBK + 1) + t];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[r][i] = fmaf(pr, vv[i], acc[r][i]);
      }
    }
  }

  T* ob = out + bh * sq * d;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = rg * kRows + r;
    if (row >= nq) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = lane + kLanes * i;
      if (c < d) narrow(ob + (size_t)(q0 + row) * d + c, acc[r][i] / l[r]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_nc(const T* q, const T* k, const T* v, T* out, int bh,
                      int sq, int skv, int d, int causal, float scale,
                      cudaStream_t stream) {
  const size_t smem = smem_bytes(d);
  const bool vec = (d * sizeof(T)) % 16 == 0 &&
                   ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)bh);
  flash_attention_kernel<T, NC><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, sq, skv, d, causal, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* q, const T* k, const T* v, T* out, int bh,
                   int sq, int skv, int d, int causal, float scale,
                   cudaStream_t stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || skv < 1 || d < 1 || d > kMaxD)
    return cudaErrorInvalidValue;
  if (d <= 4 * kLanes)
    return launch_nc<T, 4>(q, k, v, out, bh, sq, skv, d, causal, scale,
                           stream);
  if (d <= 8 * kLanes)
    return launch_nc<T, 8>(q, k, v, out, bh, sq, skv, d, causal, scale,
                           stream);
  return launch_nc<T, 16>(q, k, v, out, bh, sq, skv, d, causal, scale,
                          stream);
}

}  // namespace

// q [bh, sq, d], k / v [bh, skv, d], out [bh, sq, d]; all contiguous;
// f32 or bf16 (one entry each); scale = 1 / sqrt(d); causal 0 or 1.
extern "C" cudaError_t repro_flash_attention_f32(
    const float* q, const float* k, const float* v, float* out, int bh,
    int sq, int skv, int d, int causal, float scale, cudaStream_t stream) {
  return launch<float>(q, k, v, out, bh, sq, skv, d, causal, scale, stream);
}

extern "C" cudaError_t repro_flash_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* out, int bh, int sq, int skv, int d, int causal,
    float scale, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bh, sq, skv, d, causal, scale,
                               stream);
}
