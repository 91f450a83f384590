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
// launch is bound by its latency; at the config defaults (k 1024, w 512)
// and decode_32k's batch 128 (n 1024) ~805 MB, a ~0.24 ms bound, and 2.4
// GFLOP stay far below the ridge.
//
// Design ("flash-decoding"): each group's k + w keys (codewords, then the
// window, one sequence) are cut into `splits` contiguous ranges, one block
// each, so that a launch of few groups still fills the card; the wrapper
// picks the count from n and the SM count (kernels/vq_attention.py:
// split_count: 4 at the decode shape, none at n 1024).  Inside a block,
// each warp walks its own 16-key tiles (the block's tiles dealt out in
// turn) with no block-wide barrier: it double-buffers its tiles' keys,
// values and masses in shared memory with cp.async, so the next tile's
// loads overlap this tile's scores and accumulate, and keeps its own
// online softmax (running max and denominator per query row) and an f32
// accumulator [g, its CPL columns of d] in registers.
//   - bf16 scores run on the tensor cores: mma.sync m16n8k16 with the 16
//     keys as M, the g query rows padded to N 8 (S^T = K . Q^T) and d as
//     K; products of bf16 inputs are exact in f32, so only the order of
//     the f32 sums differs from the plain version's; the scale multiplies
//     the f32 dot, then the bias adds.  f32 scores stay f32 FMAs (no
//     TF32): a lane takes one key against every other query row, with q
//     pre-scaled as the plain version scales it.
//   - The softmax of a tile: 16 lanes a query row, two rows at a time,
//     max and sum by shuffles; a masked key weighs exactly 0 (the plain
//     version's -inf).  The weighted sum of values is f32 FMA on the
//     widened values, each lane owning CPL contiguous columns.
// At the end, with one split, the block's warps merge their (max,
// denominator, accumulator) in shared memory in warp order, and the
// output is acc / denominator stored in the input's type (round to
// nearest even for bf16); a row with no valid key gets 0 / 0 = NaN, as
// the plain version's softmax over -inf does.  With several, each warp
// writes its partial to its slot of a workspace the wrapper allocated
// once for the shape (no block-wide merge: at the decode shape that cost
// more than the slots it saves), and the block bumps its group's counter
// behind a __threadfence(); the block that finds itself last merges the
// group's slots in (split, warp) order, 16 slots' loads at once (so the
// result does not depend on which block is last), writes the output and
// resets the counter for the next launch -- all in the same launch, so a
// decode step still launches once a layer.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kKeys = 16;            // keys a warp takes a step (mma's M)
constexpr int kStages = 2;           // a warp's tiles in flight
constexpr int kMaxWarps = 4;        // the wrapper's MAX_WARPS: a slot each
constexpr int kMaxD = 256;
constexpr int kMaxG = 16;
constexpr int kMaxSplits = 64;
// what an H100 block may opt into (232,448 bytes), less the static bytes
constexpr size_t kMaxSmem = 232448 - 1024;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(unsigned* a, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}
// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// CPL contiguous elements of a shared-memory row (16-byte aligned row
// start, chunk aligned to its size), widened to f32
template <typename T, int CPL>
__device__ __forceinline__ void load_cols(const T* p, float* v) {
  constexpr int NW = CPL * (int)sizeof(T) / 4;
  uint32_t wd[NW];
  if constexpr (NW >= 4) {
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[i];
      wd[4 * i] = u.x;
      wd[4 * i + 1] = u.y;
      wd[4 * i + 2] = u.z;
      wd[4 * i + 3] = u.w;
    }
  } else if constexpr (NW == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    wd[0] = u.x;
    wd[1] = u.y;
  } else {
    wd[0] = *reinterpret_cast<const uint32_t*>(p);
  }
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int q = 0; q < CPL; ++q) v[q] = __uint_as_float(wd[q]);
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      v[2 * i] = __uint_as_float(wd[i] << 16);
      v[2 * i + 1] = __uint_as_float(wd[i] & 0xffff0000u);
    }
  }
}

// VW (1 or 4) consecutive floats, 16-byte aligned when VW is 4; L2:
// through the L2 only (another block's partials)
template <int VW, bool L2 = false>
__device__ __forceinline__ void load_f32(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 v = L2 ? __ldcg(reinterpret_cast<const float4*>(p))
                        : *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    x[0] = L2 ? __ldcg(p) : *p;
  }
}

// Shared-memory layout (bytes) of a block of W warps: the query rows, then
// either every warp's tile buffers (during the walk) or the warps' partial
// results and the merge's factors (after it).
template <typename T, int G>
struct Layout {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowsQ = kMma ? (G + 7) / 8 * 8 : G;
  int dp, ks, vs;      // padded width; K and V row strides, in elements
  size_t q_bytes, warp_bytes;
  __host__ __device__ explicit Layout(int d) {
    dp = (d + 15) / 16 * 16;
    ks = dp + 16 / (int)sizeof(T);    // 16 bytes apart: no bank conflicts
    vs = dp;
    q_bytes = (size_t)kRowsQ * ks * sizeof(T);
    warp_bytes = ((size_t)kStages * kKeys * (ks + vs) * sizeof(T) +
                  sizeof(float) * (kStages * kKeys + G * kKeys + G) + 15) /
                 16 * 16;
  }
  __host__ __device__ size_t union_bytes(int W) const {
    const size_t walk = (size_t)W * warp_bytes;
    const size_t red = sizeof(float) * ((size_t)W * G * (dp + 3) + G);
    return walk > red ? walk : red;
  }
  __host__ __device__ size_t bytes(int W) const {
    return q_bytes + union_bytes(W);
  }
};

// G: query rows a block holds (g <= G); CPL: output columns a lane owns
// (d <= 32 * CPL).  Compile-time, so the per-row loops unroll.
template <typename T, int G, int CPL>
__global__ void __launch_bounds__(kMaxWarps * 32)
vq_attention_kernel(const T* __restrict__ q, const T* __restrict__ cb_k,
                    const T* __restrict__ cb_v,
                    const float* __restrict__ mass,
                    const T* __restrict__ win_k, const T* __restrict__ win_v,
                    const float* __restrict__ win_mask, T* __restrict__ out,
                    float* __restrict__ ws_acc, float* __restrict__ ws_ml,
                    int* __restrict__ counters, int g, int d, int kcb, int w,
                    int splits, float scale, int vec) {
  using L_t = Layout<T, G>;
  constexpr bool kMma = L_t::kMma;
  constexpr int NT = (G + 7) / 8;           // mma N tiles of query rows
  constexpr int R = (G + 1) / 2;            // softmax passes, two rows each
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const L_t L(d);
  const int W = blockDim.x >> 5;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = lane >> 4, t16 = lane & 15;
  const int grp = blockIdx.x / splits, split = blockIdx.x - grp * splits;
  const int total = kcb + w;

  const T* qg = q + (size_t)grp * g * d;
  const T* ck = cb_k + (size_t)grp * kcb * d;
  const T* cv = cb_v + (size_t)grp * kcb * d;
  const float* ms = mass + (size_t)grp * kcb;
  const T* wk = win_k + (size_t)grp * w * d;
  const T* wv = win_v + (size_t)grp * w * d;
  const float* wm = win_mask + (size_t)grp * w;

  T* q_s = reinterpret_cast<T*>(smem);                     // [rows, ks]
  unsigned char* u = smem + L.q_bytes;
  T* kbuf = reinterpret_cast<T*>(u + (size_t)warp * L.warp_bytes);
  T* vbuf = kbuf + kStages * kKeys * L.ks;                  // [st, t, vs]
  float* bbuf = reinterpret_cast<float*>(vbuf + kStages * kKeys * L.vs);
  float* sw = bbuf + kStages * kKeys;                       // [G, kKeys]
  float* aw = sw + G * kKeys;                               // [G]

  // this split's 16-key tiles [lo, hi), dealt to the warps in turn
  const int n_tiles = (total + kKeys - 1) / kKeys;
  const int per = (n_tiles + splits - 1) / splits;
  const int lo = min(n_tiles, split * per), hi = min(n_tiles, lo + per);

  // a lane's first 16-byte chunk of a tile (row r0, chunk c0_), and the
  // step of 32 chunks in rows and chunks
  constexpr int E = 16 / (int)sizeof(T);
  const int cpr = vec ? d / E : 1;
  const int r0 = lane / cpr, cc0 = lane - r0 * cpr;
  const int dr = 32 / cpr, dc = 32 - dr * cpr;
  auto issue = [&](int tile, int st) {
    const int key0 = tile * kKeys, nt = min(kKeys, total - key0);
    T* kd = kbuf + st * kKeys * L.ks;
    T* vd = vbuf + st * kKeys * L.vs;
    if (vec) {
      for (int r = r0, cc = cc0; r < nt;) {
        const int key = key0 + r, c = cc * E;
        const bool cb = key < kcb;
        const size_t off = (size_t)(cb ? key : key - kcb) * d + c;
        cp_async16(kd + r * L.ks + c, (cb ? ck : wk) + off);
        cp_async16(vd + r * L.vs + c, (cb ? cv : wv) + off);
        r += dr;
        cc += dc;
        if (cc >= cpr) {
          cc -= cpr;
          ++r;
        }
      }
    } else {
      for (int e = lane; e < nt * d; e += 32) {
        const int r = e / d, c = e - r * d, key = key0 + r;
        const bool cb = key < kcb;
        const size_t off = (size_t)(cb ? key : key - kcb) * d + c;
        kd[r * L.ks + c] = (cb ? ck : wk)[off];
        vd[r * L.vs + c] = (cb ? cv : wv)[off];
      }
    }
    if (lane < nt) {
      const int key = key0 + lane;
      cp_async4(bbuf + st * kKeys + lane,
                key < kcb ? ms + key : wm + (key - kcb));
    }
    cp_commit();
  };

  float acc[G][CPL];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[j][i] = 0.f;
  float m_r[R], l_r[R];                    // rows 2r + h, on 16 lanes each
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_r[r] = -INFINITY;
    l_r[r] = 0.f;
  }
  const int c0 = lane * CPL;

  // the first tile's loads go out before the query rows are staged
  int st = 0;
  if (lo + warp < hi) issue(lo + warp, 0);
  // the query rows, zero-padded to [rows, dp] (f32: pre-scaled as the
  // plain version scales them; bf16: as they are, for the mma)
  if (vec) {
    for (int i = tid; i < g * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * E;
      float f[E];
      widen16(__ldg(reinterpret_cast<const uint4*>(qg + r * d + c)), f, T());
#pragma unroll
      for (int e = 0; e < E; ++e)
        narrow(q_s + r * L.ks + c + e, kMma ? f[e] : __fmul_rn(f[e], scale));
    }
    for (int i = tid; i < (L_t::kRowsQ - g) * L.ks; i += blockDim.x)
      narrow(q_s + g * L.ks + i, 0.f);          // the padding rows
    const int padq = L.dp - d;                  // and columns
    for (int i = tid; i < g * padq; i += blockDim.x) {
      const int r = i / padq;
      narrow(q_s + r * L.ks + d + (i - r * padq), 0.f);
    }
  } else {
    for (int i = tid; i < L_t::kRowsQ * L.dp; i += blockDim.x) {
      const int r = i / L.dp, c = i - r * L.dp;
      const float v = r < g && c < d ? widen(qg[r * d + c]) : 0.f;
      narrow(q_s + r * L.ks + c, kMma ? v : __fmul_rn(v, scale));
    }
  }
  // this warp's key columns [d, dp) stay zero: the loads never write them
  const int padc = L.dp - d;
  for (int i = lane; i < kStages * kKeys * padc; i += 32) {
    const int r = i / padc;
    narrow(kbuf + r * L.ks + d + (i - r * padc), 0.f);
  }
  __syncthreads();

  for (int tile = lo + warp; tile < hi; tile += W, st ^= 1) {
    if (tile + W < hi) {
      issue(tile + W, st ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    const int key0 = tile * kKeys, nt = min(kKeys, total - key0);
    const T* kd = kbuf + st * kKeys * L.ks;
    const T* vd = vbuf + st * kKeys * L.vs;
    // key t16's bias: log-mass for a codeword, 0 for a window slot, -inf
    // where masked or past the end
    float bias;
    {
      const int key = key0 + t16;
      const float raw = bbuf[st * kKeys + t16];
      if (key >= total)
        bias = -INFINITY;
      else if (key < kcb)
        bias = raw > 0.f ? logf(fmaxf(raw, 1e-9f)) : -INFINITY;
      else
        bias = raw > 0.f ? 0.f : -INFINITY;
    }

    if constexpr (kMma) {
      // S^T[key, row] = K[key, :] . Q[row, :], 16 keys x 8 rows a tile;
      // even and odd 16-column steps in two chains, added at the end
      float c[2][NT][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[x][n][e] = 0.f;
      const unsigned a_addr =
          smem_u32(kd + (lane & 15) * L.ks + (lane >> 4) * 8);
      const T* qb = q_s + (lane >> 2) * L.ks + 2 * (lane & 3);
      for (int kk = 0; kk < L.dp; kk += 32) {
        const bool two = kk + 16 < L.dp;       // warp-uniform
        unsigned a0[4], a1[4];
        ldmatrix_x4(a0, a_addr + kk * (unsigned)sizeof(T));
        if (two) ldmatrix_x4(a1, a_addr + (kk + 16) * (unsigned)sizeof(T));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* qr = qb + n * 8 * L.ks + kk;
          mma_bf16(c[0][n], a0, *reinterpret_cast<const unsigned*>(qr),
                   *reinterpret_cast<const unsigned*>(qr + 8));
          if (two)
            mma_bf16(c[1][n], a1,
                     *reinterpret_cast<const unsigned*>(qr + 16),
                     *reinterpret_cast<const unsigned*>(qr + 24));
        }
      }
      const float b_lo = __shfl_sync(~0u, bias, lane >> 2);
      const float b_hi = __shfl_sync(~0u, bias, (lane >> 2) + 8);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * (lane & 3) + (e & 1);
          const int t = (lane >> 2) + (e >> 1) * 8;
          const float b = e >> 1 ? b_hi : b_lo;
          const float dot = c[0][n][e] + c[1][n][e];
          if (j < g)
            sw[j * kKeys + t] =
                b == -INFINITY ? -INFINITY : __fmul_rn(dot, scale) + b;
        }
    } else {
      // lane (h, t16): key t16 against query rows h, h + 2, ..., four
      // partial sums a row (columns c mod 4), added at the end
      float4 s[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s[r] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float* kr = reinterpret_cast<const float*>(kd) + t16 * L.ks;
      const float* qf = reinterpret_cast<const float*>(q_s);
      for (int c = 0; c < L.dp; c += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int j = 2 * r + h;
          if (j < g) {
            const float4 q4 =
                *reinterpret_cast<const float4*>(qf + j * L.ks + c);
            s[r].x = fmaf(q4.x, k4.x, s[r].x);
            s[r].y = fmaf(q4.y, k4.y, s[r].y);
            s[r].z = fmaf(q4.z, k4.z, s[r].z);
            s[r].w = fmaf(q4.w, k4.w, s[r].w);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = 2 * r + h;
        const float dot = (s[r].x + s[r].y) + (s[r].z + s[r].w);
        if (j < g)
          sw[j * kKeys + t16] = bias == -INFINITY ? -INFINITY : dot + bias;
      }
    }
    __syncwarp();

    // online softmax of the tile: rows 2r (lanes 0-15) and 2r + 1 (16-31),
    // every pass's shuffles interleaved
    {
      float sv[R], mx[R], sum[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = 2 * r + h;
        sv[r] = j < g ? sw[j * kKeys + t16] : -INFINITY;
        mx[r] = sv[r];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(~0u, mx[r], o));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mx[r] = fmaxf(m_r[r], mx[r]);            // the new running max
        sv[r] = sv[r] == -INFINITY ? 0.f : expf(sv[r] - mx[r]);
        sum[r] = sv[r];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < R; ++r)
          sum[r] += __shfl_xor_sync(~0u, sum[r], o);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = 2 * r + h;
        // a max of -inf: nothing valid yet, keep the (zero) sums as they are
        const float alpha = mx[r] == -INFINITY ? 1.f : expf(m_r[r] - mx[r]);
        if (j < g) {
          sw[j * kKeys + t16] = sv[r];
          if (t16 == 0) aw[j] = alpha;
        }
        l_r[r] = l_r[r] * alpha + sum[r];
        m_r[r] = mx[r];
      }
    }
    __syncwarp();

    // acc[j, c] = acc[j, c] * alpha[j] + sum_t weight[j, t] * v[t, c],
    // four keys a step
    if (c0 < d) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j < g) {
          const float al = aw[j];
#pragma unroll
          for (int i = 0; i < CPL; ++i) acc[j][i] *= al;
        }
      int t = 0;
      for (; t + 4 <= nt; t += 4) {
        float v[4][CPL];
#pragma unroll
        for (int x = 0; x < 4; ++x)
          load_cols<T, CPL>(vd + (t + x) * L.vs + c0, v[x]);
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (j < g) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(sw + j * kKeys + t);
#pragma unroll
            for (int i = 0; i < CPL; ++i) {
              acc[j][i] = fmaf(p4.x, v[0][i], acc[j][i]);
              acc[j][i] = fmaf(p4.y, v[1][i], acc[j][i]);
              acc[j][i] = fmaf(p4.z, v[2][i], acc[j][i]);
              acc[j][i] = fmaf(p4.w, v[3][i], acc[j][i]);
            }
          }
      }
      for (; t < nt; ++t) {
        float v[CPL];
        load_cols<T, CPL>(vd + t * L.vs + c0, v);
#pragma unroll
        for (int j = 0; j < G; ++j)
          if (j < g) {
            const float pj = sw[j * kKeys + t];
#pragma unroll
            for (int i = 0; i < CPL; ++i) acc[j][i] = fmaf(pj, v[i], acc[j][i]);
          }
      }
    }
    __syncwarp();   // the next issue overwrites this stage, sw and aw
  }

  if (splits > 1) {
    // each warp's partial (max, denominator, accumulator) goes straight to
    // the workspace, slot (group, split, warp); the group's last block to
    // finish merges every slot
    const size_t part = ((size_t)grp * splits + split) * kMaxWarps + warp;
    if (c0 < d) {
#pragma unroll
      for (int j = 0; j < G; ++j)
        if (j < g) {
          float* dst = ws_acc + (part * g + j) * d + c0;
          bool whole = false;               // 16-byte stores of the chunk
          if constexpr (CPL % 4 == 0) {
            whole = d % 4 == 0 && c0 + CPL <= d;
            if (whole) {
#pragma unroll
              for (int i = 0; i < CPL; i += 4)
                *reinterpret_cast<float4*>(dst + i) = make_float4(
                    acc[j][i], acc[j][i + 1], acc[j][i + 2], acc[j][i + 3]);
            }
          }
          if (!whole) {
#pragma unroll
            for (int i = 0; i < CPL; ++i)
              if (c0 + i < d) dst[i] = acc[j][i];
          }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int j = 2 * r + h;
      if (j < g && t16 == 0)
        reinterpret_cast<float2*>(ws_ml)[part * g + j] =
            make_float2(m_r[r], l_r[r]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(counters + grp, 1) == splits - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    // every output element: the slots' (max, denominator) and partial sums,
    // 16 slots' loads at once, merged in slot order (two passes a chunk of
    // 16, online from chunk to chunk)
    auto merge_slots = [&](auto vw) {
      constexpr int VW = decltype(vw)::value;
      constexpr int kChunk = 16;
      const int n_slots = splits * kMaxWarps;
      const size_t slot0 = (size_t)grp * n_slots;
      const float2* gml = reinterpret_cast<const float2*>(ws_ml);
      for (int e = tid; e < g * d / VW; e += blockDim.x) {
        const int j = e * VW / d;
        float M = -INFINITY, den = 0.f, A[VW];
#pragma unroll
        for (int i = 0; i < VW; ++i) A[i] = 0.f;
        for (int p0 = 0; p0 < n_slots; p0 += kChunk) {
          float2 ml[kChunk];
          float a[kChunk][VW];
#pragma unroll
          for (int x = 0; x < kChunk; ++x) {
            const int p = p0 + x;
            ml[x] = make_float2(-INFINITY, 0.f);
            if (p < n_slots && (p % kMaxWarps) < W) {
              ml[x] = __ldcg(gml + (slot0 + p) * g + j);
              load_f32<VW, true>(ws_acc + ((slot0 + p) * g + j) * d +
                                     (e * VW - j * d), a[x]);
            }
          }
          float mc = M;
#pragma unroll
          for (int x = 0; x < kChunk; ++x) mc = fmaxf(mc, ml[x].x);
          if (mc == -INFINITY) continue;      // nothing valid yet
          const float fo = expf(M - mc);      // 0 while M is -inf
          den *= fo;
#pragma unroll
          for (int i = 0; i < VW; ++i) A[i] *= fo;
#pragma unroll
          for (int x = 0; x < kChunk; ++x)
            if (ml[x].x != -INFINITY) {
              const float f = expf(ml[x].x - mc);
              den = fmaf(ml[x].y, f, den);
#pragma unroll
              for (int i = 0; i < VW; ++i) A[i] = fmaf(a[x][i], f, A[i]);
            }
          M = mc;
        }
        // no valid key in any slot: 0 / 0 = NaN, as in the plain version
#pragma unroll
        for (int i = 0; i < VW; ++i)
          narrow(out + (size_t)grp * g * d + e * VW + i, A[i] / den);
      }
    };
    if (d % 4 == 0)
      merge_slots(std::integral_constant<int, 4>());
    else
      merge_slots(std::integral_constant<int, 1>());
    if (tid == 0) counters[grp] = 0;        // ready for the next launch
    return;
  }

  // one split: merge the block's warps in shared memory, in warp order
  __syncthreads();                          // every warp's walk is done
  float* red = reinterpret_cast<float*>(u);       // [W, G, dp]
  float* red_m = red + (size_t)W * G * L.dp;      // [W, G]
  float* red_l = red_m + W * G;                   // [W, G]
  float* red_f = red_l + W * G;                   // [W, G] factors
  float* blk_l = red_f + W * G;                   // [G] the denominator
  if (c0 < d) {
#pragma unroll
    for (int j = 0; j < G; ++j)
      if (j < g) {
#pragma unroll
        for (int i = 0; i < CPL; ++i)
          red[(warp * G + j) * L.dp + c0 + i] = acc[j][i];
      }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = 2 * r + h;
    if (j < g && t16 == 0) {
      red_m[warp * G + j] = m_r[r];
      red_l[warp * G + j] = l_r[r];
    }
  }
  __syncthreads();
  if (tid < g) {
    float M = -INFINITY;
    for (int v = 0; v < W; ++v) M = fmaxf(M, red_m[v * G + tid]);
    float den = 0.f;
    for (int v = 0; v < W; ++v) {
      const float mv = red_m[v * G + tid];
      const float f = mv == -INFINITY ? 0.f : expf(mv - M);
      red_f[v * G + tid] = f;
      den = fmaf(red_l[v * G + tid], f, den);
    }
    blk_l[tid] = den;
  }
  __syncthreads();
  // VW columns a step (4 when d allows 16-byte accesses); a row with no
  // valid key gets 0 / 0 = NaN, as in the plain version
  auto merge_warps = [&](auto vw) {
    constexpr int VW = decltype(vw)::value;
    for (int e = tid; e < g * d / VW; e += blockDim.x) {
      const int j = e * VW / d, c = e * VW - j * d;
      float A[VW];
#pragma unroll
      for (int i = 0; i < VW; ++i) A[i] = 0.f;
      for (int v = 0; v < W; ++v) {
        const float f = red_f[v * G + j];
        float x[VW];
        load_f32<VW>(red + (v * G + j) * L.dp + c, x);
#pragma unroll
        for (int i = 0; i < VW; ++i) A[i] = fmaf(x[i], f, A[i]);
      }
#pragma unroll
      for (int i = 0; i < VW; ++i)
        narrow(out + (size_t)grp * g * d + e * VW + i, A[i] / blk_l[j]);
    }
  };
  if (d % 4 == 0)
    merge_warps(std::integral_constant<int, 4>());
  else
    merge_warps(std::integral_constant<int, 1>());
}

template <typename T, int G, int CPL>
cudaError_t launch_gc(const T* q, const T* cb_k, const T* cb_v,
                      const float* mass, const T* win_k, const T* win_v,
                      const float* win_mask, T* out, float* ws_acc,
                      float* ws_ml, int* counters, int n, int g, int d,
                      int kcb, int w, int splits, float scale,
                      cudaStream_t stream) {
  // the opt-in to large dynamic shared memory, once per device
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit == 0 || !(configured.load() & bit)) {
    err = cudaFuncSetAttribute(vq_attention_kernel<T, G, CPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kMaxSmem);
    if (err != cudaSuccess) return err;
    configured.fetch_or(bit);
  }
  const Layout<T, G> L(d);
  int warps = kMaxWarps;
  while (warps > 1 && L.bytes(warps) > kMaxSmem) warps >>= 1;
  if (L.bytes(warps) > kMaxSmem) return cudaErrorInvalidValue;
  const int vec = (d * sizeof(T)) % 16 == 0 &&
                  ((uintptr_t)q | (uintptr_t)cb_k | (uintptr_t)cb_v |
                   (uintptr_t)win_k | (uintptr_t)win_v) % 16 == 0;
  vq_attention_kernel<T, G, CPL>
      <<<(unsigned)(n * splits), warps * 32, L.bytes(warps), stream>>>(
          q, cb_k, cb_v, mass, win_k, win_v, win_mask, out, ws_acc, ws_ml,
          counters, g, d, kcb, w, splits, scale, vec);
  return cudaGetLastError();
}

template <typename T, int G>
cudaError_t launch_g(const T* q, const T* cb_k, const T* cb_v,
                     const float* mass, const T* win_k, const T* win_v,
                     const float* win_mask, T* out, float* ws_acc,
                     float* ws_ml, int* counters, int n, int g, int d,
                     int kcb, int w, int splits, float scale,
                     cudaStream_t stream) {
  if (d <= 64)
    return launch_gc<T, G, 2>(q, cb_k, cb_v, mass, win_k, win_v, win_mask,
                              out, ws_acc, ws_ml, counters, n, g, d, kcb, w,
                              splits, scale, stream);
  if (d <= 128)
    return launch_gc<T, G, 4>(q, cb_k, cb_v, mass, win_k, win_v, win_mask,
                              out, ws_acc, ws_ml, counters, n, g, d, kcb, w,
                              splits, scale, stream);
  return launch_gc<T, G, kMaxD / 32>(q, cb_k, cb_v, mass, win_k, win_v,
                                     win_mask, out, ws_acc, ws_ml, counters,
                                     n, g, d, kcb, w, splits, scale, stream);
}

template <typename T>
cudaError_t launch(const T* q, const T* cb_k, const T* cb_v,
                   const float* mass, const T* win_k, const T* win_v,
                   const float* win_mask, T* out, float* ws_acc,
                   float* ws_ml, int* counters, int n, int g, int d, int kcb,
                   int w, int splits, float scale, cudaStream_t stream) {
  if (n < 1 || g < 1 || g > kMaxG || d < 1 || d > kMaxD || kcb < 0 ||
      w < 0 || kcb + w < 1 || splits < 1 || splits > kMaxSplits ||
      (long long)n * splits > 0x7fffffffLL ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr ||
                      counters == nullptr)))
    return cudaErrorInvalidValue;
  if (g <= 4)
    return launch_g<T, 4>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out,
                          ws_acc, ws_ml, counters, n, g, d, kcb, w, splits,
                          scale, stream);
  if (g <= 8)
    return launch_g<T, 8>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out,
                          ws_acc, ws_ml, counters, n, g, d, kcb, w, splits,
                          scale, stream);
  return launch_g<T, kMaxG>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out,
                            ws_acc, ws_ml, counters, n, g, d, kcb, w, splits,
                            scale, stream);
}

}  // namespace

// q [n, g, d], cb_k / cb_v [n, k, d], mass [n, k] f32, win_k / win_v
// [n, w, d], win_mask [n, w] f32, out [n, g, d]; all contiguous; the
// element type is f32 or bf16 (one entry each); scale = 1 / sqrt(d).
// splits: blocks a group (1..64); with more than one, ws_acc [n, splits *
// 4, g, d] f32 and ws_ml [n, splits * 4, g, 2] f32 hold the partials (a
// slot for each warp of each block) and counters [n] int32, zero before
// the first launch, count the finished blocks (the kernel leaves them
// zero again); with one they may be null.
extern "C" cudaError_t repro_vq_attention_f32(
    const float* q, const float* cb_k, const float* cb_v, const float* mass,
    const float* win_k, const float* win_v, const float* win_mask,
    float* out, float* ws_acc, float* ws_ml, int* counters, int n, int g,
    int d, int kcb, int w, int splits, float scale, cudaStream_t stream) {
  return launch<float>(q, cb_k, cb_v, mass, win_k, win_v, win_mask, out,
                       ws_acc, ws_ml, counters, n, g, d, kcb, w, splits,
                       scale, stream);
}

extern "C" cudaError_t repro_vq_attention_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* cb_k,
    const __nv_bfloat16* cb_v, const float* mass,
    const __nv_bfloat16* win_k, const __nv_bfloat16* win_v,
    const float* win_mask, __nv_bfloat16* out, float* ws_acc, float* ws_ml,
    int* counters, int n, int g, int d, int kcb, int w, int splits,
    float scale, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, cb_k, cb_v, mass, win_k, win_v, win_mask,
                               out, ws_acc, ws_ml, counters, n, g, d, kcb, w,
                               splits, scale, stream);
}
