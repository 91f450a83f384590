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
// of operands: ~0.10 ms at the 989 TFLOP/s bf16 tensor-core peak.
//
// Two kernels, picked by an explicit rule in the wrapper
// (kernels/flash_attention.py), each with its own entry point:
//
// 1. repro_flash_attention_tc_bf16, the tensor-core route: bf16 operands,
//    d 64 or 128, 16-byte aligned.  Both products run on the tensor cores
//    with wgmma (sm_90a): S = Q K^T with Q and K read from shared memory
//    (bf16 in, f32 accumulate), and O += P V with P from registers and V
//    from shared memory (V row-major, so its descriptor is the transposed,
//    MN-major one).  A block is two consumer warpgroups of 64 query rows
//    each and two producer warps.  The producers stream K and V in tiles
//    of 128 keys through a ring of 3 shared-memory stages with cp.async
//    (zero-filled past skv); an mbarrier per stage says "full" when its
//    copies land and another says "empty" when both warpgroups have
//    released it, so the warpgroups run out of step with each other and
//    one's softmax can overlap the other's products.  The tiles use the
//    descriptors' no-swizzle layout: 8-row x 16-byte core matrices, each
//    128 contiguous bytes, the d direction's core matrices adjacent.  The
//    online softmax runs in f32 registers on the wgmma accumulator layout
//    (two rows a thread, reduced over the 4 lanes that share a row), in
//    base 2.  The weights P are split as P_hi = bf16(P) and P_lo = bf16(P
//    - P_hi), and O takes both products: a single bf16 P rounds each
//    weight by up to 2^-9 and moves near-zero outputs past two bf16 ulps
//    of the f32 softmax; the split keeps ~16 bits of each weight for 1.5x
//    the FLOPs of one PV product.  The denominator sums the f32 weights.
//    Key tiles past the last key a causal block can see are never loaded,
//    a warpgroup skips the tiles none of its rows sees, and only tiles
//    that cross the diagonal or skv are masked.  Blocks take the query
//    tiles last-first, so a causal grid starts with its longest blocks.
// 2. repro_flash_attention_{f32,bf16}, the FMA route, for f32 operands and
//    every other head width (d <= 256): no tensor cores, its products run
//    as f32 FMAs (67 TFLOP/s peak).  Grid (query tiles of kBQ = 64 rows,
//    batch x heads).  The block keeps its query tile, pre-scaled, in
//    shared memory as f32 and streams the keys and values in tiles of
//    kBK = 32 through shared memory, widened to f32 (16-byte loads where
//    the rows allow, attention_common.cuh).  256 threads = 16 row groups of
//    4 rows x 16 column lanes.  For scores a thread computes its 4 rows
//    against keys lane and lane + 16; the 16 lanes of a row group reduce
//    each row's max and sum with warp shuffles, keep the running max and
//    denominator in registers, rescale by exp(m_old - m_new) and write the
//    weights to shared memory; then each thread adds weight x value for
//    its 4 rows and the columns lane + 16 * i into f32 registers.
//
// Both: a masked key, or one past skv, gets weight exactly 0; query rows
// past sq are not stored (ragged tails at any sq and skv).  The output is
// acc / denominator in the input's type; a query that sees no key gets
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

// ---------------------------------------------------------------------------
// the tensor-core route: bf16, d 64 or 128
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kWG = 2;                  // consumer warpgroups a block
constexpr int kProducers = 64;          // two producer warps
constexpr int kThreads = 128 * kWG + kProducers;
constexpr int kBQ = 64;                 // query rows a warpgroup
constexpr int kBK = 128;                // keys a tile
constexpr int kStages = 3;              // K / V tiles in flight
constexpr int kMaxQTiles = 65535;       // query tiles ride grid.y

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes
__device__ __forceinline__ void cp16(unsigned dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned addr, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr),
               "r"(count));
}
__device__ __forceinline__ void mbar_wait(unsigned addr, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned addr) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
// arrives on the barrier once this thread's earlier cp.async copies land
__device__ __forceinline__ void mbar_arrive_cp(unsigned addr) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(addr)
      : "memory");
}

// Rows [g0, g0 + rows) of a row-major [n, D] bf16 matrix into shared
// memory at dst in the no-swizzle core-matrix layout -- 16-byte chunk c of
// row r at ((r / 8) * (D / 8) + c) * 128 + (r % 8) * 16 -- copied by
// `nthreads` threads of which this one is `t`.  Rows past n are zeros (a
// zero V row times a zero weight adds nothing; a NaN could).
template <int D>
__device__ __forceinline__ void load_rows(unsigned dst,
                                          const __nv_bfloat16* src, int g0,
                                          int rows, int n, int t,
                                          int nthreads) {
  constexpr int C = D / 8;
  for (int e = t; e < rows * C; e += nthreads) {
    const int cm = e >> 3, r = e & 7;
    const int row = (cm / C) * 8 + r, c = cm - (cm / C) * C;
    const int g = g0 + row;
    cp16(dst + e * 16, src + (size_t)min(g, n - 1) * D + c * 8,
         g < n ? 16 : 0);
  }
}

// wgmma shared-memory descriptor, no swizzle: lbo is the byte stride
// between core matrices along K, sbo along M / N
__device__ __forceinline__ uint64_t desc(unsigned addr, unsigned lbo,
                                         unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D[64, N] (+)= A[64, 16] B[16, N], f32 += bf16 x bf16.  _rs..._tb: A from
// registers (the m16n8k16 fragment of each warp's 16 rows), B MN-major in
// shared memory; _ss: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n64_tb(float* d,
                                                   const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, "
      "p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_m64n128_tb(float* d,
                                                    const uint32_t* a,
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_m64n128(float* d, uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_m64n128_tb(o, a, db);
  else
    wgmma_rs_m64n64_tb(o, a, db);
}

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(kWG * kBQ + 2 * kStages * kBK) * D * 2 + 2 * kStages * 8;
}

// grid (batch x heads, query tiles of kWG * kBQ rows, last tile first).
// Warps 0-7 are the two consumer warpgroups, warps 8-9 the producers.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int sq, int skv, int causal,
                float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int C = D / 8;
  constexpr int NJ = kBK / 8;                 // 8-key column groups a tile
  constexpr unsigned kGroup = C * 128;       // bytes between 8-row groups
  constexpr unsigned kTile = kBK * D * 2;     // bytes of one K or V tile
  const unsigned q_s = smem_u32(smem);
  const unsigned k_s = q_s + kWG * kBQ * D * 2;
  const unsigned v_s = k_s + kStages * kTile;
  const unsigned full = v_s + kStages * kTile;   // kStages mbarriers each
  const unsigned empty = full + kStages * 8;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int warp = (tid >> 5) & 3, lane = tid & 31;
  const size_t bh = blockIdx.x;
  const int q0 = (int)(gridDim.y - 1 - blockIdx.y) * (kWG * kBQ);
  const __nv_bfloat16* qb = q + bh * sq * D;
  const __nv_bfloat16* kb = k + bh * skv * D;
  const __nv_bfloat16* vb = v + bh * skv * D;
  const int off = skv - sq;              // query i sees keys j <= i + off
  const int nq = min(kWG * kBQ, sq - q0);
  const int n_keys = causal ? max(0, min(skv, q0 + nq + off)) : skv;
  const int n_tiles = (n_keys + kBK - 1) / kBK;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full + 8 * st, kProducers);  // the producers' lanes
      mbar_init(empty + 8 * st, kWG);        // one arrival a warpgroup
    }
  }
  __syncthreads();

  if (wg == kWG) {
    // the producer warps: tile j into stage j % kStages once both
    // warpgroups have released the tile that stage held before
    const int t = tid - 128 * kWG;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      if (j >= kStages) mbar_wait(empty + 8 * st, (j / kStages - 1) & 1);
      load_rows<D>(k_s + st * kTile, kb, j * kBK, kBK, skv, t, kProducers);
      load_rows<D>(v_s + st * kTile, vb, j * kBK, kBK, skv, t, kProducers);
      mbar_arrive_cp(full + 8 * st);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  const int w0 = q0 + wg * kBQ;              // this warpgroup's first row
  const int w_last = min(w0 + kBQ, sq) - 1;  // its last real row
  const int ra = w0 + warp * 16 + (lane >> 2), rb = ra + 8;
  const int cq = 2 * (lane & 3);
  const unsigned qa = q_s + wg * (kBQ / 8) * kGroup;
  load_rows<D>(qa, qb, w0, kBQ, sq, tid & 127, 128);
  cp_commit_wait_all();
  // the copies (generic proxy) visible to wgmma (async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % kStages;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int k0 = j * kBK;
    if (w_last >= w0 && (!causal || k0 <= w_last + off)) {
      float s[kBK / 2];
      const unsigned ka = k_s + st * kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_m64n128(s, desc(qa + kk * 256, 128, kGroup),
                         desc(ka + kk * 256, 128, kGroup), kk > 0);
      wgmma_commit_wait();

      // s[4 * jn + e]: row (e < 2 ? ra : rb), key k0 + 8 * jn + cq + (e & 1)
      if (k0 + kBK > skv || (causal && k0 + kBK - 1 > w0 + off)) {
#pragma unroll
        for (int jn = 0; jn < NJ; ++jn)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * jn + cq + (e & 1);
            const int row = e < 2 ? ra : rb;
            if (key >= skv || (causal && key > row + off))
              s[4 * jn + e] = -INFINITY;
          }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < NJ; ++jn) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * jn], s[4 * jn + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * jn + 2], s[4 * jn + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ <= 2; o_ <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(~0u, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(~0u, mx_b, o_));
      }
      // running maxima in log2 units; -inf (nothing visible yet) -> 0
      const float mn_a = fmaxf(m_a, mx_a * scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * scale_log2);
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      // P as the A fragments of the kBK / 16 k-steps, hi and lo halves:
      // pair i holds keys 2i, 2i + 1 of this thread's row (i even: a)
      uint32_t ph[kBK / 4], pl[kBK / 4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 4; ++i) {
        const float mu = (i & 1) ? mu_b : mu_a;
        const float p0 = exp2f(fmaf(s[2 * i], scale_log2, -mu));
        const float p1 = exp2f(fmaf(s[2 * i + 1], scale_log2, -mu));
        if (i & 1)
          sum_b += p0 + p1;
        else
          sum_a += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo =
            __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        ph[i] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[i] = *reinterpret_cast<const uint32_t*>(&lo);
      }
      l_a = l_a * al_a + sum_a;        // this thread's share of the row
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        o[4 * jd] *= al_a;
        o[4 * jd + 1] *= al_a;
        o[4 * jd + 2] *= al_b;
        o[4 * jd + 3] *= al_b;
      }
      const unsigned va = v_s + st * kTile;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t dv = desc(va + 2 * kk * kGroup, kGroup, 128);
        wgmma_pv<D>(o, ph + 4 * kk, dv);
        wgmma_pv<D>(o, pl + 4 * kk, dv);
      }
      wgmma_commit_wait();
    }
    // this warpgroup is done with the stage: one arrival releases it
    if ((tid & 127) == 0) mbar_arrive(empty + 8 * st);
  }

#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l_a += __shfl_xor_sync(~0u, l_a, o_);
    l_b += __shfl_xor_sync(~0u, l_b, o_);
  }
  __nv_bfloat16* ob = out + bh * sq * D;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int col = 8 * jd + cq;
    if (ra < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)ra * D + col) =
          __floats2bfloat162_rn(o[4 * jd] / l_a, o[4 * jd + 1] / l_a);
    if (rb < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rb * D + col) =
          __floats2bfloat162_rn(o[4 * jd + 2] / l_b, o[4 * jd + 3] / l_b);
  }
}

template <int D>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, int bh,
                   int sq, int skv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)bh, (unsigned)((sq + kWG * kBQ - 1) / (kWG * kBQ)));
  flash_tc_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, out, sq, skv, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace tc

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

// The tensor-core route: as repro_flash_attention_bf16 for d 64 or 128,
// every pointer 16-byte aligned.
extern "C" cudaError_t repro_flash_attention_tc_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* out, int bh, int sq, int skv, int d, int causal,
    float scale, cudaStream_t stream) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                        (uintptr_t)out;
  if (bh < 1 || sq < 1 || skv < 1 || any % 16 != 0 ||
      (sq + tc::kWG * tc::kBQ - 1) / (tc::kWG * tc::kBQ) > tc::kMaxQTiles)
    return cudaErrorInvalidValue;
  if (d == 64)
    return tc::launch<64>(q, k, v, out, bh, sq, skv, causal, scale, stream);
  if (d == 128)
    return tc::launch<128>(q, k, v, out, bh, sq, skv, causal, scale,
                           stream);
  return cudaErrorInvalidValue;
}
