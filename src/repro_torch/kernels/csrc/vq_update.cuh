// Fused nearest-codeword assignment + cluster statistics (VQ-Update, the
// per-layer hot loop of Alg. 2) for every product-VQ branch in one launch.
//
// Replaces the TPU kernel src/repro/kernels/vq_update.py:
// vq_assign_update_pallas (_vq_update_kernel), which core/codebook.py:update
// vmaps over the branches.  For branch b and row i it returns
//     idx[b, i]  = argmin_c  |cw[b, c]|^2 - 2 x[b, i] . cw[b, c]
//     qerr[b, i] = max(min_c(...) + |x[b, i]|^2, 0)
// and accumulates counts[b, idx] += 1, sums[b, idx, :] += x[b, i, :].
// idx and qerr are the plain version's (ref.vq_assign_update) bit for bit:
// its distance is a dot product summed over j in order, every multiply and
// add rounded on its own, and the lowest index wins a tie (jnp.argmin).
//
// What bounds it on an H100.  The scan is 2*nb*b*k*f operations: 22.2
// GFLOP at the training shape (nb, b, f, k) = (32, 42335, 8, 1024), 0.33 ms
// at the 67 TFLOP/s fp32 peak -- but that peak counts FMAs, and the plain
// version's rounding forbids them: the first version (one thread a row,
// __fmul_rn/__fadd_rn over every codeword) took 1.21 ms, issue-bound.
// Here the distances run on the tensor cores and the kernel is bound by
// what follows them: per row and codeword pair, a compare-select fold of
// the approximate distances (~3 fp32 instructions a distance, nb*b*k of
// them: 0.13 ms at the card's fp32 issue rate at the shape above) beside
// the 3xTF32 products (3 * 2*nb*b*k*f_pad, f padded to a multiple of 8:
// 0.13 ms at 495 TFLOP/s).  PERF.md splits the measured time.
//
// Design: a persistent grid (the blocks one wave holds) splits the nb*b
// rows evenly; a block's range is cut at branch boundaries.  For each
// branch it meets, the block stages the [k, f] codewords in shared memory
// (f = 8 swizzled against bank conflicts) and their |c|^2 in the plain
// version's order.  A warp takes 32 rows at a time (two m16 tiles), staged
// in its shared memory where they fit:
//   1. the rows become TF32 A fragments of -2x, split hi + lo;
//   2. the scan: for every 8 codewords, mma.sync m16n8k8 computes
//      d~ = |c|^2 - 2 x.c as  lo*hi + hi*lo + hi*hi  products accumulated
//      onto |c|^2 (the C operand).  A lane holds 2 rows x 2 codewords of
//      a tile; tiles pair up, so per row it folds groups of 4 codewords:
//      the smallest group minimum, the group's first tile, and the second
//      smallest group minimum.  The next pair's mmas are issued before a
//      pair is folded;
//   3. the 4 lanes of a row merge theirs.  A row is settled when the
//      runner-up group's minimum exceeds min d~ + 2E (and that is finite):
//      only the winning group's codewords can then win, and they are
//      rescored exactly (the plain version's arithmetic) in increasing
//      index with a strict <.  Any other row joins its warp's queue (its
//      row and min d~ held in a lane's registers); 32 queued rows, or the
//      rest at the end of a branch, make a tile whose every codeword with
//      d~ <= min d~ + 2E is rescored exactly in increasing index (3 % of
//      the trained model's last-layer rows, 0.6 % of the first layer's).
// Why this is exact: |d~ - d| <= E for every codeword, with d the plain
// version's fp32 distance (bound below).  Then U = min d~ + E is at least
// the smallest d, and a codeword with d~ > min d~ + 2E has d >= d~ - E > U:
// it is neither the minimum nor tied with it.  So every codeword that can
// win (ties included) is rescored exactly, in index order.  A NaN d~ is a
// candidate in the rescoring pass (!(d~ > T)), and a row whose threshold is
// not finite rescores every codeword, as the first version scanned them.
//
// The bound E (the wrapper's candidate_bound mirrors it; the CPU test
// tests/test_torch_vq_scan.py checks it on an emulation of this scan).
// Let X = |x| cmax, cmax = max_c |c|, S = sum_j |x_j c_j| <= X; hi = v
// truncated to TF32's 10 mantissa bits, lo = (v - hi) truncated again, so
// |v - hi - lo| < 2^-20 |v| and |lo| < 2^-10 |v|.
//   (i)   the split: the terms dropped (lo*lo and the remainders) are
//         < 3.01 * 2^-20 * |2 x_j c_j| each: 6.02 * 2^-20 S in all;
//   (ii)  the tensor cores: products of TF32 values are exact; each mma's
//         accumulation is taken to err by at most eps_tc = 2^-20 times the
//         sum of the magnitudes it adds (<= cmax^2 + 4.02 X) -- fp32
//         accumulation errs by ~2^-23 of it: a probe of 67 M distances on
//         the card (random, mixed-magnitude, large-row and |c|^2-dominated
//         inputs) found at most 0.6 of 2^-20 (cmax^2 + 4X) in all -- with
//         3 * ceil(f / 8) mmas a distance;
//   (iii) the plain version's own rounding: <= (2f + 3) 2^-24 (cmax^2 + 2X).
// With n_mma = 3 ceil(f / 8) and f <= 32 this sums to less than
//     E = (n_mma + 6) * 2^-20 * (cmax^2 + 4 |x| cmax) + 2^-118 (1 + |x| + cmax)
// (the +1 in n_mma + 6 covers the fp32 evaluation of E; the last term,
// subnormal products a tensor core may flush).  On real rows a gap under
// ~1e-5 relative is rare, so nearly every row is settled.
//
// Statistics: each lane takes one row; the warp combines the rows that
// chose the same codeword (__match_any_sync, then a shuffle tree over the
// peers) and one lane adds the group's count and sums with global atomics.
// A collapsed codebook costs one add per warp and codeword, not one per
// row (the first version: 4.3 ms at the training batch, 12.0 at the
// hybrid's).  A per-block copy of the statistics in shared memory was
// measured slower in every case, the hot spot included (its fp32 adds are
// compare-and-swap loops, and its footprint cost occupancy), and is not
// kept.  Counts are whole numbers and exact in any order; sums depend on
// the order of the adds (chip_smoke.py's scatter bound) and are exact on
// grid rows.
//
// f = 21 (the gradient half of the 40-class layer is 5 wide) pads to 24
// in the fragments; the two training widths (8 and 21) are compile-time
// instantiations, any other f <= 32 takes the generic one (4 k-steps,
// runtime f), also exported on its own (repro_vq_update_generic_f32) so
// that chip_smoke.py can time it at the training widths.
//
// Narrow emit, repro_vq_update_u8_f32: the same kernel with the assignment
// written as uint8 (emit_dtype uint8, k <= 256, the int8 / fp8 tiers'
// table type; and uint4, k <= 16, whose ids the wrapper returns in the
// same uint8 tensor).  The index type is a template parameter.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxF = 32;            // widest row the generic build holds
constexpr unsigned kFull = 0xffffffffu;
constexpr float kEpsBound = 9.5367431640625e-07f;   // 2^-20
constexpr float kTinyBound = 3.0092655e-36f;        // 2^-118

template <int F>
struct Cfg {
  static constexpr int KS = F > 0 ? (F + 7) / 8 : kMaxF / 8;   // k-steps
  static constexpr int MT = 2;                   // m16 row tiles per warp
  static constexpr int R = 16 * MT;              // rows per warp tile
  static constexpr int W = F > 0 ? F : kMaxF;    // register row width
};

// Element (c, j) of the staged codewords.  f = 8: the two halves of a row
// swap for c & 4, so the 8 codewords x 4 lanes of a B fragment load hit
// 32 distinct banks.
template <int F>
__device__ __forceinline__ int cw_off(int c, int j, int fd) {
  if (F == 8) return c * 8 + (j ^ (c & 4));
  return c * fd + j;
}

// v = hi + lo + r with hi, lo TF32 (low 13 bits zero), |r| < 2^-20 |v|.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi))) & 0xffffe000u;
}

// d = A B + c on the tensor cores (m16n8k8, TF32 in, fp32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1,
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The plain version's distance |c|^2 - 2 x.c of one row (staged in shared
// memory, or global) and one staged codeword, each multiply and add rounded
// on its own.
template <int F>
__device__ __forceinline__ float exact_dist(const float* xr,
                                            const float* c_s,
                                            const float* cn2_s, int c,
                                            int fd) {
  constexpr int W = Cfg<F>::W;
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < W; ++j)
    if (j < fd) dot = __fadd_rn(dot, __fmul_rn(xr[j], c_s[cw_off<F>(c, j, fd)]));
  return __fsub_rn(cn2_s[c], __fmul_rn(2.f, dot));
}

// The B fragments (codewords nt*8 + g at k-rows q, q + 4 of every k-step,
// split hi / lo) and the C pair (|c|^2 of columns 2q, 2q + 1).  tail: the
// last tile of a k that is not a multiple of 8 (zeros and +inf past k).
template <int F>
__device__ __forceinline__ void load_b(const float* c_s, const float* cn2_s,
                                       int nt, int g, int q, int k, int fd,
                                       int ks_n, bool tail,
                                       uint32_t (&bh)[Cfg<F>::KS][2],
                                       uint32_t (&bl)[Cfg<F>::KS][2],
                                       float (&cc)[2]) {
  const int c = nt * 8 + g;
#pragma unroll
  for (int ks = 0; ks < Cfg<F>::KS; ++ks) {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = ks * 8 + q + 4 * t;
      const float v = (ks < ks_n && j < fd && (!tail || c < k))
                          ? c_s[cw_off<F>(c, j, fd)] : 0.f;
      split_tf32(v, bh[ks][t], bl[ks][t]);
    }
  }
  const int c0 = nt * 8 + 2 * q;
  if (tail) {
    cc[0] = c0 < k ? cn2_s[c0] : INFINITY;
    cc[1] = c0 + 1 < k ? cn2_s[c0 + 1] : INFINITY;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(cn2_s + c0);
    cc[0] = v.x;
    cc[1] = v.y;
  }
}

// d~ of this lane's 2 rows x 2 codewords of one m-tile (fragment order):
// the small products first, onto |c|^2 (the C operand), then hi * hi.
template <int F>
__device__ __forceinline__ void tile_dist(
    float (&d)[4], const uint32_t (&ah)[Cfg<F>::KS][4],
    const uint32_t (&al)[Cfg<F>::KS][4], const uint32_t (&bh)[Cfg<F>::KS][2],
    const uint32_t (&bl)[Cfg<F>::KS][2], const float (&cc)[2], int ks_n) {
  const float c4[4] = {cc[0], cc[1], cc[0], cc[1]};
  mma_tf32(d, al[0], bh[0][0], bh[0][1], c4);
  mma_tf32(d, ah[0], bl[0][0], bl[0][1], d);
#pragma unroll
  for (int ks = 1; ks < Cfg<F>::KS; ++ks) {
    if (ks < ks_n) {
      mma_tf32(d, al[ks], bh[ks][0], bh[ks][1], d);
      mma_tf32(d, ah[ks], bl[ks][0], bl[ks][1], d);
    }
  }
#pragma unroll
  for (int ks = 0; ks < Cfg<F>::KS; ++ks)
    if (ks < ks_n) mma_tf32(d, ah[ks], bh[ks][0], bh[ks][1], d);
}

// d~ of 8 codewords (tile nt) for the warp tile's MT m-tiles.
template <int F, bool Tail = false>
__device__ __forceinline__ void tile_all(
    float (&d)[Cfg<F>::MT][4], int nt, const float* c_s, const float* cn2_s,
    int g, int q, int k, int fd, int ks_n,
    const uint32_t (&ah)[Cfg<F>::MT][Cfg<F>::KS][4],
    const uint32_t (&al)[Cfg<F>::MT][Cfg<F>::KS][4]) {
  uint32_t bh[Cfg<F>::KS][2], bl[Cfg<F>::KS][2];
  float cc[2];
  load_b<F>(c_s, cn2_s, nt, g, q, k, fd, ks_n, Tail, bh, bl, cc);
#pragma unroll
  for (int mt = 0; mt < Cfg<F>::MT; ++mt)
    tile_dist<F>(d[mt], ah[mt], al[mt], bh, bl, cc, ks_n);
}

// A tile of queued near-tie rows: every candidate (d~ <= thr) of a row
// marked fb is rescored exactly, strict < in increasing index per lane;
// xr: this lane's rows (mt, h).
template <int F>
__device__ __forceinline__ void rescore_tile(
    int nt, bool tail, const float* c_s, const float* cn2_s,
    const float* const (&xr)[Cfg<F>::MT][2], int g, int q, int k, int fd,
    int ks_n,
    const uint32_t (&ah)[Cfg<F>::MT][Cfg<F>::KS][4],
    const uint32_t (&al)[Cfg<F>::MT][Cfg<F>::KS][4],
    const float (&thr)[Cfg<F>::MT][2], const bool (&fb)[Cfg<F>::MT][2],
    float (&bd)[Cfg<F>::MT][2], int (&bi)[Cfg<F>::MT][2]) {
  constexpr int MT = Cfg<F>::MT;
  float d[MT][4];
  if (tail)
    tile_all<F, true>(d, nt, c_s, cn2_s, g, q, k, fd, ks_n, ah, al);
  else
    tile_all<F>(d, nt, c_s, cn2_s, g, q, k, fd, ks_n, ah, al);
  bool any = false;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      any |= fb[mt][i >> 1] && !(d[mt][i] > thr[mt][i >> 1]);
  if (!any) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = nt * 8 + 2 * q + (i & 1), h = i >> 1;
      if (fb[mt][h] && !(d[mt][i] > thr[mt][h]) && c < k) {
        const float ex = exact_dist<F>(xr[mt][h], c_s, cn2_s, c, fd);
        if (ex < bd[mt][h]) {          // strict: the lowest index keeps ties
          bd[mt][h] = ex;
          bi[mt][h] = c;
        }
      }
    }
  }
}

template <int F, typename Idx>
__global__ void __launch_bounds__(kThreads)
vq_update_kernel(const float* __restrict__ x, const float* __restrict__ cw,
                 Idx* __restrict__ idx, float* __restrict__ qerr,
                 float* __restrict__ counts, float* __restrict__ sums, int nb,
                 int n, int k, int f, long long per_block, int stage_x) {
  using C = Cfg<F>;
  constexpr int KS = C::KS, MT = C::MT, R = C::R, W = C::W;
  const int fd = F > 0 ? F : f;
  const int ks_n = F > 0 ? KS : (f + 7) / 8;
  const int nt_full = k / 8;                     // tiles with no codeword past k
  const int nt_n = (k + 7) / 8;
  const float e_coef = (float)(3 * ks_n + 6) * kEpsBound;
  extern __shared__ float smem[];
  float* cn2_s = smem;                                 // [k]
  float* c_s = smem + k;                               // [k, fd]
  float* x_s = c_s + (size_t)k * fd;                  // [warps, R, fd]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;

  const long long total = (long long)nb * n;
  const long long lo = (long long)blockIdx.x * per_block;
  const long long hi = lo + per_block < total ? lo + per_block : total;
  for (long long s = lo; s < hi;) {
    const int br = (int)(s / n);
    const long long br_end = (long long)(br + 1) * n;
    const long long e = hi < br_end ? hi : br_end;
    const int row0 = (int)(s - (long long)br * n);
    const int rows = (int)(e - s);
    const float* xb = x + (size_t)br * n * fd;

    // ---- stage this branch's codewords and |c|^2 ----
    __syncthreads();                 // the previous branch is done
    const float* cwb = cw + (size_t)br * k * fd;
    for (int i = threadIdx.x; i < k * fd; i += kThreads) {
      const int c = i / fd;
      c_s[cw_off<F>(c, i - c * fd, fd)] = cwb[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < k; c += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < fd; ++j) {
        const float v = c_s[cw_off<F>(c, j, fd)];
        acc = __fadd_rn(acc, __fmul_rn(v, v));
      }
      cn2_s[c] = acc;
    }
    __syncthreads();
    float cm2 = 0.f;                 // max |c|^2 (fmaxf: a NaN codeword is
    for (int c = lane; c < k; c += 32) cm2 = fmaxf(cm2, cn2_s[c]);   // only
#pragma unroll                       // ever a candidate, never a winner)
    for (int o = 16; o; o >>= 1) cm2 = fmaxf(cm2, __shfl_xor_sync(kFull, cm2, o));
    const float cmax = sqrtf(cm2);

    // ---- warp tiles of R rows; near-tie rows queue up per warp ----
    float* xw = x_s + (size_t)warp * R * fd;   // this warp's rows (stage_x)
    int qn = 0, qrow = 0;                      // lane l holds queue entry l:
    float qm1 = 0.f;                           // its row and its min d~
    uint32_t ah[MT][KS][4], al[MT][KS][4];
    float xn[MT][2];
    // A fragments of -2x (rows g, g + 8 of each m-tile; k-cols q, q + 4)
    // and the rows' norms, the rows given by a pointer each
    auto build = [&](auto rowp, int valid) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          const float* xr = rowp(r < valid ? r : 0);
          float s2 = 0.f;
#pragma unroll
          for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
            for (int t = 0; t < 2; ++t) {
              const int j = ks * 8 + q + 4 * t;
              const float v = (r < valid && ks < ks_n && j < fd) ? xr[j] : 0.f;
              s2 = fmaf(v, v, s2);
              split_tf32(-2.f * v, ah[mt][ks][h + 2 * t], al[mt][ks][h + 2 * t]);
            }
          }
          s2 += __shfl_xor_sync(kFull, s2, 1);
          s2 += __shfl_xor_sync(kFull, s2, 2);
          xn[mt][h] = sqrtf(s2);
        }
      }
    };
    auto bound2 = [&](float xr) {   // 2E for a row of norm xr
      return 2.f * (e_coef * (cm2 + 4.f * xr * cmax)
                    + kTinyBound * (1.f + xr + cmax));
    };
    // One lane's row: idx and qerr (ok), and the warp's statistics (every
    // lane calls it): the lanes that chose the same codeword are combined
    // (__match_any_sync, then a shuffle tree over the peers) and one adds
    // the group's count and sums.
    auto finish = [&](bool ok, int row, const float* xr, float best,
                      int arg) {
      float xv[W];
      float xn2 = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        xv[j] = (ok && j < fd) ? xr[j] : 0.f;
        if (j < fd) xn2 = __fadd_rn(xn2, __fmul_rn(xv[j], xv[j]));
      }
      if (ok) {
        const size_t out = (size_t)br * n + row;
        idx[out] = (Idx)arg;
        qerr[out] = fmaxf(__fadd_rn(best, xn2), 0.f);
      }
      const int key = ok ? arg : -1;
      const unsigned peers = __match_any_sync(kFull, key);
      const int first = __ffs(peers) - 1;
      unsigned rest = peers & (0xfffffffeu << lane);
      int rel = __popc(peers & ((1u << lane) - 1u));
      while (__any_sync(kFull, rest)) {
        const int next = __ffs(rest);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          if (j < fd) {
            const float tv = __shfl_sync(kFull, xv[j], (next - 1) & 31);
            if (next) xv[j] += tv;
          }
        }
        rest &= ~__ballot_sync(kFull, rel & 1);
        rel >>= 1;
      }
      if (lane == first && key >= 0) {
        const size_t cid = (size_t)br * k + arg;
        atomicAdd(counts + cid, (float)__popc(peers));
        float* srow = sums + cid * fd;
#pragma unroll
        for (int j = 0; j < W; ++j)
          if (j < fd) atomicAdd(srow + j, xv[j]);
      }
    };
    // The queued rows as one tile: every candidate rescored exactly.
    auto drain = [&]() {
      const int valid = qn;
      if (stage_x) {
        __syncwarp();
        if (lane < valid)
          for (int j = 0; j < fd; ++j)
            xw[lane * fd + j] = xb[(size_t)qrow * fd + j];
        __syncwarp();
      }
      auto rowp = [&](int r) -> const float* {
        const int qr = __shfl_sync(kFull, qrow, r);
        return stage_x ? xw + r * fd : xb + (size_t)qr * fd;
      };
      build(rowp, valid);
      const float* xr[MT][2];
      float thr[MT][2], bd[MT][2];
      bool fb[MT][2];
      int bi[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          xr[mt][h] = rowp(r < valid ? r : 0);
          thr[mt][h] = __shfl_sync(kFull, qm1, r) + bound2(xn[mt][h]);
          fb[mt][h] = r < valid;
          bd[mt][h] = INFINITY;
          bi[mt][h] = 0;
        }
      }
      for (int nt = 0; nt < nt_n; ++nt)
        rescore_tile<F>(nt, nt == nt_full, c_s, cn2_s, xr, g, q, k, fd, ks_n,
                        ah, al, thr, fb, bd, bi);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            const float od = __shfl_xor_sync(kFull, bd[mt][h], o);
            const int oi = __shfl_xor_sync(kFull, bi[mt][h], o);
            if (od < bd[mt][h] || (od == bd[mt][h] && oi < bi[mt][h])) {
              bd[mt][h] = od;
              bi[mt][h] = oi;
            }
          }
        }
      }
      // lane q of a quad takes quad row q + 4 * round (row g + 8h of m-tile
      // mt is quad row 2 mt + h)
#pragma unroll
      for (int rd = 0; rd < (2 * MT + 3) / 4; ++rd) {
        const int qi = q + 4 * rd;
        float best = INFINITY;
        int arg = 0, r = R;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (qi == 2 * mt + h) {
              best = bd[mt][h];
              arg = bi[mt][h];
              r = mt * 16 + g + 8 * h;
            }
        const bool ok = r < valid;
        const int row = __shfl_sync(kFull, qrow, ok ? r : 0);
        finish(ok, row, rowp(ok ? r : 0), best, arg);
      }
      qn = 0;
    };
    // Queue this lane's row (need) in slot order; drain whenever 32 wait.
    auto enqueue = [&](bool need, int row, float m) {
      const unsigned mask = __ballot_sync(kFull, need);
      int left = __popc(mask), done = 0;
      while (left > 0) {
        const int take = left < 32 - qn ? left : 32 - qn;
        const int off = lane - qn;         // the entry this lane receives
        const bool mine = off >= 0 && off < take;
        int src = lane;
        if (mine) {                        // the (done + off)-th enqueuer
          unsigned mm = mask;
          for (int i = 0; i < done + off; ++i) mm &= mm - 1;
          src = __ffs(mm) - 1;
        }
        const int rr = __shfl_sync(kFull, row, src);
        const float mv = __shfl_sync(kFull, m, src);
        if (mine) {
          qrow = rr;
          qm1 = mv;
        }
        qn += take;
        done += take;
        left -= take;
        if (qn == 32) drain();
      }
    };

    for (int t0 = warp * R; t0 < rows; t0 += kWarps * R) {
      const int valid = rows - t0 < R ? rows - t0 : R;
      const int rbase = row0 + t0;
      // the tile's rows, [valid, fd]: staged in this warp's shared memory
      // where it fits, else read in place
      const float* xt = xb + (size_t)rbase * fd;
      if (stage_x) {
        __syncwarp();
        for (int i = lane; i < valid * fd; i += 32) xw[i] = xt[i];
        __syncwarp();
        xt = xw;
      }
      build([&](int r) { return xt + r * fd; }, valid);

      // The scan.  A lane sees 2 codewords (columns 2q, 2q + 1) of every
      // tile; tiles pair up (0, 1), (2, 3), ... into groups of 4 codewords
      // a lane (an odd last tile and the tail tile stand alone).  Per row
      // and lane: m1, the smallest group minimum, n1 the first tile of
      // that group, and m2 the second smallest group minimum.  The next
      // pair's mmas are issued before a pair is folded in.
      float m1[MT][2], m2[MT][2];
      int n1[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          m1[mt][h] = m2[mt][h] = INFINITY;
          n1[mt][h] = 0;
        }
      }
      // a group's minimum lo, first tile nt: fold it into (m1, n1, m2)
      auto fold = [&](int mt, int h, float lo, int nt) {
        const bool p = lo < m1[mt][h];          // selects, not a branch
        m2[mt][h] = fminf(m2[mt][h], fmaxf(m1[mt][h], lo));
        n1[mt][h] = p ? nt : n1[mt][h];
        m1[mt][h] = fminf(m1[mt][h], lo);
      };
      auto fold1 = [&](const float (&d)[MT][4], int nt) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            fold(mt, h, fminf(d[mt][2 * h], d[mt][2 * h + 1]), nt);
      };
      auto fold2 = [&](const float (&da)[MT][4], const float (&db)[MT][4],
                       int nt) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            fold(mt, h,
                 fminf(fminf(da[mt][2 * h], da[mt][2 * h + 1]),
                       fminf(db[mt][2 * h], db[mt][2 * h + 1])),
                 nt);
      };
      {
        float da[MT][4], db[MT][4], dc[MT][4], dd[MT][4];
        const int pairs_end = nt_full & ~1;      // tiles 0 .. pairs_end - 1
        auto tile = [&](float (&d)[MT][4], int nt) {
          tile_all<F>(d, nt, c_s, cn2_s, g, q, k, fd, ks_n, ah, al);
        };
        if (pairs_end > 0) {
          tile(da, 0);
          tile(db, 1);
        }
        for (int nt = 0; nt < pairs_end; nt += 4) {
          if (nt + 2 < pairs_end) {
            tile(dc, nt + 2);
            tile(dd, nt + 3);
          }
          fold2(da, db, nt);
          if (nt + 2 >= pairs_end) break;
          if (nt + 4 < pairs_end) {
            tile(da, nt + 4);
            tile(db, nt + 5);
          }
          fold2(dc, dd, nt + 2);
        }
        if (pairs_end < nt_full) {
          tile(da, pairs_end);
          fold1(da, pairs_end);
        }
        if (nt_full * 8 < k) {
          tile_all<F, true>(da, nt_full, c_s, cn2_s, g, q, k, fd, ks_n, ah,
                            al);
          fold1(da, nt_full);
        }
      }
      // The 4 lanes of a row merge (min, runner-up, winning group's first
      // column).  Every group other than the winning one has a minimum of
      // at least the runner-up; so when that exceeds min d~ + 2E (a finite
      // bound) only the winning group's codewords can win: the row is
      // settled.  The others queue up.
      float a1v[MT][2];
      int cw0[MT][2];
      bool settled[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float a1 = m1[mt][h], a2 = m2[mt][h];
          int ac = n1[mt][h] * 8 + 2 * q;
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {
            const float b1 = __shfl_xor_sync(kFull, a1, o);
            const float b2 = __shfl_xor_sync(kFull, a2, o);
            const int bc = __shfl_xor_sync(kFull, ac, o);
            a2 = fminf(fmaxf(a1, b1), fminf(a2, b2));
            if (b1 < a1 || (b1 == a1 && bc < ac)) {
              a1 = b1;
              ac = bc;
            }
          }
          const float thr = a1 + bound2(xn[mt][h]);
          a1v[mt][h] = a1;
          cw0[mt][h] = ac;
          settled[mt][h] = isfinite(thr) && a2 > thr;
        }
      }
      // per row (lane q of a quad takes quad row q + 4 * round): a settled
      // row's two candidates rescored exactly, its outputs and statistics;
      // then the unsettled rows join the queue
      constexpr int kRounds = (2 * MT + 3) / 4;
      bool need[kRounds];
      int qrow_r[kRounds];
      float qm1_r[kRounds];
#pragma unroll
      for (int rd = 0; rd < kRounds; ++rd) {
        const int qi = q + 4 * rd;
        float best = INFINITY, m = 0.f;
        int arg = 0, r = R;
        bool done = false;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (qi == 2 * mt + h) {
              done = settled[mt][h];
              arg = cw0[mt][h];
              m = a1v[mt][h];
              r = mt * 16 + g + 8 * h;
            }
        const bool ok = r < valid;
        const float* xr = xt + (ok ? r : 0) * fd;
        if (ok && done) {
          // the winning group's codewords (columns 2q, 2q + 1 of its tile
          // and the next; a lone tile's neighbour only adds candidates),
          // rescored exactly in increasing index, strict <
          const int c0 = arg;
          arg = c0;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int c = c0 + (u & 1) + 8 * (u >> 1);
            if (c < k) {
              const float e = exact_dist<F>(xr, c_s, cn2_s, c, fd);
              if (e < best) {
                best = e;
                arg = c;
              }
            }
          }
        }
        finish(ok && done, rbase + r, xr, best, arg);
        need[rd] = ok && !done;
        qrow_r[rd] = rbase + r;
        qm1_r[rd] = m;
      }
#pragma unroll
      for (int rd = 0; rd < kRounds; ++rd) enqueue(need[rd], qrow_r[rd], qm1_r[rd]);
    }
    if (qn > 0) drain();
    s = e;
  }
}

// Shared memory: |c|^2 and the codewords, k (f + 1) floats (the first
// version's footprint, so every shape it took still runs), then, where
// they fit, the warps' row tiles.  One wave of blocks, each an equal share
// of the nb * n rows.
template <int F, typename Idx>
cudaError_t launch(const float* x, const float* cw, Idx* idx, float* qerr,
                   float* counts, float* sums, int nb, int n, int k, int f,
                   cudaStream_t stream) {
  int dev = 0, limit = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(
           &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const size_t base = ((size_t)k * f + (size_t)k) * sizeof(float);
  const size_t xtile = (size_t)kWarps * Cfg<F>::R * f * sizeof(float);
  if (base > (size_t)limit) return cudaErrorInvalidValue;
  const int stage_x = base + xtile <= (size_t)limit;
  const size_t smem = base + (stage_x ? xtile : 0);
  auto kern = vq_update_kernel<F, Idx>;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long total = (long long)nb * n;
  const long long tiles = (total + Cfg<F>::R - 1) / Cfg<F>::R;
  long long grid = (long long)per_sm * sms;
  if (grid > tiles) grid = tiles;
  const long long per_block = (total + grid - 1) / grid;
  grid = (total + per_block - 1) / per_block;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(
      x, cw, idx, qerr, counts, sums, nb, n, k, f, per_block, stage_x);
  return cudaGetLastError();
}

template <typename Idx>
cudaError_t dispatch(const float* x, const float* cw, Idx* idx, float* qerr,
                     float* counts, float* sums, int nb, int n, int k, int f,
                     cudaStream_t stream) {
  if (f < 1 || f > kMaxF || k < 1 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
  switch (f) {
    case 8:
      return launch<8>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
    case 21:
      return launch<21>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
    default:
      return launch<0>(x, cw, idx, qerr, counts, sums, nb, n, k, f, stream);
  }
}

}  // namespace
