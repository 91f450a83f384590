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
//   3. the 4 lanes of a row merge theirs, and the winning group's
//      codewords are rescored exactly (the plain version's arithmetic) in
//      increasing index with a strict <, giving u, an exact distance and
//      so at least the row's smallest d, and the threshold T below.  A row
//      is settled when the runner-up group's minimum exceeds T (and T is
//      finite): only the winning group's codewords can then win.  Any
//      other row joins its warp's queue (its row and T held in a lane's
//      registers); 32 queued rows, or the rest at the end of a branch,
//      make a tile whose every codeword with d~ <= T is rescored exactly
//      in increasing index.
// Why this is exact.  For every codeword c, |d~_c - d_c| <= E(|x|, |c|),
// with d the plain version's fp32 distance and E increasing in |c|
// (below).  A codeword that can win (ties included) has d_c <= min d <= u.
// Its norm is then at most r(|x|, u): d_c >= (1 - rho)|c|^2 - (2 + 2rho)
// |x||c| (Cauchy-Schwarz and the plain version's rounding, rho = 2^-17 >=
// (2f + 3) 2^-24), which exceeds u for every |c| above the positive root
//     r = ((1 + rho)|x| + sqrt((1 + rho)^2 |x|^2 + (1 - rho) u)) / (1 - rho)
// (evaluated with margins: b = |x| (1 + 2^-14), the root of
// max(b^2 + u, 0) + 2^-16 (b^2 + |u|), times 1 + 2^-14).  So it has
//     d~_c <= u + E(|x|, min(cmax, r)) = T,
// and a codeword with d~ > T is neither the minimum nor tied with it: every
// codeword that can win is rescored exactly, in index order.  (Where the
// runner-up group's minimum does not exceed min d~, the winning group is
// not rescored; u <= d_a <= min d~ + E(|x|, cmax) for a, the codeword of
// min d~, stands in for it, a looser T.)  T uses the
// norms near the row, not the branch's largest: a trained codebook's few
// far-out codewords (norms 10x the rows') would otherwise widen the band
// of every row.  A NaN d~ is a candidate in the rescoring pass
// (!(d~ > T)), and a row whose threshold is not finite rescores every
// codeword, as the first version scanned them.
//
// The bound E (the wrapper's candidate_bound mirrors it, norm_cap the norm
// r; the CPU test tests/test_torch_vq_scan.py checks both on an emulation
// of this scan).  Let X = |x| |c|, S = sum_j |x_j c_j| <= X; hi = v
// truncated to TF32's 10 mantissa bits, lo = (v - hi) truncated again, so
// |v - hi - lo| < 2^-20 |v| and |lo| < 2^-10 |v|.
//   (i)   the split: the terms dropped (lo*lo and the remainders) are
//         < 3.01 * 2^-20 * |2 x_j c_j| each: 6.02 * 2^-20 S in all;
//   (ii)  the tensor cores: products of TF32 values are exact; each mma's
//         accumulation is taken to err by at most eps_tc = 2^-20 times the
//         sum of the magnitudes it adds (<= |c|^2 + 4.02 X) -- fp32
//         accumulation errs by ~2^-23 of it: a probe of 67 M distances on
//         the card (random, mixed-magnitude, large-row and |c|^2-dominated
//         inputs) found at most 0.6 of 2^-20 (cmax^2 + 4X) in all -- with
//         at most 3 * ceil(f / 8) mmas a distance (two at vq_assign's
//         f 4, whose one 4-deep step takes an m16n8k8 and an m16n8k4);
//   (iii) the plain version's own rounding: <= (2f + 3) 2^-24 (|c|^2 + 2X).
// With n_mma = 3 ceil(f / 8) and f <= 32 this sums to less than
//     E = (n_mma + 6) * 2^-20 * (|c|^2 + 4 |x| |c|) + 2^-118 (1 + |x| + |c|)
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
//
// vq_assign.cu instantiates the same kernel without the statistics (the
// template flag Stats), on rows read through their strides (the branch
// view of an [n, nb * f] table), at its served widths 4 and 16 with scans
// of their own shape (Cfg: f 4 on m16n8k4 with the codewords' hi / lo
// parts staged, 4 m-tiles a warp; both with groups of 4 tiles).  The
// widths this file's entries take keep the scan described above.
//
// The wide build (vq_wide_kernel, at the end of this file) takes what this
// scan cannot hold: branches wider than 32 or codebooks beyond one block's
// shared memory; its own header note says how it differs.
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
constexpr float kNormUp = 1.00006103515625f;        // 1 + 2^-14
constexpr float kDiscSlack = 1.52587890625e-05f;    // 2^-16

// The scan's shape for a row width F (0: generic, f <= kMaxF at run time).
// KSTEP: the k-step of the fragments, 8 (m16n8k8), or 4 where f = 4 would
// leave half of every k8 step zeros (tile_dist); MT: m16 row tiles a warp,
// each B fragment serving all of them; GT: tiles a fold group (a lane's
// 2 * GT codewords a row); PIPE: pairs of tiles with the next pair's mmas
// issued before a pair's fold; SPLIT: the codewords' TF32 hi / lo parts
// staged once per branch in shared memory, not split again for every tile;
// MINB:
// vq_assign's blocks an SM (its __launch_bounds__; vq_update's kernel sets
// none).  The widths vq_update instantiates (8, 21, generic) keep the shape
// its scan was measured with; 4 and 16 are vq_assign's served widths
// (vq_assign.cu), whose shapes were picked by timing the alternatives on an
// H100.
template <int F>
struct Cfg {
  static constexpr int KSTEP = F == 4 ? 4 : 8;
  static constexpr int KS =
      F > 0 ? (F + KSTEP - 1) / KSTEP : kMaxF / KSTEP;  // k-steps
  static constexpr int MT = 2;                   // m16 row tiles per warp
  static constexpr int GT = F == 4 ? 4 : 2;
  static constexpr bool PIPE = GT == 2 && F != 16;
  static constexpr bool SPLIT = F == 4;
  static constexpr int MINB = F == 4 || F == 16 ? 2 : 1;
  static constexpr int R = 16 * MT;              // rows per warp tile
  static constexpr int W = F > 0 ? F : kMaxF;    // register row width
};

// Element (c, j) of the staged codewords, swizzled so that the 8 codewords x
// 4 lanes of a B fragment load hit 32 distinct banks: f = 8, the two halves
// of a row swap for c & 4; f = 16, its four quarters permute by bits 1-2 of
// c (unswizzled, codewords c and c + 2 share banks: 4-way conflicts).
template <int F>
__device__ __forceinline__ int cw_off(int c, int j, int fd) {
  if (F == 8) return c * 8 + (j ^ (c & 4));
  if (F == 16) return c * 16 + (j ^ (((c >> 1) & 3) << 2));
  return c * fd + j;
}

// The staged hi / lo pair of codeword c at k-step ks, k-row u (Cfg::SPLIT):
// the 8 codewords x 4 lanes of a B fragment read 32 consecutive pairs.
template <int F>
__device__ __forceinline__ int split_off(int c, int ks, int u) {
  return (c * Cfg<F>::KS + ks) * Cfg<F>::KSTEP + u;
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

// d = A B + c on the tensor cores (m16n8k4, TF32 in, fp32 accumulate): A's
// registers are rows g and g + 8 at k-column q, B's k-row q at column g.
__device__ __forceinline__ void mma_tf32_k4(float (&d)[4], uint32_t a0,
                                            uint32_t a1, uint32_t b0,
                                            const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k4.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%7,%8,%9,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]),
        "f"(c[3]));
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

// The B fragments (codewords nt*8 + g at k-rows q, q + 4 of every k8 step,
// or q of every k4 step, split hi / lo) and the C pair (|c|^2 of columns 2q,
// 2q + 1).  tail: the last tile of a k that is not a multiple of 8 (zeros
// and +inf past k).  c_s: the staged codewords, or with Cfg::SPLIT their
// staged hi / lo pairs (split_off), zeros past k.
template <int F>
__device__ __forceinline__ void load_b(const float* c_s, const float* cn2_s,
                                       int nt, int g, int q, int k, int fd,
                                       int ks_n, bool tail,
                                       uint32_t (&bh)[Cfg<F>::KS][2],
                                       uint32_t (&bl)[Cfg<F>::KS][2],
                                       float (&cc)[2]) {
  using C = Cfg<F>;
  const int c = nt * 8 + g;
#pragma unroll
  for (int ks = 0; ks < C::KS; ++ks) {
#pragma unroll
    for (int t = 0; t < C::KSTEP / 4; ++t) {
      if constexpr (C::SPLIT) {
        const float2 v = reinterpret_cast<const float2*>(c_s)[split_off<F>(
            c, ks, q + 4 * t)];
        bh[ks][t] = __float_as_uint(v.x);
        bl[ks][t] = __float_as_uint(v.y);
      } else {
        const int j = ks * C::KSTEP + q + 4 * t;
        const float v = (ks < ks_n && j < fd && (!tail || c < k))
                            ? c_s[cw_off<F>(c, j, fd)] : 0.f;
        split_tf32(v, bh[ks][t], bl[ks][t]);
      }
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
// the small products first, onto |c|^2 (the C operand), then hi * hi.  With
// KSTEP 4 the two small products of a k-step go into one m16n8k8, lo * hi in
// its k-columns 0-3 and hi * lo in 4-7, and hi * hi into an m16n8k4: two
// mmas a tile, which timed faster than three m16n8k4.
template <int F>
__device__ __forceinline__ void tile_dist(
    float (&d)[4], const uint32_t (&ah)[Cfg<F>::KS][4],
    const uint32_t (&al)[Cfg<F>::KS][4], const uint32_t (&bh)[Cfg<F>::KS][2],
    const uint32_t (&bl)[Cfg<F>::KS][2], const float (&cc)[2], int ks_n) {
  const float c4[4] = {cc[0], cc[1], cc[0], cc[1]};
  if constexpr (Cfg<F>::KSTEP == 4) {
#pragma unroll
    for (int ks = 0; ks < Cfg<F>::KS; ++ks) {
      const uint32_t a8[4] = {al[ks][0], al[ks][1], ah[ks][0], ah[ks][1]};
      if (ks == 0)
        mma_tf32(d, a8, bh[ks][0], bl[ks][0], c4);
      else
        mma_tf32(d, a8, bh[ks][0], bl[ks][0], d);
    }
#pragma unroll
    for (int ks = 0; ks < Cfg<F>::KS; ++ks)
      mma_tf32_k4(d, ah[ks][0], ah[ks][1], bh[ks][0], d);
  } else {
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
// xr: this lane's rows (mt, h); scan_s: load_b's source, c_s: the staged
// codewords.
template <int F>
__device__ __forceinline__ void rescore_tile(
    int nt, bool tail, const float* scan_s, const float* c_s,
    const float* cn2_s,
    const float* const (&xr)[Cfg<F>::MT][2], int g, int q, int k, int fd,
    int ks_n,
    const uint32_t (&ah)[Cfg<F>::MT][Cfg<F>::KS][4],
    const uint32_t (&al)[Cfg<F>::MT][Cfg<F>::KS][4],
    const float (&thr)[Cfg<F>::MT][2], const bool (&fb)[Cfg<F>::MT][2],
    float (&bd)[Cfg<F>::MT][2], int (&bi)[Cfg<F>::MT][2]) {
  constexpr int MT = Cfg<F>::MT;
  float d[MT][4];
  if (tail)
    tile_all<F, true>(d, nt, scan_s, cn2_s, g, q, k, fd, ks_n, ah, al);
  else
    tile_all<F>(d, nt, scan_s, cn2_s, g, q, k, fd, ks_n, ah, al);
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

// The kernels' body.  Stats: vq_update (idx, qerr and the cluster
// statistics); without it vq_assign's (idx, and qerr -- its want_min --
// unless nullptr).  x: [nb, n, f] with strides (sb, sr, 1).
template <int F, typename Idx, bool Stats>
__device__ __forceinline__ void vq_scan(
    const float* __restrict__ x, long long sb, long long sr,
    const float* __restrict__ cw, Idx* __restrict__ idx,
    float* __restrict__ qerr, float* __restrict__ counts,
    float* __restrict__ sums, int nb, int n, int k, int f,
    long long per_block, int stage_x) {
  using C = Cfg<F>;
  constexpr int KS = C::KS, MT = C::MT, R = C::R, W = C::W, GT = C::GT;
  static_assert(R >= 32, "a warp's near-tie queue (32 rows) drains as one "
                         "warp tile");
  const int fd = F > 0 ? F : f;
  const int ks_n = F > 0 ? KS : (f + 7) / 8;
  const int nt_full = k / 8;                     // tiles with no codeword past k
  const int nt_n = (k + 7) / 8;
  const float e_coef = (float)(3 * ks_n + 6) * kEpsBound;
  extern __shared__ float smem[];
  // [nt_n * 8, KS * KSTEP] hi / lo pairs first (8-byte aligned), if staged
  float2* b_s = reinterpret_cast<float2*>(smem);
  float* cn2_s = smem + (C::SPLIT ? 2 * nt_n * 8 * KS * C::KSTEP : 0);  // [k]
  float* c_s = cn2_s + k;                              // [k, fd]
  float* x_s = c_s + (size_t)k * fd;                  // [warps, R, fd]
  // what the scan's B fragments are loaded from (load_b)
  const float* scan_s = C::SPLIT ? reinterpret_cast<const float*>(b_s) : c_s;
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
    const float* xb = x + br * sb;

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
    if constexpr (C::SPLIT) {
      for (int i = threadIdx.x; i < nt_n * 8 * KS * C::KSTEP; i += kThreads) {
        const int c = i / (KS * C::KSTEP), j = i - c * (KS * C::KSTEP);
        uint32_t h, l;
        split_tf32(c < k && j < fd ? c_s[cw_off<F>(c, j, fd)] : 0.f, h, l);
        b_s[i] = make_float2(__uint_as_float(h), __uint_as_float(l));
      }
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
    float qthr = 0.f;                          // its row and its threshold
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
            for (int t = 0; t < C::KSTEP / 4; ++t) {
              const int j = ks * C::KSTEP + q + 4 * t;
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
    // The threshold T of a row of norm xr whose exactly rescored winning
    // group gave u >= its smallest d: a codeword with d <= u has norm at
    // most r (the header's bound), so its d~ <= u + E(min(cmax, r)).
    auto threshold = [&](float u, float xr) {
      const float b = xr * kNormUp;
      const float bb = b * b;
      const float r =
          (b + sqrtf(fmaxf(bb + u, 0.f) + kDiscSlack * (bb + fabsf(u)))) *
          kNormUp;
      const float cm = fminf(cmax, r);
      return u + e_coef * (cm * cm + 4.f * xr * cm)
             + kTinyBound * (1.f + xr + cm);
    };
    // One lane's row: idx and qerr (ok), and the warp's statistics (every
    // lane calls it): the lanes that chose the same codeword are combined
    // (__match_any_sync, then a shuffle tree over the peers) and one adds
    // the group's count and sums.  Without Stats: idx, and qerr if asked.
    auto finish = [&](bool ok, int row, const float* xr, float best,
                      int arg) {
      const size_t out = (size_t)br * n + row;
      if constexpr (!Stats) {
        if (ok) {
          idx[out] = (Idx)arg;
          if (qerr != nullptr) {
            float xn2 = 0.f;
#pragma unroll
            for (int j = 0; j < W; ++j)
              if (j < fd) xn2 = __fadd_rn(xn2, __fmul_rn(xr[j], xr[j]));
            qerr[out] = fmaxf(__fadd_rn(best, xn2), 0.f);
          }
        }
        return;
      }
      float xv[W];
      float xn2 = 0.f;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        xv[j] = (ok && j < fd) ? xr[j] : 0.f;
        if (j < fd) xn2 = __fadd_rn(xn2, __fmul_rn(xv[j], xv[j]));
      }
      if (ok) {
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
            xw[lane * fd + j] = xb[qrow * sr + j];
        __syncwarp();
      }
      auto rowp = [&](int r) -> const float* {
        const int qr = __shfl_sync(kFull, qrow, r);
        return stage_x ? xw + r * fd : xb + qr * sr;
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
          const float t = __shfl_sync(kFull, qthr, r);
          thr[mt][h] = isfinite(t) ? t : INFINITY;
          fb[mt][h] = r < valid;
          bd[mt][h] = INFINITY;
          bi[mt][h] = 0;
        }
      }
      for (int nt = 0; nt < nt_n; ++nt)
        rescore_tile<F>(nt, nt == nt_full, scan_s, c_s, cn2_s, xr, g, q, k,
                        fd, ks_n, ah, al, thr, fb, bd, bi);
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
          qthr = mv;
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
      // where it fits, else read in place (row stride xs)
      const float* xt = xb + rbase * sr;
      long long xs = sr;
      if (stage_x) {
        __syncwarp();
        if (sr == fd) {
          for (int i = lane; i < valid * fd; i += 32) xw[i] = xt[i];
        } else {
          for (int i = lane; i < valid * fd; i += 32) {
            const int r = i / fd;
            xw[i] = xt[r * sr + (i - r * fd)];
          }
        }
        __syncwarp();
        xt = xw;
        xs = fd;
      }
      build([&](int r) { return xt + r * xs; }, valid);

      // The scan.  A lane sees 2 codewords (columns 2q, 2q + 1) of every
      // tile; GT consecutive tiles make a group of 2 * GT codewords a lane
      // (tiles past the last whole group and the tail tile stand alone).
      // Per row and lane: m1, the smallest group minimum, n1 the first tile
      // of that group, and m2 the second smallest group minimum.  With GT
      // = 2 the next pair's mmas are issued before a pair is folded in.
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
        float da[MT][4];
        auto tile = [&](float (&d)[MT][4], int nt) {
          tile_all<F>(d, nt, scan_s, cn2_s, g, q, k, fd, ks_n, ah, al);
        };
        if constexpr (!C::PIPE) {
          // groups of GT tiles, a lane's 2 GT codewords a row folded at
          // once, each group's mmas issued together before its fold
          const int groups_end = nt_full / GT * GT;
          for (int nt = 0; nt < groups_end; nt += GT) {
            float dg[GT][MT][4];
#pragma unroll
            for (int u = 0; u < GT; ++u) tile(dg[u], nt + u);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float lo[GT];
#pragma unroll
                for (int u = 0; u < GT; ++u)
                  lo[u] = fminf(dg[u][mt][2 * h], dg[u][mt][2 * h + 1]);
#pragma unroll
                for (int w = GT / 2; w > 0; w >>= 1)
#pragma unroll
                  for (int u = 0; u < w; ++u) lo[u] = fminf(lo[u], lo[u + w]);
                fold(mt, h, lo[0], nt);
              }
          }
          for (int nt = groups_end; nt < nt_full; ++nt) {   // lone tiles
            tile(da, nt);
            fold1(da, nt);
          }
        } else {
          float db[MT][4], dc[MT][4], dd[MT][4];
          const int pairs_end = nt_full & ~1;    // tiles 0 .. pairs_end - 1
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
        }
        if (nt_full * 8 < k) {
          tile_all<F, true>(da, nt_full, scan_s, cn2_s, g, q, k, fd, ks_n, ah,
                            al);
          fold1(da, nt_full);
        }
      }
      // The 4 lanes of a row merge (min, runner-up, winning group's first
      // column).  Every group other than the winning one has a minimum of
      // at least the runner-up.
      float a1v[MT][2], a2v[MT][2];
      int cw0[MT][2];
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
          a1v[mt][h] = a1;
          a2v[mt][h] = a2;
          cw0[mt][h] = ac;
        }
      }
      // Per row (lane q of a quad takes quad row q + 4 * round): the
      // winning group's codewords rescored exactly give u and the row's
      // threshold T.  When the runner-up exceeds a finite T only the
      // winning group's codewords can win: the row is settled, with its
      // outputs and statistics.  The other rows queue up with T.  A
      // runner-up that does not exceed the minimum d~ itself (T is never
      // below it) cannot settle: such a row skips the rescoring and queues
      // with the T of u's bound min d~ + E(|x|, cmax).
      constexpr int kRounds = (2 * MT + 3) / 4;
      bool need[kRounds];
      int qrow_r[kRounds];
      float qthr_r[kRounds];
#pragma unroll
      for (int rd = 0; rd < kRounds; ++rd) {
        const int qi = q + 4 * rd;
        float best = INFINITY, a1 = 0.f, a2 = 0.f, xrn = 0.f;
        int arg = 0, r = R;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (qi == 2 * mt + h) {
              a1 = a1v[mt][h];
              a2 = a2v[mt][h];
              arg = cw0[mt][h];
              xrn = xn[mt][h];
              r = mt * 16 + g + 8 * h;
            }
        const bool ok = r < valid;
        const bool tie = !(a2 > a1);
        const float* xr = xt + (ok ? r : 0) * xs;
        if (ok && !tie) {
          // the winning group's codewords (columns 2q, 2q + 1 of its GT
          // tiles; a lone tile's neighbours only add candidates), rescored
          // exactly in increasing index, strict <
          const int c0 = arg;
#pragma unroll
          for (int u = 0; u < 2 * GT; ++u) {
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
        const float t = threshold(
            tie ? a1 + e_coef * (cm2 + 4.f * xrn * cmax)
                      + kTinyBound * (1.f + xrn + cmax)
                : best,
            xrn);
        const bool done = ok && !tie && isfinite(t) && a2 > t;
        finish(done, rbase + r, xr, best, arg);
        need[rd] = ok && !done;
        qrow_r[rd] = rbase + r;
        qthr_r[rd] = t;
      }
#pragma unroll
      for (int rd = 0; rd < kRounds; ++rd)
        enqueue(need[rd], qrow_r[rd], qthr_r[rd]);
    }
    if (qn > 0) drain();
    s = e;
  }
}

template <int F, typename Idx>
__global__ void __launch_bounds__(kThreads)
vq_update_kernel(const float* __restrict__ x, long long sb, long long sr,
                 const float* __restrict__ cw, Idx* __restrict__ idx,
                 float* __restrict__ qerr, float* __restrict__ counts,
                 float* __restrict__ sums, int nb, int n, int k, int f,
                 long long per_block, int stage_x) {
  vq_scan<F, Idx, true>(x, sb, sr, cw, idx, qerr, counts, sums, nb, n, k, f,
                        per_block, stage_x);
}

// vq_assign's kernel: Cfg::MINB blocks an SM (2 at the served widths, where
// a block's 8 warps alone left the scan's latencies exposed).
template <int F>
__global__ void __launch_bounds__(kThreads, Cfg<F>::MINB)
vq_assign_kernel(const float* __restrict__ x, long long sb, long long sr,
                 const float* __restrict__ cw, int* __restrict__ idx,
                 float* __restrict__ qerr, int nb, int n, int k, int f,
                 long long per_block, int stage_x) {
  vq_scan<F, int, false>(x, sb, sr, cw, idx, qerr, nullptr, nullptr, nb, n,
                         k, f, per_block, stage_x);
}

// Shared memory: with Cfg::SPLIT the codewords' hi / lo pairs (k rounded up
// to a tile, 8 bytes a coordinate), then |c|^2 and the codewords, k (f + 1)
// floats (the first version's footprint, so every shape it took still
// runs), then, where they fit, the warps' row tiles.  One wave of blocks,
// each an equal share of the nb * n rows.
template <int F>
size_t smem_base(int k, int f) {
  using C = Cfg<F>;
  const size_t split =
      C::SPLIT ? (size_t)((k + 7) / 8) * 8 * C::KS * C::KSTEP * 8 : 0;
  return split + ((size_t)k * f + (size_t)k) * sizeof(float);
}

template <int F, typename Idx, bool Stats>
cudaError_t launch(const float* x, long long sb, long long sr,
                   const float* cw, Idx* idx, float* qerr, float* counts,
                   float* sums, int nb, int n, int k, int f,
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
  const size_t base = smem_base<F>(k, f);
  const size_t xtile = (size_t)kWarps * Cfg<F>::R * f * sizeof(float);
  if (base > (size_t)limit) return cudaErrorInvalidValue;
  const int stage_x = base + xtile <= (size_t)limit;
  const size_t smem = base + (stage_x ? xtile : 0);
  auto kern = [] {
    if constexpr (Stats) return vq_update_kernel<F, Idx>;
    else return vq_assign_kernel<F>;
  }();
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
  if constexpr (Stats)
    kern<<<(unsigned)grid, kThreads, smem, stream>>>(
        x, sb, sr, cw, idx, qerr, counts, sums, nb, n, k, f, per_block,
        stage_x);
  else
    kern<<<(unsigned)grid, kThreads, smem, stream>>>(
        x, sb, sr, cw, idx, qerr, nb, n, k, f, per_block, stage_x);
  return cudaGetLastError();
}

// vq_update's widths: x [nb, n, f] contiguous.
template <typename Idx>
cudaError_t dispatch(const float* x, const float* cw, Idx* idx, float* qerr,
                     float* counts, float* sums, int nb, int n, int k, int f,
                     cudaStream_t stream) {
  if (f < 1 || f > kMaxF || k < 1 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
  const long long sb = (long long)n * f, sr = f;
  switch (f) {
    case 8:
      return launch<8, Idx, true>(x, sb, sr, cw, idx, qerr, counts, sums, nb,
                                  n, k, f, stream);
    case 21:
      return launch<21, Idx, true>(x, sb, sr, cw, idx, qerr, counts, sums,
                                   nb, n, k, f, stream);
    default:
      return launch<0, Idx, true>(x, sb, sr, cw, idx, qerr, counts, sums, nb,
                                  n, k, f, stream);
  }
}

// ===========================================================================
// The wide build: branches wider than the narrow build's registers hold
// (f > 32: GAT's 43 / 65, the Graph Transformer's 128 / 168 / 256), or
// codebooks larger than one block's shared memory, any f <= kWideMaxF and
// any k.  The same function and the same exactness argument as above; what
// changes is where the operands live.
//
// A tiled GEMM with an argmin epilogue, as the Pallas kernel's (b / bb,
// k / kb) grid is.  A persistent grid walks tiles of kWideBM = 64 rows of
// one branch.  A block stages its tile's rows in shared memory (read
// through their strides), then streams the branch's codewords through
// shared memory in tiles of BN (64, or 32 where 64 would not fit beside the
// rows), double-buffered with cp.async -- in 16-byte chunks where f is a
// multiple of 4, else float by float (a row of odd f is not 16-byte
// aligned) -- with their |c|^2 from a first kernel that sums them in the
// plain version's order.  Warp w takes m-tile w & 3 (16 rows) and half
// w >> 2 of each codeword tile; per 8-deep k-step it splits its -2x A
// fragment and each B fragment into TF32 hi + lo and accumulates lo*hi,
// hi*lo and hi*hi (mma.sync m16n8k8) onto |c|^2: 3 ceil(f / 8) mmas a
// distance, as in the narrow build.  Each lane folds its columns, in
// increasing index, into the row's smallest d~ (m1), its codeword (i1) and
// the second smallest d~ over all other codewords (m2); the quad's lanes
// and the two halves merge them.  Then per row: u = the exact distance of
// i1 (its codeword read from L2), T = u + E(|x|, min(cmax, r)) as above,
// and the row is settled when T is finite and m2 > T: every other codeword
// has d~ > T, so none can win.  The other rows join the block's queue (row
// and T); 64 queued rows, or the rest at the end of a branch, make a tile
// that streams the codewords again and rescores exactly every codeword with
// !(d~ > T), in increasing index per lane with a strict <, the lanes and
// halves merged by (d, index).
//
// The bound at these widths.  (i) and (ii) above hold for any f; (iii),
// the plain version's own rounding, (2f + 3) 2^-24 (|c|^2 + 2X), outgrows
// the narrow build's allowance past f 32, so the wide build's E adds
// ceil((2f + 3) / 16) to n_mma + 6 (vq_update.py:candidate_bound(wide=
// True)); the norm cap r takes rho = (2f + 3) 2^-24 <= 2^-14 (f <= 440)
// inside margins of 2^-12 (kWideUp).  E grows with f -- 135 x 2^-20 at
// f 256 -- so more rows queue than at f 8; chip_smoke.py prints how many.
//
// Statistics: the cluster sums are [k, f] per branch, 1 MB at k 1024 and
// f 256, which no block can privatize in shared memory.  A finished tile's
// rows that chose the same codeword are chained in shared memory (each
// row's next row with the same codeword); the first row of each chain adds
// the chain's count and, column by column with consecutive threads on
// consecutive columns, its summed row to global memory with atomics: one
// add per codeword, column and tile, and a collapsed codebook costs f adds
// a tile, not f a row.
//
// What bounds it on an H100: the 3xTF32 products, 6 nb n k f_pad flops
// (0.151 ms at [4, 42335, 65], f_pad 72, and k 1024 at the 495 TFLOP/s
// TF32 peak), on mma.sync, whose operands come from shared memory a
// fragment at a time, split again by every warp that reads them: 1.27 ms
// there on an H100 80GB HBM3 at 700 W (PERF.md).  wgmma and TMA are for a
// later version.
constexpr int kWideBM = 64;                  // rows a tile
constexpr int kWideQ = 2 * kWideBM;          // the queue's capacity
constexpr int kWideMaxF = 440;               // rho <= 2^-14 (header above)
constexpr float kWideUp = 1.000244140625f;   // 1 + 2^-12

__host__ __device__ constexpr int wide_fp(int f) { return (f + 7) / 8 * 8; }
// the row stride of staged rows and codewords: 4 mod 8 floats, so the 8
// rows x 4 k-columns of a fragment load hit 32 distinct banks
__host__ __device__ constexpr int wide_stride(int f) { return wide_fp(f) + 4; }

// A block's bookkeeping, after its row and codeword tiles.
struct WideMisc {
  float m1[2][kWideBM], m2[2][kWideBM];   // per half: min d~, runner-up
  int i1[2][kWideBM];                     // per half: the min's codeword
  float xn2[kWideBM];                     // exact |x|^2 of the staged rows
  float thr[kWideBM];                     // a rescoring tile's thresholds
  float best[kWideBM];                    // a finished row's exact distance
  int arg[kWideBM];                       // its codeword; -1: not finished
  int row[kWideBM];                       // the staged rows (in the branch)
  int next[kWideBM];                      // next staged row, same codeword
  int lead[kWideBM];                      // first staged row of its codeword
  int q_row[kWideQ];
  float q_thr[kWideQ];
  float red[kWarps];
  int q_n;
  float cmax;
};
// vq_update.py:WIDE_MISC_BYTES mirrors this size
static_assert(sizeof(WideMisc) == 4392, "WideMisc changed: update "
                                        "vq_update.py:WIDE_MISC_BYTES");

__host__ __device__ constexpr size_t wide_smem(int f, int bn) {
  return (size_t)(kWideBM + 2 * bn) * wide_stride(f) * sizeof(float)
         + 2 * (size_t)bn * sizeof(float) + sizeof(WideMisc);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The plain version's distance of a row and a codeword of f floats.
__device__ __forceinline__ float wide_exact(const float* xr, const float* cr,
                                            float cn2, int f) {
  float dot = 0.f;
#pragma unroll 4
  for (int j = 0; j < f; ++j) dot = __fadd_rn(dot, __fmul_rn(xr[j], cr[j]));
  return __fsub_rn(cn2, __fmul_rn(2.f, dot));
}

// |c|^2 of every codeword, in the plain version's order.
__global__ void wide_norms_kernel(const float* __restrict__ cw,
                                  float* __restrict__ cn2, long long count,
                                  int f) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= count) return;
  const float* p = cw + c * f;
  float acc = 0.f;
  for (int j = 0; j < f; ++j) acc = __fadd_rn(acc, __fmul_rn(p[j], p[j]));
  cn2[c] = acc;
}

template <int BN, typename Idx, bool Stats, bool Vec>
__global__ void __launch_bounds__(kThreads)
vq_wide_kernel(const float* __restrict__ x, long long sb, long long sr,
               const float* __restrict__ cw, const float* __restrict__ cn2,
               Idx* __restrict__ idx, float* __restrict__ qerr,
               float* __restrict__ counts, float* __restrict__ sums, int nb,
               int n, int k, int f, long long per_block) {
  constexpr int BM = kWideBM;
  constexpr int NT = BN / 16;                 // n8 tiles a warp a tile
  const int fp = wide_fp(f), s = wide_stride(f), ks_n = fp / 8;
  const float e_coef =
      (float)(3 * ks_n + 6 + (2 * f + 3 + 15) / 16) * kEpsBound;
  extern __shared__ float smem[];
  float* x_s = smem;                                   // [BM, s]
  float* c_s = x_s + BM * s;                           // [2][BN, s]
  float* cn_s = c_s + 2 * BN * s;                      // [2][BN]
  WideMisc& ms = *reinterpret_cast<WideMisc*>(cn_s + 2 * BN);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int mt = warp & 3, half = warp >> 2;
  const int nt_n = (k + BN - 1) / BN;                  // codeword tiles
  const int tpb = (n + BM - 1) / BM;                   // row tiles a branch
  const long long total = (long long)nb * tpb;
  const long long t_lo = (long long)blockIdx.x * per_block;
  const long long t_hi = t_lo + per_block < total ? t_lo + per_block : total;

  // Vec (f a multiple of 4 on an aligned table): codewords copied in
  // 16-byte chunks and rows read, a warp a row; else float by float over
  // the whole tile (a warp a row timed 3-9 % slower at f 43 and 65, and
  // the same test at run time cost the other path 1-3 %, on an H100 80GB
  // HBM3 at 700 W).

  // Stage rows ms.row[r] (-1: a zero row) of branch br, and their exact
  // |x|^2.
  auto stage = [&](int br) {
    const float* xb = x + br * sb;
    if constexpr (Vec) {
      for (int r = warp; r < BM; r += kWarps) {
        const int row = ms.row[r];
        for (int j = lane; j < fp; j += 32)
          x_s[r * s + j] = (row >= 0 && j < f) ? xb[row * sr + j] : 0.f;
      }
    } else {
      for (int i = tid; i < BM * fp; i += kThreads) {
        const int r = i / fp, j = i - r * fp;
        const int row = ms.row[r];
        x_s[r * s + j] = (row >= 0 && j < f) ? xb[row * sr + j] : 0.f;
      }
    }
    __syncthreads();
    if (tid < BM) {
      const float* xr = x_s + tid * s;
      float a = 0.f;
      for (int j = 0; j < f; ++j) a = __fadd_rn(a, __fmul_rn(xr[j], xr[j]));
      ms.xn2[tid] = a;
    }
  };

  // One pass over the branch's codewords for the staged rows.  Without
  // Rescore: every lane folds (m1, i1, m2) of its two rows and the quad's
  // lanes merge them into ms (per half).  With Rescore: every codeword with
  // !(d~ > thr) of a row r < rows is rescored exactly; the lanes' (best,
  // index) merge into ms.m1 / ms.i1.
  auto pass = [&](int br, bool rescore, int rows) {
    const float* cwb = cw + (size_t)br * k * f;
    const float* cnb = cn2 + (size_t)br * k;
    auto load = [&](int t, int buf) {
      const int c0 = t * BN;
      if constexpr (Vec) {
        for (int c = warp; c < BN; c += kWarps) {
          float* dst = c_s + (buf * BN + c) * s;
          const bool live = c0 + c < k;
          const float* src = cwb + (size_t)(c0 + c) * f;
          for (int j = 4 * lane; j < fp; j += 128) {
            const bool v = live && j < f;
            cp_async16(dst + j, v ? src + j : cwb, v);
          }
        }
      } else {
        for (int i = tid; i < BN * fp; i += kThreads) {
          const int c = i / fp, j = i - c * fp;
          const bool v = c0 + c < k && j < f;
          cp_async4(c_s + (buf * BN + c) * s + j,
                    v ? cwb + (size_t)(c0 + c) * f + j : cwb, v);
        }
      }
      for (int c = tid; c < BN; c += kThreads)
        cp_async4(cn_s + buf * BN + c, c0 + c < k ? cnb + c0 + c : cnb,
                  c0 + c < k);
      cp_async_commit();
    };
    const int r0 = mt * 16 + g;                 // this lane's rows r0, r0 + 8
    float m1[2] = {INFINITY, INFINITY}, m2[2] = {INFINITY, INFINITY};
    int i1[2] = {0, 0};
    float thr[2] = {0.f, 0.f};
    bool fb[2] = {false, false};
    if (rescore) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float t = ms.thr[r0 + 8 * h];
        thr[h] = isfinite(t) ? t : INFINITY;
        fb[h] = r0 + 8 * h < rows;
      }
    }
    load(0, 0);
    for (int t = 0; t < nt_n; ++t) {
      const int buf = t & 1;
      if (t + 1 < nt_n) {
        load(t + 1, buf ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* cb = c_s + buf * BN * s;
      const float* cnt = cn_s + buf * BN;
      const int c0 = t * BN + half * (BN / 2);  // this warp's first column
      const int l0 = half * (BN / 2);           // ... in the tile
      float acc[NT][4];
#pragma unroll
      for (int u = 0; u < NT; ++u) {
        const int cl = l0 + u * 8 + 2 * q;
        const float a = c0 + u * 8 + 2 * q < k ? cnt[cl] : INFINITY;
        const float b = c0 + u * 8 + 2 * q + 1 < k ? cnt[cl + 1] : INFINITY;
        acc[u][0] = a;
        acc[u][1] = b;
        acc[u][2] = a;
        acc[u][3] = b;
      }
      for (int ks = 0; ks < ks_n; ++ks) {
        const int j = ks * 8 + q;
        uint32_t ah[4], al[4];
        split_tf32(-2.f * x_s[r0 * s + j], ah[0], al[0]);
        split_tf32(-2.f * x_s[(r0 + 8) * s + j], ah[1], al[1]);
        split_tf32(-2.f * x_s[r0 * s + j + 4], ah[2], al[2]);
        split_tf32(-2.f * x_s[(r0 + 8) * s + j + 4], ah[3], al[3]);
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const float* cr = cb + (l0 + u * 8 + g) * s + j;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(cr[0], bh0, bl0);
          split_tf32(cr[4], bh1, bl1);
          mma_tf32(acc[u], al, bh0, bh1, acc[u]);
          mma_tf32(acc[u], ah, bl0, bl1, acc[u]);
          mma_tf32(acc[u], ah, bh0, bh1, acc[u]);
        }
      }
      if (!rescore) {
#pragma unroll
        for (int u = 0; u < NT; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1, c = c0 + u * 8 + 2 * q + (i & 1);
            const float d = acc[u][i];
            m2[h] = fminf(m2[h], fmaxf(m1[h], d));
            i1[h] = d < m1[h] ? c : i1[h];
            m1[h] = fminf(m1[h], d);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < NT; ++u) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i >> 1, c = c0 + u * 8 + 2 * q + (i & 1);
            if (fb[h] && !(acc[u][i] > thr[h]) && c < k) {
              const int cl = l0 + u * 8 + 2 * q + (i & 1);
              const float e = wide_exact(x_s + (r0 + 8 * h) * s, cb + cl * s,
                                         cnt[cl], f);
              if (e < m1[h]) {         // strict: the lowest index keeps ties
                m1[h] = e;
                i1[h] = c;
              }
            }
          }
        }
      }
      __syncthreads();                 // the buffer is free for tile t + 2
    }
    // the quad's lanes hold the same rows: merge, lane q = 0 writes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float b1 = __shfl_xor_sync(kFull, m1[h], o);
        const float b2 = __shfl_xor_sync(kFull, m2[h], o);
        const int bi = __shfl_xor_sync(kFull, i1[h], o);
        m2[h] = fminf(fmaxf(m1[h], b1), fminf(m2[h], b2));
        if (b1 < m1[h] || (b1 == m1[h] && bi < i1[h])) {
          m1[h] = b1;
          i1[h] = bi;
        }
      }
      if (q == 0) {
        ms.m1[half][r0 + 8 * h] = m1[h];
        ms.m2[half][r0 + 8 * h] = m2[h];
        ms.i1[half][r0 + 8 * h] = i1[h];
      }
    }
    __syncthreads();
  };

  // Merge the two halves of row r: (min, its codeword, runner-up).
  auto merged = [&](int r, float& a1, int& ai, float& a2) {
    a1 = ms.m1[0][r];
    ai = ms.i1[0][r];
    a2 = ms.m2[0][r];
    const float b1 = ms.m1[1][r], b2 = ms.m2[1][r];
    const int bi = ms.i1[1][r];
    a2 = fminf(fmaxf(a1, b1), fminf(a2, b2));
    if (b1 < a1 || (b1 == a1 && bi < ai)) {
      a1 = b1;
      ai = bi;
    }
  };

  // The staged rows with ms.arg[r] >= 0 are finished: their outputs, and
  // with Stats the cluster statistics, one chain of rows a codeword.
  auto finish = [&](int br) {
    if (tid < BM && ms.arg[tid] >= 0) {
      const size_t out = (size_t)br * n + ms.row[tid];
      idx[out] = (Idx)ms.arg[tid];
      if (qerr != nullptr)
        qerr[out] = fmaxf(__fadd_rn(ms.best[tid], ms.xn2[tid]), 0.f);
    }
    if constexpr (Stats) {
      if (tid < BM) {
        const int a = ms.arg[tid];
        int nx = -1, first = a >= 0;
        if (a >= 0) {
          for (int r = 0; r < tid; ++r) first &= ms.arg[r] != a;
          for (int r = BM - 1; r > tid; --r) nx = ms.arg[r] == a ? r : nx;
        }
        ms.next[tid] = nx;
        ms.lead[tid] = first;
      }
      __syncthreads();
      if (tid < BM && ms.lead[tid]) {
        int len = 0;
        for (int r = tid; r >= 0; r = ms.next[r]) ++len;
        atomicAdd(counts + (size_t)br * k + ms.arg[tid], (float)len);
      }
      for (int p = tid; p < BM * f; p += kThreads) {
        const int r = p / f, j = p - r * f;
        if (ms.lead[r]) {
          float acc = 0.f;
          for (int rr = r; rr >= 0; rr = ms.next[rr]) acc += x_s[rr * s + j];
          atomicAdd(sums + ((size_t)br * k + ms.arg[r]) * f + j, acc);
        }
      }
    }
    __syncthreads();
  };

  // Rescore the first cnt queued rows as one tile.
  auto drain = [&](int br, int cnt) {
    if (tid < BM) {
      ms.row[tid] = tid < cnt ? ms.q_row[tid] : -1;
      ms.thr[tid] = tid < cnt ? ms.q_thr[tid] : 0.f;
    }
    __syncthreads();
    const int rest = ms.q_n - cnt;
    for (int i = tid; i < rest; i += kThreads) {     // [cnt, q_n) -> [0, rest)
      ms.q_row[i] = ms.q_row[cnt + i];               // rest <= cnt: no overlap
      ms.q_thr[i] = ms.q_thr[cnt + i];
    }
    __syncthreads();
    if (tid == 0) ms.q_n = rest;
    stage(br);
    pass(br, true, cnt);
    if (tid < BM) {
      float a1, a2;
      int ai;
      // the halves' (best, index): the same merge, the runner-up unused
      merged(tid, a1, ai, a2);
      ms.arg[tid] = tid < cnt ? ai : -1;
      ms.best[tid] = a1;
    }
    __syncthreads();
    finish(br);
  };

  int cur = -1;
  if (tid == 0) ms.q_n = 0;
  for (long long t = t_lo; t < t_hi; ++t) {
    const int br = (int)(t / tpb);
    const int row0 = (int)(t - (long long)br * tpb) * BM;
    if (br != cur) {
      __syncthreads();
      if (cur >= 0 && ms.q_n > 0) drain(cur, ms.q_n);
      cur = br;
      // cmax of the branch (fmaxf: a NaN codeword is only ever a candidate)
      float m = 0.f;
      for (int c = tid; c < k; c += kThreads)
        m = fmaxf(m, cn2[(size_t)br * k + c]);
#pragma unroll
      for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      if (lane == 0) ms.red[warp] = m;
      __syncthreads();
      if (tid == 0) {
        float a = 0.f;
        for (int w = 0; w < kWarps; ++w) a = fmaxf(a, ms.red[w]);
        ms.cmax = sqrtf(a);
      }
    }
    if (tid < BM) ms.row[tid] = row0 + tid < n ? row0 + tid : -1;
    __syncthreads();
    stage(br);
    pass(br, false, 0);
    if (tid < BM) {
      float a1, a2;
      int ai;
      merged(tid, a1, ai, a2);
      ms.arg[tid] = -1;
      if (ms.row[tid] >= 0) {
        const float u = wide_exact(x_s + tid * s, cw + ((size_t)br * k + ai) * f,
                                   cn2[(size_t)br * k + ai], f);
        const float xr = sqrtf(ms.xn2[tid]);
        const float b = xr * kWideUp, bb = b * b;
        const float r =
            (b + sqrtf(fmaxf(bb + u, 0.f) + (kWideUp - 1.f) * (bb + fabsf(u))))
            * kWideUp;
        const float cm = fminf(ms.cmax, r);
        const float thr = u + e_coef * (cm * cm + 4.f * xr * cm)
                          + kTinyBound * (1.f + xr + cm);
        if (isfinite(thr) && a2 > thr) {
          ms.arg[tid] = ai;
          ms.best[tid] = u;
        } else {
          const int slot = atomicAdd(&ms.q_n, 1);
          ms.q_row[slot] = ms.row[tid];
          ms.q_thr[slot] = thr;
        }
      }
    }
    __syncthreads();
    finish(br);
    if (ms.q_n >= BM) drain(br, BM);
  }
  __syncthreads();
  if (cur >= 0 && ms.q_n > 0) drain(cur, ms.q_n);
}

// Launch the wide build: |c|^2 into cn2 (nb * k floats of the caller's
// scratch), then the scan with the widest codeword tile that fits.
template <typename Idx, bool Stats>
cudaError_t launch_wide(const float* x, long long sb, long long sr,
                        const float* cw, float* cn2, Idx* idx, float* qerr,
                        float* counts, float* sums, int nb, int n, int k,
                        int f, cudaStream_t stream) {
  if (f < 1 || f > kWideMaxF || k < 1 || nb < 1 || n < 1)
    return cudaErrorInvalidValue;
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
  const bool bn64 = wide_smem(f, 64) <= (size_t)limit;
  const size_t smem = wide_smem(f, bn64 ? 64 : 32);
  if (smem > (size_t)limit) return cudaErrorInvalidValue;
  const bool vec = f % 4 == 0 && (reinterpret_cast<size_t>(cw) & 15) == 0;
  auto kern = bn64 ? (vec ? &vq_wide_kernel<64, Idx, Stats, true>
                          : &vq_wide_kernel<64, Idx, Stats, false>)
                   : (vec ? &vq_wide_kernel<32, Idx, Stats, true>
                          : &vq_wide_kernel<32, Idx, Stats, false>);
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long count = (long long)nb * k;
  wide_norms_kernel<<<(unsigned)((count + 255) / 256), 256, 0, stream>>>(
      cw, cn2, count, f);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long tiles = (long long)nb * ((n + kWideBM - 1) / kWideBM);
  long long grid = (long long)per_sm * sms;
  if (grid > tiles) grid = tiles;
  const long long per_block = (tiles + grid - 1) / grid;
  grid = (tiles + per_block - 1) / per_block;
  kern<<<(unsigned)grid, kThreads, smem, stream>>>(
      x, sb, sr, cw, cn2, idx, qerr, counts, sums, nb, n, k, f, per_block);
  return cudaGetLastError();
}

}  // namespace
