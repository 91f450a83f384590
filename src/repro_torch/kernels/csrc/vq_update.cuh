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
// changes is where the operands live and which instruction multiplies them.
//
// A tiled GEMM with an argmin epilogue, as the Pallas kernel's (b / bb,
// k / kb) grid is, on Hopper's warpgroup products (wgmma).
//   * A prologue (wide_prep_kernel) splits every codeword once per call
//     into its TF32 hi and lo parts, zero-padded to f_pad = 8 ceil(f / 8)
//     columns and to k_pad = 128 ceil(k / 128) codewords, and writes them
//     to the caller's scratch in the operand layout of a 128-codeword tile
//     (wide_split_off: no-swizzle core matrices, 4-column slabs of 16),
//     beside |c|^2 in the plain version's order (+inf past k).  Splitting
//     in shared memory instead would cost each block per tile as many
//     instructions as its argmin fold; pre-split operands double the bytes
//     read from L2, which PERF.md weighs against the card's L2 rate.
//   * A persistent grid walks tiles of BM = 64 WGS rows of one branch: WGS
//     consumer warpgroups of 64 rows each (2, or 1 where 128-row tiles
//     would leave SMs idle or f has no 128-row plan: 64-row tiles measured
//     1.8x faster at [1, 5000, 256], 1.4x slower at [4, 42335, 65]) and
//     one producer warp.  The rows are copied (cp.async) into the idle ring
//     and the consumers split their -2x into TF32 hi / lo once per row tile,
//     into shared memory (ARES); where 2 BM f_pad floats and a ring would
//     not fit (f_pad > 392 at 64 rows), they keep the fp32 rows and split
//     each K chunk into a small buffer instead.  The producer's idle lanes
//     prefetch the next row tile's rows into L2.
//   * The producer streams the branch's pre-split codewords through a ring
//     of >= 3 stages, each a chunk of KC columns (hi, lo) of a 128-codeword
//     tile plus its |c|^2, one cp.async.bulk per part against an mbarrier
//     (no tensor map to encode on the host); the consumers release a
//     stage once their products have read it.
//   * Per tile, each consumer warpgroup starts 64 accumulators a thread at
//     |c|^2 and issues wgmma m64n128k8 .tf32 from shared memory: lo * hi,
//     hi * lo and hi * hi at every 8-deep k-step, in that order, so a
//     distance takes n_mma = 3 ceil(f / 8) accumulations as in the narrow
//     build.  The two warpgroups share every stage; while one folds its
//     tile the other's products run.
//   * Each lane folds its 2 rows x 32 codewords, in increasing index, into
//     the row's smallest d~ (m1), its codeword (i1) and the second smallest
//     d~ over all other codewords (m2); the quad's lanes merge them.  Then
//     the epilogue, on every thread of the block: the rows and their i1
//     codewords are copied into the idle ring (wide_stage_cols), and a
//     thread a row sums u = the exact distance of i1 and |x|^2 over j in
//     order; T = u + E(|x|, min(cmax, r)) as above, and the row is settled
//     when T is finite and m2 > T.  The other rows join the block's queue
//     (row and T; counted in the scratch's first word); BM queued rows, or
//     the rest at the end of a branch, make a tile that streams the
//     codewords again and rescores exactly every codeword with !(d~ > T),
//     in increasing index per lane with a strict <, merged by (d, index).
//
// The bound at these widths.  (i) holds for any f; (iii), the plain
// version's own rounding, (2f + 3) 2^-24 (|c|^2 + 2X), outgrows the narrow
// build's allowance past f 32, so the wide build's E adds ceil((2f + 3) /
// 16) (vq_update.py:candidate_bound(wide=True)); the norm cap r takes rho
// = (2f + 3) 2^-24 <= 2^-14 (f <= 440) inside margins of 2^-12 (kWideUp).
// (ii) on wgmma: a probe of 67 M distances on the card (chip_smoke.py
// phase 24: random, mixed-magnitude, large-row and |c|^2-dominated inputs)
// found the accumulation off by up to 1.08 of 2^-20 (cmax^2 + 4X) in all,
// the |c|^2-dominated inputs worst (mma.sync: 0.6), so the wide E takes 3
// more accumulations' allowance than n_mma: n_mma + 9 + ceil((2f + 3) /
// 16) in all, 138 x 2^-20 at f 256 (WIDE_TC_EXTRA).  E grows with f, so
// more rows queue than at f 8; the scratch counts them.
//
// Statistics: the cluster sums are [k, f] per branch, 1 MB at k 1024 and
// f 256, which no block can privatize in shared memory.  A finished tile's
// rows, still staged in the ring, are summed by codeword: within each
// 32-row segment onto the segment's first row with that codeword (a thread
// a segment and column, in row order), then the segments' sums in order,
// added to global memory with one 16-byte atomic per 4 aligned columns:
// one add per codeword, column and tile, and a collapsed codebook costs f
// adds a tile, not f a row.  Counts are exact in any order; the sums'
// order is not the plain version's (within chip_smoke.py's scatter bound,
// exact on grid rows).
//
// What bounds it on an H100: the 3xTF32 products, 6 nb n k f_pad flops
// (0.151 ms at [4, 42335, 65], f_pad 72, and k 1024 at the 495 TFLOP/s
// TF32 peak), and the codeword tiles read from L2 once per row tile (0.78
// GB at that shape with 128-row tiles: 0.11 ms at the 6.8-7.2 TB/s L2 read
// rate measured on the card).  The scan (waits, products, fold) takes
// about half of the time there; the rows' staging, the exact u and the
// statistics run between row tiles, not overlapped with it (PERF.md
// splits the time, tools/wide_scan_phases.py).
constexpr int kWideBN = 128;                 // codewords a tile (wgmma N)
constexpr int kWideMaxF = 440;               // rho <= 2^-14 (header above)
constexpr float kWideUp = 1.000244140625f;   // 1 + 2^-12
constexpr int kWideMinStages = 3;
constexpr int kWideMaxStages = 6;
constexpr int kWideMaxKC = 64;               // widest K chunk of a stage
constexpr int kWidePrepCw = 16;              // codewords a prologue block

__host__ __device__ constexpr int wide_fp(int f) { return (f + 7) / 8 * 8; }
__host__ __device__ constexpr int wide_kpad(int k) {
  return (k + kWideBN - 1) / kWideBN * kWideBN;
}
// the fp32 rows' stride where the rows are not split once (!ARES): 4 mod 8
// floats, so a core matrix's 8 rows x 4 columns hit 32 distinct banks
__host__ __device__ constexpr int wide_xs(int f) { return wide_fp(f) + 4; }
// scratch floats: the queued-row counter (4 floats, a uint32 in the first),
// |c|^2 [nb, k_pad], the split codewords [nb, k_pad / 128, {hi, lo}, 128
// f_pad] (vq_update.py:wide_scratch_floats mirrors it)
__host__ __device__ constexpr size_t wide_scratch_floats(int nb, int k,
                                                         int f) {
  return 4 + (size_t)nb * wide_kpad(k) * (1 + 2 * (size_t)wide_fp(f));
}
// offset of part (c, j) of a branch's split codewords: tile c / 128, then
// 4-column slabs of 16 core matrices (8 codewords x 4 columns, 128 bytes);
// lo lies 128 f_pad floats after hi (vq_update.py:wide_split_layout)
__host__ __device__ constexpr size_t wide_split_off(int c, int j, int fp) {
  return (size_t)(c / kWideBN) * 2 * kWideBN * fp
         + (size_t)(((j / 4) * (kWideBN / 8) + (c % kWideBN) / 8) * 32
                    + (c % 8) * 4 + j % 4);
}

// A block's bookkeeping, at the start of its shared memory.
template <int BM>
struct WideMisc {
  float m1[BM], m2[BM];         // min d~ (rescoring: min exact d), runner-up
  int i1[BM];                   // the min's codeword
  float xn2[BM];                // exact |x|^2 of the tile's rows
  float thr[BM];                // a rescoring tile's thresholds
  float best[BM];               // a finished row's exact distance
  int arg[BM];                  // its codeword; -1: not finished
  int row[BM];                  // the tile's rows (in the branch), -1: none
  // the statistics' segments of 32 rows: each row's first row with its
  // codeword in its segment; a segment's first such row, the next one in
  // a later segment; whether a row is the tile's first with its codeword
  int seg_lead[BM], seg_next[BM], lead[BM];
  int q_row[2 * BM];
  float q_thr[2 * BM];
  unsigned long long full[kWideMaxStages], empty[kWideMaxStages];
  float red[10];
  int q_n;
  unsigned queued;
  float cmax;
  int pad;
};
// vq_update.py:wide_misc_bytes mirrors these sizes
static_assert(sizeof(WideMisc<128>) == 7832, "WideMisc changed: update "
                                             "vq_update.py:wide_misc_bytes");
static_assert(sizeof(WideMisc<64>) == 3992, "WideMisc changed: update "
                                            "vq_update.py:wide_misc_bytes");

__host__ __device__ constexpr size_t wide_misc_round(int bm) {
  return ((bm == 128 ? sizeof(WideMisc<128>) : sizeof(WideMisc<64>)) + 127)
         / 128 * 128;
}
// the rows' operand: hi / lo of -2x (ARES), or the fp32 rows and a K-chunk
// buffer of hi / lo for each warpgroup
__host__ __device__ constexpr size_t wide_a_bytes(int bm, int f, bool ares,
                                                  int kc) {
  return ares ? (size_t)bm * wide_fp(f) * 8
              : (size_t)bm * wide_xs(f) * 4 + (size_t)bm * kc * 8;
}
// one ring stage: hi and lo of KC columns of 128 codewords, and |c|^2
__host__ __device__ constexpr size_t wide_stage_bytes(int kc) {
  return (size_t)kWideBN * (2 * kc + 1) * 4;
}

// Columns the epilogue stages at a time in the idle ring (x and a
// codeword, bm rows each, at an odd stride): all f where they fit.
inline int wide_epilogue_cols(int f, int bm, int kc, int stages) {
  const int cols = (int)(stages * wide_stage_bytes(kc) / 4) / (2 * bm) - 1;
  return cols < f ? cols : f;
}

// The launch's shape at width f with WGS consumer warpgroups: the rows
// split once (ares) where that fits beside a ring of kWideMinStages, else
// chunk by chunk; the widest K chunk that fits; as many stages as fit, up
// to kWideMaxStages (vq_update.py:wide_plan mirrors it).
struct WidePlan {
  int ares, kc, stages;
  size_t smem;
};
inline bool wide_plan(int f, int wgs, size_t limit, WidePlan& p) {
  const int bm = 64 * wgs, fp = wide_fp(f);
  for (int ares = 1; ares >= 0; --ares)
    for (int kc = fp < kWideMaxKC ? fp : kWideMaxKC; kc >= 8; kc -= 8) {
      const size_t fixed = wide_misc_round(bm) + wide_a_bytes(bm, f, ares, kc);
      if (fixed >= limit) continue;
      size_t s = (limit - fixed) / wide_stage_bytes(kc);
      if (s > (size_t)kWideMaxStages) s = kWideMaxStages;
      if (s >= (size_t)kWideMinStages) {
        p = {ares, kc, (int)s, fixed + s * wide_stage_bytes(kc)};
        return true;
      }
    }
  return false;
}

__device__ __forceinline__ unsigned wide_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void wide_mbar_init(unsigned a, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a),
               "r"(count));
}
__device__ __forceinline__ void wide_mbar_wait(unsigned a, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void wide_mbar_arrive(unsigned a) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a)
               : "memory");
}
__device__ __forceinline__ void wide_mbar_expect(unsigned a, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(a), "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16) from global src to shared dst, completing on the
// mbarrier at bar
__device__ __forceinline__ void wide_bulk(unsigned dst, const float* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void wide_fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wide_bar(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// wgmma shared-memory descriptor, no swizzle: lbo the byte stride between
// core matrices along K, sbo along M / N
__device__ __forceinline__ uint64_t wide_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}
__device__ __forceinline__ void wide_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wide_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wide_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64, 128] += A[64, 8] B[128, 8]^T, fp32 += tf32 x tf32, A and B K-major
// in shared memory.  d[4 j + e]: row g + 8 (e >> 1) of the warp's 16,
// column 8 j + 2 q + (e & 1).
__device__ __forceinline__ void wide_wgmma(float* d, uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p, 1, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
}

// The plain version's distance of a row and a codeword of f floats, and
// the row's |x|^2, each summed over j in order.
__device__ __forceinline__ float wide_exact(const float* xr, const float* cr,
                                            float cn2, int f, float* xn2) {
  float dot = 0.f, xx = 0.f;
  if ((f & 3) == 0 &&
      ((reinterpret_cast<size_t>(xr) | reinterpret_cast<size_t>(cr)) & 15) ==
          0) {                                  // 16-byte loads, same order
    for (int j = 0; j < f; j += 4) {
      const float4 v = *reinterpret_cast<const float4*>(xr + j);
      const float4 c = *reinterpret_cast<const float4*>(cr + j);
      dot = __fadd_rn(dot, __fmul_rn(v.x, c.x));
      dot = __fadd_rn(dot, __fmul_rn(v.y, c.y));
      dot = __fadd_rn(dot, __fmul_rn(v.z, c.z));
      dot = __fadd_rn(dot, __fmul_rn(v.w, c.w));
      xx = __fadd_rn(xx, __fmul_rn(v.x, v.x));
      xx = __fadd_rn(xx, __fmul_rn(v.y, v.y));
      xx = __fadd_rn(xx, __fmul_rn(v.z, v.z));
      xx = __fadd_rn(xx, __fmul_rn(v.w, v.w));
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < f; ++j) {
      const float v = xr[j];
      dot = __fadd_rn(dot, __fmul_rn(v, cr[j]));
      xx = __fadd_rn(xx, __fmul_rn(v, v));
    }
  }
  if (xn2 != nullptr) *xn2 = xx;
  return __fsub_rn(cn2, __fmul_rn(2.f, dot));
}

// Instrumentation hooks of tools/wide_scan_phases.py (compiled in only
// with -DREPRO_WIDE_PHASES): clock64() stamps of thread 0 by phase.
#ifndef REPRO_WIDE_PHASES
#define WIDE_PH_DECL
#define WIDE_PH(p)
#define WIDE_PH_DRAIN(on)
#define WIDE_PH_FLUSH()
#endif

// The prologue: |c|^2 of every codeword in the plain version's order (+inf
// past k), the TF32 hi / lo parts of every codeword (zeros past k and f) at
// wide_split_off, and the queued-row counter zeroed.  Grid (k_pad / 16,
// nb), 128 threads.
__global__ void __launch_bounds__(128)
wide_prep_kernel(const float* __restrict__ cw, float* __restrict__ scratch,
                 int nb, int k, int f) {
  __shared__ float s[kWidePrepCw * (kWideMaxF + 1)];
  const int fp = wide_fp(f), kpad = wide_kpad(k), sf = f + 1;
  const int br = blockIdx.y, c0 = blockIdx.x * kWidePrepCw, tid = threadIdx.x;
  if (blockIdx.x == 0 && br == 0 && tid == 0)
    reinterpret_cast<unsigned*>(scratch)[0] = 0u;
  const int live = k - c0;      // codewords of this block below k
  const float* src = cw + ((size_t)br * k + c0) * f;
  for (int i = tid; i < kWidePrepCw * f; i += blockDim.x) {
    const int c = i / f, j = i - c * f;
    s[c * sf + j] = c < live ? src[i] : 0.f;
  }
  __syncthreads();
  if (tid < kWidePrepCw) {
    float a = 0.f;
    for (int j = 0; j < f; ++j)
      a = __fadd_rn(a, __fmul_rn(s[tid * sf + j], s[tid * sf + j]));
    scratch[4 + (size_t)br * kpad + c0 + tid] = tid < live ? a : INFINITY;
  }
  float* sp = scratch + 4 + (size_t)nb * kpad + (size_t)br * kpad * 2 * fp;
  for (int i = tid; i < kWidePrepCw * fp; i += blockDim.x) {
    const int c = i / fp, j = i - c * fp;
    uint32_t hi, lo;
    split_tf32(j < f ? s[c * sf + j] : 0.f, hi, lo);
    const size_t o = wide_split_off(c0 + c, j, fp);
    sp[o] = __uint_as_float(hi);
    sp[o + (size_t)kWideBN * fp] = __uint_as_float(lo);
  }
}

__device__ __forceinline__ void wide_cp4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   wide_u32(dst)),
               "l"(src)
               : "memory");
}

// Columns [j0, j0 + jc) of the tile's rows (row[r] >= 0) into ex [BM, JS]
// and, with win (cwb: the branch's codewords), of each row's codeword
// i1[r] into ec: a warp a row, lanes on consecutive columns, every copy in
// flight at once (cp.async).  Ends with a block barrier.
template <int BM, int NT>
__device__ __forceinline__ void wide_stage_cols(
    const float* xb, long long sr, const float* cwb, int f, const int* row,
    const int* i1, bool win, int j0, int jc, float* ex, float* ec, int JS,
    int warp, int lane) {
  for (int r = warp; r < BM; r += NT / 32) {
    const int rw = row[r];
    if (rw >= 0) {
      const float* xr = xb + rw * sr + j0;
      for (int jj = lane; jj < jc; jj += 32)
        wide_cp4(ex + r * JS + jj, xr + jj);
      if (win) {
        const float* cr = cwb + (size_t)i1[r] * f + j0;
        for (int jj = lane; jj < jc; jj += 32)
          wide_cp4(ec + r * JS + jj, cr + jj);
      }
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
  __syncthreads();
}

// Thread r < BM: |x|^2 of row r of the tile (xx) and, with win, its dot
// product with codeword i1[r] (dot), each summed over j in order, from
// columns staged JC at a time (wide_stage_cols).
template <int BM, int NT>
__device__ __forceinline__ void wide_rows_exact(
    const float* xb, long long sr, const float* cwb, int f, const int* row,
    const int* i1, bool win, float* ex, float* ec, int JC, int JS, int tid,
    int warp, int lane, float& dot, float& xx) {
  dot = 0.f;
  xx = 0.f;
  const bool mine = tid < BM && row[tid < BM ? tid : 0] >= 0;
  for (int j0 = 0; j0 < f; j0 += JC) {
    const int jc = f - j0 < JC ? f - j0 : JC;
    wide_stage_cols<BM, NT>(xb, sr, cwb, f, row, i1, win, j0, jc, ex, ec, JS,
                            warp, lane);
    if (mine) {
      const float* xr = ex + tid * JS;
      const float* cr = ec + tid * JS;
      for (int jj = 0; jj < jc; ++jj) {
        const float v = xr[jj];
        if (win) dot = __fadd_rn(dot, __fmul_rn(v, cr[jj]));
        xx = __fadd_rn(xx, __fmul_rn(v, v));
      }
    }
    __syncthreads();
  }
}

// The scan.  Probe: no argmin; every d~ of the staged rows is written to
// probe [nb, n, k_pad] (chip_smoke.py's accumulation probe).
template <int WGS, bool ARES, typename Idx, bool Stats, bool Probe = false>
__global__ void __launch_bounds__(WGS * 128 + 32, 1)
vq_wide_kernel(const float* __restrict__ x, long long sb, long long sr,
               const float* __restrict__ cw, float* __restrict__ scratch,
               Idx* __restrict__ idx, float* __restrict__ qerr,
               float* __restrict__ counts, float* __restrict__ sums, int nb,
               int n, int k, int f, long long per_block, int kc, int stages,
               int ecols) {
  constexpr int BM = 64 * WGS;                // rows a tile
  constexpr int NCT = 128 * WGS;              // consumer threads
  constexpr int NT = NCT + 32;                // + the producer warp
  const int fp = wide_fp(f), ks_n = fp / 8, kpad = wide_kpad(k);
  const int nt_n = kpad / kWideBN;            // codeword tiles
  const int ch_n = (fp + kc - 1) / kc;        // K chunks a tile
  const int steps = nt_n * ch_n;              // ring stages a pass
  const float e_coef =
      (float)(3 * ks_n + 9 + (2 * f + 3 + 15) / 16) * kEpsBound;
  const float* cn2 = scratch + 4;
  const float* cws = cn2 + (size_t)nb * kpad;
  extern __shared__ __align__(128) unsigned char wsm[];
  WideMisc<BM>& ms = *reinterpret_cast<WideMisc<BM>*>(wsm);
  const unsigned s0 = wide_u32(wsm);
  const unsigned a_s = s0 + (unsigned)wide_misc_round(BM);
  float* a_p = reinterpret_cast<float*>(wsm + wide_misc_round(BM));
  const unsigned ring = a_s + (unsigned)wide_a_bytes(BM, f, ARES, kc);
  const unsigned st_b = (unsigned)wide_stage_bytes(kc);
  const unsigned lo_off = (unsigned)kWideBN * kc * 4;   // a stage's lo part
  const int tid = threadIdx.x, lane = tid & 31;
  // warp and warpgroup broadcast from lane 0, so that the compiler knows
  // them uniform and keeps the products of a warpgroup in flight together
  const int warp = __shfl_sync(kFull, tid >> 5, 0);
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, q = lane & 3;
  const int tpb = (n + BM - 1) / BM;          // row tiles a branch
  const long long total = (long long)nb * tpb;
  const long long t_lo = (long long)blockIdx.x * per_block;
  const long long t_hi = t_lo + per_block < total ? t_lo + per_block : total;
  // Between passes the ring is idle: the epilogue stages JC columns at a
  // time of the tile's rows (and their codewords) there, at the odd row
  // stride JS (wide_epilogue_cols), so that the serial sums over j read
  // shared memory; and a pass stages its rows there first where they fit
  // (raw_ok).
  const int JC = ecols, JS = ecols | 1;
  float* ex = reinterpret_cast<float*>(wsm + (ring - s0));
  float* ec = ex + BM * JS;
  const bool raw_ok = (size_t)BM * wide_xs(f) * 4 <= (size_t)stages * st_b;
  unsigned seq = 0;                           // ring stages used so far
  int pf_br = -1, pf_row0 = 0;                // the row tile after this one
  WIDE_PH_DECL

  auto full = [&](unsigned st) {
    return wide_u32(&ms.full[0]) + 8 * st;
  };
  auto empty = [&](unsigned st) {
    return wide_u32(&ms.empty[0]) + 8 * st;
  };

  // One pass over branch br's codewords for the rows ms.row[0, BM).
  // Without rescore: every lane folds (m1, i1, m2) of its two rows and the
  // quad's lanes merge them into ms.  With rescore: every codeword with
  // !(d~ > ms.thr) of a row r < rows is rescored exactly; the lanes'
  // (best, index) merge into ms.m1 / ms.i1.  The caller syncs the block.
  auto pass = [&](int br, bool rescore, int rows) {
    const float* xb = x + br * sb;
    if (ARES && raw_ok) {
      // the ring is idle until the producer starts: every thread copies
      // the tile's rows there (fp32 at stride wide_xs(f), all in flight),
      // then the consumers split them into the rows' operand
      const int xs = wide_xs(f);
      for (int r = warp; r < BM; r += NT / 32) {
        const int row = ms.row[r];
        if (row >= 0)
          for (int j = lane; j < f; j += 32)
            wide_cp4(ex + r * xs + j, xb + row * sr + j);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                       "memory");
      __syncthreads();
      if (wg < WGS) {
        uint32_t* ah = reinterpret_cast<uint32_t*>(a_p);
        uint32_t* al = ah + (size_t)BM * fp;
        const int n_cm = (BM / 8) * (fp / 4);
        for (int cm = warp; cm < n_cm; cm += NCT / 32) {
          const int j4 = cm / (BM / 8), g8 = cm - j4 * (BM / 8);
          const int r = g8 * 8 + g, j = j4 * 4 + q;
          const float v = ms.row[r] >= 0 && j < f ? ex[r * xs + j] : 0.f;
          split_tf32(-2.f * v, ah[cm * 32 + lane], al[cm * 32 + lane]);
        }
      }
      wide_fence_async();     // the ring's next writes are the async proxy's
      __syncthreads();
    }
    if (wg == WGS) {                          // the producer warp
      if (lane == 0) {
        const float* cnb = cn2 + (size_t)br * kpad;
        const float* cwb = cws + (size_t)br * kpad * 2 * fp;
        for (int i = 0; i < steps; ++i) {
          const unsigned sq = seq + i, st = sq % stages;
          if (sq >= (unsigned)stages)
            wide_mbar_wait(empty(st), ((sq / stages) + 1) & 1);
          const int t = i / ch_n, c0 = (i - t * ch_n) * kc;
          const int w = fp - c0 < kc ? fp - c0 : kc;
          const unsigned part = (unsigned)w * kWideBN * 4;
          const float* th = cwb + (size_t)t * 2 * kWideBN * fp;
          const unsigned dst = ring + st * st_b;
          wide_mbar_expect(full(st), 2 * part + (c0 == 0 ? kWideBN * 4 : 0));
          wide_bulk(dst, th + (size_t)c0 * kWideBN, part, full(st));
          wide_bulk(dst + lo_off, th + (size_t)kWideBN * fp + c0 * kWideBN,
                    part, full(st));
          if (c0 == 0)
            wide_bulk(dst + 2 * lo_off, cnb + t * kWideBN, kWideBN * 4,
                      full(st));
        }
      } else if (pf_br >= 0) {
        // the other lanes: the next row tile's rows into L2
        const float* xb = x + pf_br * sb;
        for (int r = lane - 1; r < BM && pf_row0 + r < n; r += 31) {
          const char* p0 = reinterpret_cast<const char*>(
              xb + (pf_row0 + r) * sr);
          for (int o = 0; o < f * 4; o += 128)
            asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p0 + o));
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p0 + f * 4 - 4));
        }
      }
      seq += steps;
      return;
    }
    // the rows' operand where the ring could not stage it: -2x split
    // once (ARES), or the fp32 rows
    if (!(ARES && raw_ok)) {
      if constexpr (ARES) {
        // a warp a core matrix (8 rows x 4 columns, lane (r % 8) * 4 +
        // j % 4), 16 of them loaded before any is split
        uint32_t* ah = reinterpret_cast<uint32_t*>(a_p);
        uint32_t* al = ah + (size_t)BM * fp;
        constexpr int NW = NCT / 32, NB = 16;
        const int n_cm = (BM / 8) * (fp / 4);
        for (int cm0 = warp; cm0 < n_cm; cm0 += NB * NW) {
          float v[NB];
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int cm = cm0 + u * NW;
            const int j4 = cm / (BM / 8), g8 = cm - j4 * (BM / 8);
            const int row = cm < n_cm ? ms.row[g8 * 8 + g] : -1;
            const int j = j4 * 4 + q;
            v[u] = row >= 0 && j < f ? xb[row * sr + j] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < NB; ++u) {
            const int cm = cm0 + u * NW;
            if (cm < n_cm)
              split_tf32(-2.f * v[u], ah[cm * 32 + lane],
                         al[cm * 32 + lane]);
          }
        }
        wide_fence_async();
      } else {
        const int xs = wide_xs(f);
        for (int r = warp; r < BM; r += NCT / 32) {
          const int row = ms.row[r];
          for (int j = lane; j < fp; j += 32)
            a_p[r * xs + j] = row >= 0 && j < f ? xb[row * sr + j] : 0.f;
        }
      }
      wide_bar(1, NCT);
    }
    WIDE_PH(1);
    const int r0 = 64 * wg + 16 * wi + g;     // this lane's rows r0, r0 + 8
    float m1[2] = {INFINITY, INFINITY}, m2[2] = {INFINITY, INFINITY};
    int i1[2] = {0, 0};
    float thr[2] = {0.f, 0.f};
    bool fb[2] = {false, false};
    const float* xr[2] = {xb, xb};
    if (rescore) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float t = ms.thr[r0 + 8 * h];
        thr[h] = isfinite(t) ? t : INFINITY;
        fb[h] = r0 + 8 * h < rows;
        if (fb[h]) xr[h] = xb + ms.row[r0 + 8 * h] * sr;
      }
    }
    // A: the warpgroup's 64 rows; 4-column slabs of BM / 8 (ARES) or 8
    // (the chunk buffer) core matrices
    const unsigned a_lbo = ARES ? BM * 16 : 1024;
    const unsigned a_base =
        ARES ? a_s + 1024 * wg
             : a_s + (unsigned)(BM * wide_xs(f) * 4) + wg * 64 * kc * 8;
    const unsigned a_lo = ARES ? (unsigned)BM * fp * 4 : 64 * kc * 4;
    float acc[64];
    // chunk c of the tile in ring stage st: (!ARES: the rows' chunk split
    // into the buffer first) the products lo * hi, hi * lo, hi * hi of
    // each 8-deep k-step, committed as one group
    auto issue = [&](unsigned st, int c) {
      const int c0 = c * kc, w = fp - c0 < kc ? fp - c0 : kc;
      if constexpr (!ARES) {
        uint32_t* bh = reinterpret_cast<uint32_t*>(
            a_p + BM * wide_xs(f) + wg * 64 * kc * 2);
        uint32_t* bl = bh + 64 * kc;
        const int xs = wide_xs(f);
        for (int cm = wi; cm < 8 * (w / 4); cm += 4) {
          const int j4 = cm >> 3, g8 = cm & 7;
          const float v = a_p[(64 * wg + g8 * 8 + g) * xs + c0 + j4 * 4 + q];
          split_tf32(-2.f * v, bh[cm * 32 + lane], bl[cm * 32 + lane]);
        }
        wide_fence_async();
        wide_bar(2 + wg, 128);
      }
      wide_mbar_wait(full(st), (seq / stages) & 1);
      WIDE_PH(2);
      const unsigned b_hi = ring + st * st_b;
      const unsigned a0 =
          a_base + (ARES ? (unsigned)(c0 / 8) * 2 * a_lbo : 0u);
      wide_wgmma_fence();
#pragma unroll 1
      for (int s = 0; s < w / 8; ++s) {
        const unsigned ah = a0 + s * 2 * a_lbo, bh = b_hi + s * 4096;
        const uint64_t dah = wide_desc(ah, a_lbo, 128);
        const uint64_t dbh = wide_desc(bh, 2048, 128);
        wide_wgmma(acc, wide_desc(ah + a_lo, a_lbo, 128), dbh);
        wide_wgmma(acc, dah, wide_desc(bh + lo_off, 2048, 128));
        wide_wgmma(acc, dah, dbh);
      }
      wide_wgmma_commit();
    };
    for (int t = 0; t < nt_n; ++t) {
      // chunk 0 brings the tile's |c|^2, the accumulators' start
      {
        const unsigned st = seq % stages;
        wide_mbar_wait(full(st), (seq / stages) & 1);
        const float* cn = reinterpret_cast<const float*>(
            wsm + (ring - s0) + st * st_b + 2 * lo_off);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float2 v =
              *reinterpret_cast<const float2*>(cn + 8 * j + 2 * q);
          acc[4 * j] = v.x;
          acc[4 * j + 1] = v.y;
          acc[4 * j + 2] = v.x;
          acc[4 * j + 3] = v.y;
        }
        issue(st, 0);
      }
      for (int c = 1; c < ch_n; ++c) {
        if constexpr (!ARES) {   // the chunk buffer is free after chunk c - 1
          wide_wgmma_wait<0>();
          wide_mbar_arrive(empty(seq % stages));
          ++seq;
          issue(seq % stages, c);
        } else {
          ++seq;
          issue(seq % stages, c);
          wide_wgmma_wait<1>();            // chunk c - 1's stage is read
          wide_mbar_arrive(empty((seq - 1) % stages));
        }
      }
      wide_wgmma_wait<0>();
      wide_mbar_arrive(empty(seq % stages));
      ++seq;
      WIDE_PH(3);
      if constexpr (Probe) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = ms.row[r0 + 8 * (e >> 1)];
            if (row >= 0)
              sums[((size_t)br * n + row) * kpad + t * kWideBN + 8 * j +
                   2 * q + (e & 1)] = acc[4 * j + e];
          }
      } else if (!rescore) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, cc = t * kWideBN + 8 * j + 2 * q + (e & 1);
            const float d = acc[4 * j + e];
            m2[h] = fminf(m2[h], fmaxf(m1[h], d));
            i1[h] = d < m1[h] ? cc : i1[h];
            m1[h] = fminf(m1[h], d);
          }
      } else {
        // the candidates (!(d~ > T)) as bits in increasing codeword order,
        // then each rescored exactly
        uint32_t cand[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!(acc[4 * j + e] > thr[e >> 1]))
              cand[e >> 1] |= 1u << (2 * j + (e & 1));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t m = fb[h] ? cand[h] : 0u;
          while (m != 0u) {
            const int bit = __ffs(m) - 1;
            m &= m - 1u;
            const int cc = t * kWideBN + 8 * (bit >> 1) + 2 * q + (bit & 1);
            if (cc >= k) break;
            const float dx =
                wide_exact(xr[h], cw + ((size_t)br * k + cc) * f,
                           cn2[(size_t)br * kpad + cc], f, nullptr);
            if (dx < m1[h]) {          // strict: the lowest index keeps ties
              m1[h] = dx;
              i1[h] = cc;
            }
          }
        }
      }
      WIDE_PH(4);
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
        ms.m1[r0 + 8 * h] = m1[h];
        ms.m2[r0 + 8 * h] = m2[h];
        ms.i1[r0 + 8 * h] = i1[h];
      }
    }
  };

  // The tile's rows with ms.arg[r] >= 0 are finished: their outputs, and
  // with Stats the cluster statistics, one chain of rows a codeword.
  auto finish = [&](int br) {
    for (int r = tid; r < BM; r += NT)
      if (ms.arg[r] >= 0) {
        const size_t out = (size_t)br * n + ms.row[r];
        idx[out] = (Idx)ms.arg[r];
        if (qerr != nullptr)
          qerr[out] = fmaxf(__fadd_rn(ms.best[r], ms.xn2[r]), 0.f);
      }
    if constexpr (Stats) {
      // rows by codeword: the tile's first (it adds the count), the first
      // in each 32-row segment, and from there the first in a later one
      constexpr int SEG = 32;
      bool chained = false;                    // a segment holds a chain
      for (int r = tid; r < BM; r += NT) {
        const int a = ms.arg[r], s0 = r / SEG * SEG;
        int len = 0, first = BM, sl = r, sn = -1;
        if (a >= 0)
          for (int rr = 0; rr < BM; ++rr) {
            const bool m = ms.arg[rr] == a;
            len += m;
            first = m && rr < first ? rr : first;
            sl = m && rr >= s0 && rr < sl ? rr : sl;
            sn = m && sn < 0 && rr >= s0 + SEG ? rr : sn;
          }
        ms.seg_lead[r] = sl;
        ms.seg_next[r] = sn;
        ms.lead[r] = a >= 0 && first == r;
        chained |= sl != r;
        if (a >= 0 && first == r)
          atomicAdd(counts + (size_t)br * k + a, (float)len);
      }
      chained = __syncthreads_or(chained);
      for (int j0 = 0; j0 < f; j0 += JC) {
        const int jc = f - j0 < JC ? f - j0 : JC;
        // one chunk holds the width: the rows are still staged from u
        if (JC < f)
          wide_stage_cols<BM, NT>(x + br * sb, sr, cw, f, ms.row, ms.i1,
                                  false, j0, jc, ex, ec, JS, warp, lane);
        // each segment's rows of a codeword summed onto its first row there,
        // in row order, a thread a (segment, column)
        if (chained) {
          for (int e = tid; e < (BM / SEG) * jc; e += NT) {
            const int s = e / jc, jj = e - s * jc;
            for (int r = s * SEG; r < s * SEG + SEG; ++r) {
              const int l = ms.seg_lead[r];
              if (ms.arg[r] >= 0 && l != r)
                ex[l * JS + jj] += ex[r * JS + jj];
            }
          }
          __syncthreads();
        }
        for (int r = warp; r < BM; r += NT / 32) {
          if (!ms.lead[r]) continue;
          // the segments' sums in order; columns by 16-byte groups where
          // aligned, the ends one by one
          const size_t g0 = ((size_t)br * k + ms.arg[r]) * f + j0;
          float* s_ = sums + g0;
          const int hd = min((int)((4 - (g0 & 3)) & 3), jc);
          const int nv = (jc - hd) >> 2, tl = hd + 4 * nv;
          for (int e = lane; e < hd + jc - tl; e += 32) {
            const int jj = e < hd ? e : tl + e - hd;
            float a = 0.f;
            for (int rr = r; rr >= 0; rr = ms.seg_next[rr])
              a += ex[rr * JS + jj];
            atomicAdd(s_ + jj, a);
          }
          for (int v = lane; v < nv; v += 32) {
            const int jj = hd + 4 * v;
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
            for (int rr = r; rr >= 0; rr = ms.seg_next[rr]) {
              const float* e_ = ex + rr * JS + jj;
              a.x += e_[0];
              a.y += e_[1];
              a.z += e_[2];
              a.w += e_[3];
            }
            atomicAdd(reinterpret_cast<float4*>(s_ + jj), a);
          }
        }
        __syncthreads();
      }
    }
    wide_fence_async();      // the ring's next writes are the async proxy's
    __syncthreads();
  };

  // Rescore the first cnt queued rows as one tile.
  auto drain = [&](int br, int cnt) {
    WIDE_PH_DRAIN(1);
    for (int r = tid; r < BM; r += NT) {
      ms.row[r] = r < cnt ? ms.q_row[r] : -1;
      ms.thr[r] = r < cnt ? ms.q_thr[r] : 0.f;
    }
    __syncthreads();
    const int rest = ms.q_n - cnt;
    for (int i = tid; i < rest; i += NT) {          // [cnt, q_n) -> [0, rest)
      ms.q_row[i] = ms.q_row[cnt + i];              // rest <= cnt: no overlap
      ms.q_thr[i] = ms.q_thr[cnt + i];
    }
    __syncthreads();
    if (tid == 0) ms.q_n = rest;
    pass(br, true, cnt);
    __syncthreads();
    float dot, xx;
    wide_rows_exact<BM, NT>(x + br * sb, sr, cw + (size_t)br * k * f, f,
                            ms.row, ms.i1, false, ex, ec, JC, JS, tid, warp,
                            lane, dot, xx);
    for (int r = tid; r < BM; r += NT) {
      ms.arg[r] = r < cnt ? ms.i1[r] : -1;
      ms.best[r] = ms.m1[r];
      if (r < cnt) ms.xn2[r] = xx;          // thread r holds row r's |x|^2
    }
    __syncthreads();
    finish(br);
    WIDE_PH(7);
    WIDE_PH_DRAIN(0);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wide_mbar_init(full(s), 1);
      wide_mbar_init(empty(s), NCT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    ms.q_n = 0;
    ms.queued = 0;
  }
  __syncthreads();
  int cur = -1;
  for (long long t = t_lo; t < t_hi; ++t) {
    const int br = (int)(t / tpb);
    const int row0 = (int)(t - (long long)br * tpb) * BM;
    if (br != cur) {
      __syncthreads();
      if (!Probe && cur >= 0 && ms.q_n > 0) drain(cur, ms.q_n);
      cur = br;
      // cmax of the branch (fmaxf: a NaN codeword is only ever a candidate)
      float m = 0.f;
      for (int c = tid; c < k; c += NT)
        m = fmaxf(m, cn2[(size_t)br * kpad + c]);
#pragma unroll
      for (int o = 16; o; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      if (lane == 0) ms.red[warp] = m;
      __syncthreads();
      if (tid == 0) {
        float a = 0.f;
        for (int w = 0; w < NT / 32; ++w) a = fmaxf(a, ms.red[w]);
        ms.cmax = sqrtf(a);
      }
    }
    for (int r = tid; r < BM; r += NT)
      ms.row[r] = row0 + r < n ? row0 + r : -1;
    __syncthreads();
    WIDE_PH(0);
    if (t + 1 < t_hi) {
      pf_br = (int)((t + 1) / tpb);
      pf_row0 = (int)(t + 1 - (long long)pf_br * tpb) * BM;
    }
    pass(br, false, 0);
    pf_br = -1;
    __syncthreads();
    WIDE_PH(4);
    if constexpr (Probe) continue;
    float dot, xx;
    wide_rows_exact<BM, NT>(x + br * sb, sr, cw + (size_t)br * k * f, f,
                            ms.row, ms.i1, true, ex, ec, JC, JS, tid, warp,
                            lane, dot, xx);

    for (int r = tid; r < BM; r += NT) {     // r = tid: its sums above
      ms.arg[r] = -1;
      const int row = ms.row[r];
      if (row < 0) continue;
      const int ai = ms.i1[r];
      const float a2 = ms.m2[r];
      const float u =
          __fsub_rn(cn2[(size_t)br * kpad + ai], __fmul_rn(2.f, dot));
      ms.xn2[r] = xx;
      const float xn = sqrtf(xx);
      const float b = xn * kWideUp, bb = b * b;
      const float rr =
          (b + sqrtf(fmaxf(bb + u, 0.f) + (kWideUp - 1.f) * (bb + fabsf(u))))
          * kWideUp;
      const float cm = fminf(ms.cmax, rr);
      const float thr = u + e_coef * (cm * cm + 4.f * xn * cm)
                        + kTinyBound * (1.f + xn + cm);
      if (isfinite(thr) && a2 > thr) {
        ms.arg[r] = ai;
        ms.best[r] = u;
      } else {
        const int slot = atomicAdd(&ms.q_n, 1);
        ms.q_row[slot] = row;
        ms.q_thr[slot] = thr;
        atomicAdd(&ms.queued, 1u);
      }
    }
    __syncthreads();
    WIDE_PH(5);
    finish(br);
    WIDE_PH(6);
    if (ms.q_n >= BM) drain(br, BM);
  }
  __syncthreads();
  if (!Probe && cur >= 0 && ms.q_n > 0) drain(cur, ms.q_n);
  if (tid == 0 && ms.queued > 0)
    atomicAdd(reinterpret_cast<unsigned*>(scratch), ms.queued);
  WIDE_PH(0);
  WIDE_PH_FLUSH();
}

// Launch the wide build: the prologue into the caller's scratch
// (wide_scratch_floats(nb, k, f) floats), then the scan.  wgs: consumer
// warpgroups a block (0: 2, or 1 where 128-row tiles are fewer than the
// SMs or f has no 128-row plan -- PERF.md times both).
template <typename Idx, bool Stats, bool Probe = false>
cudaError_t launch_wide(const float* x, long long sb, long long sr,
                        const float* cw, float* scratch, Idx* idx,
                        float* qerr, float* counts, float* sums, int nb,
                        int n, int k, int f, cudaStream_t stream,
                        int wgs = 0) {
  if (f < 1 || f > kWideMaxF || k < 1 || nb < 1 || n < 1 || wgs < 0 ||
      wgs > 2)
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
  WidePlan p;
  if (wgs == 0)            // 128-row tiles where they fill the SMs
    wgs = (long long)nb * ((n + 127) / 128) >= sms &&
                  wide_plan(f, 2, (size_t)limit, p)
              ? 2 : 1;
  if (!wide_plan(f, wgs, (size_t)limit, p)) return cudaErrorInvalidValue;
  auto kern = wgs == 2
      ? (p.ares ? &vq_wide_kernel<2, true, Idx, Stats, Probe>
                : &vq_wide_kernel<2, false, Idx, Stats, Probe>)
      : (p.ares ? &vq_wide_kernel<1, true, Idx, Stats, Probe>
                : &vq_wide_kernel<1, false, Idx, Stats, Probe>);
  const int threads = 128 * wgs + 32;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, threads, p.smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  wide_prep_kernel<<<dim3((unsigned)(wide_kpad(k) / kWidePrepCw),
                          (unsigned)nb), 128, 0, stream>>>(cw, scratch, nb, k,
                                                           f);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int bm = 64 * wgs;
  const long long tiles = (long long)nb * ((n + bm - 1) / bm);
  long long grid = (long long)per_sm * sms;
  if (grid > tiles) grid = tiles;
  const long long per_block = (tiles + grid - 1) / grid;
  grid = (tiles + per_block - 1) / per_block;
  kern<<<(unsigned)grid, threads, p.smem, stream>>>(
      x, sb, sr, cw, scratch, idx, qerr, counts, sums, nb, n, k, f, per_block,
      p.kc, p.stages, wide_epilogue_cols(f, bm, p.kc, p.stages));
  return cudaGetLastError();
}

// The plan the launch takes at width f with wgs warpgroups, for the
// wrappers' tests: {ares, kc, stages, smem bytes}; cudaErrorInvalidValue
// where no plan fits.
inline cudaError_t wide_plan_query(int f, int wgs, int* out) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(
           &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return err;
  WidePlan p;
  if (f < 1 || f > kWideMaxF || !wide_plan(f, wgs, (size_t)limit, p))
    return cudaErrorInvalidValue;
  out[0] = p.ares;
  out[1] = p.kc;
  out[2] = p.stages;
  out[3] = (int)p.smem;
  return cudaSuccess;
}

}  // namespace
