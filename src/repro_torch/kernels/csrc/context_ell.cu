// Fused multi-branch VQ-context SpMM (the Eq. 6 out-of-batch term):
//     out[i, b*fb + j] = sum_d val[i, d] * cw[b, A[b, ids[i, d]], j]
//
// Replaces the TPU kernel src/repro/kernels/context_ell.py:
// context_ell_pallas in its _context_ell_kernel form (fp32 codewords,
// int32 assignment table, no w_t epilogue), called by
// core/message_passing.py:context_messages_reconstruct, and in the forms
// of the precision tiers (see "Precision tiers" below).
//
// What bounds it on an H100: the L2 traffic of two dependent gathers per
// slot (node id -> codeword id -> codeword element), each a 32-byte
// sector for 1-16 useful bytes, and, at the serving shape (b = 256, D =
// 18, 128 output columns), launch latency.  The bytes the function needs
// are small: ids and values (6.1 MB at the training batch b = 42,335), the
// assignment entries of the touched nodes and the touched codeword rows,
// 0.014 ms of bandwidth.
//
// The table is read in place in the layout its owner holds it in; the
// kernels take its strides.  core.conv.hold_table holds a tier state's
// table node-major on the card -- [nb, n] values over [n, nb] storage, a
// node's ids in every branch in one sector, as the Pallas kernel reads its
// transposed table: with the 1-byte codewords staged in shared memory the
// table's reads are what the staged kernel waits on, 1.6-2.0x faster
// node-major at the training batch -- and an fp32 state's table row-major:
// its codewords are gathered from L2, and the two layouts measured within
// 1.2x on the trained model's ids (PERF.md).
//
// Three kernels, all bit-equal to the plain version: every slot in order
// with an fp32 accumulator, each multiply and add rounded on its own;
// padding slots (val == 0) multiplied, not skipped; out-of-range ids
// clamped as a JAX gather would.  D == 0 never reaches them: the wrapper
// returns zeros.
//   * context_ell_kernel: one block a row, one thread a column c (branch
//     b = c / fb), the slots walked in order with a 32-bit offset per slot
//     from a 64-bit branch base -- measured faster than 64-bit offsets,
//     and than issuing 4 slots' loads ahead at the training batch or 16
//     at the serving batch (PERF.md) -- and the codewords read in place
//     from L2.  Small batches, and codewords too large for one block's
//     shared memory (f32 at k 1024: 512 KB).
//   * context_ell_staged_kernel: b >= kStagedRows and every codeword fits
//     one block (the tiers' k 256 tables, the 40-column gradient half): a
//     persistent grid, each block staging the codewords in shared memory
//     once; each warp takes rows in passes (warp_accumulate): it stages a
//     chunk of kDS slots' values and table entries (vector loads from the
//     node-major table), then each lane gathers its codeword elements from
//     shared memory.  Splitting larger codeword sets into column groups
//     was measured slower (each group re-reads every row) and is not kept.
//   * the w_t form, repro_context_ell_wt_*: the same accumulate into a
//     block's rows in shared memory, then the epilogue out[i, :] = acc[i,
//     :] @ w_t (w_t [nb*fb, f_out]) -- the _context_ell_wt_kernel form of
//     context_ell_pallas, called by the Eq. 7 backward injection
//     (core/message_passing.py:inject_context_grad) with reverse-edge
//     operands, the gradient codewords and w_t = W^T; the Pallas kernel
//     does the @ W^T on its MXU in the kernel body, so the epilogue belongs
//     here too.  At the training shape (b = 42,335, Dr = 18, nb*fb = 128,
//     f_out = 128) the epilogue is b*128*128 = 694 M multiply-adds, each a
//     separately rounded multiply and add for the plain version's bits:
//     1.39 G fp32 instructions, ~0.045 ms at the card's issue rate.
//     Large batches take 32-row blocks: the context one thread an
//     element (fp32 codewords) or through warp_accumulate (1-byte ones,
//     codewords in place), w_t streamed through shared
//     memory in slices of kWtK rows, and each thread register-tiles 4 rows
//     x 4 outputs (four 16-byte context broadcasts and four 16-byte w_t
//     rows for 64 multiply-adds), summing the columns in order.  Small
//     batches take 8-row blocks (enough blocks to fill the card) reading
//     w_t from L2, as do context rows too wide for 32 rows of shared
//     memory (nb*fb > ~1,700), so every width the first version took still
//     runs.
//
// Precision tiers: _context_ell_q_kernel, _context_ell_q_wt_kernel and the
// uint8 and nibble-packed branches of _accumulate.  The kernels are
// templates on the codeword type (float, int8_t, __nv_fp8_e4m3) and on the
// table (int32, uint8 [nb, n], or nibble-packed [nb, ceil(n/2)] uint8 with
// node v's id in the byte v >> 1 at bit (v & 1) * 4), with one extern "C"
// entry per pair: repro_context_ell[_wt]_<f32|i8|f8>_<i32|u8|a4>.  A 1-byte
// codeword widens to fp32 exactly, the slots accumulate in the fp32
// kernels' order, and the [nb, 1, fb] scale (read as the flat [nb*fb] row)
// multiplies once after the last slot -- before the w_t columns are summed,
// as the Pallas kernel dequantizes before its W^T matmul -- so every form
// is bit-equal to the plain version.  The table is read in its storage
// type, never widened.
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kStWarps = 16;   // warps of a staged forward block
constexpr int kDS = 32;        // slots a warp stages at a time
constexpr int kAS = 32;        // table entries a warp stages per slot
constexpr int kPL = 4;         // (row, column) pairs a lane accumulates
constexpr int kWtK = 32;       // w_t columns (rows of w_t) staged at a time
constexpr int kWtOut = 128;    // outputs per pass of the w_t epilogue
constexpr int kStagedRows = 4096;   // the staged forward from this many rows

// table kinds
constexpr int kI32 = 0;      // int32
constexpr int kU8 = 1;       // uint8
constexpr int kA4 = 2;       // nibble-packed uint8 (node v in byte v >> 1)

// The table and its strides in elements (bytes for the 1-byte tables):
// entry (br, v) -- for kA4 the byte holding node v -- is at
// br * s_br + v' * s_id, v' = v (v >> 1 for kA4).  [nb, n]: s_br = n (or
// ceil(n/2)), s_id = 1; node-major [n, nb] ([ceil(n/2), nb]): s_br = 1,
// s_id = nb.
struct Table {
  const void* p;
  long long s_br, s_id;
};

// Branch br's entries (64-bit base), then node id's entry at a 32-bit
// offset id * s_id (the wrapper keeps n * s_id under 2^31).
template <int Tab>
__device__ __forceinline__ const void* table_row(const Table& t, int br) {
  return static_cast<const char*>(t.p)
         + (size_t)br * t.s_br * (Tab == kI32 ? 4 : 1);
}

template <int Tab>
__device__ __forceinline__ int table_at(const void* row, int id, int s_id) {
  if (Tab == kI32) return static_cast<const int*>(row)[id * s_id];
  if (Tab == kU8) return static_cast<const uint8_t*>(row)[id * s_id];
  const int byte = static_cast<const uint8_t*>(row)[(id >> 1) * s_id];
  return (byte >> ((id & 1) * 4)) & 0xF;
}

// Node id's entries A[0 .. nb - 1, id], clamped to [0, k), into ap
// (16-byte aligned when nb % 4 == 0).  In a node-major table they are
// contiguous: read 4 (int32) or 16 / 4 (1-byte) at a time where aligned.
template <int Tab>
__device__ __forceinline__ void stage_entries(int* ap, const Table& t, int nb,
                                              int id, int k) {
  auto cl = [k](int a) { return min(max(a, 0), k - 1); };
  if (t.s_br == 1 && (nb & 3) == 0) {
    if (Tab == kI32) {
      const int* src = static_cast<const int*>(t.p) + (size_t)id * t.s_id;
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int bl = 0; bl < nb; bl += 4) {
          const int4 v = *reinterpret_cast<const int4*>(src + bl);
          *reinterpret_cast<int4*>(ap + bl) =
              make_int4(cl(v.x), cl(v.y), cl(v.z), cl(v.w));
        }
        return;
      }
    } else {
      const uint8_t* src = static_cast<const uint8_t*>(t.p)
                           + (size_t)(Tab == kA4 ? id >> 1 : id) * t.s_id;
      const int sh = Tab == kA4 ? (id & 1) * 4 : 0;
      const unsigned mask = Tab == kA4 ? 0xFu : 0xFFu;
      auto put4 = [&](int* o, unsigned w) {
        *reinterpret_cast<int4*>(o) = make_int4(
            cl((w >> sh) & mask), cl((w >> (8 + sh)) & mask),
            cl((w >> (16 + sh)) & mask), cl((w >> (24 + sh)) & mask));
      };
      if ((nb & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        for (int bl = 0; bl < nb; bl += 16) {
          const uint4 v = *reinterpret_cast<const uint4*>(src + bl);
          put4(ap + bl, v.x);
          put4(ap + bl + 4, v.y);
          put4(ap + bl + 8, v.z);
          put4(ap + bl + 12, v.w);
        }
        return;
      }
      if ((reinterpret_cast<uintptr_t>(src) & 3) == 0) {
        for (int bl = 0; bl < nb; bl += 4)
          put4(ap + bl, *reinterpret_cast<const unsigned*>(src + bl));
        return;
      }
    }
  }
  for (int bl = 0; bl < nb; ++bl)
    ap[bl] = cl(table_at<Tab>(table_row<Tab>(t, bl), id, (int)t.s_id));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(int8_t v) { return (float)v; }
__device__ __forceinline__ float widen(__nv_fp8_e4m3 v) { return (float)v; }

// One output element (row, column c) on its own: sum_d val[d] *
// cw[br, A[br, id_d], j] in slot order (the scale is applied by the caller).
template <typename Cw, int Tab>
__device__ __forceinline__ float accumulate(
    const int* __restrict__ ir, const float* __restrict__ vr, const Table& tab,
    const Cw* __restrict__ cw, int c, int deg, int n, int k, int f_blk) {
  const int br = c / f_blk;
  const int j = c - br * f_blk;
  const Cw* cb = cw + (size_t)br * k * f_blk + j;
  const void* row = table_row<Tab>(tab, br);
  const int s_id = (int)tab.s_id;
  float acc = 0.f;
  for (int d = 0; d < deg; ++d) {
    const int id = min(max(ir[d], 0), n - 1);
    const int a = min(max(table_at<Tab>(row, id, s_id), 0), k - 1);
    acc = __fadd_rn(acc, __fmul_rn(vr[d], widen(cb[a * f_blk])));
  }
  return acc;
}

// Rows per warp pass of warp_accumulate for nb branches of width f_blk:
// up to kPL * 32 (row, column) pairs and kAS staged table entries a slot.
__host__ __device__ __forceinline__ int warp_rows(int nb, int f_blk) {
  int rw = (kPL * 32) / (nb * f_blk);
  if (rw * nb > kAS) rw = kAS / nb;
  return rw < 1 ? 1 : rw;
}

// A warp's rows r0 .. r0 + nr - 1 (nb * f_blk <= kPL * 32, nb <= kAS):
// lane pair i is (row, column) p / ncol, p % ncol of p = lane + 32 i.  For
// every chunk of kDS slots the warp first stages the rows' values and
// their table entries A[br, id] (all independent loads: one round trip for
// the chunk), then each lane gathers its codeword elements from cwp -- the
// [nb, k, f_blk] codewords, in shared memory or in place -- and
// accumulates in slot order, each multiply and add rounded on its own.
template <typename Cw, int Tab>
__device__ __forceinline__ void warp_accumulate(
    float (&acc)[kPL], const int* __restrict__ ids,
    const float* __restrict__ vals, const Table& tab, const Cw* cwp,
    long long r0, int nr, int deg, int n, int k, int f_blk, int nb,
    int* a_s, float* v_s, int lane) {
  const int ncol = nb * f_blk;
#pragma unroll
  for (int i = 0; i < kPL; ++i) acc[i] = 0.f;
  for (int d0 = 0; d0 < deg; d0 += kDS) {
    const int ds = deg - d0 < kDS ? deg - d0 : kDS;
    __syncwarp();
    for (int e = lane; e < nr * ds; e += 32) {
      const int row = e / ds, sl = e - row * ds;
      const long long off = (r0 + row) * deg + d0 + sl;
      const int id = min(max(ids[off], 0), n - 1);
      v_s[row * kDS + sl] = vals[off];
      stage_entries<Tab>(a_s + (row * kDS + sl) * nb, tab, nb, id, k);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPL; ++i) {
      const int p = lane + 32 * i, row = p / ncol;
      if (row < nr) {
        const int c = p - row * ncol, bl = c / f_blk, j = c - bl * f_blk;
        const Cw* cb = cwp + (size_t)bl * k * f_blk + j;
        const int* ap = a_s + row * kDS * nb + bl;
        const float* vp = v_s + row * kDS;
        float a = acc[i];
#pragma unroll 8
        for (int sl = 0; sl < ds; ++sl)
          a = __fadd_rn(a, __fmul_rn(vp[sl], widen(cb[ap[sl * nb] * f_blk])));
        acc[i] = a;
      }
    }
  }
}

// One block a row, one thread a column, the codewords read in place (L2):
// small batches, and codewords too large for one block's shared memory.
template <typename Cw, int Tab>
__global__ void __launch_bounds__(kMaxThreads)
context_ell_kernel(const int* __restrict__ ids, const float* __restrict__ vals,
                   Table tab, const Cw* __restrict__ cw,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int deg, int n, int nb, int k, int f_blk) {
  const long long row = blockIdx.x;
  const int ncol = nb * f_blk;
  const int* ir = ids + row * deg;
  const float* vr = vals + row * deg;
  for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
    const float acc = accumulate<Cw, Tab>(ir, vr, tab, cw, c, deg, n, k, f_blk);
    out[row * ncol + c] = scale == nullptr ? acc : __fmul_rn(acc, scale[c]);
  }
}

// Large batches whose codewords all fit one block: a persistent grid, each
// block stages every codeword in shared memory once, then its warps take
// rows_pb / (warps * rw) passes of warp_accumulate each.
template <typename Cw, int Tab>
__global__ void __launch_bounds__(kStWarps * 32)
context_ell_staged_kernel(const int* __restrict__ ids,
                          const float* __restrict__ vals, Table tab,
                          const Cw* __restrict__ cw,
                          const float* __restrict__ scale,
                          float* __restrict__ out, int b, int deg, int n,
                          int nb, int k, int f_blk, int rows_pb) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int ncol = nb * f_blk;
  const int rw = warp_rows(nb, f_blk);
  Cw* cw_s = reinterpret_cast<Cw*>(sm);
  const size_t cw_bytes = ((size_t)nb * k * f_blk * sizeof(Cw) + 15) & ~15;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* a_s = reinterpret_cast<int*>(sm + cw_bytes) + warp * rw * kDS * nb;
  float* v_s = reinterpret_cast<float*>(sm + cw_bytes)
               + kStWarps * rw * kDS * nb + warp * rw * kDS;
  for (int i = threadIdx.x; i < nb * k * f_blk; i += blockDim.x)
    cw_s[i] = cw[i];
  __syncthreads();
  const long long lo = (long long)blockIdx.x * rows_pb;
  const long long hi = lo + rows_pb < b ? lo + rows_pb : b;
  for (long long r0 = lo + warp * rw; r0 < hi; r0 += kStWarps * rw) {
    const int nr = hi - r0 < rw ? (int)(hi - r0) : rw;
    float acc[kPL];
    warp_accumulate<Cw, Tab>(acc, ids, vals, tab, cw_s, r0, nr, deg, n, k,
                             f_blk, nb, a_s, v_s, lane);
#pragma unroll
    for (int i = 0; i < kPL; ++i) {
      const int p = lane + 32 * i, row = p / ncol;
      if (row < nr) {
        const int c = p - row * ncol;
        out[(r0 + row) * ncol + c] =
            scale == nullptr ? acc[i] : __fmul_rn(acc[i], scale[c]);
      }
    }
  }
}

// The w_t form.  TR = 4: 32 rows a block, w_t streamed through shared
// memory in slices and register-tiled (large batches); TR = 1: 8 rows a
// block, thread o summing output o of all 8 rows with w_t read from L2
// (small batches, and context rows too wide for 32 rows).  Warp: the
// context through warp_accumulate, else one thread an element.
template <typename Cw, int Tab, int TR, bool Warp>
__global__ void __launch_bounds__(kMaxThreads)
context_ell_wt_kernel(const int* __restrict__ ids,
                      const float* __restrict__ vals, Table tab,
                      const Cw* __restrict__ cw,
                      const float* __restrict__ scale,
                      const float* __restrict__ w_t, float* __restrict__ out,
                      int b, int deg, int n, int nb, int k, int f_blk,
                      int f_out) {
  constexpr int RB = 8 * TR;                     // rows of the block
  constexpr int kWarps = kMaxThreads / 32;
  extern __shared__ __align__(16) float smem[];
  const int ncol = nb * f_blk;
  const int ncol_s = (ncol + 3) & ~3;            // 16-byte aligned rows
  float* acc_s = smem;                           // [RB, ncol_s]
  float* w_s = smem + RB * ncol_s;               // TR 4: [kWtK, kWtOut]
  float* st_s = w_s + (TR == 4 ? kWtK * kWtOut : 0);   // Warp: staging
  const long long row0 = (long long)blockIdx.x * RB;
  const int rows = b - row0 < RB ? (int)(b - row0) : RB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (!Warp) {
    for (int t = threadIdx.x; t < RB * ncol; t += blockDim.x) {
      const int r = t / ncol;
      const int c = t - r * ncol;
      float v = 0.f;   // rows past the end of the last block stay 0
      if (r < rows) {
        v = accumulate<Cw, Tab>(ids + (row0 + r) * deg,
                                vals + (row0 + r) * deg, tab, cw, c, deg, n,
                                k, f_blk);
        if (scale != nullptr) v = __fmul_rn(v, scale[c]);
      }
      acc_s[r * ncol_s + c] = v;
    }
  } else {
    const int rw = warp_rows(nb, f_blk);
    int* a_s = reinterpret_cast<int*>(st_s) + warp * rw * kDS * nb;
    float* v_s = st_s + kWarps * rw * kDS * nb + warp * rw * kDS;
    for (int r0 = warp * rw; r0 < RB; r0 += kWarps * rw) {
      const int nr = RB - r0 < rw ? RB - r0 : rw;
      const int nv = rows - r0 < nr ? (rows - r0 > 0 ? rows - r0 : 0) : nr;
      float acc[kPL];
      if (nv > 0)
        warp_accumulate<Cw, Tab>(acc, ids, vals, tab, cw, row0 + r0, nv, deg,
                                 n, k, f_blk, nb, a_s, v_s, lane);
#pragma unroll
      for (int i = 0; i < kPL; ++i) {
        const int p = lane + 32 * i, row = p / ncol;
        if (row < nr) {
          const int c = p - row * ncol;
          float v = 0.f;
          if (row < nv)
            v = scale == nullptr ? acc[i] : __fmul_rn(acc[i], scale[c]);
          acc_s[(r0 + row) * ncol_s + c] = v;
        }
      }
    }
  }
  __syncthreads();
  if (TR == 1) {
    // every w_t element read once a thread serves the block's 8 rows
    for (int o = threadIdx.x; o < f_out; o += blockDim.x) {
      float y[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) y[r] = 0.f;
      for (int c = 0; c < ncol; ++c) {
        const float w = w_t[(size_t)c * f_out + o];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          y[r] = __fadd_rn(y[r], __fmul_rn(acc_s[r * ncol_s + c], w));
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (r < rows) out[(row0 + r) * f_out + o] = y[r];
    }
    return;
  }
  // thread (rg, og): rows 4 rg .. 4 rg + 3, outputs ob + 4 og .. + 3
  const int rg = warp, og = lane;
  const float* a0 = acc_s + (TR * rg) * ncol_s;
  for (int ob = 0; ob < f_out; ob += kWtOut) {
    const int o0 = ob + 4 * og;
    const float4* wv = reinterpret_cast<const float4*>(w_s) + og;
    float y[TR][4];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int o = 0; o < 4; ++o) y[r][o] = 0.f;
    for (int c0 = 0; c0 < ncol; c0 += kWtK) {
      const int kc = ncol - c0 < kWtK ? ncol - c0 : kWtK;
      __syncthreads();   // the previous slice consumed
      for (int t = threadIdx.x; t < kWtK * kWtOut; t += blockDim.x) {
        const int cc = t / kWtOut, o = ob + t - cc * kWtOut;
        w_s[t] = (cc < kc && o < f_out) ? w_t[(size_t)(c0 + cc) * f_out + o]
                                        : 0.f;
      }
      __syncthreads();
      int cc = 0;
      for (; cc + 4 <= kc; cc += 4) {   // four columns at a time
        float4 av[TR];
#pragma unroll
        for (int r = 0; r < TR; ++r)
          av[r] = *reinterpret_cast<const float4*>(a0 + r * ncol_s + c0 + cc);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 w = wv[(cc + u) * (kWtOut / 4)];
#pragma unroll
          for (int r = 0; r < TR; ++r) {
            const float a = u == 0 ? av[r].x
                          : u == 1 ? av[r].y
                          : u == 2 ? av[r].z : av[r].w;
            y[r][0] = __fadd_rn(y[r][0], __fmul_rn(a, w.x));
            y[r][1] = __fadd_rn(y[r][1], __fmul_rn(a, w.y));
            y[r][2] = __fadd_rn(y[r][2], __fmul_rn(a, w.z));
            y[r][3] = __fadd_rn(y[r][3], __fmul_rn(a, w.w));
          }
        }
      }
      for (; cc < kc; ++cc) {
        const float4 w = wv[cc * (kWtOut / 4)];
#pragma unroll
        for (int r = 0; r < TR; ++r) {
          const float a = a0[r * ncol_s + c0 + cc];
          y[r][0] = __fadd_rn(y[r][0], __fmul_rn(a, w.x));
          y[r][1] = __fadd_rn(y[r][1], __fmul_rn(a, w.y));
          y[r][2] = __fadd_rn(y[r][2], __fmul_rn(a, w.z));
          y[r][3] = __fadd_rn(y[r][3], __fmul_rn(a, w.w));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int rr = TR * rg + r;
      if (rr < rows) {
#pragma unroll
        for (int o = 0; o < 4; ++o)
          if (o0 + o < f_out) out[(row0 + rr) * f_out + o0 + o] = y[r][o];
      }
    }
  }
}

cudaError_t smem_limit(int* limit) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// Shared memory of the staged forward: every codeword, then the warps'
// staging.
template <typename Cw>
size_t staged_bytes(int nb, int k, int f_blk) {
  const int rw = warp_rows(nb, f_blk);
  return (((size_t)nb * k * f_blk * sizeof(Cw) + 15) & ~(size_t)15)
         + (size_t)kStWarps * rw * kDS * (nb + 1) * sizeof(float);
}

template <typename Cw, int Tab>
cudaError_t launch(const int* ids, const float* vals, Table tab, const Cw* cw,
                   const float* scale, float* out, int b, int deg, int n,
                   int nb, int k, int f_blk, cudaStream_t stream) {
  if (b < 1 || deg < 1 || n < 1 || nb < 1 || k < 1 || f_blk < 1)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  // large batches whose codewords all fit one block's shared memory take
  // the staged kernel (measured: with 3-4 groups of branches re-reading
  // the rows, the direct one is faster)
  const bool staged = b >= kStagedRows && nb <= kAS && nb * f_blk <= kPL * 32
                      && staged_bytes<Cw>(nb, k, f_blk) <= (size_t)limit;
  if (!staged) {
    int threads = ((nb * f_blk + 31) / 32) * 32;
    if (threads > kMaxThreads) threads = kMaxThreads;
    context_ell_kernel<Cw, Tab><<<(unsigned)b, threads, 0, stream>>>(
        ids, vals, tab, cw, scale, out, deg, n, nb, k, f_blk);
    return cudaGetLastError();
  }
  const size_t smem = staged_bytes<Cw>(nb, k, f_blk);
  auto kern = context_ell_staged_kernel<Cw, Tab>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kStWarps * 32, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // one wave of blocks splits the rows evenly
  const int rows_pb = (b + per_sm * sms - 1) / (per_sm * sms);
  const int blocks = (b + rows_pb - 1) / rows_pb;
  kern<<<(unsigned)blocks, kStWarps * 32, smem, stream>>>(
      ids, vals, tab, cw, scale, out, b, deg, n, nb, k, f_blk, rows_pb);
  return cudaGetLastError();
}

template <typename Cw, int Tab, int TR, bool Warp>
cudaError_t launch_wt_as(const int* ids, const float* vals, Table tab,
                         const Cw* cw, const float* scale, const float* w_t,
                         float* out, int b, int deg, int n, int nb, int k,
                         int f_blk, int f_out, size_t smem,
                         cudaStream_t stream) {
  auto kern = context_ell_wt_kernel<Cw, Tab, TR, Warp>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((b + 8 * TR - 1) / (8 * TR));
  kern<<<blocks, kMaxThreads, smem, stream>>>(
      ids, vals, tab, cw, scale, w_t, out, b, deg, n, nb, k, f_blk, f_out);
  return cudaGetLastError();
}

// Shared memory of the w_t form: the [rows, ncol] context, a w_t slice,
// then the warps' staging (warp_accumulate).  Small batches take 8-row
// blocks (enough of them to fill the card), as do context rows too wide
// for 32.
template <typename Cw, int Tab>
cudaError_t launch_wt(const int* ids, const float* vals, Table tab,
                      const Cw* cw, const float* scale, const float* w_t,
                      float* out, int b, int deg, int n, int nb, int k,
                      int f_blk, int f_out, cudaStream_t stream) {
  if (b < 1 || deg < 1 || n < 1 || nb < 1 || k < 1 || f_blk < 1 || f_out < 1)
    return cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t err = smem_limit(&limit);
  if (err != cudaSuccess) return err;
  const size_t lim = (size_t)limit;
  const size_t ncol_s = ((size_t)nb * f_blk + 3) & ~(size_t)3;
  const size_t wide = (32 * ncol_s + (size_t)kWtK * kWtOut) * sizeof(float);
  if (b < kStagedRows || wide > lim)
    return launch_wt_as<Cw, Tab, 1, false>(
        ids, vals, tab, cw, scale, w_t, out, b, deg, n, nb, k, f_blk, f_out,
        8 * ncol_s * sizeof(float), stream);
  // 1-byte codewords take warp_accumulate (measured 4 % faster on the
  // int8 tier's operands), fp32 ones one thread an element (9 % faster)
  if constexpr (sizeof(Cw) == 1) {
    const size_t stage = (size_t)(kMaxThreads / 32) * warp_rows(nb, f_blk)
                         * kDS * (nb + 1) * sizeof(float);
    if (nb <= kAS && nb * f_blk <= kPL * 32 && wide + stage <= lim)
      return launch_wt_as<Cw, Tab, 4, true>(ids, vals, tab, cw, scale, w_t,
                                            out, b, deg, n, nb, k, f_blk,
                                            f_out, wide + stage, stream);
  }
  return launch_wt_as<Cw, Tab, 4, false>(ids, vals, tab, cw, scale, w_t, out,
                                         b, deg, n, nb, k, f_blk, f_out, wide,
                                         stream);
}

}  // namespace

// ids/vals: [b, deg] contiguous int32/fp32 (deg >= 1); assign: the int32 /
// uint8 table or the packed one, read at (br, v) -> br * s_br + v * s_id
// (packed: v >> 1) -- [nb, n] (s_br = n or ceil(n/2), s_id = 1) or
// node-major [n, nb] (s_br = 1, s_id = nb); cw: [nb, k, f_blk] contiguous;
// scale: the [nb, 1, f_blk] fp32 scales of quantized codewords (nullptr for
// fp32 ones); out: [b, nb*f_blk] fp32.  The _wt entries take w_t:
// [nb*f_blk, f_out] contiguous fp32 and write out: [b, f_out].
#define REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, TABN, TAB)                       \
  extern "C" cudaError_t repro_context_ell_##CWN##_##TABN(                   \
      const int* ids, const float* vals, const void* assign, long long s_br, \
      long long s_id, const CWT* cw, const float* scale, float* out, int b,  \
      int deg, int n, int nb, int k, int f_blk, cudaStream_t stream) {       \
    return launch<CWT, TAB>(ids, vals, Table{assign, s_br, s_id}, cw, scale, \
                            out, b, deg, n, nb, k, f_blk, stream);           \
  }                                                                          \
  extern "C" cudaError_t repro_context_ell_wt_##CWN##_##TABN(                \
      const int* ids, const float* vals, const void* assign, long long s_br, \
      long long s_id, const CWT* cw, const float* scale, const float* w_t,   \
      float* out, int b, int deg, int n, int nb, int k, int f_blk,           \
      int f_out, cudaStream_t stream) {                                      \
    return launch_wt<CWT, TAB>(ids, vals, Table{assign, s_br, s_id}, cw,     \
                               scale, w_t, out, b, deg, n, nb, k, f_blk,     \
                               f_out, stream);                               \
  }

#define REPRO_CONTEXT_ELL_TABLES(CWN, CWT)       \
  REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, i32, kI32) \
  REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, u8, kU8)   \
  REPRO_CONTEXT_ELL_ENTRIES(CWN, CWT, a4, kA4)

REPRO_CONTEXT_ELL_TABLES(f32, float)
REPRO_CONTEXT_ELL_TABLES(i8, int8_t)
REPRO_CONTEXT_ELL_TABLES(f8, __nv_fp8_e4m3)

// The card's opt-in shared memory a block, as the launches above read it.
extern "C" cudaError_t repro_smem_optin(int* out) { return smem_limit(out); }
