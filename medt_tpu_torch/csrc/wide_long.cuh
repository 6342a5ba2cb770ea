// The long-span attention at wide group planes (spans 65 to 256, every even
// gp up to 128 outside the narrow designs' 2, 4, 8 and 16), for Hopper
// (sm_90a): what the forward (csrc/axial_wide_long_fwd.cu) and the
// backward (csrc/axial_wide_long_bwd.cu, axial_wide_long_col.cu) share.
//
// Replaces, at those widths, the Pallas TPU kernels of flash2_lanes_core
// in medt_tpu/ops/pallas_axial_lanes.py (forward _flash2_fwd_kernel,
// backward _flash2_bwd_rule), and serves the long-span sites of
// fused_attn_core (medt_tpu/ops/pallas_axial_train.py: its forward and
// _fused_bwd_rule), which JAX's stripe kernel admits at span 80-192 and gp
// up to 106 where its flash2 admits none; the port runs both contracts on
// the fused lanes layout (ops/axial_attention.py::fused_route). The
// contract is flash2's (csrc/axial_flash2_fwd.cu): per group gi, query row
// i, key j and stripe s (c = gp/2)
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//   p = softmax_j(logit),  sv[p,i] = sum_j p_ij v[p,j],
//   sve[p,i] = sum_j p_ij vemb[p,i,j]
// with the row max m and denominator l saved, in natural units, for the
// backward, which rebuilds p from them.
//
// Why kernels of their own: the narrow flash2 (csrc/tiled_fwd.cuh,
// tiled_bwd.cuh) keeps a query row's 2gp accumulators in registers (240-250
// registers a thread at gp 16) and partial table sums per 128-stripe block
// (g * ceil(S/128) slots of 2gp L^2 floats: 8.6 GB at span 256, gp 128,
// 2048 stripes); the short-span wide forward (csrc/wide_attn.cuh) keeps a
// whole logits row per thread in shared memory (64 keys) and the short-span
// wide backward (csrc/axial_wide_bwd.cu) writes p and dlog to a (g, L, L,
// S) scratch (453 MB at axial50m's 384 px span-96 site at batch 8).
//
// The design. A block has kWarps warps; lane = stripe of a 32-stripe tile
// (a warp's copy of a q, k or v row is 128 contiguous bytes) and each
// thread owns RT query (or key) rows of its stripe, a warp RT rows, the
// block RB = kWarps * RT. Keys (or queries) are walked in tiles of KT; a
// tile's k and v (q, dsv, dsve) rows of the block's 32 stripes and the
// block's rows' entries of the three tables are staged in shared memory by
// cp.async (a bf16 qkv as raw 16-byte copies, converted to float by the
// same thread after the wait) into a ring of three, two or one slots
// (pick_slots: as many as fit the SM's share of each of the blocks the
// launch bounds ask for; the next tiles are in flight while this one is
// computed). Every staged k or v value then feeds the thread's RT rows
// from a register, and a table tile is laid out [row][channel][key] so
// that one 16-byte broadcast gives four keys to every lane. A thread's q
// (k) rows and its dq (dk) sums stay in registers:
//   * the forward (long_fwd_kernel): one sweep over the key tiles, the
//     softmax online (a tile's max, one exp a pair, the accumulators
//     rescaled once a tile); its sv and sve accumulators (RT x 2 x pc)
//     stay in registers: the value planes split into chunks of at most
//     fwd_planes(CM) planes, one a block (grid axis y), each block
//     recomputing its rows' logits, so every sum keeps one order;
//   * the backward's row pass (long_row_kernel): dq, delta, daff and the
//     table gradients. A block owns RB query rows and a fixed slice of the
//     (group, 32-stripe) units (row_slices: enough blocks to fill the card,
//     at most kMaxPartFloats of partials); for each unit it loads the
//     rows' q, dsv, dsve once, walks every key tile, rebuilds p and dlog
//     from m, l and delta, and then sums the tile's table gradient over the
//     unit's 32 stripes from the staged dlog and p and the staged q, k and
//     dsve rows as register-tiled products (KT x 2 elements a thread: four
//     rows of dlog or p against two of q, dsve or k), added to the block's
//     partial slot in device memory (the same thread every time, in unit
//     order), which medt::bwd_finalize then sums over the slots in order;
//   * the backward's column pass (long_col_kernel, its own source): dk and
//     dv, a block RB keys of one group and 32 stripes, walking the query
//     tiles; its v and dv rows in registers where they take at most 64
//     (regs_v), else in the thread's own shared-memory columns.
// The exps are one MUFU.EX2 each (fexp). No (L, L) or (g, L, L, S) array
// is held; every sum has one owner and a fixed order: the same bits on
// every run. Extra memory of the backward beyond its outputs: delta (g,
// L, S), at most L * ceil(S/32) daff slots of 4g floats (slot_capacity)
// and, with positions, row_slices partial slots of 2gp L^2 floats: 2.4 +
// 19.5 MB at (span 96, gp 12, 768 stripes), 2.4 + 38.9 MB at gp 24, 0.3 +
// 26.0 MB at (96, gp 32, 96 stripes) and 16.8 + 268.4 MB at the largest
// geometry (span 256, gp 128, g 8, 2048 stripes: 4 slots, the
// kMaxPartFloats cap).
// Widths: instantiated per register bucket CM of c (8, 16, 32, 64:
// wide::cm_bucket), c at run time, every channel loop stopping at c (or
// gp); and, for the axial classifiers' long-span widths with positions,
// exact instances (exact_c) whose c is a constant, so that
// those loops unroll without a guard. Either sums in the same order, so a
// width gets the same bits whichever instance runs it. The knobs (rows a
// thread, keys a tile, blocks an SM of each kernel) are the constexpr
// functions below. bf16 qkv (wide::Lanes<__nv_bfloat16>) is converted
// where it is staged or read and the backward rounds dqkv once where it
// stores it, so every output equals the float32 kernel's on the upcast
// qkv.
// What bounds them on the H100: at axial50m's span-96 sites (gp 12, 24, S
// = 768 at batch 8) a launch moves about 60 MB and does 5-13 GFLOP of
// float32 work (0.08-0.19 ms at 67 TFLOP/s): the bound is the operations.
// They run at 5-15x that bound: the products read their operands from
// shared memory (one 16-byte broadcast table load feeds 4 keys x RT rows,
// one k or v load RT rows; the table sums 6 loads for 8 products), and at
// 170-255 registers a thread two or three blocks an SM leave little to
// hide the loads' latency (PERF.md, the long-span table).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "wide_attn.cuh"

namespace wide_long {
namespace {

constexpr int kStripes = 32;     // stripes of a tile: lane = stripe
constexpr int kWarps = 4;        // warps of a block
constexpr int kThreads = kStripes * kWarps;
constexpr int kMaxSpan = 256;
// the lane pitch of the rows that the table sums read across (33 floats,
// so that lanes reading one stripe of different rows hit different banks)
constexpr int kPitch = 33;
// the backward's row pass: the blocks it aims for (two an SM) and the most
// floats its table partial slots may take (256 MB) where one slot is less
constexpr int kTargetBlocks = 264;
constexpr long long kMaxPartFloats = 1LL << 26;
// shared memory: an SM's 228 KB, less 1 KB a block; at most kSmemMax a
// block (the opt-in limit)
constexpr int kSmemSM = 228 * 1024;
constexpr int kSmemMax = 227 * 1024;

// rows (queries or keys) a thread: the forward 2 up to register bucket 32,
// the column pass 2 up to bucket 16, else 1; the row pass (by c, not by
// bucket) 2 where a block of them with one ring slot fits two an SM (c <=
// 14), else 1
__host__ __device__ constexpr int fwd_rows(int cm) { return cm <= 32 ? 2 : 1; }
__host__ __device__ constexpr int row_rows(int c) { return c <= 14 ? 2 : 1; }
__host__ __device__ constexpr int col_rows(int cm) { return cm <= 16 ? 2 : 1; }
// keys (queries) of a tile
__host__ __device__ constexpr int fwd_keys(int cm) { return cm <= 16 ? 8 : 4; }
__host__ __device__ constexpr int row_keys(int cm) { return cm <= 32 ? 4 : 2; }
__host__ __device__ constexpr int col_keys(int cm) { return cm <= 32 ? 4 : 2; }
// value planes a forward block accumulates in registers, at most
__host__ __device__ constexpr int fwd_planes(int cm) {
  return cm <= 8 ? 16 : cm <= 16 ? 24 : cm <= 32 ? 16 : 32;
}

// The widths that have exact instances (c a template constant, so that
// every channel and plane loop unrolls without a guard): the axial
// classifiers' long-span widths with positions, gp 12, 24 (axial50m) and
// 32 (axial50l), in the row pass gp 12 alone (above it its unrolled plane
// loops spill); 0 for the other widths, which take their bucket. An exact
// instance sums in the bucket's order: the same bits.
__host__ __device__ constexpr int exact_c(int gp) {
  return gp == 12 || gp == 24 || gp == 32 ? gp / 2 : 0;
}

// blocks an SM that each kernel's launch bounds ask ptxas for (its cap on
// registers a thread: 65536 / (kThreads * blocks))
__host__ __device__ constexpr int fwd_blocks(int cm) {
  return cm <= 16 ? 3 : 2;
}
__host__ __device__ constexpr int row_blocks(int cm) { return 2; }
__host__ __device__ constexpr int col_blocks(int cm) { return 2; }

// e^x as one MUFU.EX2 of x log2(e) (about 2 ulp; the softmax weights
// held against the plain versions at the same tolerances as expf)
__device__ __forceinline__ float fexp(float x) {
  return flash2::ex2(x * flash2::kLog2e);
}

__host__ __device__ constexpr int stripe_tiles(int S) {
  return (S + kStripes - 1) / kStripes;
}

// daff slots a backward may write: one per row-pass row tile and 32
// stripes, at most one a query row and 32 stripes
__host__ __device__ constexpr int slot_capacity(int L, int S) {
  return L * ((S + kStripes - 1) / kStripes);
}

// the row pass's slices of the g * ceil(S/32) (group, stripe-tile) units,
// one table partial slot each: enough for kTargetBlocks blocks, no more
// than the units, no more than kMaxPartFloats floats of slots (at least 1)
__host__ __device__ inline int row_slices(int g, int gp, int L, int S) {
  const int rb = kWarps * row_rows(gp / 2);
  const int units = g * stripe_tiles(S), row_tiles = (L + rb - 1) / rb;
  long long ns = (kTargetBlocks + row_tiles - 1) / row_tiles;
  const long long cap = kMaxPartFloats / (2LL * gp * L * L);
  if (ns > cap) ns = cap;
  if (ns > units) ns = units;
  return ns < 1 ? 1 : (int)ns;
}

inline bool geometry_ok(int g, int gp, int L, int S) {
  return g >= 1 && g <= 65535 && S >= 1 && L >= 1 && L <= kMaxSpan &&
         wide::gp_ok(gp);
}

// floats rounded up to a 16-byte multiple
__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

// n float rows of a (g, rows, L, S) tensor (dsv, dsve; rows = 1: m, l,
// delta) from row r0 of group gi at positions p0 .. p0 + KT, 32 stripes
// from s0, into dst[(u * KT + j) * P + x], zero past L and S; 16-byte
// copies with vec (S % 4 == 0, src 16-byte aligned, P % 4 == 0)
template <int KT>
__device__ __forceinline__ void stage_f32(const float* src, int rows,
                                          float* dst, int gi, int r0, int n,
                                          int p0, int L, int S, int s0, int P,
                                          bool vec, int t, int nt) {
  const size_t base = ((size_t)gi * rows + r0) * L;
  if (vec) {
    for (int e = t; e < n * KT * 8; e += nt) {
      const int x = (e & 7) * 4, uj = e >> 3, j = uj % KT, u = uj / KT;
      const bool ok = p0 + j < L && s0 + x < S;
      const float* from = src + (base + (size_t)u * L + p0 + j) * S + s0 + x;
      flash2::cp_async16(dst + (u * KT + j) * P + x, ok ? from : src, ok);
    }
    return;
  }
  for (int e = t; e < n * KT * kStripes; e += nt) {
    const int x = e & 31, uj = e >> 5, j = uj % KT, u = uj / KT;
    const bool ok = p0 + j < L && s0 + x < S;
    const float* from = src + (base + (size_t)u * L + p0 + j) * S + s0 + x;
    flash2::cp_async4(dst + (u * KT + j) * P + x, ok ? from : src, ok);
  }
}

// bf16 qkv rows by cp.async: rows r0 .. r0 + n of group gi at positions
// p0 .. p0 + KT and the 32 stripes from s0, raw, 8 values a 16-byte copy
// (S % 8 == 0 and qkv 16-byte aligned: a copy is all valid or all past the
// edge, zero-filled), into raw[(u * KT + j) * 32 + x]; after the ring's
// wait the same thread's convert_raw writes its copies as floats to
// dst[(u * KT + j) * P + x] (exact).
template <int KT>
__device__ __forceinline__ void stage_raw(
    const wide::Lanes<__nv_bfloat16>& x, __nv_bfloat16* raw, int gi, int r0,
    int n, int p0, int s0, int t, int nt) {
  const __nv_bfloat16* src =
      x.qkv + (((size_t)gi * 2 * x.gp + r0) * x.L + p0) * x.S + s0;
  for (int e = t; e < n * KT * 4; e += nt) {
    const int xo = (e & 3) * 8, uj = e >> 2, j = uj % KT, u = uj / KT;
    const bool ok = p0 + j < x.L && s0 + xo < x.S;
    flash2::cp_async16(raw + uj * kStripes + xo,
                       ok ? src + ((size_t)u * x.L + j) * x.S + xo : x.qkv,
                       ok);
  }
}

template <int KT>
__device__ __forceinline__ void convert_raw(const __nv_bfloat16* raw,
                                            float* dst, int n, int P, int t,
                                            int nt) {
  for (int e = t; e < n * KT * 4; e += nt) {
    const int xo = (e & 3) * 8, uj = e >> 2;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + uj * kStripes + xo);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    float* to = dst + uj * P + xo;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      to[2 * k] = f.x;
      to[2 * k + 1] = f.y;
    }
  }
}

// Rows of qkv into a ring slot, as wide::Lanes::stage with np = KT and
// ts = 32 (pitch P); a bf16 qkv with vec goes by stage_raw into raw (P
// floats a row), to be converted after the wait (convert_rows)
template <int KT, class T>
__device__ __forceinline__ void stage_rows(const wide::Lanes<T>& x,
                                           float* dst, float* raw, int gi,
                                           int r0, int n, int p0, int s0,
                                           int P, bool vec, int t, int nt) {
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      stage_raw<KT>(x, reinterpret_cast<__nv_bfloat16*>(raw), gi, r0, n, p0,
                    s0, t, nt);
      return;
    }
  }
  x.stage(dst, gi, r0, n, n, p0, KT, s0, kStripes, P,
          vec && P % 4 == 0, t, nt);
}

template <int KT, class T>
__device__ __forceinline__ void convert_rows(float* dst, const float* raw,
                                             int n, int P, bool vec, int t,
                                             int nt) {
  if constexpr (sizeof(T) == 2) {
    if (vec) {
      convert_raw<KT>(reinterpret_cast<const __nv_bfloat16*>(raw), dst, n, P,
                      t, nt);
    }
  }
}

// floats of a slot's raw bf16 area for n rows of KT x 32 values (none for
// float qkv or without vec, where bf16 goes by converting loads)
template <class T>
__host__ __device__ constexpr int raw_floats(int n, int kt, bool vec) {
  return sizeof(T) == 2 && vec ? n * kt * kStripes / 2 : 0;
}

// The tables' entries of nr rows from rb (the block's query rows, or with
// col its key rows) and the KT positions from p0 (keys, or queries with
// col), channels [0, c) qemb, [c, 2c) kemb_t, [2c, 2c + npv) vemb planes
// from pv0: dst[(r * nch + ch) * KT + u] = table_ch(i, j), (i, j) = (rb +
// r, p0 + u) or with col (p0 + u, rb + r); zero past L. Each thread walks
// the (r, ch) rows by a fixed step, so no index is divided.
template <int KT, class T>
__device__ __forceinline__ void stage_tables(const wide::Lanes<T>& x,
                                             float* dst, int rb, int nr,
                                             int pv0, int npv, int p0,
                                             bool col, int t, int nt) {
  const int L = x.L, C = x.gp / 2, nch = 2 * C + npv, step = nt / KT;
  const size_t LL = (size_t)L * L;
  const int u = t % KT;
  int ch = t / KT, r = 0;
  while (ch >= nch) {
    ch -= nch;
    ++r;
  }
  while (r < nr) {
    const int i = col ? p0 + u : rb + r, j = col ? rb + r : p0 + u;
    const bool ok = i < L && j < L;
    const float* tab = ch < C ? x.qemb + ch * LL
                       : ch < 2 * C ? x.kemb_t + (ch - C) * LL
                                    : x.vemb + (pv0 + ch - 2 * C) * LL;
    flash2::cp_async4(dst + (r * nch + ch) * KT + u,
                      ok ? tab + (size_t)i * L + j : x.qemb, ok);
    ch += step;
    while (ch >= nch) {
      ch -= nch;
      ++r;
    }
  }
}

// KT entries of a staged table row as registers (16-byte loads)
template <int KT>
__device__ __forceinline__ void load_row(const float* p, float (&v)[KT]) {
#pragma unroll
  for (int u = 0; u < KT; u += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + u);
    v[u] = f.x;
    v[u + 1] = f.y;
    v[u + 2] = f.z;
    v[u + 3] = f.w;
  }
}
template <>
__device__ __forceinline__ void load_row<2>(const float* p, float (&v)[2]) {
  const float2 f = *reinterpret_cast<const float2*>(p);
  v[0] = f.x;
  v[1] = f.y;
}

// The ring's wait for its oldest tile: `later` tiles' copies (committed
// after it) may stay in flight
__device__ __forceinline__ void ring_wait(int later) {
  if (later >= 2) {
    flash2::cp_async_wait<2>();
  } else if (later == 1) {
    flash2::cp_async_wait<1>();
  } else {
    flash2::cp_async_wait<0>();
  }
}

// The ring: tiles issued ahead of the one computed (nslot - 1, at most
// those left), so that the loop issues tile k + ahead before it waits for
// tile k
__device__ __forceinline__ int ring_later(int nslot, int k, int total) {
  return nslot > 1 ? min(nslot - 1, total - 1 - k) : 0;
}

// ring slots (3, 2 or 1) whose shared memory (fixed + slot floats each)
// fits: three or two within an SM's share for `blocks` blocks, else one
// within kSmemMax; 0 when none fits
inline int pick_slots(long long fixed, long long slot, int blocks) {
  const long long share = kSmemSM / blocks - 1024;
  for (int n = 3; n >= 2; --n) {
    if ((fixed + n * slot) * (long long)sizeof(float) <= share) return n;
  }
  if ((fixed + slot) * (long long)sizeof(float) <= kSmemMax) return 1;
  return 0;
}

}  // namespace

// The backward's column pass (csrc/axial_wide_long_col.cu): dk and dv rows
// of dqkv from the row pass's delta; launches on `stream` and returns the
// launch's CUDA error.
cudaError_t long_col(const float* qkv, const float* qemb, const float* kemb_t,
                     const float* vemb, const float* aff, const float* m,
                     const float* l, const float* dsv, const float* dsve,
                     const float* delta, float* dqkv, int g, int gp, int L,
                     int S, bool pos, cudaStream_t stream);
cudaError_t long_col(const __nv_bfloat16* qkv, const float* qemb,
                     const float* kemb_t, const float* vemb, const float* aff,
                     const float* m, const float* l, const float* dsv,
                     const float* dsve, const float* delta,
                     __nv_bfloat16* dqkv, int g, int gp, int L, int S,
                     bool pos, cudaStream_t stream);

}  // namespace wide_long
