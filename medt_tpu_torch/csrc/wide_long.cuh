// The long-span attention at wide group planes (spans 65 to 256, every even
// gp up to 128 outside the narrow designs' 2, 4, 8 and 16), for Hopper
// (sm_90a): what the forward (csrc/axial_wide_long_fwd.cu) and the
// backward (csrc/axial_wide_long_bwd.cu) share.
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
// The design: a block owns one group, 32 stripes (lane = stripe, so a
// warp's copy of a q, k or v row is 128 contiguous bytes) and R query (or
// key) rows, one a thread (R = 8, 4, 2 or 1: the most whose shared memory
// fits kSmemBudget, pick_rows); it walks the keys (queries) in tiles of KT
// (8 at register bucket 8, else 4: key_tile), each tile's k, v (q, dsv, dsve) rows and
// the block's rows of the three tables staged in shared memory once and
// read there by every row of the block; a thread's q (k) row and its dq
// (dk) sums stay in registers, its 2gp value accumulators (or dsv, dsve
// rows) in shared memory ([channel][thread], conflict-free). No (L, L) or
// (g, L, L, S) array is held:
//   * the forward: one sweep, the softmax online (a tile's max, one exp a
//     pair, the accumulators rescaled once a tile);
//   * the backward: a row pass (dq, delta = sum dsv sv + dsve sve, the
//     daff sums one slot a block), a column pass (dk, dv) and, with
//     positions, a table pass, each rebuilding p and dlog from m, l and
//     delta; in the table pass a block owns one query row and kTabKeys
//     keys over every group and stripe, so each table gradient element is
//     summed by one thread in a fixed order: no partial slots, no atomics;
//     medt::bwd_finalize then sums the daff slots.
// Extra memory of the backward beyond its outputs: delta (g, L, S) and at
// most L * ceil(S/32) daff slots of 4g floats (slot_capacity); at the
// largest geometry (span 256, gp 128, g 8, 2048 stripes) 18.9 MB.
// Widths: instantiated per register bucket CM of c (8, 16, 32, 64:
// wide::cm_bucket), c at run time; every channel loop stops at c (or gp),
// so a width sums in the same order whichever bucket runs it. bf16 qkv
// (wide::Lanes<__nv_bfloat16>) is converted where it is staged and the
// backward rounds dqkv once where it stores it, so every output equals the
// float32 kernel's on the upcast qkv.
// What bounds them on the H100: at axial50m's span-96 sites (gp 12, 24, S
// = 768 at batch 8) a launch moves about 60 MB and does 5-10 GFLOP of
// float32 work; every pair's products read one operand from shared memory
// (about one load a multiply-add), so they are bound by shared-memory
// loads and latency: a simple design that is right first.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "wide_attn.cuh"

namespace wide_long {
namespace {

constexpr int kStripes = 32;     // threads of a block along the stripes
constexpr int kMaxRows = 8;      // query (or key) rows of a block, at most
constexpr int kMaxSpan = 256;
constexpr int kTabKeys = 8;      // keys of a table-pass block
constexpr int kTabMaxWarps = 4;  // warps of a table-pass block, at most
// shared memory of a block: the budget that keeps two blocks an SM, and
// what one block may take where nothing fits the budget
constexpr int kSmemBudget = 112 * 1024;
constexpr int kSmemMax = 220 * 1024;

// blocks of 256 threads an SM the backward passes ask ptxas for: two (at
// most 128 registers a thread) up to register bucket 16, one above
__host__ __device__ constexpr int min_blocks(int cm) { return cm <= 16 ? 2 : 1; }

// keys (or queries) of a tile by register bucket of c: 8 at bucket 8, 4
// above, where a tile of 8 halved the blocks an SM holds
__host__ __device__ constexpr int key_tile(int cm) { return cm <= 8 ? 8 : 4; }

// R = 8, 4, 2 or 1: the most rows whose shared memory (floats(R) floats)
// fits kSmemBudget, else kSmemMax; 0 when none does
template <class F>
int pick_rows(F floats) {
  const long long lims[2] = {kSmemBudget, kSmemMax};
  for (int k = 0; k < 2; ++k) {
    for (int r = kMaxRows; r >= 1; r /= 2) {
      if ((long long)floats(r) * (long long)sizeof(float) <= lims[k]) {
        return r;
      }
    }
  }
  return 0;
}

// daff slots a backward may write: one per row-pass block, at most one a
// query row and 32 stripes (its rows a block depend on gp)
__host__ __device__ constexpr int slot_capacity(int L, int S) {
  return L * ((S + kStripes - 1) / kStripes);
}

inline bool geometry_ok(int g, int gp, int L, int S) {
  return g >= 1 && g <= 65535 && S >= 1 && L >= 1 && L <= kMaxSpan &&
         wide::gp_ok(gp);
}

// n rows of qkv from row r0 of group gi at positions p0 .. p0 + KT (zero
// past np or the last stripe), 32 stripes from s0, into dst[(row * KT +
// u) * 32 + lane], by the block's nt threads
template <int KT, class T>
__device__ __forceinline__ void stage_qkv(const wide::Lanes<T>& x, float* dst,
                                          int gi, int r0, int n, int p0,
                                          int np, int s0, int t, int nt) {
  const int total = n * KT * kStripes;
  for (int e = t; e < total; e += nt) {
    const int ln = e % kStripes, u = (e / kStripes) % KT;
    const int row = e / (kStripes * KT), s = s0 + ln;
    dst[e] = (u < np && s < x.S) ? x.row(gi, r0 + row, p0 + u, s) : 0.f;
  }
}

// the same from a float (g, n, L, S) tensor (dsv, dsve) or, with n = 1, a
// (g, L, S) one (m, l, delta); inv stores 1 / value
template <int KT>
__device__ __forceinline__ void stage_f32(const float* src, float* dst,
                                          int gi, int n, int L, int S,
                                          int p0, int np, int s0, int t,
                                          int nt, bool inv = false) {
  const int total = n * KT * kStripes;
  const size_t LS = (size_t)L * S;
  for (int e = t; e < total; e += nt) {
    const int ln = e % kStripes, u = (e / kStripes) % KT;
    const int row = e / (kStripes * KT), s = s0 + ln;
    float v = 0.f;
    if (u < np && s < S) {
      v = __ldg(src + ((size_t)gi * n + row) * LS + (size_t)(p0 + u) * S + s);
      if (inv) v = 1.f / v;
    }
    dst[e] = v;
  }
}

// table entry (ch, i, j) of the 2c + gp rows qemb, kemb_t, vemb
template <class T>
__device__ __forceinline__ float table_at(const wide::Lanes<T>& x, int ch,
                                          int i, int j) {
  const int C = x.gp / 2, L = x.L;
  const float* tab = ch < C ? x.qemb + (size_t)ch * L * L
                     : ch < 2 * C ? x.kemb_t + (size_t)(ch - C) * L * L
                                  : x.vemb + (size_t)(ch - 2 * C) * L * L;
  return __ldg(tab + (size_t)i * L + j);
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
