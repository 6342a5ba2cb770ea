// The tiled backward of the flash contract, shared by the flash (spans up
// to 64, csrc/axial_flash_bwd.cu) and flash2 (spans up to 256,
// csrc/axial_flash2_bwd.cu) entry points, each with its own tile policy.
//
// The forward (per group gi, query i, key j, stripe s; c = gp/2):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   sv[p,i] = sum_j p_ij v[p,j],  sve[p,i] = sum_j p_ij vemb[p,i,j]
// saves its row max m and denominator l, from which p is rebuilt. Given
// dsv, dsve (g, gp, L, S), with
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   delta_i = sum_p dsv[p,i] sv[p,i] + dsve[p,i] sve[p,i]   (saved sv, sve)
//   dlog_ij = p_ij (dsim_ij - delta_i)
// it writes the fused dqkv (g, 2gp, L, S):
//   dq[c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])
//   dv[p,j] = sum_i p_ij dsv[p,i]
// the table gradients (2gp, L, L), summed over every group and stripe,
//   dqemb[c,i,j] = a2 sum dlog_ij q[c,i],  dkemb_t[c,i,j] = a4 sum dlog_ij k[c,j]
//   dvemb[p,i,j] = sum p_ij dsve[p,i]
// and daff (g, 8) = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog,
//                    sum dlog*kr, sum dlog, 0, 0] (rows 2..5 zero w/o pos).
//
// Blocks run in parallel and in no order, so the sums over queries and over
// stripes are taken without atomics, in a fixed order, by two passes and a
// last launch that sums the per-block partials in index order
// (medt::bwd_finalize, csrc/reduce.cuh): three launches per call.
//   * row pass (dq, delta, the table and daff partials): a block owns one
//     group, QB query rows and a chunk of kRowStripes = 128 stripes, one
//     warp per query row (two or four at gp 8, 16); a lane holds SS = 4
//     (gp <= 4) adjacent stripes of its row. Per key block it stages k and v
//     for the chunk and the table tile by cp.async, in a ring of kStages
//     slots (csrc/flash2_tiles.cuh). A thread first sums its table-gradient
//     terms over its own SS stripes in registers; a warp then
//     reduce-scatters JS keys x 2gp rows = 32 values over its 32 lanes (31
//     shuffles per lane, each lane ends with one of the sums) instead of a
//     warp_sum per value; the warps of a row are summed in a fixed order in
//     shared memory, and the block writes its slot of the table partials
//     once per key block. The table partials are (g * ceil(S/128), 2gp, L,
//     L) floats. The row pass also writes delta and the row's log2
//     normaliser mm = (m - a1 - a3 - a5) log2(e) + log2(l) for the column
//     pass (the scratch is (2, g, L, S));
//   * column pass (dk, dv): a block owns one group, KT keys and 32 stripes
//     (lane = stripe); a thread holds KJ keys of its stripe. Per block of QB
//     queries it stages the per-(query, stripe) operands q, dsv, dsve,
//     delta, mm and the table column tile, so every staged value serves KJ
//     keys (or, for a table value, the warp's 32 stripes);
//   * p = exp2(a0' qk + a2' qr + a4' kr - mm), the affines carrying log2(e),
//     so each pair costs FMAs and one exp2;
//   * no tensor cores: the contraction depth is c = 1..8, and the deep sums
//     (over L keys, and the table gradients over g * S stripes) would fail
//     the float32 tolerances in TF32.
//
// qkv and dqkv are float32 or bf16 (the element type T of the template):
// the k/v and q rows are staged raw and converted where they are read, and
// each dqkv value is rounded once where it is stored (from_f32), so a bf16
// qkv gives the float32 kernel's table and daff gradients on the upcast
// qkv, bit for bit, and its dqkv rounded once. Everything else is float32.
//
// A tile policy TL gives: kMaxSpan; kRowWarps (warps per row-pass block);
// row_keys(gp) (keys per staged row-pass block); kColWarps (warps per
// column-pass block); col_keys(gp) (keys per column-pass thread);
// col_queries(gp) (queries per staged column-pass block); kRowQueries (by
// log2 gp), the query rows per row-pass block that follow from kRowWarps,
// QB = kRowWarps / (warps per row), stated for the wrapper, which mirrors
// them to size the daff partials, ceil(L / QB) * ceil(S / 128).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash2_tiles.cuh"
#include "reduce.cuh"

namespace flash2 {
namespace {

using medt::warp_sum;

// stripes per row-pass block, and so per slot of the table partials
constexpr int kRowStripes = 128;
constexpr int kColStripes = 32;  // one per lane

template <class TL, int GP>
struct RowCfg {
  static constexpr int C = GP / 2;
  static constexpr int R = 2 * GP;  // table rows: qemb c, kemb_t c, vemb gp
  static constexpr int kWarps = TL::kRowWarps;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int SS = GP <= 4 ? 4 : GP == 8 ? 2 : 1;  // stripes/lane
  static constexpr int WPQ = kRowStripes / (32 * SS);     // warps per row
  static constexpr int QB = kWarps / WPQ;                 // rows per block
  static constexpr int JS = 32 / R;  // keys per reduce-scatter of 32 values
  static constexpr int KB = TL::row_keys(GP);             // keys per stage
  static constexpr int KV = (C + GP) * KB * kRowStripes;
  static constexpr int TAB = R * QB * KB;
  static constexpr int TBUF = kWarps * KB * R;
  static_assert(QB >= 1 && QB * WPQ == kWarps, "whole rows per block");
  static_assert(QB == TL::kRowQueries[GP == 2 ? 1 : GP == 4 ? 2 : GP == 8 ? 3
                                                                        : 4],
                "mirrored row tile");
  static_assert(KB % JS == 0 && JS * R == 32, "whole reduce-scatters");
};

// One row-pass slot, in bytes: the k/v rows (KV elements of T), then with
// positions the table tile (TAB floats).
template <class TL, int GP, bool POS, class T>
__host__ __device__ constexpr int row_stage_bytes() {
  return RowCfg<TL, GP>::KV * (int)sizeof(T) +
         (POS ? RowCfg<TL, GP>::TAB * (int)sizeof(float) : 0);
}

template <class TL, int GP, bool POS, class T>
constexpr size_t row_smem_bytes() {
  using K = RowCfg<TL, GP>;
  return (size_t)kStages * row_stage_bytes<TL, GP, POS, T>() +
         ((POS ? K::TBUF : 0) + K::kWarps * 4) * sizeof(float);
}

template <class TL, int GP, bool POS>
struct ColCfg {
  static constexpr int C = GP / 2;
  static constexpr int R = 2 * GP;
  static constexpr int kWarps = TL::kColWarps;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int KJ = TL::col_keys(GP);  // keys/thread
  static constexpr int KG = KJ < 4 ? KJ : 4;   // keys per table read
  static constexpr int KT = kWarps * KJ;       // keys per block
  static constexpr int QB = TL::col_queries(GP);  // queries per stage
  // staged per-(query, stripe) operand rows: q (c), dsv (gp), [dsve (gp)],
  // delta, mm
  static constexpr int OG = C, OE = C + GP, OD = C + GP + (POS ? GP : 0);
  static constexpr int OM = OD + 1, ROWS = OM + 1;
  static constexpr int OPS = ROWS * QB * kColStripes;
  static constexpr int TAB = POS ? R * QB * KT : 0;
  static constexpr int STAGE = OPS + TAB;
  static_assert(KJ % KG == 0 && KT % 4 == 0, "whole table reads");
};

template <class T>
struct BwdArgs {
  const T* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  const float* aff;
  const float* m;     // the forward's saved row max (g, L, S)
  const float* l;     // and softmax denominator
  const float* sv;    // the forward's saved outputs (g, gp, L, S)
  const float* sve;
  const float* dsv;
  const float* dsve;
  float* scratch;     // (2, g, L, S): delta, then mm; written by the row pass
  T* dqkv;
  float* tab_part;    // (g * ceil(S/128), 2gp, L, L) with positions
  float* aff_part;    // (ceil(L/QB) * ceil(S/128), g, 4)
  int g, L, S;
  bool vec_s, vec_l;
};

// Sum over the warp's lanes of v[lane], left in lane `lane`: five halving
// exchanges (16 + 8 + 4 + 2 + 1 shuffles), in a fixed order.
template <int N>
__device__ __forceinline__ void rs_step(float (&v)[32], int lane) {
  constexpr int H = N / 2;
  const bool up = (lane & H) != 0;
#pragma unroll
  for (int k = 0; k < H; ++k) {
    const float send = up ? v[k] : v[k + H];
    const float keep = up ? v[k + H] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, H);
  }
}

__device__ __forceinline__ float reduce_scatter32(float (&v)[32], int lane) {
  rs_step<32>(v, lane);
  rs_step<16>(v, lane);
  rs_step<8>(v, lane);
  rs_step<4>(v, lane);
  rs_step<2>(v, lane);
  return v[0];
}

// One staged key block of the row pass for the thread's SS stripes of row ql.
template <class TL, int GP, bool POS, bool CHECK, class E>
__device__ __forceinline__ void row_block(
    const E* kv, const float* tab, float* tb, int ql, int so, int lane,
    int nvalid, float a0s, float a2s, float a4s,
    const float (&q)[RowCfg<TL, GP>::SS][GP / 2],
    const float (&gv)[RowCfg<TL, GP>::SS][GP],
    const float (&ge)[RowCfg<TL, GP>::SS][GP],
    const float (&mm)[RowCfg<TL, GP>::SS],
    const float (&dl)[RowCfg<TL, GP>::SS],
    float (&A)[RowCfg<TL, GP>::SS][GP / 2],
    float (&B)[RowCfg<TL, GP>::SS][GP / 2], float& s_kr, float& s_b) {
  using K = RowCfg<TL, GP>;
  constexpr int C = K::C, R = K::R, SS = K::SS, QB = K::QB, JS = K::JS,
                KB = K::KB;
#pragma unroll 1
  for (int jb = 0; jb < KB; jb += JS) {
    if (CHECK && jb >= nvalid) break;
    float T[32];
    float qe[C][JS], ke[C][JS], ve[GP][JS];
    if constexpr (POS) {
#pragma unroll
      for (int t = 0; t < 32; ++t) T[t] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        lds<JS>(qe[c], tab + (c * QB + ql) * KB + jb);
        lds<JS>(ke[c], tab + ((C + c) * QB + ql) * KB + jb);
      }
#pragma unroll
      for (int p = 0; p < GP; ++p)
        lds<JS>(ve[p], tab + ((2 * C + p) * QB + ql) * KB + jb);
    }
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
      const bool valid = !CHECK || jb + jj < nvalid;
      float kk[C][SS], vv[GP][SS];
#pragma unroll
      for (int c = 0; c < C; ++c)
        lds<SS>(kk[c], kv + (c * KB + jb + jj) * kRowStripes + so);
#pragma unroll
      for (int p = 0; p < GP; ++p)
        lds<SS>(vv[p], kv + ((C + p) * KB + jb + jj) * kRowStripes + so);
#pragma unroll
      for (int u = 0; u < SS; ++u) {
        float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qk = fmaf(q[u][c], kk[c][u], qk);
          if constexpr (POS) {
            qr = fmaf(q[u][c], qe[c][jj], qr);
            kr = fmaf(kk[c][u], ke[c][jj], kr);
          }
        }
        float x = fmaf(a0s, qk, -mm[u]);
        if constexpr (POS) x = fmaf(a4s, kr, fmaf(a2s, qr, x));
        float pr = ex2(x);
        if (CHECK && !valid) pr = 0.f;
        float dsim = -dl[u];
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          dsim = fmaf(gv[u][p], vv[p][u], dsim);
          if constexpr (POS) dsim = fmaf(ge[u][p], ve[p][jj], dsim);
        }
        const float dlog = pr * dsim;
        s_b += dlog;
#pragma unroll
        for (int c = 0; c < C; ++c) A[u][c] = fmaf(dlog, kk[c][u], A[u][c]);
        if constexpr (POS) {
          s_kr = fmaf(dlog, kr, s_kr);
#pragma unroll
          for (int c = 0; c < C; ++c) {
            B[u][c] = fmaf(dlog, qe[c][jj], B[u][c]);
            T[jj * R + c] = fmaf(dlog, q[u][c], T[jj * R + c]);
            T[jj * R + C + c] = fmaf(dlog, kk[c][u], T[jj * R + C + c]);
          }
#pragma unroll
          for (int p = 0; p < GP; ++p)
            T[jj * R + 2 * C + p] = fmaf(pr, ge[u][p], T[jj * R + 2 * C + p]);
        }
      }
    }
    // lane t now holds, for value t = (key jb + t / R, table row t % R),
    // the sum over the warp's 32 * SS stripes
    if constexpr (POS) tb[jb * R + lane] = reduce_scatter32(T, lane);
  }
}

template <class TL, int GP, bool POS, class T>
__global__ void __launch_bounds__(RowCfg<TL, GP>::kThreads)
tiled_bwd_row_kernel(BwdArgs<T> a) {
  using K = RowCfg<TL, GP>;
  constexpr int C = K::C, R = K::R, SS = K::SS, WPQ = K::WPQ, QB = K::QB,
                KB = K::KB, NW = K::kWarps, NT = K::kThreads;
  constexpr int STAGE = row_stage_bytes<TL, GP, POS, T>();
  extern __shared__ __align__(16) float smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);
  // [warp][KB][R]
  float* tbuf = reinterpret_cast<float*>(ring + kStages * STAGE);
  float* wsum = tbuf + (POS ? K::TBUF : 0);       // [warp][4]

  const int L = a.L, S = a.S;
  const int i0 = blockIdx.x * QB, s0 = blockIdx.y * kRowStripes;
  const int gi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ql = warp / WPQ;
  const int so = (warp % WPQ) * 32 * SS + lane * SS;  // stripe in the chunk
  const int i = i0 + ql;
  const size_t LS = (size_t)L * S, LL = (size_t)L * L;
  const T* qkv = a.qkv + (size_t)gi * 2 * GP * LS;
  const int nkb = (L + KB - 1) / KB;

  auto load = [&](int kb) {
    unsigned char* st = ring + (kb % kStages) * STAGE;
    const int j0 = kb * KB;
    stage<C + GP, KB, kRowStripes, NT>(
        reinterpret_cast<T*>(st), qkv + C * LS + (size_t)j0 * S + s0, LS, S,
        L - j0, S - s0, a.vec_s, threadIdx.x);
    if constexpr (POS) {
      const size_t off = (size_t)i0 * L + j0;
      float* t = reinterpret_cast<float*>(st + K::KV * sizeof(T));
      stage<C, QB, KB, NT>(t, a.qemb + off, LL, L, L - i0, L - j0, a.vec_l,
                           threadIdx.x);
      stage<C, QB, KB, NT>(t + C * QB * KB, a.kemb_t + off, LL, L, L - i0,
                           L - j0, a.vec_l, threadIdx.x);
      stage<GP, QB, KB, NT>(t + 2 * C * QB * KB, a.vemb + off, LL, L, L - i0,
                            L - j0, a.vec_l, threadIdx.x);
    }
  };
#pragma unroll
  for (int kb = 0; kb < kStages - 1; ++kb) {
    if (kb < nkb) load(kb);
    cp_async_commit();
  }

  const float* af = a.aff + gi * 8;
  const float a0 = af[0], a2 = af[2], a4 = af[4];
  const float a0s = a0 * kLog2e, a2s = a2 * kLog2e, a4s = a4 * kLog2e;
  const float bias = POS ? (af[1] + af[3]) + af[5] : af[1];

  // Per (row i, stripe): a stripe past the edge (or a row past the span)
  // has zero q and upstream gradient, so every sum it joins gets 0 from it.
  float q[SS][C], gv[SS][GP], ge[SS][GP], mm[SS], dl[SS], A[SS][C], B[SS][C];
#pragma unroll
  for (int u = 0; u < SS; ++u) {
    const int s = s0 + so + u;
    const bool ok = i < L && s < S;
    const size_t io = (size_t)gi * GP * LS + (size_t)i * S + s;
    const size_t row = ((size_t)gi * L + i) * S + s;
    float delta = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      q[u][c] = ok ? to_f32(qkv[c * LS + (size_t)i * S + s]) : 0.f;
      A[u][c] = 0.f;
      B[u][c] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      gv[u][p] = ok ? a.dsv[io + p * LS] : 0.f;
      ge[u][p] = (POS && ok) ? a.dsve[io + p * LS] : 0.f;
      if (ok) {
        delta += gv[u][p] * a.sv[io + p * LS];
        if constexpr (POS) delta += ge[u][p] * a.sve[io + p * LS];
      }
    }
    dl[u] = delta;
    mm[u] = ok ? (a.m[row] - bias) * kLog2e + log2f(a.l[row]) : 0.f;
    if (ok) {
      a.scratch[row] = delta;
      a.scratch[(size_t)a.g * LS + row] = mm[u];
    }
  }

  float s_kr = 0.f, s_b = 0.f;
  float* part = a.tab_part +
                ((size_t)gi * gridDim.y + blockIdx.y) * R * LL;
  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kb + kStages - 1 < nkb) load(kb + kStages - 1);
    cp_async_commit();
    const unsigned char* st = ring + (kb % kStages) * STAGE;
    const T* kv = reinterpret_cast<const T*>(st);
    const float* tab =
        reinterpret_cast<const float*>(st + K::KV * sizeof(T));
    float* tb = tbuf + warp * KB * R;
    const int nvalid = L - kb * KB;
    if (nvalid >= KB) {
      row_block<TL, GP, POS, false>(kv, tab, tb, ql, so, lane, nvalid, a0s,
                                    a2s, a4s, q, gv, ge, mm, dl, A, B, s_kr,
                                    s_b);
    } else {
      row_block<TL, GP, POS, true>(kv, tab, tb, ql, so, lane, nvalid, a0s,
                                   a2s, a4s, q, gv, ge, mm, dl, A, B, s_kr,
                                   s_b);
    }
    if constexpr (POS) {
      // the block's slot of the table partials for this key block: the
      // warps of each row summed in order, rows of KB keys coalesced
      __syncthreads();
      const int j0 = kb * KB;
#pragma unroll 1
      for (int e = threadIdx.x; e < QB * R * KB; e += NT) {
        const int jj = e % KB, r = (e / KB) % R, qq = e / (KB * R);
        if (i0 + qq >= L || j0 + jj >= L) continue;
        float v = 0.f;
#pragma unroll
        for (int w = 0; w < WPQ; ++w)
          v += tbuf[((qq * WPQ + w) * KB + jj) * R + r];
        const float scale = r < C ? a2 : r < 2 * C ? a4 : 1.f;
        part[((size_t)r * L + i0 + qq) * L + j0 + jj] = v * scale;
      }
    }
  }

  float s_qk = 0.f, s_qr = 0.f;
#pragma unroll
  for (int u = 0; u < SS; ++u) {
    const int s = s0 + so + u;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      s_qk = fmaf(q[u][c], A[u][c], s_qk);
      s_qr = fmaf(q[u][c], B[u][c], s_qr);
    }
    if (i < L && s < S) {
      const size_t dq0 = (size_t)gi * 2 * GP * LS + (size_t)i * S + s;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float d = POS ? fmaf(a2, B[u][c], a0 * A[u][c]) : a0 * A[u][c];
        a.dqkv[dq0 + c * LS] = from_f32<T>(d);
      }
    }
  }
  const float sums[4] = {s_qk, s_b, s_qr, s_kr};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) wsum[warp * 4 + k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float v = 0.f;
    for (int w = 0; w < NW; ++w) v += wsum[w * 4 + threadIdx.x];
    a.aff_part[(((size_t)blockIdx.x * gridDim.y + blockIdx.y) * a.g + gi) *
                   4 +
               threadIdx.x] = v;
  }
}

// One staged query block of the column pass for the thread's KJ keys; the
// q rows at the start of ops are staged as T.
template <class TL, int GP, bool POS, class T>
__device__ __forceinline__ void col_block(
    const float* ops, const float* tab, int kt0, int lane, float a0,
    float a4, float a0s, float a2s, float a4s,
    const float (&k)[ColCfg<TL, GP, POS>::KJ][GP / 2],
    const float (&v)[ColCfg<TL, GP, POS>::KJ][GP],
    float (&dk)[ColCfg<TL, GP, POS>::KJ][GP / 2],
    float (&dv)[ColCfg<TL, GP, POS>::KJ][GP]) {
  using K = ColCfg<TL, GP, POS>;
  constexpr int C = K::C, KJ = K::KJ, KG = K::KG, KT = K::KT, QB = K::QB;
  constexpr int RS = QB * kColStripes;  // operand row stride
#pragma unroll 1
  for (int ii = 0; ii < QB; ++ii) {
    const float* o = ops + ii * kColStripes + lane;
    const T* oq = reinterpret_cast<const T*>(ops) + ii * kColStripes + lane;
    float q[C], aq[C], gv[GP], ge[GP];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      q[c] = to_f32(oq[c * RS]);
      aq[c] = a0 * q[c];
    }
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      gv[p] = o[(K::OG + p) * RS];
      if constexpr (POS) ge[p] = o[(K::OE + p) * RS];
    }
    const float dl = o[K::OD * RS], mmv = o[K::OM * RS];
#pragma unroll
    for (int kg = 0; kg < KJ; kg += KG) {
      float qe[C][KG], ke[C][KG], ve[GP][KG];
      if constexpr (POS) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          lds<KG>(qe[c], tab + (c * QB + ii) * KT + kt0 + kg);
          lds<KG>(ke[c], tab + ((C + c) * QB + ii) * KT + kt0 + kg);
        }
#pragma unroll
        for (int p = 0; p < GP; ++p)
          lds<KG>(ve[p], tab + ((2 * C + p) * QB + ii) * KT + kt0 + kg);
      }
#pragma unroll
      for (int jj = 0; jj < KG; ++jj) {
        const int kk = kg + jj;
        float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          qk = fmaf(q[c], k[kk][c], qk);
          if constexpr (POS) {
            qr = fmaf(q[c], qe[c][jj], qr);
            kr = fmaf(k[kk][c], ke[c][jj], kr);
          }
        }
        float x = fmaf(a0s, qk, -mmv);
        if constexpr (POS) x = fmaf(a4s, kr, fmaf(a2s, qr, x));
        const float pr = ex2(x);
        float dsim = -dl;
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          dsim = fmaf(gv[p], v[kk][p], dsim);
          if constexpr (POS) dsim = fmaf(ge[p], ve[p][jj], dsim);
        }
        const float dlog = pr * dsim;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float w = POS ? fmaf(a4, ke[c][jj], aq[c]) : aq[c];
          dk[kk][c] = fmaf(dlog, w, dk[kk][c]);
        }
#pragma unroll
        for (int p = 0; p < GP; ++p) dv[kk][p] = fmaf(pr, gv[p], dv[kk][p]);
      }
    }
  }
}

template <class TL, int GP, bool POS, class T>
__global__ void __launch_bounds__(ColCfg<TL, GP, POS>::kThreads)
tiled_bwd_col_kernel(BwdArgs<T> a) {
  using K = ColCfg<TL, GP, POS>;
  constexpr int C = K::C, KJ = K::KJ, KT = K::KT, QB = K::QB,
                NT = K::kThreads;
  constexpr int RS = QB * kColStripes;
  extern __shared__ __align__(16) float smem[];

  const int L = a.L, S = a.S;
  const int j0 = blockIdx.x * KT, s0 = blockIdx.y * kColStripes;
  const int gi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = s0 + lane;
  const size_t LS = (size_t)L * S, LL = (size_t)L * L;
  const T* qkv = a.qkv + (size_t)gi * 2 * GP * LS;
  const size_t grow = (size_t)gi * GP * LS;  // group offset of dsv, dsve
  const int nqb = (L + QB - 1) / QB;

  auto load = [&](int qb) {
    float* st = smem + (qb % kStages) * K::STAGE;
    const int i0 = qb * QB;
    const size_t at = (size_t)i0 * S + s0;
    const int vb = L - i0, vx = S - s0;
    const bool vs = a.vec_s;
    const int t = threadIdx.x;
    // the q rows as T, in the first C * RS floats' room
    stage<C, QB, kColStripes, NT>(reinterpret_cast<T*>(st), qkv + at, LS, S,
                                  vb, vx, vs, t);
    stage<GP, QB, kColStripes, NT>(st + K::OG * RS, a.dsv + grow + at, LS, S,
                                   vb, vx, vs, t);
    if constexpr (POS) {
      stage<GP, QB, kColStripes, NT>(st + K::OE * RS, a.dsve + grow + at, LS,
                                     S, vb, vx, vs, t);
    }
    stage<1, QB, kColStripes, NT>(st + K::OD * RS,
                                  a.scratch + (size_t)gi * LS + at, 0, S, vb,
                                  vx, vs, t);
    stage<1, QB, kColStripes, NT>(st + K::OM * RS,
                                  a.scratch + (size_t)(a.g + gi) * LS + at, 0,
                                  S, vb, vx, vs, t);
    if constexpr (POS) {
      const size_t off = (size_t)i0 * L + j0;
      float* tb = st + K::OPS;
      const int vk = L - j0;
      stage<C, QB, KT, NT>(tb, a.qemb + off, LL, L, vb, vk, a.vec_l, t);
      stage<C, QB, KT, NT>(tb + C * QB * KT, a.kemb_t + off, LL, L, vb, vk,
                           a.vec_l, t);
      stage<GP, QB, KT, NT>(tb + 2 * C * QB * KT, a.vemb + off, LL, L, vb,
                            vk, a.vec_l, t);
    }
  };
#pragma unroll
  for (int qb = 0; qb < kStages - 1; ++qb) {
    if (qb < nqb) load(qb);
    cp_async_commit();
  }

  const float* af = a.aff + gi * 8;
  const float a0 = af[0], a4 = af[4];
  const float a0s = a0 * kLog2e, a2s = af[2] * kLog2e, a4s = a4 * kLog2e;
  const int kt0 = warp * KJ;  // the thread's first key in the block
  float k[KJ][C], v[KJ][GP], dk[KJ][C], dv[KJ][GP];
#pragma unroll
  for (int kk = 0; kk < KJ; ++kk) {
    const int j = j0 + kt0 + kk;
    const bool ok = j < L && s < S;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      k[kk][c] = ok ? to_f32(qkv[(C + c) * LS + (size_t)j * S + s]) : 0.f;
      dk[kk][c] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      v[kk][p] = ok ? to_f32(qkv[(GP + p) * LS + (size_t)j * S + s]) : 0.f;
      dv[kk][p] = 0.f;
    }
  }

  // Rows past the span and stripes past the edge are staged as zeros: their
  // dsim, delta and dsv are 0, so they add exactly 0 to dk and dv.
  for (int qb = 0; qb < nqb; ++qb) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (qb + kStages - 1 < nqb) load(qb + kStages - 1);
    cp_async_commit();
    const float* ops = smem + (qb % kStages) * K::STAGE;
    col_block<TL, GP, POS, T>(ops, ops + K::OPS, kt0, lane, a0, a4, a0s,
                              a2s, a4s, k, v, dk, dv);
  }

  if (s >= S) return;
#pragma unroll
  for (int kk = 0; kk < KJ; ++kk) {
    const int j = j0 + kt0 + kk;
    if (j >= L) break;
    const size_t out0 = (size_t)gi * 2 * GP * LS + (size_t)j * S + s;
#pragma unroll
    for (int c = 0; c < C; ++c)
      a.dqkv[out0 + (C + c) * LS] = from_f32<T>(dk[kk][c]);
#pragma unroll
    for (int p = 0; p < GP; ++p)
      a.dqkv[out0 + (GP + p) * LS] = from_f32<T>(dv[kk][p]);
  }
}

template <class TL, int GP, bool POS, class T>
cudaError_t launch_variant(const BwdArgs<T>& a, cudaStream_t stream) {
  using KR = RowCfg<TL, GP>;
  using KC = ColCfg<TL, GP, POS>;
  auto row = tiled_bwd_row_kernel<TL, GP, POS, T>;
  auto col = tiled_bwd_col_kernel<TL, GP, POS, T>;
  const size_t row_smem = row_smem_bytes<TL, GP, POS, T>();
  const size_t col_smem = (size_t)kStages * KC::STAGE * sizeof(float);
  cudaError_t err = allow_smem(row, row_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(col, col_smem);
  if (err != cudaSuccess) return err;
  const dim3 row_grid((a.L + KR::QB - 1) / KR::QB,
                      (a.S + kRowStripes - 1) / kRowStripes, a.g);
  row<<<row_grid, KR::kThreads, row_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 col_grid((a.L + KC::KT - 1) / KC::KT,
                      (a.S + kColStripes - 1) / kColStripes, a.g);
  col<<<col_grid, KC::kThreads, col_smem, stream>>>(a);
  return cudaGetLastError();
}

// Query rows per row-pass block of policy TL at gp.
template <class TL>
constexpr int row_queries(int gp) {
  return TL::kRowQueries[gp == 2 ? 1 : gp == 4 ? 2 : gp == 8 ? 3 : 4];
}

// The tile policies. Flash2's was sized for spans up to 256. The flash
// contract (spans up to 64) runs the same tiles. Two policies sized for
// short spans were slower on an H100 80GB HBM3 at 700 W (device ms per
// MedT-128 batch-16 step and per medt_512 batch-4 step, against 0.82 and
// 1.45-1.46 with these tiles; PERF.md, kernel row 4):
//   * 4-warp row blocks of 4 query rows, so that two fit an SM, and 4 keys
//     per column thread, so that the (32, 4, 512) site fills 256 column
//     blocks: 0.95 and 1.78;
//   * row-pass key blocks of 32 at gp <= 4, half the stages: 0.82-0.83 and
//     1.63.
// The wrapper mirrors kRowQueries (ops/axial_lanes.py: ROW_QUERIES).
struct Flash2Tiles {
  static constexpr int kMaxSpan = 256;
  // query rows per row-pass block, by log2(gp)
  static constexpr int kRowQueries[5] = {0, 8, 8, 4, 2};
  static constexpr int kRowWarps = 8;
  static constexpr int row_keys(int gp) {
    return gp <= 4 ? 16 : gp == 8 ? 8 : 4;
  }
  static constexpr int kColWarps = 4;
  static constexpr int col_keys(int gp) {
    return gp <= 4 ? 8 : gp == 8 ? 4 : 2;
  }
  static constexpr int col_queries(int gp) { return gp <= 4 ? 16 : 8; }
};

struct FlashTiles : Flash2Tiles {
  static constexpr int kMaxSpan = 64;
};

// The whole backward of one call under policy TL, qkv and dqkv of element
// type T (float or bf16): validate, row pass, column pass, finalize. m, l,
// sv, sve are the forward's saved outputs; scratch holds 2 * g * L * S floats (delta, then the row normaliser mm).
// dtables: (2gp, L, L) = dqemb (c rows), dkemb_t (c rows), dvemb (gp rows),
// not written without positions. Partials: tab_part (g * ceil(S/128), 2gp,
// L, L) (unused without positions), aff_part (ceil(L/QB) * ceil(S/128), g,
// 4). sve and dsve are not read without positions. Returns the first CUDA
// error of its launches.
template <class TL, class T>
int tiled_bwd(const T* qkv, const float* qemb, const float* kemb_t,
              const float* vemb, const float* aff, const float* m,
              const float* l, const float* sv, const float* sve,
              const float* dsv, const float* dsve, T* dqkv,
              float* dtables, float* daff, float* scratch, float* tab_part,
              float* aff_part, int g, int gp, int L, int S, int has_pos,
              int n_tab_part, int n_aff_part, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (gp != 2 && gp != 4 && gp != 8 && gp != 16) {
    return (int)cudaErrorInvalidValue;
  }
  const int chunks = (S + kRowStripes - 1) / kRowStripes;
  const int rows = row_queries<TL>(gp);
  if (g < 1 || S < 1 || L < 1 || L > TL::kMaxSpan || g > 65535 ||
      (S + kColStripes - 1) / kColStripes > 65535 ||
      n_aff_part != ((L + rows - 1) / rows) * chunks ||
      (has_pos && n_tab_part != g * chunks)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  const bool vec_s = S % kChunk<T> == 0 && aligned16(qkv) && aligned16(dsv) &&
                     aligned16(scratch) && (!pos || aligned16(dsve));
  const bool vec_l = pos && L % 4 == 0 && aligned16(qemb) &&
                     aligned16(kemb_t) && aligned16(vemb);
  const BwdArgs<T> a{qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve,
                  scratch, dqkv, tab_part, aff_part, g, L, S, vec_s, vec_l};
  cudaError_t err;
  switch (gp) {
    case 2: err = pos ? launch_variant<TL, 2, true, T>(a, stream)
                      : launch_variant<TL, 2, false, T>(a, stream); break;
    case 4: err = pos ? launch_variant<TL, 4, true, T>(a, stream)
                      : launch_variant<TL, 4, false, T>(a, stream); break;
    case 8: err = pos ? launch_variant<TL, 8, true, T>(a, stream)
                      : launch_variant<TL, 8, false, T>(a, stream); break;
    default: err = pos ? launch_variant<TL, 16, true, T>(a, stream)
                       : launch_variant<TL, 16, false, T>(a, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(tab_part, dtables, pos ? n_tab_part : 0,
                     (size_t)2 * gp * L * L, aff_part, daff, n_aff_part, g,
                     has_pos, stream);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace flash2
