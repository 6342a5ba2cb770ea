// The lanes-contract attention backward at wide group planes (every even gp
// up to 128 outside 2, 4, 8 and 16), for Hopper (sm_90a).
//
// Replaces, at those widths, the Pallas TPU kernels of
// medt_tpu/ops/pallas_axial_lanes.py that csrc/axial_lanes_bwd.cu and
// csrc/axial_flash_bwd.cu replace at gp 2, 4, 8 and 16: _bwd_kernel (the
// lanes contract, softmax recomputed from the logits) and _flash_bwd_kernel
// (the flash contract, probabilities from the forward's saved m, l and
// delta from its saved sv, sve). The train route sends the stripe backward
// (pallas_axial_train.py's _fused_bwd_rule) here too at these widths
// (ops/axial_attention.py: fused_route). Contract (ops/axial_lanes.py):
// qkv (g, 2gp, L, S), tables qemb, kemb_t (c, L, L) and vemb (gp, L, L),
// affine (g, 8), upstream dsv, dsve (g, gp, L, S) -> dqkv (g, 2gp, L, S),
// the table gradients (2gp, L, L) summed over groups and stripes, daff (g,
// 8). Per group gi, query i, key j, stripe s (c = gp/2):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   dlog_ij = p_ij (dsim_ij - delta_i),  delta_i = sum_j p_ij dsim_ij
//   dq[c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])
//   dv[p,j] = sum_i p_ij dsv[p,i]
//   dqemb[c,i,j] = a2 sum dlog_ij q[c,i],  dkemb_t[c,i,j] = a4 sum dlog_ij
//   k[c,j],  dvemb[p,i,j] = sum p_ij dsve[p,i]
//   daff = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog, sum dlog*kr,
//           sum dlog, 0, 0]
//
// What bounds it on the H100. Per pair (i, j) of a stripe the work is about
// 3c (logit) + 2gp (dsim) + 2c (dq) + 2c (dk) + gp (dv) FMAs and the table
// terms; the inputs are read once at the bound, so at the classifiers'
// sites (spans 7-56, 56-448 stripes) a launch is bound by how many operand
// loads feed each FMA, their latency and how many blocks keep the SMs
// busy, not by DRAM. The first design held one query row a thread,
// computed every logit twice, re-read dsv, k, v and the tables per pair
// from L1/L2 and swept a (g, L, L, S) scratch six times; its table kernel
// was 2gp L^2 warp dot products. This design:
//   * row pass (wide_row_kernel), thread = RI query rows x 1 stripe (lane =
//     stripe; RI = 4, 2, 2, 1 by register bucket), a block per window of
//     kKeyWindow keys (short chains, many blocks: its daff sums a slot of
//     their own), the keys in steps of kJT = 4: each k and v load serves
//     RI rows, each table value is a 16-byte shared-memory broadcast (the
//     block's (2c + gp) x rows x window tile staged once), each dsv / dsve
//     value serves kJT keys; the logit is computed once, p, dsim and dlog
//     once, the daff sums from qk, qr, kr kept from the logit; p and dlog
//     are written once to the (g, L, L, S) scratch;
//   * lanes contract only, first (wide_row_kernel<STATS>): the same sweep
//     over every key of a row gives its max, denominator and delta by an
//     online softmax, so the row pass then runs as for the flash contract;
//   * column pass (wide_col_kernel), thread = RJ positions x 1 stripe: dk
//     (the positions as keys) and dq (as queries) in one sweep over dlog,
//     then dv from p; q and k, then dsv, staged by cp.async in a 2-slot
//     ring that the block's warps share, its kemb_t columns and qemb rows
//     in shared memory;
//   * table pass (wide_tab_kernel), a block per (position x, group): the
//     three table gradients at x as register-tiled products over the
//     stripes (4 x 4 outputs a thread, operands staged 32 stripes at a
//     time in a 2-slot cp.async ring), one slot per group;
//   * medt::bwd_finalize sums the table and daff slots in a fixed order.
// Measured and dropped (PERF.md section 6): dsv and dsve staged in the row
// pass (fewer warps a block: slower), four rows a thread at buckets 16 and
// 64 (slower), dlog and p staged in the column pass's ring (slower).
// The scratch (2 g L^2 S floats, plus (3, g, L, S) for the lanes contract)
// is written once and read once per consumer. No float atomics: the same
// bits every run. float32 arithmetic; qkv (and dqkv) float32 or bf16 (the
// _bf16 entry point), converted where read and rounded once where stored,
// so every other output equals the float32 entry point's on the upcast qkv,
// bit for bit. Each kernel is instantiated per register bucket of c
// (wide::cm_bucket: 8, 16, 32, 64) and takes gp at run time; every loop
// over channels stops at c (or gp). No tensor cores: TF32 fails the float32
// tolerances (csrc/tiled_bwd.cuh). Kernels launch on the caller's stream,
// allocate nothing and do not synchronise; the entry points return the
// first CUDA error of their launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"
#include "wide_attn.cuh"

namespace {

using medt::warp_sum;
using wide::kChunkP;
using wide::Lanes;

constexpr int kLanes = 32;       // stripes of a row or column block
constexpr int kMaxWarps = 4;     // warps of a row or column block
constexpr int kJT = 4;           // keys of a row-pass step
constexpr int kKeyWindow = 8;    // keys of a row-pass block
constexpr int kTileBudget = 112 * 1024;  // bytes of a row block's tables
constexpr int kColStage = 32 * 1024;     // bytes of a column-pass stage
constexpr int kTabThreads = 256;
constexpr int kTabStripes = 32;  // stripes a table block stages at once
constexpr int kTabTiles = 4;     // 4 x 4 output tiles a table thread holds
// the row pass's static shared memory (its warps' daff sums), which counts
// with the dynamic tile against the 48 KB that needs no opt-in
constexpr size_t kStaticSmem = kMaxWarps * 4 * sizeof(float);

// query rows a row-pass thread holds, and positions a column-pass thread
// holds, by register bucket
__host__ __device__ constexpr int rows_per_thread(int cm) {
  return cm <= 8 ? 4 : cm <= 32 ? 2 : 1;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Keys of a row-pass block: the row pass splits the keys into windows of
// kKeyWindow (a block per window, its daff sums a slot of their own), so
// that short per-thread chains and many blocks keep the SMs busy; the
// lanes contract's statistics sweep (an online softmax over every key of
// a row) takes them all.
int row_keys(int L) {
  return round4(L) < kKeyWindow ? round4(L) : kKeyWindow;
}

// Warps of a row-pass block: up to kMaxWarps while its table tile ((c + c
// + gp) table rows x its query rows x kw keys) fits kTileBudget.
// The wrapper mirrors this (ops/axial_lanes.py: wide_row_queries).
int row_warps(int gp, int kw) {
  const int ri = rows_per_thread(wide::cm_bucket(gp / 2));
  const int per = 2 * gp * ri * kw * (int)sizeof(float);
  const int w = kTileBudget / per;
  return w < 1 ? 1 : w > kMaxWarps ? kMaxWarps : w;
}

int row_queries(int gp, int kw) {
  return row_warps(gp, kw) * rows_per_thread(wide::cm_bucket(gp / 2));
}

// daff partial slots: one per row-pass block (query rows x key window x
// kLanes stripes)
int row_slots(int gp, int L, int S) {
  const int kw = row_keys(L), qb = row_queries(gp, kw);
  return ((L + qb - 1) / qb) * ((L + kw - 1) / kw) *
         ((S + kLanes - 1) / kLanes);
}

template <class T>
struct BwdArgs {
  Lanes<T> x;
  const float* aff;
  const float* m;      // (g, L, S): saved (flash) or the stats pass's
  const float* l;
  const float* delta;  // (g, L, S) of the stats pass, or null: from sv, sve
  const float* sv;
  const float* sve;
  const float* dsv;    // (g, gp, L, S)
  const float* dsve;
  T* dqkv;             // (g, 2gp, L, S)
  float* prob;         // (g, L, L, S) scratch: p_ij
  float* dlog;         // (g, L, L, S) scratch: dlog_ij
  float* stats;        // (3, g, L, S): m, l, delta (lanes contract)
  float* tab_part;     // (g, 2gp, L, L), positions only
  float* aff_part;     // (row_slots, g, 4)
  int nw;              // warps of a row or column block
  int kw;              // keys of a row block (a multiple of 4)
};

template <class T>
__device__ __forceinline__ size_t pair_at(const BwdArgs<T>& a, int gi, int i,
                                          int j, int s) {
  const int L = a.x.L;
  return (((size_t)gi * L + i) * L + j) * a.x.S + s;
}

template <class T>
__device__ __forceinline__ size_t plane_at(const BwdArgs<T>& a, int gi, int p,
                                           int gp, int i, int s) {
  return (((size_t)gi * gp + p) * a.x.L + i) * a.x.S + s;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float at4(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// One element into a float slot of shared memory: float by cp.async (zero
// when !valid), bf16 converted by a plain load.
template <class T>
__device__ __forceinline__ void stage_f32(float* dst, const T* src,
                                          bool valid) {
  if constexpr (sizeof(T) == 4) {
    flash2::cp_async4(dst, src, valid);
  } else {
    *dst = valid ? flash2::to_f32(*src) : 0.f;
  }
}

// rows x QN positions x kLanes stripes of a (row, L, S) operand into
// dst[(row * QN + q) * kLanes + lane]: row r at base + r * rs, position
// p0 + q (< L), stripe s0 + lane (< S); zeros elsewhere.
template <class T>
__device__ __forceinline__ void stage_rows(float* dst, const T* base,
                                           size_t rs, int rows, int QN,
                                           int p0, int L, int S, int s0,
                                           int tid, int nt) {
  const int n = rows * QN * kLanes;
#pragma unroll 4
  for (int e = tid; e < n; e += nt) {
    const int lane = e % kLanes, rest = e / kLanes, q = rest % QN,
              r = rest / QN;
    const bool ok = p0 + q < L && s0 + lane < S;
    stage_f32(dst + e, ok ? base + r * rs + (size_t)(p0 + q) * S + s0 + lane
                          : base, ok);
  }
}

// The row pass. A block of nw warps owns group gi, kLanes stripes (lane =
// stripe), QB = nw * RI query rows, RI a thread, and a window of KW keys
// (blockIdx.y = row block * windows + window); its table tile is
// tab[(tr * QB + r) * KW + j - k0], tr over qemb (c), kemb_t (c), vemb
// (gp). STATS: the lanes contract's first sweep, every key of a row
// (KW = round4(L)), writing m, l and delta.
template <int CM, bool POS, bool STATS, class T>
__global__ void __launch_bounds__(kMaxWarps * 32)
wide_row_kernel(BwdArgs<T> a) {
  constexpr int RI = rows_per_thread(CM);
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  __shared__ float wsum[kMaxWarps][4];
  const Lanes<T>& x = a.x;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2, KW = a.kw;
  const int QB = a.nw * RI, nt = a.nw * 32, KS = (L + KW - 1) / KW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s_raw = blockIdx.x * kLanes + lane;
  const bool s_ok = s_raw < S;
  const int s = s_ok ? s_raw : S - 1;
  const int i0 = (blockIdx.y / KS) * QB, k0 = (blockIdx.y % KS) * KW;
  const int k1 = k0 + KW < L ? k0 + KW : L;
  const int gi = blockIdx.z, wr = warp * RI;
  if constexpr (POS) {  // tab[(tr * QB + r) * KW + j - k0], keys k0..k1
    const int n = (2 * C + GP) * QB * KW;
    for (int e = threadIdx.x; e < n; e += nt) {
      const int j = k0 + e % KW, rest = e / KW, r = rest % QB,
                tr = rest / QB;
      const int i = i0 + r;
      float v = 0.f;
      if (j < L && i < L) {
        v = tr < C       ? x.tq(tr, i, j)
            : tr < 2 * C ? x.tk(tr - C, i, j)
                         : x.tv(tr - 2 * C, i, j);
      }
      tab[e] = v;
    }
    __syncthreads();
  }
  float af[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) af[k] = __ldg(a.aff + gi * 8 + k);
  int ir[RI];
  bool rok[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    const int i = i0 + wr + r;
    rok[r] = s_ok && i < L;
    ir[r] = i < L ? i : L - 1;
  }
  float q[RI][CM];
#pragma unroll
  for (int r = 0; r < RI; ++r) wide::load_q(x, q[r], gi, ir[r], s);
  // STATS: running max, denominator, sum of e^(lg - m) dsim; else the
  // saved (or stats-pass) max, 1 / denominator and delta
  float m[RI], il[RI], dlt[RI];
#pragma unroll
  for (int r = 0; r < RI; ++r) {
    if constexpr (STATS) {
      m[r] = -3.0e38f;
      il[r] = 0.f;
      dlt[r] = 0.f;
    } else {
      const size_t row = ((size_t)gi * L + ir[r]) * S + s;
      m[r] = a.m[row];
      il[r] = 1.f / a.l[row];
      if (a.delta != nullptr) {
        dlt[r] = a.delta[row];
      } else {
        float d = 0.f;
        for (int pp = 0; pp < GP; ++pp) {
          const size_t o = plane_at(a, gi, pp, GP, ir[r], s);
          d = fmaf(a.dsv[o], a.sv[o], d);
          if constexpr (POS) d = fmaf(a.dsve[o], a.sve[o], d);
        }
        dlt[r] = d;
      }
    }
  }
  float s_qk = 0.f, s_b = 0.f, s_qr = 0.f, s_kr = 0.f;
  for (int j0 = k0; j0 < k1; j0 += kJT) {
    int jc[kJT];
#pragma unroll
    for (int u = 0; u < kJT; ++u) jc[u] = j0 + u < L ? j0 + u : L - 1;
    // the logits' three terms, each channel's k serving RI rows
    float qk[RI][kJT], qr[RI][kJT], kr[RI][kJT];
#pragma unroll
    for (int r = 0; r < RI; ++r) {
#pragma unroll
      for (int u = 0; u < kJT; ++u) qk[r][u] = qr[r][u] = kr[r][u] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        float kc[kJT];
#pragma unroll
        for (int u = 0; u < kJT; ++u) kc[u] = x.k(gi, c, jc[u], s);
#pragma unroll
        for (int r = 0; r < RI; ++r) {
          float4 tq, tk;
          if constexpr (POS) {
            tq = ld4(tab + ((size_t)(c * QB + wr + r) * KW + j0 - k0));
            tk = ld4(tab + ((size_t)((C + c) * QB + wr + r) * KW + j0 - k0));
          }
#pragma unroll
          for (int u = 0; u < kJT; ++u) {
            qk[r][u] = fmaf(q[r][c], kc[u], qk[r][u]);
            if constexpr (POS) {
              qr[r][u] = fmaf(q[r][c], at4(tq, u), qr[r][u]);
              kr[r][u] = fmaf(kc[u], at4(tk, u), kr[r][u]);
            }
          }
        }
      }
    }
    // dsim, each v serving RI rows and each dsv, dsve kJT keys
    float ds[RI][kJT];
#pragma unroll
    for (int r = 0; r < RI; ++r) {
#pragma unroll
      for (int u = 0; u < kJT; ++u) ds[r][u] = 0.f;
    }
#pragma unroll 2
    for (int pp = 0; pp < GP; ++pp) {
      float vv[kJT];
#pragma unroll
      for (int u = 0; u < kJT; ++u) vv[u] = x.v(gi, pp, jc[u], s);
#pragma unroll
      for (int r = 0; r < RI; ++r) {
        const size_t o = plane_at(a, gi, pp, GP, ir[r], s);
        const float dv = __ldg(a.dsv + o);
        float de = 0.f;
        float4 tv;
        if constexpr (POS) {
          de = __ldg(a.dsve + o);
          tv = ld4(tab + ((size_t)((2 * C + pp) * QB + wr + r) * KW + j0 -
                          k0));
        }
#pragma unroll
        for (int u = 0; u < kJT; ++u) {
          ds[r][u] = fmaf(dv, vv[u], ds[r][u]);
          if constexpr (POS) ds[r][u] = fmaf(de, at4(tv, u), ds[r][u]);
        }
      }
    }
    float dl[RI][kJT];
#pragma unroll
    for (int r = 0; r < RI; ++r) {
#pragma unroll
      for (int u = 0; u < kJT; ++u) {
        float lg = qk[r][u] * af[0] + af[1];
        if constexpr (POS) {
          lg += (qr[r][u] * af[2] + af[3]) + (kr[r][u] * af[4] + af[5]);
        }
        const bool ok = rok[r] && j0 + u < k1;
        if constexpr (STATS) {
          if (ok) {  // online softmax: il the denominator, dlt sum e * dsim
            if (lg > m[r]) {
              const float sc = expf(m[r] - lg);
              il[r] = fmaf(il[r], sc, 1.f);
              dlt[r] = fmaf(dlt[r], sc, ds[r][u]);
              m[r] = lg;
            } else {
              const float e = expf(lg - m[r]);
              il[r] += e;
              dlt[r] = fmaf(e, ds[r][u], dlt[r]);
            }
          }
          dl[r][u] = 0.f;
        } else {
          const float p = ok ? expf(lg - m[r]) * il[r] : 0.f;
          dl[r][u] = p * (ds[r][u] - dlt[r]);
          if (ok) {
            const size_t o = pair_at(a, gi, ir[r], j0 + u, s);
            a.prob[o] = p;
            a.dlog[o] = dl[r][u];
          }
          s_b += dl[r][u];
          s_qk = fmaf(dl[r][u], qk[r][u], s_qk);
          if constexpr (POS) {
            s_qr = fmaf(dl[r][u], qr[r][u], s_qr);
            s_kr = fmaf(dl[r][u], kr[r][u], s_kr);
          }
        }
      }
    }
  }
  if constexpr (STATS) {
    const size_t gls = (size_t)gridDim.z * L * S;
#pragma unroll
    for (int r = 0; r < RI; ++r) {
      if (rok[r]) {
        const size_t row = ((size_t)gi * L + ir[r]) * S + s;
        a.stats[row] = m[r];
        a.stats[gls + row] = il[r];
        a.stats[2 * gls + row] = dlt[r] / il[r];
      }
    }
    return;
  } else {
    const float sums[4] = {s_qk, s_b, s_qr, s_kr};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = warp_sum(sums[k]);
      if (lane == 0) wsum[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      float v = 0.f;
      for (int w = 0; w < a.nw; ++w) v += wsum[w][threadIdx.x];
      const size_t slot = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
      a.aff_part[(slot * gridDim.z + gi) * 4 + threadIdx.x] = v;
    }
  }
}

// The column pass. A block of nw warps owns group gi, kLanes stripes and
// KB = nw * RJ positions, RJ a thread, taken as keys for dk and dv and as
// queries for dq; with positions its kemb_t columns and qemb rows are
// staged. Two sweeps, each staging IC positions at a time in a 2-slot
// cp.async ring shared by the block's warps: q and k (2c rows) for dk and
// dq together, then dsv (kChunkP rows a chunk) for dv.
template <int CM, bool POS, class T>
__global__ void __launch_bounds__(kMaxWarps * 32)
wide_col_kernel(BwdArgs<T> a, int IC) {
  constexpr int RJ = rows_per_thread(CM);
  extern __shared__ float4 smem4[];
  float* tab = reinterpret_cast<float*>(smem4);
  const Lanes<T>& x = a.x;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2;
  const int KB = a.nw * RJ, nt = a.nw * 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s_raw = blockIdx.x * kLanes + lane;
  const bool s_ok = s_raw < S;
  const int s = s_ok ? s_raw : S - 1;
  const int j0 = blockIdx.y * KB, gi = blockIdx.z, wr = warp * RJ;
  const int s_blk = blockIdx.x * kLanes;
  const size_t LS = (size_t)L * S;
  const int rows = 2 * C > kChunkP ? 2 * C : kChunkP;  // a ring slot's
  // tk[(c * L + i) * KB + kk] = kemb_t[c, i, j0 + kk] (dk), then
  // tq[(c * L + j) * KB + kk] = qemb[c, j0 + kk, j] (dq)
  float* tq = tab + (POS ? (size_t)C * L * KB : 0);
  float* ring = tq + (POS ? (size_t)C * L * KB : 0);
  const size_t slot = (size_t)rows * IC * kLanes;
  if constexpr (POS) {
    const int n = C * L * KB;
    for (int e = threadIdx.x; e < n; e += nt) {
      const int kk = e % KB, ci = e / KB, i = ci % L, c = ci / L;
      const int j = j0 + kk;
      tab[e] = j < L ? x.tk(c, i, j) : 0.f;
      tq[e] = j < L ? x.tq(c, j, i) : 0.f;
    }
  }
  const float a0 = __ldg(a.aff + gi * 8), a2 = __ldg(a.aff + gi * 8 + 2),
              a4 = __ldg(a.aff + gi * 8 + 4);
  int jr[RJ];
  bool rok[RJ];
#pragma unroll
  for (int r = 0; r < RJ; ++r) {
    const int j = j0 + wr + r;
    rok[r] = s_ok && j < L;
    jr[r] = j < L ? j : L - 1;
  }
  const int nch = (L + IC - 1) / IC;
  // one sweep over the positions p, q and k (2c rows) staged:
  //   dk[c,j] = sum_p dlog_pj (a0 q[c,p] + a4 kemb_t[c,p,j])
  //   dq[c,i] = sum_p dlog_ip (a0 k[c,p] + a2 qemb[c,i,p])
  // for the block's positions j, i as keys and as queries
  float dk[RJ][CM], dq[RJ][CM];
#pragma unroll
  for (int r = 0; r < RJ; ++r) {
#pragma unroll
    for (int c = 0; c < CM; ++c) dk[r][c] = dq[r][c] = 0.f;
  }
  const T* qb = x.qkv + (size_t)gi * 2 * GP * LS;
  stage_rows(ring, qb, LS, 2 * C, IC, 0, L, S, s_blk, threadIdx.x, nt);
  flash2::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      stage_rows(ring + ((ch + 1) & 1) * slot, qb, LS, 2 * C, IC,
                 (ch + 1) * IC, L, S, s_blk, threadIdx.x, nt);
    }
    flash2::cp_async_commit();
    flash2::cp_async_wait<1>();
    __syncthreads();
    const float* qs = ring + (ch & 1) * slot;
    const float* ks = qs + (size_t)C * IC * kLanes;
    const int np = min(IC, L - ch * IC);
    for (int pp = 0; pp < np; ++pp) {
      const int p = ch * IC + pp;
      float dlk[RJ], dlq[RJ];
#pragma unroll
      for (int r = 0; r < RJ; ++r) {
        dlk[r] = a.dlog[pair_at(a, gi, p, jr[r], s)];
        dlq[r] = a.dlog[pair_at(a, gi, jr[r], p, s)];
      }
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          const float qv = qs[(c * IC + pp) * kLanes + lane];
          const float kv = ks[(c * IC + pp) * kLanes + lane];
          float tk[RJ], tqv[RJ];
          if constexpr (POS) {
            flash2::lds(tk, tab + ((size_t)(c * L + p) * KB + wr));
            flash2::lds(tqv, tq + ((size_t)(c * L + p) * KB + wr));
          }
#pragma unroll
          for (int r = 0; r < RJ; ++r) {
            float w = a0 * qv;
            if constexpr (POS) w = fmaf(a4, tk[r], w);
            dk[r][c] = fmaf(dlk[r], w, dk[r][c]);
            float v = a0 * kv;
            if constexpr (POS) v = fmaf(a2, tqv[r], v);
            dq[r][c] = fmaf(dlq[r], v, dq[r][c]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RJ; ++r) {
    if (rok[r]) {
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          a.dqkv[plane_at(a, gi, c, 2 * GP, jr[r], s)] =
              flash2::from_f32<T>(dq[r][c]);
          a.dqkv[plane_at(a, gi, C + c, 2 * GP, jr[r], s)] =
              flash2::from_f32<T>(dk[r][c]);
        }
      }
    }
  }
  // dv[p,j] = sum_i p_ij dsv[p,i], kChunkP value channels at a time, dsv
  // staged
  for (int p0 = 0; p0 < GP; p0 += kChunkP) {
    const int n = min(kChunkP, GP - p0);
    const float* db = a.dsv + ((size_t)gi * GP + p0) * LS;
    float dv[RJ][kChunkP];
#pragma unroll
    for (int r = 0; r < RJ; ++r) {
#pragma unroll
      for (int u = 0; u < kChunkP; ++u) dv[r][u] = 0.f;
    }
    stage_rows(ring, db, LS, n, IC, 0, L, S, s_blk, threadIdx.x, nt);
    flash2::cp_async_commit();
    for (int ch = 0; ch < nch; ++ch) {
      if (ch + 1 < nch) {
        stage_rows(ring + ((ch + 1) & 1) * slot, db, LS, n, IC,
                   (ch + 1) * IC, L, S, s_blk, threadIdx.x, nt);
      }
      flash2::cp_async_commit();
      flash2::cp_async_wait<1>();
      __syncthreads();
      const float* ds = ring + (ch & 1) * slot;
      const int ni = min(IC, L - ch * IC);
      for (int ii = 0; ii < ni; ++ii) {
        const int i = ch * IC + ii;
        float pr[RJ];
#pragma unroll
        for (int r = 0; r < RJ; ++r) {
          pr[r] = a.prob[pair_at(a, gi, i, jr[r], s)];
        }
#pragma unroll
        for (int u = 0; u < kChunkP; ++u) {
          if (u < n) {
            const float d = ds[(u * IC + ii) * kLanes + lane];
#pragma unroll
            for (int r = 0; r < RJ; ++r) dv[r][u] = fmaf(pr[r], d, dv[r][u]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < RJ; ++r) {
      if (rok[r]) {
#pragma unroll
        for (int u = 0; u < kChunkP; ++u) {
          if (u < n) {
            a.dqkv[plane_at(a, gi, GP + p0 + u, 2 * GP, jr[r], s)] =
                flash2::from_f32<T>(dv[r][u]);
          }
        }
      }
    }
  }
}

// Positions a column-pass ring slot stages: up to 16 while max(2c,
// kChunkP) rows x kLanes stripes of them fit kColStage bytes.
int col_queries(int gp) {
  const int rows = gp > wide::kChunkP ? gp : wide::kChunkP;
  const int ic = kColStage / (rows * kLanes * (int)sizeof(float));
  return ic < 1 ? 1 : ic > 16 ? 16 : ic;
}

// The table pass's layout: A rows (q c, k c, dsve gp, each segment padded
// to a multiple of 4) x B columns (dlog[x, j], dlog[i, x], p[x, j], each
// round4(L)); segment t of A pairs with segment t of B.
struct TabShape {
  int C4, G4, Lp, RA, RAp, NB, NBp, RT, CT, NT, NSUB;
  __host__ __device__ TabShape(int gp, int L) {
    C4 = round4(gp / 2);
    G4 = round4(gp);
    Lp = round4(L);
    RA = 2 * C4 + G4;
    RAp = RA + 4;  // rows of a staged stripe, 16-byte aligned
    NB = 3 * Lp;
    NBp = NB + 4;
    RT = RA / 4;
    CT = Lp / 4;
    NT = RT * CT;
    NSUB = NT >= kTabThreads ? 1 : kTabThreads / NT;
  }
  __host__ __device__ int stage_floats() const {
    return kTabStripes * (RAp + NBp);
  }
  __host__ __device__ int smem_floats() const {  // a 2-slot ring
    const int red = NSUB > 1 ? NSUB * NT * 16 : 0;
    return 2 * stage_floats() > red ? 2 * stage_floats() : red;
  }
};

// The table pass. A block per (position x, group gi): at query row x,
//   dqemb[c,x,j] = a2 sum_s q[c,x] dlog_xj,  dvemb[p,x,j] = sum_s dsve[p,x]
//   p_xj;  at key x, dkemb_t[c,i,x] = a4 sum_s k[c,x] dlog_ix
// over all the group's stripes, kTabStripes at a time; a thread holds up
// to kTabTiles 4 x 4 output tiles (NSUB threads split a tile's stripes when
// the tiles are fewer than the threads, summed in a fixed order). Writes
// its group's slot of the table partials.
template <class T>
__global__ void __launch_bounds__(kTabThreads) wide_tab_kernel(BwdArgs<T> a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Lanes<T>& x = a.x;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2, LL = L * L;
  const int px = blockIdx.x, gi = blockIdx.y, tid = threadIdx.x;
  const TabShape sh(GP, L);
  // NSUB > 1: thread (share u, tile t0); else tiles t0, t0 + kTabThreads..
  const int u = sh.NSUB > 1 ? tid / sh.NT : 0;
  const int t0 = sh.NSUB > 1 ? tid % sh.NT : tid;
  const bool active = u < sh.NSUB;
  float acc[kTabTiles][4][4];
#pragma unroll
  for (int k = 0; k < kTabTiles; ++k) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[k][rr][cc] = 0.f;
    }
  }
  // a slot: A [t][RAp], then B [t][NBp]; the stripes in a 2-slot ring
  auto stage = [&](int slot, int s0) {
    float* As = sm + slot * sh.stage_floats();
    float* Bs = As + kTabStripes * sh.RAp;
#pragma unroll 4
    for (int e = tid; e < sh.RA * kTabStripes; e += kTabThreads) {
      const int t = e % kTabStripes, row = e / kTabStripes, s = s0 + t;
      const bool in = s < S;
      float* dst = As + t * sh.RAp + row;
      if (row < sh.C4) {
        stage_f32(dst, in && row < C ? x.qkv + (((size_t)gi * 2 * GP + row) *
                                                   L + px) * S + s
                                     : x.qkv,
                  in && row < C);
      } else if (row < 2 * sh.C4) {
        const int c = row - sh.C4;
        stage_f32(dst, in && c < C ? x.qkv + (((size_t)gi * 2 * GP + C + c) *
                                                 L + px) * S + s
                                   : x.qkv,
                  in && c < C);
      } else {
        const int p = row - 2 * sh.C4;
        const bool ok = in && p < GP;
        stage_f32(dst, ok ? a.dsve + plane_at(a, gi, p, GP, px, s) : a.dsve,
                  ok);
      }
    }
#pragma unroll 4
    for (int e = tid; e < sh.NB * kTabStripes; e += kTabThreads) {
      const int t = e % kTabStripes, col = e / kTabStripes, s = s0 + t;
      const int seg = col / sh.Lp, y = col - seg * sh.Lp;
      const bool ok = s < S && y < L;
      const float* src = !ok       ? a.dlog
                         : seg == 0 ? a.dlog + pair_at(a, gi, px, y, s)
                         : seg == 1 ? a.dlog + pair_at(a, gi, y, px, s)
                                    : a.prob + pair_at(a, gi, px, y, s);
      stage_f32(Bs + t * sh.NBp + col, src, ok);
    }
  };
  const int nch = (S + kTabStripes - 1) / kTabStripes;
  stage(0, 0);
  flash2::cp_async_commit();
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) stage((ch + 1) & 1, (ch + 1) * kTabStripes);
    flash2::cp_async_commit();
    flash2::cp_async_wait<1>();
    __syncthreads();
    const float* As = sm + (ch & 1) * sh.stage_floats();
    const float* Bs = As + kTabStripes * sh.RAp;
    if (active) {
      const int tmax = min(kTabStripes, S - ch * kTabStripes);
#pragma unroll
      for (int k = 0; k < kTabTiles; ++k) {
        const int ti = t0 + k * kTabThreads;
        if (ti < sh.NT) {
          const int rt = ti / sh.CT, ct = ti - rt * sh.CT, row0 = rt * 4;
          const int seg = row0 < sh.C4 ? 0 : row0 < 2 * sh.C4 ? 1 : 2;
          const int col0 = seg * sh.Lp + ct * 4;
          for (int t = u; t < tmax; t += sh.NSUB) {
            const float4 av = ld4(As + t * sh.RAp + row0);
            const float4 bv = ld4(Bs + t * sh.NBp + col0);
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                acc[k][rr][cc] = fmaf(at4(av, rr), at4(bv, cc), acc[k][rr][cc]);
              }
            }
          }
        }
      }
    }
    __syncthreads();
  }
  // the NSUB shares of a tile, summed in order (NSUB > 1: one tile each)
  if (sh.NSUB > 1) {
    if (active) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          sm[(u * sh.NT + t0) * 16 + rr * 4 + cc] = acc[0][rr][cc];
        }
      }
    }
    __syncthreads();
    if (tid < sh.NT) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          float v = 0.f;
          for (int w = 0; w < sh.NSUB; ++w) v += sm[(w * sh.NT + tid) * 16 + rr * 4 + cc];
          acc[0][rr][cc] = v;
        }
      }
    }
  }
  const bool writes = sh.NSUB > 1 ? tid < sh.NT : true;
  if (!writes) return;
  const float a2 = __ldg(a.aff + gi * 8 + 2), a4 = __ldg(a.aff + gi * 8 + 4);
  float* part = a.tab_part + (size_t)gi * 2 * GP * LL;
#pragma unroll
  for (int k = 0; k < kTabTiles; ++k) {
    const int ti = t0 + k * kTabThreads;
    if (ti >= sh.NT || (sh.NSUB > 1 && k > 0)) continue;
    const int rt = ti / sh.CT, ct = ti - rt * sh.CT, row0 = rt * 4;
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int row = row0 + rr;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int y = ct * 4 + cc;
        if (y >= L) continue;
        if (row < sh.C4) {
          if (row < C) part[(size_t)row * LL + px * L + y] = a2 * acc[k][rr][cc];
        } else if (row < 2 * sh.C4) {
          const int c = row - sh.C4;
          if (c < C) part[(size_t)(C + c) * LL + y * L + px] = a4 * acc[k][rr][cc];
        } else {
          const int p = row - 2 * sh.C4;
          if (p < GP) part[(size_t)(2 * C + p) * LL + px * L + y] = acc[k][rr][cc];
        }
      }
    }
  }
}

template <int CM, bool POS, class T>
cudaError_t bwd_launches(BwdArgs<T> a, int g, bool lanes, cudaStream_t st) {
  const int L = a.x.L, S = a.x.S, gp = a.x.gp;
  const int sb = (S + kLanes - 1) / kLanes;
  cudaError_t err;
  if (lanes) {  // m, l and delta of the lanes contract first, every key
    const int kw = round4(L), nw = row_warps(gp, kw);
    const int qb = nw * rows_per_thread(CM);
    const size_t smem = POS ? (size_t)2 * gp * qb * kw * sizeof(float) : 0;
    a.nw = nw;
    a.kw = kw;
    auto k_stats = wide_row_kernel<CM, POS, true, T>;
    err = flash2::allow_smem(k_stats, smem + kStaticSmem);
    if (err != cudaSuccess) return err;
    k_stats<<<dim3(sb, (L + qb - 1) / qb, g), nw * 32, smem, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t gls = (size_t)g * L * S;
    a.m = a.stats;
    a.l = a.stats + gls;
    a.delta = a.stats + 2 * gls;
  }
  const int kw = row_keys(L), nw = row_warps(gp, kw);
  const int qb = nw * rows_per_thread(CM);
  const dim3 grid_r(sb, ((L + qb - 1) / qb) * ((L + kw - 1) / kw), g);
  const size_t smem_r = POS ? (size_t)2 * gp * qb * kw * sizeof(float) : 0;
  a.nw = nw;
  a.kw = kw;
  auto k_row = wide_row_kernel<CM, POS, false, T>;
  err = flash2::allow_smem(k_row, smem_r + kStaticSmem);
  if (err != cudaSuccess) return err;
  k_row<<<grid_r, nw * 32, smem_r, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kb = kMaxWarps * rows_per_thread(CM);
  const dim3 grid_c((S + kLanes - 1) / kLanes, (L + kb - 1) / kb, g);
  const int ic = col_queries(gp);
  const int ring_rows = gp > kChunkP ? gp : kChunkP;
  const size_t smem_c =
      ((POS ? (size_t)2 * (gp / 2) * L * kb : 0) +
       (size_t)2 * ring_rows * ic * kLanes) * sizeof(float);
  a.nw = kMaxWarps;
  auto k_col = wide_col_kernel<CM, POS, T>;
  err = flash2::allow_smem(k_col, smem_c);
  if (err != cudaSuccess) return err;
  k_col<<<grid_c, kMaxWarps * 32, smem_c, st>>>(a, ic);
  err = cudaGetLastError();
  if (err != cudaSuccess || !POS) return err;
  const TabShape sh(gp, L);
  const size_t smem_t = (size_t)sh.smem_floats() * sizeof(float);
  auto k_tab = wide_tab_kernel<T>;
  err = flash2::allow_smem(k_tab, smem_t);
  if (err != cudaSuccess) return err;
  k_tab<<<dim3(L, g), kTabThreads, smem_t, st>>>(a);
  return cudaGetLastError();
}

template <int CM, class T>
cudaError_t bwd_cm(const BwdArgs<T>& a, int g, bool pos, bool lanes,
                   cudaStream_t st) {
  return pos ? bwd_launches<CM, true, T>(a, g, lanes, st)
             : bwd_launches<CM, false, T>(a, g, lanes, st);
}

template <class T>
int wide_bwd(const T* qkv, const float* qemb, const float* kemb_t,
             const float* vemb, const float* aff, const float* m,
             const float* l, const float* sv, const float* sve,
             const float* dsv, const float* dsve, T* dqkv, float* dtables,
             float* daff, float* prob, float* dlog, float* tab_part,
             float* aff_part, int g, int gp, int L, int S, int has_pos,
             int saved, int n_aff_part, void* stream) {
  if (g < 1 || g > 65535 || S < 1 || L < 1 || L > wide::kMaxSpan ||
      !wide::gp_ok(gp) || n_aff_part != row_slots(gp, L, S)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pos = has_pos != 0, lanes = saved == 0;
  const size_t pairs = (size_t)g * L * L * S;
  // the lanes contract's (3, g, L, S) statistics follow p in its scratch
  const BwdArgs<T> a{Lanes<T>{qkv, qemb, kemb_t, vemb, gp, L, S}, aff,
                     lanes ? nullptr : m, lanes ? nullptr : l, nullptr, sv,
                     sve, dsv, dsve, dqkv, prob, dlog,
                     lanes ? prob + pairs : nullptr, tab_part, aff_part, 0,
                     0};
  cudaError_t err;
  switch (wide::cm_bucket(gp / 2)) {
    case 8: err = bwd_cm<8>(a, g, pos, lanes, st); break;
    case 16: err = bwd_cm<16>(a, g, pos, lanes, st); break;
    case 32: err = bwd_cm<32>(a, g, pos, lanes, st); break;
    default: err = bwd_cm<64>(a, g, pos, lanes, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(tab_part, dtables, pos ? g : 0, (size_t)2 * gp * L * L,
                     aff_part, daff, n_aff_part, g, has_pos, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The backward at any even gp up to 128, spans up to 64: the lanes
// contract (saved == 0: m, l, sv, sve not read) or the flash contract
// (saved != 0). dtables (2gp, L, L) and tab_part (g, 2gp, L, L) are not
// touched without positions, nor dsve read. Scratch: prob holds p (g, L,
// L, S) and, for the lanes contract, then m, l and delta (3, g, L, S);
// dlog (g, L, L, S); aff_part n_aff_part = ceil(L / QB) * ceil(L / KW) *
// ceil(S / 32) slots of (g, 4), KW = min(8, round4(L)) the row pass's
// keys a block (row_keys) and QB its query rows (row_queries).
int medt_wide_attn_bwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, const float* m, const float* l,
                       const float* sv, const float* sve, const float* dsv,
                       const float* dsve, float* dqkv, float* dtables,
                       float* daff, float* prob, float* dlog, float* tab_part,
                       float* aff_part, int g, int gp, int L, int S,
                       int has_pos, int saved, int n_aff_part, void* stream) {
  return wide_bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve,
                  dqkv, dtables, daff, prob, dlog, tab_part, aff_part, g, gp,
                  L, S, has_pos, saved, n_aff_part, stream);
}

// The same on bf16 qkv: dqkv (bf16) is the float32 entry point's dqkv on
// the upcast qkv rounded once, every other output its own, bit for bit.
int medt_wide_attn_bwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                            const float* kemb_t, const float* vemb,
                            const float* aff, const float* m, const float* l,
                            const float* sv, const float* sve,
                            const float* dsv, const float* dsve,
                            __nv_bfloat16* dqkv, float* dtables, float* daff,
                            float* prob, float* dlog, float* tab_part,
                            float* aff_part, int g, int gp, int L, int S,
                            int has_pos, int saved, int n_aff_part,
                            void* stream) {
  return wide_bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve,
                  dqkv, dtables, daff, prob, dlog, tab_part, aff_part, g, gp,
                  L, S, has_pos, saved, n_aff_part, stream);
}

}  // extern "C"
