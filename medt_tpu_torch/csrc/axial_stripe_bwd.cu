// Backward of the stripe-major train-mode attention core, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel medt_tpu/ops/pallas_axial_train.py::
// _fused_bwd_rule (pl.pallas_call at :306, body _bwd_kernel). Same forward
// as csrc/axial_stripe_fwd.cu (per stripe s, group gi, query i, key j;
// c = gp/2; layouts stripe-major: q, k, v views with free stripe and group
// strides and rows of L contiguous floats, as the forward takes them; the
// upstream and input gradients dense):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   sv[p,i] = sum_j p_ij v[p,j],  sve[p,i] = sum_j p_ij vemb[p,i,j]
// Given dsv, dsve (S, g, gp, L), with
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   delta_i = sum_j p_ij dsim_ij,   dlog_ij = p_ij (dsim_ij - delta_i)
// it writes
//   dq[s,gi,c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[s,gi,c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb[c,j,i])
//   dv[s,gi,p,j] = sum_i p_ij dsv[p,i]
// the table gradients, summed over every stripe and group,
//   dqemb[c,i,j] = sum a2 dlog_ij q[c,i]
//   dkemb[c,j,i] = sum a4 dlog_ij k[c,j]
//   dvemb[p,i,j] = sum p_ij dsve[p,i]
// and daff (g, 8) = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog,
//                    sum dlog*kr, sum dlog, 0, 0] (columns 2..5 zero
//                    without positions), as _bwd_kernel lays it out.
//
// The first CUDA design (PR 8) ran two kernels of one-warp blocks, grid
// (L, ceil(S/32), g): a row kernel, one thread per (stripe, query), that
// built the softmax twice (an online pass for m, l and delta, then the
// gradient pass) and per key j reduced 2c + gp table-gradient terms over
// its warp by shuffles, lane 0 scattering them into a (g * ceil(S/32), 2gp,
// L, L) partial; a column kernel that rebuilt every logit from m, l and
// delta kept in device memory; then two reductions: four launches a call.
// On an H100 80GB HBM3 at 700 W it took 172-192 us of device time a call,
// about 110 times its bound (PERF.md, kernel row 11).
//
// This design is the card's counterpart of the TPU kernel's whole-tile
// program, after csrc/axial_lanes_bwd.cu: one launch in which a block of
// kThreads threads owns one group and a chunk of NS stripes (chunk_stripes:
// 4 with positions at spans 33..64 below gp kWideGp, else 2, so that even
// a batch-1 call has 128 blocks). It stages the chunk's q, k, v, dsv (and
// dsve) rows in shared memory by cp.async (16-byte copies where the rows
// allow; ragged stripes and keys past the span zero-filled), and kemb
// transposed with an odd row stride, then:
//   * row phase: a warp per query i, a half-warp per stripe of it, its 16
//     lanes over the keys (KPL = LP / 16 each, LP the span rounded up to
//     16, 32 or 64), so the qemb and vemb rows it reads from L2 are
//     coalesced (and loaded one query ahead); one pass gives the logits
//     and dsim, the max, exp2 weights, l and delta by half-warp shuffles,
//     then p and dlog, stored in shared memory, and dq, written at once.
//     The query's dqemb and dvemb terms are summed over its stripes in
//     registers and written to the block's slot of the partials;
//   * column phase: a thread per (key j, stripe) forms dk and dv from the
//     stored p and dlog, with no logit recomputed;
//   * table phase, positions only: a thread per (j, i) sums dkemb[c, j, i]
//     over the chunk's stripes in index order, lanes over i so that its
//     writes stay coalesced.
// The daff sums need no logit again: sum dlog*qk = sum_ci q[c,i] dA[c,i]
// with dA[c,i] = sum_j dlog_ij k[c,j] (dq's own sum), and likewise qr from
// dq's table sum and kr from dk's. Strides are chosen so that the half-
// warps of a warp (two stripes of one query) and the lanes of each phase
// fall in distinct banks. A second launch (medt::bwd_finalize) sums the
// table and daff partials in a fixed order: two launches a call, no float
// atomics, the same bits every run. The partials have one slot per block:
// tables (g * ceil(S/NS), 2gp, L, L) floats with positions, daff
// (ceil(S/NS), g, 4). At the batch-1 path sites (g = 8): span 64, gp 2 or
// 4, S 64: 128 slots, 8 or 16 MB; span 32, gp 4, S 32: 128 slots, 4 MB;
// the first design's were 1, 2 and 0.25 MB. Walking several chunks per
// block would keep them at that size, at the price of that many times
// fewer blocks: a block cannot hold the p and dlog of more stripes at span
// 64 (32 KB a stripe).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, kernel row 11): 24.8,
// 35.9 and 12.7 us of device time a call at (span, gp, S) = (64, 2, 64),
// (64, 4, 64), (32, 4, 32) with positions, against 147.4, 319.1 and 67.7
// for the first design; the finalize takes 2.5-3.9 us of them. The first
// layout of this design, whose table phase summed all 2gp table rows and
// whose row phase loaded the table rows as it went, took 59.8 us at (64,
// 4, 64).
// What bounds it on the H100: at batch 1 a call moves a few MB and does
// about 0.1-0.3 GFLOP, a few microseconds at the card's peaks; the kernel
// is bound by latency (one tile load, three phases per block, about one
// block per SM, few warps) and the partials' traffic. No tensor cores:
// contraction depths c <= 8 are too shallow.
// Kernels launch on the caller's stream, allocate nothing (the wrapper
// passes the partials) and do not synchronise; the entry point returns the
// first CUDA error of its launches.

#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"
#include "reduce.cuh"

namespace {

using flash2::ex2;
using flash2::kLog2e;
using medt::warp_sum;

constexpr int kMaxSpan = 64;
constexpr int kThreads = 256;  // threads per block
constexpr int kWarps = kThreads / 32;
// from this many group planes a block at span bucket 64 holds 2 stripes,
// not 4. Mirrored by ops/axial_train.py (BWD_WIDE_GP).
constexpr int kWideGp = 8;
// dynamic shared memory a block may use on an H100 (227 KB)
constexpr int kMaxSmemBytes = 232448;

// The span rounded up to the kernel's bucket (16, 32 or 64).
inline int span_bucket(int L) { return L <= 16 ? 16 : L <= 32 ? 32 : 64; }

// Stripes per block: 4 with positions at span bucket 64 below kWideGp
// group planes, else 2. The fewer stripes a block holds, the more blocks
// share a call's few stripes, but with positions each block writes a table
// partial of 2gp L^2 floats. Mirrored by ops/axial_train.py
// (bwd_chunk_stripes).
__host__ __device__ constexpr int chunk_stripes(int gp, int lp, bool pos) {
  return pos && lp == 64 && gp < kWideGp ? 4 : 2;
}

template <int GP, int LP, bool POS>
struct Cfg {
  static constexpr int C = GP / 2;
  static constexpr int R = 2 * GP;  // table rows: qemb c, kemb c, vemb gp
  static constexpr int NS = chunk_stripes(GP, LP, POS);
  static constexpr int KPL = LP / 16;  // keys per lane in the row phase
  // staged tile: rows q (c), k (c), v (gp), dsv (gp), [dsve (gp)], each
  // NS stripes of XP floats; XP % 32 == 16 puts the two stripes that a
  // warp's half-warps read on distinct banks
  static constexpr int XP = LP == 16 ? 16 : LP + 16;
  static constexpr int OQ = 0, OK = C, OV = GP, OG = 2 * GP, OE = 3 * GP;
  static constexpr int ROWS = 3 * GP + (POS ? GP : 0);
  static constexpr int RS = NS * XP;  // one staged row, all stripes
  static constexpr int TILE = ROWS * RS;
  // p and dlog, [stripe][i][j]: row stride IS = LP + 1 (odd), stripe
  // stride SS with SS % 32 == 16
  static constexpr int IS = LP + 1;
  static constexpr int SS = LP * IS + (48 - LP * IS % 32) % 32;
  static constexpr int PD = NS * SS;
  // kemb as [c][j][i] with row stride IS, where it fits beside the rest
  static constexpr int TKF = C * LP * IS;
  static constexpr int REST = TILE + 2 * PD + kWarps * 4;
  static constexpr bool STAGE_TK =
      POS && (REST + TKF) * (int)sizeof(float) <= kMaxSmemBytes;
  static constexpr int TK = STAGE_TK ? TKF : 0;
  static constexpr int FLOATS = REST + TK;
  static_assert(NS % 2 == 0 && LP % 16 == 0, "stripe pairs, 16-key runs");
  static_assert(FLOATS * (int)sizeof(float) <= kMaxSmemBytes,
                "the block's shared memory");
};

struct Args {
  const float* q;       // (S, g, c, L), strides q_ss, q_sg
  const float* k;       // (S, g, c, L), strides k_ss, k_sg
  const float* v;       // (S, g, gp, L), strides v_ss, v_sg
  const float* qemb;    // (c, L, L) [c, i, j]
  const float* kemb;    // (c, L, L) [c, j, i]
  const float* vemb;    // (gp, L, L) [p, i, j]
  const float* aff;     // (g, 8)
  const float* dsv;     // (S, g, gp, L)
  const float* dsve;    // (S, g, gp, L), with positions
  float* dq;
  float* dk;
  float* dv;
  float* tab_part;      // (g * blocks, 2gp, L, L) with positions
  float* aff_part;      // (blocks, g, 4)
  long long q_ss, q_sg, k_ss, k_sg, v_ss, v_sg;
  int S, g, L;
  bool vec;             // 16-byte copies of the tile rows
};

template <int GP, int LP, bool POS>
__global__ void __launch_bounds__(kThreads) stripe_bwd_kernel(Args a) {
  using K = Cfg<GP, LP, POS>;
  constexpr int C = K::C, NS = K::NS, XP = K::XP, RS = K::RS, IS = K::IS,
                SS = K::SS, KPL = K::KPL;
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;
  float* sp = tile + K::TILE;  // p
  float* sd = sp + K::PD;      // dlog
  float* tk = sd + K::PD;      // kemb [c][j][i], if staged
  float* wsum = tk + K::TK;    // [warp][4]

  const int L = a.L, S = a.S, g = a.g, gi = blockIdx.y;
  const int s0 = blockIdx.x * NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vs = min(NS, S - s0);  // valid stripes of the chunk
  const size_t LL = (size_t)L * L;

  // -- stage the chunk's rows (and kemb) -------------------------------------
  {
    const long long d_ss = (long long)g * GP * L;  // dense (S, g, gp, L)
    const size_t d0 = ((size_t)s0 * g + gi) * GP * L;
    flash2::stage<C, NS, LP, kThreads, XP>(
        tile + K::OQ * RS, a.q + s0 * a.q_ss + gi * a.q_sg, L, a.q_ss, vs, L,
        a.vec, tid);
    flash2::stage<C, NS, LP, kThreads, XP>(
        tile + K::OK * RS, a.k + s0 * a.k_ss + gi * a.k_sg, L, a.k_ss, vs, L,
        a.vec, tid);
    flash2::stage<GP, NS, LP, kThreads, XP>(
        tile + K::OV * RS, a.v + s0 * a.v_ss + gi * a.v_sg, L, a.v_ss, vs, L,
        a.vec, tid);
    flash2::stage<GP, NS, LP, kThreads, XP>(tile + K::OG * RS, a.dsv + d0, L,
                                            d_ss, vs, L, a.vec, tid);
    if constexpr (POS) {
      flash2::stage<GP, NS, LP, kThreads, XP>(tile + K::OE * RS,
                                              a.dsve + d0, L, d_ss, vs, L,
                                              a.vec, tid);
    }
    if constexpr (K::STAGE_TK) {
      for (int rw = warp; rw < C * L; rw += kWarps) {  // rw = c * L + j
        const int c = rw / L, j = rw - c * L;
        for (int i = lane; i < L; i += 32) {
          flash2::cp_async4(tk + (c * LP + j) * IS + i,
                            a.kemb + (size_t)rw * L + i, true);
        }
      }
    }
    flash2::cp_async_commit();
    flash2::cp_async_wait<0>();
    __syncthreads();
  }
  // A stripe past the edge is staged as zeros: its dsim and delta are 0,
  // so its dlog is 0 and its p meets only zero dsv and dsve.

  const float* af = a.aff + gi * 8;
  const float a0 = af[0];
  const float a2 = POS ? af[2] : 0.f, a4 = POS ? af[4] : 0.f;
  const float a0s = a0 * kLog2e, a2s = a2 * kLog2e, a4s = a4 * kLog2e;
  // kemb[c, j, i]: staged, or from L2 (gp 16 at span bucket 64, off every
  // path)
  auto kemb_at = [&](int c, int j, int i) {
    return K::STAGE_TK ? tk[(c * LP + j) * IS + i]
                       : __ldg(a.kemb + c * LL + (size_t)j * L + i);
  };
  float s_qk = 0.f, s_b = 0.f, s_qr = 0.f, s_kr = 0.f;

  // -- row phase: a warp per query i, a half-warp per stripe of it, lanes
  // over the keys ---------------------------------------------------------------
  {
    constexpr int NP = NS / 2;  // half-warp h: stripes 2 * pair + h
    const int h = lane >> 4, l16 = lane & 15;
    float* part = a.tab_part + ((size_t)gi * gridDim.x + blockIdx.x) * K::R * LL;
    // The qemb and vemb values of a query come from L2: they are loaded one
    // query ahead, so that the latency hides behind a query's passes.
    float tqn[KPL][C], tvn[KPL][GP];
    auto load_tables = [&](int i) {
#pragma unroll
      for (int t = 0; t < KPL; ++t) {
        const int j = l16 + 16 * t;
        const bool ok = POS && i < L && j < L;
        const size_t ij = (size_t)i * L + j;
#pragma unroll
        for (int c = 0; c < C; ++c)
          tqn[t][c] = ok ? __ldg(a.qemb + c * LL + ij) : 0.f;
#pragma unroll
        for (int p = 0; p < GP; ++p)
          tvn[t][p] = ok ? __ldg(a.vemb + p * LL + ij) : 0.f;
      }
    };
    if constexpr (POS) load_tables(warp);
    for (int i = warp; i < L; i += kWarps) {
      float tqv[KPL][C], tvv[KPL][GP];
      // the query's dqemb and dvemb terms, summed over the stripes of this
      // half-warp, then of the warp
      float aq[KPL][C], av[KPL][GP];
      if constexpr (POS) {
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            tqv[t][c] = tqn[t][c];
            aq[t][c] = 0.f;
          }
#pragma unroll
          for (int p = 0; p < GP; ++p) {
            tvv[t][p] = tvn[t][p];
            av[t][p] = 0.f;
          }
        }
        load_tables(i + kWarps);
      }
#pragma unroll
      for (int pair = 0; pair < NP; ++pair) {
        const int s = 2 * pair + h;
        const float* col = tile + s * XP;  // staged row r at col[r * RS]
        float q[C], gv[GP], ge[GP];
#pragma unroll
        for (int c = 0; c < C; ++c) q[c] = col[(K::OQ + c) * RS + i];
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          gv[p] = col[(K::OG + p) * RS + i];
          ge[p] = POS ? col[(K::OE + p) * RS + i] : 0.f;
        }
        float xs[KPL], ds[KPL], kv[KPL][C];
        float mx = -3.0e38f;
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          const int j = l16 + 16 * t;
          xs[t] = ds[t] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) kv[t][c] = 0.f;
          if (j < L) {
            float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float kc = col[(K::OK + c) * RS + j];
              kv[t][c] = kc;
              qk = fmaf(q[c], kc, qk);
              if constexpr (POS) {
                qr = fmaf(q[c], tqv[t][c], qr);
                kr = fmaf(kc, kemb_at(c, j, i), kr);
              }
            }
            float x = a0s * qk;  // log2 units; the biases cancel
            if constexpr (POS) x = fmaf(a4s, kr, fmaf(a2s, qr, x));
            float d = 0.f;
#pragma unroll
            for (int p = 0; p < GP; ++p) {
              d = fmaf(gv[p], col[(K::OV + p) * RS + j], d);
              if constexpr (POS) d = fmaf(ge[p], tvv[t][p], d);
            }
            xs[t] = x;
            ds[t] = d;
            mx = fmaxf(mx, x);
          }
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float l = 0.f, wd = 0.f;
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          if (l16 + 16 * t < L) {
            const float e = ex2(xs[t] - mx);
            xs[t] = e;
            l += e;
            wd = fmaf(e, ds[t], wd);
          }
        }
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          l += __shfl_xor_sync(0xffffffffu, l, o);
          wd += __shfl_xor_sync(0xffffffffu, wd, o);
        }
        const float inv_l = 1.f / l;
        const float delta = wd * inv_l;
        float* prow = sp + s * SS + i * IS;
        float* drow = sd + s * SS + i * IS;
        float dA[C], dB[C];
#pragma unroll
        for (int c = 0; c < C; ++c) dA[c] = dB[c] = 0.f;
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
          const int j = l16 + 16 * t;
          if (j < L) {
            const float pj = xs[t] * inv_l;
            const float dl = pj * (ds[t] - delta);
            prow[j] = pj;
            drow[j] = dl;
            s_b += dl;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              dA[c] = fmaf(dl, kv[t][c], dA[c]);
              if constexpr (POS) {
                dB[c] = fmaf(dl, tqv[t][c], dB[c]);
                aq[t][c] = fmaf(dl, q[c], aq[t][c]);
              }
            }
            if constexpr (POS) {
#pragma unroll
              for (int p = 0; p < GP; ++p) av[t][p] = fmaf(pj, ge[p], av[t][p]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) {
            dA[c] += __shfl_xor_sync(0xffffffffu, dA[c], o);
            if constexpr (POS)
              dB[c] += __shfl_xor_sync(0xffffffffu, dB[c], o);
          }
        }
        if (l16 == 0) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            s_qk = fmaf(q[c], dA[c], s_qk);
            if constexpr (POS) s_qr = fmaf(q[c], dB[c], s_qr);
          }
        }
        if (l16 < C && s0 + s < S) {  // lane c writes dq[s, gi, c, i]
          float out = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            if (c == l16) out = POS ? fmaf(a2, dB[c], a0 * dA[c]) : a0 * dA[c];
          }
          a.dq[(((size_t)(s0 + s) * g + gi) * C + l16) * L + i] = out;
        }
      }
      if constexpr (POS) {
        // the two half-warps' sums, added in one order on both; half 0
        // writes the query's dqemb row, half 1 its dvemb row
#pragma unroll
        for (int t = 0; t < KPL; ++t) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            aq[t][c] += __shfl_xor_sync(0xffffffffu, aq[t][c], 16);
#pragma unroll
          for (int p = 0; p < GP; ++p)
            av[t][p] += __shfl_xor_sync(0xffffffffu, av[t][p], 16);
          const int j = l16 + 16 * t;
          if (j < L) {
            const size_t ij = (size_t)i * L + j;
            if (h == 0) {
#pragma unroll
              for (int c = 0; c < C; ++c) part[c * LL + ij] = a2 * aq[t][c];
            } else {
#pragma unroll
              for (int p = 0; p < GP; ++p)
                part[(2 * C + p) * LL + ij] = av[t][p];
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // -- column phase: thread (key j, stripe) ------------------------------------
  for (int it = tid; it < LP * NS; it += kThreads) {
    const int j = it % LP, s = it / LP;
    if (j >= L) continue;
    const float* col = tile + s * XP;
    const float* pc = sp + s * SS + j;  // p[s][i][j] at pc[i * IS]
    const float* dc = sd + s * SS + j;
    float dKA[C], dKB[C], dvv[GP];
#pragma unroll
    for (int c = 0; c < C; ++c) dKA[c] = dKB[c] = 0.f;
#pragma unroll
    for (int p = 0; p < GP; ++p) dvv[p] = 0.f;
    for (int i = 0; i < L; ++i) {
      const float dl = dc[i * IS], pj = pc[i * IS];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        dKA[c] = fmaf(dl, col[(K::OQ + c) * RS + i], dKA[c]);
        if constexpr (POS) dKB[c] = fmaf(dl, kemb_at(c, j, i), dKB[c]);
      }
#pragma unroll
      for (int p = 0; p < GP; ++p)
        dvv[p] = fmaf(pj, col[(K::OG + p) * RS + i], dvv[p]);
    }
    if constexpr (POS) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        s_kr = fmaf(col[(K::OK + c) * RS + j], dKB[c], s_kr);
    }
    if (s0 + s < S) {
      const size_t sg = (size_t)(s0 + s) * g + gi;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a.dk[(sg * C + c) * L + j] =
            POS ? fmaf(a4, dKB[c], a0 * dKA[c]) : a0 * dKA[c];
      }
#pragma unroll
      for (int p = 0; p < GP; ++p) a.dv[(sg * GP + p) * L + j] = dvv[p];
    }
  }

  // -- table phase (positions): dkemb[c, j, i], summed over the chunk's
  // stripes in index order; thread per (j, i), lanes over i ------------------
  if constexpr (POS) {
    float* part = a.tab_part + ((size_t)gi * gridDim.x + blockIdx.x) * K::R * LL;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* kc = tile + (K::OK + c) * RS;
#pragma unroll 4
      for (int e = tid; e < LP * LP; e += kThreads) {
        const int j = e / LP, i = e % LP;
        if (j < L && i < L) {
          const float* w = sd + i * IS + j;  // dlog[s][i][j] at w[s * SS]
          float v = 0.f;
#pragma unroll
          for (int s = 0; s < NS; ++s) v = fmaf(w[s * SS], kc[s * XP + j], v);
          part[(C + c) * LL + (size_t)j * L + i] = a4 * v;
        }
      }
    }
  }

  const float sums[4] = {s_qk, s_b, s_qr, s_kr};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float v = warp_sum(sums[t]);
    if (lane == 0) wsum[warp * 4 + t] = v;
  }
  __syncthreads();
  if (tid < 4) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += wsum[w * 4 + tid];
    a.aff_part[((size_t)blockIdx.x * g + gi) * 4 + tid] = v;
  }
}

template <int GP, int LP, bool POS>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  using K = Cfg<GP, LP, POS>;
  auto kernel = stripe_bwd_kernel<GP, LP, POS>;
  const size_t smem = (size_t)K::FLOATS * sizeof(float);
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + K::NS - 1) / K::NS, a.g);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int GP>
cudaError_t launch_gp(const Args& a, bool pos, cudaStream_t stream) {
  switch (span_bucket(a.L)) {
    case 16: return pos ? launch_variant<GP, 16, true>(a, stream)
                        : launch_variant<GP, 16, false>(a, stream);
    case 32: return pos ? launch_variant<GP, 32, true>(a, stream)
                        : launch_variant<GP, 32, false>(a, stream);
    default: return pos ? launch_variant<GP, 64, true>(a, stream)
                        : launch_variant<GP, 64, false>(a, stream);
  }
}

}  // namespace

extern "C" {

// q, k, v: stripe stride *_ss and group stride *_sg in floats, rows of L
// contiguous floats; dsv, dsve, dq, dk, dv dense.
// dtables: (2gp, L, L) = dqemb (c rows, [c, i, j]), dkemb (c rows,
// [c, j, i]), dvemb (gp rows, [p, i, j]); not written without positions.
// Partials, with B = ceil(S / NS) blocks per group (NS = chunk_stripes(gp,
// span_bucket(L))): tab_part (g * B, 2gp, L, L) with positions (unused
// without), aff_part (B, g, 4). dsve is not read without positions.
int medt_stripe_attn_bwd(const float* q, const float* k, const float* v,
                         const float* qemb, const float* kemb,
                         const float* vemb, const float* aff,
                         const float* dsv, const float* dsve, float* dq,
                         float* dk, float* dv, float* dtables, float* daff,
                         float* tab_part, float* aff_part, long long q_ss,
                         long long q_sg, long long k_ss, long long k_sg,
                         long long v_ss, long long v_sg, int S, int g, int gp,
                         int L, int has_pos, int n_tab_part, int n_aff_part,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool pos = has_pos != 0;
  if (g < 1 || g > 65535 || S < 1 || L < 1 || L > kMaxSpan ||
      (gp != 2 && gp != 4 && gp != 8 && gp != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int ns = chunk_stripes(gp, span_bucket(L), pos);
  const int blocks = (S + ns - 1) / ns;
  if (n_aff_part != blocks || (pos && n_tab_part != g * blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  using flash2::aligned16;
  const bool vec = L % 4 == 0 && q_ss % 4 == 0 && q_sg % 4 == 0 &&
                   k_ss % 4 == 0 && k_sg % 4 == 0 && v_ss % 4 == 0 &&
                   v_sg % 4 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && aligned16(dsv) && (!pos || aligned16(dsve));
  const Args a{q, k, v, qemb, kemb, vemb, aff, dsv, dsve, dq, dk, dv,
               tab_part, aff_part, q_ss, q_sg, k_ss, k_sg, v_ss, v_sg, S, g,
               L, vec};
  cudaError_t err;
  switch (gp) {
    case 2: err = launch_gp<2>(a, pos, stream); break;
    case 4: err = launch_gp<4>(a, pos, stream); break;
    case 8: err = launch_gp<8>(a, pos, stream); break;
    default: err = launch_gp<16>(a, pos, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(tab_part, dtables, pos ? n_tab_part : 0,
                     (size_t)2 * gp * L * L, aff_part, daff, n_aff_part, g,
                     has_pos, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
