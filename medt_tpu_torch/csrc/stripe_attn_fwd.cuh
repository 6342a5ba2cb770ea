// The stripe-major logits -> softmax -> (sv, sve) body, for Hopper
// (sm_90a), shared by the batch-1 eval kernel (csrc/axial_eval_fwd.cu) and
// the forward of the train-mode stripe core (csrc/axial_stripe_fwd.cu).
// Each source supplies an epilogue that stages its own per-group affines
// and stores the result: the eval epilogue applies the folded output BN and
// writes out, the train epilogue writes sv and sve themselves.
//
// Per stripe s, group gi and query row i:
//   logit[j] = (qk*a0 + a1) [+ (qr*a2 + a3) + (kr*a4 + a5)]
//     qk = sum_c q[c,i] k[c,j]
//     qr = sum_c q[c,i] qemb[c,i,j],  kr = sum_c k[c,j] kemb[c,j,i]
//   p = softmax_j(logit)
//   sv[p] = sum_j p_j v[p,j],  sve[p] = sum_j p_j vemb[p,i,j]
// with a = sim_affine[gi, 0..5] (the folded similarity BN). q, k (S, g, c,
// L) and v (S, g, gp, L) are stripe-major with free stripe and group
// strides and rows of L contiguous floats, so a caller passes three views
// of one fused (S, g, 2gp, L) qkv without a split; the tables (c, L, L),
// (c, L, L), (gp, L, L) are dense and shared by every group. Everything is
// float32. Without positions (HAS_POS false) the tables are not read and
// sve is zero. Spans 1..64, gp 2, 4, 8, 16.
//
// What bounds it on the H100: at the batch-1 shapes (S <= 64 stripes) one
// launch moves about 1-2 MB and does under 0.1 GFLOP, so not device bytes
// or float32 operations but latency, shared-memory reads and the L2
// traffic of restaging the tables: per (pair, query row, key) the body
// reads 3c + 2gp operands from shared memory, and every block restages
// the table rows it needs. The first design ran each (stripe, query row)
// as one thread's serial chain over all L keys (at span 64 about 8 warps
// per SM) and staged its operands with one dependent global load after
// another. What this design does about it:
//   * a query row's keys are spread over kKeyLanes = 4 lanes of a warp, in
//     runs of VW <= 4 consecutive keys, so every shared-memory read of k,
//     v and the tables is one vector load of VW keys: a warp holds 8 query
//     rows; the softmax's max and sum are shuffles over the 4 lanes, and
//     the sv/sve partials are summed by a reduce-scatter over the gp
//     planes, after which the epilogue stores the planes each lane holds;
//   * at span bucket 64 with positions a lane computes its row for PL = 2
//     pairs at once (gp <= 8), so each table vector it reads serves both;
//   * a block of NW warps owns RB query rows of PB (stripe, group) pairs:
//     it stages the pairs' q, k, v rows and the epilogue's affines, and the
//     RB rows of the tables, which do not depend on the group, with
//     cp.async (16-byte copies where L and the strides are multiples of 4,
//     else 4-byte; kemb by 4-byte copies that land transposed, [c][i][j]);
//     PB gives each warp an item and doubles while the grid keeps
//     kTargetBlocks (about two per SM); where the tables are large (spans
//     over 16 with positions) a block has 16 warps (8 at gp 16), so that
//     each staged table row serves more pairs and the grid restages the
//     tables fewer times; an epilogue that asks for it (kFillGrid) halves
//     the warps, down to 4, while the grid would leave more than half the
//     SMs without a block (kMinBlocks), where restaging costs less than
//     the idle SMs;
//   * every shared-memory layout is strided by the span bucket LB (rows of
//     fewer keys are zero-filled), so all its index arithmetic is
//     compile-time; a table row's stride is 4 VW floats past a multiple of
//     32, so the vector loads of a warp's rows fall in distinct banks;
//   * the logits take log2(e) into the scales, drop the per-group shifts
//     a1, a3, a5 (constant over the keys, so the softmax does not see them)
//     and take exp2 as one MUFU.EX2: exact for a softmax, so both epilogues
//     take it; the train backward recomputes the softmax its own way, so
//     the forward saves no m or l;
//   * no tensor cores: contraction depths c <= 8 are far too shallow.
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; launch_stripe_fwd returns cudaGetLastError().
//
// An epilogue Epi provides:
//   struct Params;                    the kernel's extra argument
//   static constexpr int kAffinePerPlane;
//       floats per group plane staged after the 8 similarity affines
//   static constexpr bool kFillGrid;
//       whether a small grid takes blocks of fewer warps (kMinBlocks)
//   static const float* affine(const Params&, int gi, int GP, int t);
//       the source of that staged float t (0 <= t < kAffinePerPlane * GP)
//   template <int GP, bool HAS_POS, int NP> static void store(
//       const Params&, const float* aff, size_t off, int L, int p0,
//       const float (&acc_v)[GP], const float (&acc_e)[GP], float inv_l);
//       writes planes p0 .. p0 + NP of one query row: acc_v[t] and
//       acc_e[t] (t < NP) are plane p0 + t's unnormalised sums, aff the
//       pair's staged affines past the first 8, and off = ((s * g + gi) *
//       GP) * L + i indexes a dense (S, g, GP, L) output at plane 0.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"

// Each source that includes this gets its own copy (anonymous namespace):
// the sources link into one library.
namespace medt {
namespace {

constexpr int kMaxSpan = 64;
constexpr int kKeyLanes = 4;               // lanes sharing a query row
constexpr int kRowsPerWarp = 32 / kKeyLanes;
constexpr int kMaxRows = 16;               // query rows per block, at most
constexpr int kTableBytes = 48 * 1024;     // table rows per block, at most
// the grid's blocks, at least, while a larger tile keeps to it: about two
// per SM on the H100's 132
constexpr int kTargetBlocks = 264;
// below this many blocks (half the H100's SMs) a kFillGrid epilogue halves
// its warps per block. On an H100 (700 W) the train forward at (span, gp,
// stripes) = (32, 4, 32) took 3.2 us with 128 blocks of 8 warps and 3.7
// with 64 of 16, while (64, 4, 64) took 7.6 with 128 blocks of 16 warps
// and 8.1 with 256 of 8: more blocks restage the tables more often
constexpr int kMinBlocks = 66;
constexpr int kMinWarps = 4;
constexpr int kMaxItems = 8;               // (pair, row group) items a warp
constexpr size_t kMaxSmemBytes = 227 * 1024;  // a block's, on the H100

// Query rows per block: the bucket up to kMaxRows, halved while the
// tables' rows (2c + gp of them, Lp floats each) would take more than
// kTableBytes.
constexpr int table_rows(int tables, int LB, int Lp) {
  int rb = LB < kMaxRows ? LB : kMaxRows;
  while (tables > 0 && rb > kRowsPerWarp &&
         4 * tables * rb * Lp > kTableBytes) {
    rb /= 2;
  }
  return rb;
}

// Warps per block at most: 16 where the staged tables are large (spans
// over 16 with positions), so that more pairs share each staged table row
// (8 at gp 16, whose pairs are twice as large); else 4.
constexpr int wide_warps(int GP, bool HAS_POS, int LB) {
  return HAS_POS && LB >= 32 ? (GP <= 8 ? 16 : 8) : kMinWarps;
}

// The compile-time layout of one instance: span bucket LB, NW warps.
template <class Epi, int GP, bool HAS_POS, int LB, int NW_>
struct Tile {
  static constexpr int C = GP / 2;
  static constexpr int NK = LB / kKeyLanes;           // keys per lane
  static constexpr int VW = NK < 4 ? NK : 4;          // keys per vector
  // table row stride: 4 VW floats past a multiple of 32
  static constexpr int Lp = (LB + 31) / 32 * 32 + 4 * VW;
  static constexpr int PS = 2 * GP * LB + 4;          // a staged pair
  static constexpr int AF = 8 + Epi::kAffinePerPlane * GP;  // its affines
  static constexpr int RB =                           // query rows a block
      table_rows(HAS_POS ? 2 * C + GP : 0, LB, Lp);
  // pairs per lane: with positions each table vector read serves PL pairs
  static constexpr int PL = HAS_POS && LB == 64 && GP <= 8 ? 2 : 1;
  static constexpr int NW = NW_;                      // warps per block
  static constexpr int TQ = HAS_POS ? C * RB * Lp : 0;   // t_q, t_k floats
  static constexpr int TV = HAS_POS ? GP * RB * Lp : 0;  // t_v floats
  static size_t smem_floats(int PB) {
    return (size_t)PB * (PS + AF) + 2 * TQ + TV;
  }
};

struct StripeArgs {
  const float* q;        // (S, g, c, L), strides q_ss, q_sg
  const float* k;        // (S, g, c, L), strides k_ss, k_sg
  const float* v;        // (S, g, gp, L), strides v_ss, v_sg
  const float* qemb;     // (c, L, L) [c, i, j]
  const float* kemb;     // (c, L, L) [c, j, i]
  const float* vemb;     // (gp, L, L) [p, i, j]
  const float* sim_aff;  // (g, 8)
  long long q_ss, q_sg, k_ss, k_sg, v_ss, v_sg;
  int S, g, L;
  int PB;                // (stripe, group) pairs per block
  bool vec;              // 16-byte copies of q, k, v
  bool tvec;             // 16-byte copies of qemb and vemb
};

// Sums a[N] (and b[N] when TWO) over the lanes of a key-lane group (lanes
// that differ in the bits below 2 * OFF): level by level, from the largest
// offset, each lane keeps one half of its planes and adds its partner's
// copy of that half, until one plane is left, then sums that plane over
// the remaining levels. Returns the first plane this lane holds, in a[0]
// (and the next ones in a[1] ...).
template <int N, int OFF, bool TWO>
struct Scatter {
  __device__ __forceinline__ static int run(float* a, float* b, int kl) {
    if constexpr (OFF == 0) {
      return 0;
    } else if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool upper = (kl & OFF) != 0;
#pragma unroll
      for (int t = 0; t < H; ++t) {
        const float send = upper ? a[t] : a[t + H];
        const float keep = upper ? a[t + H] : a[t];
        a[t] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
        if constexpr (TWO) {
          const float send_b = upper ? b[t] : b[t + H];
          const float keep_b = upper ? b[t + H] : b[t];
          b[t] = keep_b + __shfl_xor_sync(0xffffffffu, send_b, OFF);
        }
      }
      return (upper ? H : 0) + Scatter<H, OFF / 2, TWO>::run(a, b, kl);
    } else {
      a[0] += __shfl_xor_sync(0xffffffffu, a[0], OFF);
      if constexpr (TWO) b[0] += __shfl_xor_sync(0xffffffffu, b[0], OFF);
      return Scatter<1, OFF / 2, TWO>::run(a, b, kl);
    }
  }
};

template <class Epi, int GP, bool HAS_POS, int LB, int NW_>
__global__ void __launch_bounds__(NW_ * 32)
stripe_attn_fwd_kernel(StripeArgs x, typename Epi::Params ep) {
  using T = Tile<Epi, GP, HAS_POS, LB, NW_>;
  constexpr int C = T::C, NK = T::NK, VW = T::VW, Lp = T::Lp, PS = T::PS;
  constexpr int AF = T::AF, RB = T::RB, PL = T::PL, NW = T::NW;
  constexpr int NT = NW * 32, RW = kRowsPerWarp;
  constexpr int CL = C * LB, GL = GP * LB;     // k and v in a staged pair
  constexpr int X4 = LB / 4;                   // 16-byte chunks of a row
  constexpr int NP = GP >= kKeyLanes ? GP / kKeyLanes : 1;  // planes a lane
  constexpr int DUP = GP >= kKeyLanes ? 1 : kKeyLanes / GP;
  extern __shared__ __align__(16) float smem[];
  const int L = x.L, PB = x.PB, g = x.g;
  float* s_pair = smem;                        // [PB][PS]: q, k, v rows
  float* s_aff = s_pair + PB * PS;             // [PB][AF]
  float* t_q = s_aff + PB * AF;                // [C][RB][Lp]
  float* t_k = t_q + T::TQ;                    // [C][RB][Lp], [c][i][j]
  float* t_v = t_k + T::TQ;                    // [GP][RB][Lp]

  const int npairs = x.S * g;
  const int pr0 = blockIdx.x * PB;
  const int i0 = blockIdx.y * RB;
  const int tid = threadIdx.x;

  // The pairs' rows, q [C], k [C] and v [GP], L floats each (of (s, gi) =
  // pair / g, % g), lie at LB floats in the slab, zero-filled past L;
  // 16-byte chunks, or 4-byte copies of their floats.
  for (int e = tid; e < PB * 2 * GP * X4; e += NT) {
    const int run = e / X4, xo = (e - run * X4) * 4;
    const int pb = run / (2 * GP), row = run - pb * 2 * GP, pr = pr0 + pb;
    const bool ok = pr < npairs && xo < L;
    const int s = pr / g, gi = pr - s * g;
    const float* src =
        row < C ? x.q + s * x.q_ss + gi * x.q_sg + row * L
        : row < GP ? x.k + s * x.k_ss + gi * x.k_sg + (row - C) * L
                   : x.v + s * x.v_ss + gi * x.v_sg + (row - GP) * L;
    float* dst = s_pair + pb * PS + row * LB + xo;
    if (x.vec) {
      flash2::cp_async16(dst, ok ? src + xo : x.q, ok);
    } else {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const bool okw = ok && xo + w < L;
        flash2::cp_async4(dst + w, okw ? src + xo + w : x.q, okw);
      }
    }
  }
  // the affines of each pair's group: [8 sim][the epilogue's]
  for (int e = tid; e < PB * AF; e += NT) {
    const int pb = e / AF, t = e - pb * AF, gi = (pr0 + pb) % g;
    flash2::cp_async4(s_aff + e, t < 8 ? x.sim_aff + gi * 8 + t
                                       : Epi::affine(ep, gi, GP, t - 8),
                      true);
  }
  if constexpr (HAS_POS) {
    // the table rows i0 .. i0 + RB of qemb [c, i, j] and vemb [p, i, j]:
    // runs (row, i) of L floats, j contiguous, landing at [row][il][j] in
    // t_q (rows c) and t_v (rows C + p)
    for (int e = tid; e < (C + GP) * RB * X4; e += NT) {
      const int run = e / X4, xo = (e - run * X4) * 4;
      const int row = run / RB, il = run - row * RB, i = i0 + il;
      const bool ok = i < L && xo < L;
      const float* tab = row < C ? x.qemb : x.vemb;
      const int tr = row < C ? row : row - C;
      const float* src = tab + ((size_t)tr * L + i) * L + xo;
      float* dst = (row < C ? t_q : t_v) + (tr * RB + il) * Lp + xo;
      if (x.tvec) {
        flash2::cp_async16(dst, ok ? src : tab, ok);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const bool okw = ok && xo + w < L;
          flash2::cp_async4(dst + w, okw ? src + w : tab, okw);
        }
      }
    }
    // kemb[c, j, i], read with i minor (coalesced), landing transposed at
    // [c][il][j]: 4-byte copies, each to its own address
    for (int e = tid; e < C * LB * RB; e += NT) {
      const int il = e % RB, cj = e / RB, j = cj % LB, c = cj / LB;
      const int i = i0 + il;
      const bool ok = j < L && i < L;
      flash2::cp_async4(t_k + (c * RB + il) * Lp + j,
                        ok ? x.kemb + ((size_t)c * L + j) * L + i : x.kemb,
                        ok);
    }
  }
  flash2::cp_async_commit();
  flash2::cp_async_wait<0>();
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int r = lane / kKeyLanes, kl = lane - r * kKeyLanes;
  // an item: RW query rows of PL pairs; rows fastest
  const int items = (RB * ((PB + PL - 1) / PL) + RW - 1) / RW;
  // every lane of a warp runs each item to its end (the shuffles need all
  // 32); lanes past the edge compute on clamped rows and do not write
  for (int item = warp; item < items; item += NW) {
    const int rs = item * RW + r;                 // (pair group, row)
    const int pg = rs / RB, il = rs - pg * RB, i = i0 + il;
    const int ilc = i < L ? il : 0;
    const float* tq = t_q + ilc * Lp;             // + c * RB * Lp + j
    const float* tk = t_k + ilc * Lp;
    const float* tv = t_v + ilc * Lp;             // + p * RB * Lp + j

    bool valid[PL];
    const float* ps[PL];                          // q, then k at CL, v at GL
    const float* a[PL];
    float qs[PL][C], qe[PL][C], sk[PL];
#pragma unroll
    for (int w = 0; w < PL; ++w) {
      const int pb = pg * PL + w;
      valid[w] = pb < PB && pr0 + pb < npairs && i < L;
      const int pbc = valid[w] ? pb : 0;
      ps[w] = s_pair + pbc * PS;
      a[w] = s_aff + pbc * AF;
      const float sq = a[w][0] * flash2::kLog2e;
      const float se = HAS_POS ? a[w][2] * flash2::kLog2e : 0.f;
      sk[w] = HAS_POS ? a[w][4] * flash2::kLog2e : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float qv = ps[w][c * LB + i0 + ilc];
        qs[w][c] = qv * sq;
        qe[w][c] = qv * se;
      }
    }

    // logits (log2 units, shifts dropped) of this lane's keys: runs of VW
    // keys, j = VW * (kl + kKeyLanes * t) + v; each table vector serves
    // the PL pairs
    float lg[PL][NK], mx[PL];
#pragma unroll
    for (int w = 0; w < PL; ++w) mx[w] = -1e30f;
#pragma unroll
    for (int t = 0; t < NK / VW; ++t) {
      const int j0 = VW * (kl + kKeyLanes * t);
      float qk[PL][VW], qr[PL][VW], kr[PL][VW];
#pragma unroll
      for (int w = 0; w < PL; ++w) {
#pragma unroll
        for (int v = 0; v < VW; ++v) qk[w][v] = qr[w][v] = kr[w][v] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float eq[VW], ek[VW];
        if constexpr (HAS_POS) {
          flash2::lds<VW>(eq, tq + c * RB * Lp + j0);
          flash2::lds<VW>(ek, tk + c * RB * Lp + j0);
        }
#pragma unroll
        for (int w = 0; w < PL; ++w) {
          float kv[VW];
          flash2::lds<VW>(kv, ps[w] + CL + c * LB + j0);
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            qk[w][v] += qs[w][c] * kv[v];
            if constexpr (HAS_POS) {
              qr[w][v] += qe[w][c] * eq[v];
              kr[w][v] += kv[v] * ek[v];
            }
          }
        }
      }
#pragma unroll
      for (int w = 0; w < PL; ++w) {
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          float xl = qk[w][v];
          if constexpr (HAS_POS) xl += qr[w][v] + kr[w][v] * sk[w];
          xl = j0 + v < L ? xl : -1e30f;
          lg[w][t * VW + v] = xl;
          mx[w] = fmaxf(mx[w], xl);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < PL; ++w) {
#pragma unroll
      for (int o = kKeyLanes / 2; o > 0; o >>= 1) {
        mx[w] = fmaxf(mx[w], __shfl_xor_sync(0xffffffffu, mx[w], o));
      }
    }

    float l[PL], acc_v[PL][GP], acc_e[PL][GP];
#pragma unroll
    for (int w = 0; w < PL; ++w) {
      l[w] = 0.f;
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        acc_v[w][p] = 0.f;
        acc_e[w][p] = 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < NK / VW; ++t) {
      const int j0 = VW * (kl + kKeyLanes * t);
      float e[PL][VW];
#pragma unroll
      for (int w = 0; w < PL; ++w) {
#pragma unroll
        for (int v = 0; v < VW; ++v) {
          e[w][v] = j0 + v < L ? flash2::ex2(lg[w][t * VW + v] - mx[w])
                               : 0.f;
          l[w] += e[w][v];
        }
      }
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        float ev[VW];
        if constexpr (HAS_POS) flash2::lds<VW>(ev, tv + p * RB * Lp + j0);
#pragma unroll
        for (int w = 0; w < PL; ++w) {
          float vv[VW];
          flash2::lds<VW>(vv, ps[w] + GL + p * LB + j0);
#pragma unroll
          for (int v = 0; v < VW; ++v) {
            acc_v[w][p] += e[w][v] * vv[v];
            if constexpr (HAS_POS) acc_e[w][p] += e[w][v] * ev[v];
          }
        }
      }
    }

#pragma unroll
    for (int w = 0; w < PL; ++w) {
#pragma unroll
      for (int o = kKeyLanes / 2; o > 0; o >>= 1) {
        l[w] += __shfl_xor_sync(0xffffffffu, l[w], o);
      }
      const int p0 =
          Scatter<GP, kKeyLanes / 2, HAS_POS>::run(acc_v[w], acc_e[w], kl);
      if (valid[w] && kl % DUP == 0) {
        const int pr = pr0 + pg * PL + w, s = pr / g, gi = pr - s * g;
        const size_t off = ((size_t)s * g + gi) * GP * L + i;
        Epi::template store<GP, HAS_POS, NP>(ep, a[w] + 8, off, L, p0,
                                             acc_v[w], acc_e[w],
                                             1.f / l[w]);
      }
    }
  }
}

// Pairs per block of an instance T: one item per warp, doubled while the
// grid keeps kTargetBlocks.
template <class T>
int pairs_per_block(long long npairs, long long chunks) {
  const int per_item = kRowsPerWarp * T::PL;  // (pair, row) of an item
  int PB = T::PL * ((T::NW * per_item + T::RB * T::PL - 1) /
                    (T::RB * T::PL));
  while (PB * T::RB < kMaxItems * T::NW * per_item &&
         chunks * ((npairs + 2 * PB - 1) / (2 * PB)) >= kTargetBlocks &&
         sizeof(float) * T::smem_floats(2 * PB) <= kMaxSmemBytes) {
    PB *= 2;
  }
  return PB;
}

template <class Epi, int GP, bool HAS_POS, int LB,
          int NW = wide_warps(GP, HAS_POS, LB)>
int launch(StripeArgs x, const typename Epi::Params& ep,
           cudaStream_t stream) {
  using T = Tile<Epi, GP, HAS_POS, LB, NW>;
  const long long npairs = (long long)x.S * x.g;
  const long long chunks = (x.L + T::RB - 1) / T::RB;
  const int PB = pairs_per_block<T>(npairs, chunks);
  const long long blocks = (npairs + PB - 1) / PB;
  if constexpr (Epi::kFillGrid && NW > kMinWarps) {
    if (blocks * chunks < kMinBlocks) {
      return launch<Epi, GP, HAS_POS, LB, NW / 2>(x, ep, stream);
    }
  }
  x.PB = PB;
  const size_t bytes = sizeof(float) * T::smem_floats(PB);
  auto kernel = stripe_attn_fwd_kernel<Epi, GP, HAS_POS, LB, NW>;
  const cudaError_t err = flash2::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)blocks, (unsigned)chunks);
  kernel<<<grid, NW * 32, bytes, stream>>>(x, ep);
  return (int)cudaGetLastError();
}

template <class Epi, int GP, bool HAS_POS>
int launch_span(const StripeArgs& x, const typename Epi::Params& ep,
                cudaStream_t stream) {
  if (x.L <= 4) return launch<Epi, GP, HAS_POS, 4>(x, ep, stream);
  if (x.L <= 8) return launch<Epi, GP, HAS_POS, 8>(x, ep, stream);
  if (x.L <= 16) return launch<Epi, GP, HAS_POS, 16>(x, ep, stream);
  if (x.L <= 32) return launch<Epi, GP, HAS_POS, 32>(x, ep, stream);
  return launch<Epi, GP, HAS_POS, kMaxSpan>(x, ep, stream);
}

template <class Epi, bool HAS_POS>
int launch_gp(int gp, const StripeArgs& x, const typename Epi::Params& ep,
              cudaStream_t stream) {
  switch (gp) {
    case 2: return launch_span<Epi, 2, HAS_POS>(x, ep, stream);
    case 4: return launch_span<Epi, 4, HAS_POS>(x, ep, stream);
    case 8: return launch_span<Epi, 8, HAS_POS>(x, ep, stream);
    case 16: return launch_span<Epi, 16, HAS_POS>(x, ep, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Checks the geometry, picks the copy widths and launches the instance for
// (gp, L, has_pos); x.PB, x.vec and x.tvec are set here.
template <class Epi>
int launch_stripe_fwd(StripeArgs x, int gp, int has_pos,
                      const typename Epi::Params& ep, void* stream_ptr) {
  if (x.S < 1 || x.g < 1 || x.g > 65535 || x.L < 1 || x.L > kMaxSpan) {
    return (int)cudaErrorInvalidValue;
  }
  x.vec = x.L % 4 == 0 && flash2::aligned16(x.q) &&
          flash2::aligned16(x.k) && flash2::aligned16(x.v) &&
          (x.q_ss | x.q_sg | x.k_ss | x.k_sg | x.v_ss | x.v_sg) % 4 == 0;
  x.tvec = x.L % 4 == 0 && flash2::aligned16(x.qemb) &&
           flash2::aligned16(x.vemb);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (has_pos) return launch_gp<Epi, true>(gp, x, ep, stream);
  return launch_gp<Epi, false>(gp, x, ep, stream);
}

}  // namespace
}  // namespace medt
