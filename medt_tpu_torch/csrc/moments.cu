// Similarity-BN batch moments of the train-mode attention, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of medt_tpu/ops/pallas_moments.py:
//   * moment_sums_core forward (body _moments_kernel);
//   * its backward _sums_bwd_rule (body _moments_bwd_kernel).
// On the q/k rows of the fused qkv (g, 2gp, L, S) (c = gp/2; the v rows are
// never read) it sums, per group, the first and second raw moments of the
// three logit terms over every (query, key, stripe):
//   s1_qk = sum_s sum_c qs[c,s] ks[c,s],       qs = sum_l q[c,l,s]
//   s2_qk = sum_s sum_cd qq[c,d,s] kk[c,d,s],  qq = sum_l q[c,l,s] q[d,l,s]
//   s1_qr = sum q[c,l,s] r_q[c,l],   s2_qr = sum q[c,l,s] q[d,l,s] e_q[c,d,l]
//   s1_kr, s2_kr the same on k with r_k, e_k
// into a (g, 8) row [s1_qk, s2_qk, s1_qr, s2_qr, s1_kr, s2_kr, 0, 0]
// (tables r (c, L) and e (c, c, L); zero-size without positions). The
// backward takes the cotangent ct (g, 8) and writes the fused dqkv (v rows
// zero) and the table gradients, summed over groups and stripes:
//   dq[c,l,s] = ct0 ks[c] + 2 ct1 sum_d kk[c,d] q[d] + ct2 r_q[c,l]
//               + ct3 sum_d (e_q[c,d,l] + e_q[d,c,l]) q[d]
//   dr_q[c,l] = sum ct2 q[c,l,s],  de_q[c,d,l] = sum ct3 q[c,l,s] q[d,l,s]
// (dk, dr_k, de_k the same with ct4, ct5 on k). The e tables are symmetric
// where the attention builds them; the (e + e^T) form is the exact gradient
// of the forward for any e.
//
// What bounds it on the H100: device memory. Each q/k element is read once
// for ~c^2 operations, far below the card's 20 float32 operations per byte;
// the backward also writes every dqkv element once (three times the
// forward's bytes). The TPU kernel's resident (g, 8) block becomes a
// deterministic two-level reduction: per-block partials summed in a fixed
// order by a second launch. Design:
//   * forward (moments_fwd_kernel below), and its finalize. The first CUDA
//     design (PR 5) ran one thread per (group, stripe), g * ceil(S/128)
//     blocks of 128 threads, each thread walking all L rows with dependent
//     loads and the r and e tables read from L2 inside its row loop: 64
//     blocks for 132 SMs at the (256, 4, 1024) medt_512 site, 13.5 times
//     its bound there, and 0.59 ms of device time per medt_512 batch-4 step
//     (22 launches, bound 0.093 ms) on an H100 80GB HBM3 at 700 W. Now a
//     block owns 32 stripes (g * ceil(S/32) blocks, 128 or more at every
//     path site), stages their q/k slab in shared memory once, and spreads
//     the sums of a stripe over its eight warps, a q-side sum and its
//     k-side twin a warp; the tables are staged too. Every sum keeps the
//     first design's order and rounding, per stripe and across stripes, so
//     the forward gives its bits (compare_kernels.py's out_sha256 at every
//     path geometry). The backward's tile, whose rows are spread over
//     threads and combined by shuffles, ran in 0.165 ms per medt_512 step
//     on the same card, but its sums, as accurate, moved the MedT-128
//     batch-16 train step on the kernels 2.8 times beyond the smoke's
//     parity bound against plain cores (PERF.md, PR 12): the order costs
//     the long spans their parallelism, as each stripe's sum is one chain;
//   * backward, one launch (moments_bwd_kernel below), and with positions
//     a fixed-order finalize (tab_finalize_kernel). The first CUDA design
//     made three launches a call: a stats pass of g * ceil(S/128) blocks (64 at
//     g = 8, S = 1024, for 132 SMs) whose threads walked all L rows with
//     dependent loads, an element pass that reloaded the per-stripe sums
//     from device memory for every element and read q and k a second time,
//     and a partial sum; 1.377 ms per MedT-128 batch-16 step (22 launches)
//     on an H100 80GB HBM3 at 700 W, 20 times its bound. Now a block owns
//     one group and a tile of stripes sized by the span (at least 132
//     blocks at every path site), stages the tile's q/k slab in shared
//     memory once by cp.async, forms the per-stripe sums from it, writes
//     dq, dk and the zero v rows, and with positions sums its stripes' table
//     terms into one slot of the partials. Measured on the same card
//     (PERF.md, kernel row 8): 0.38 ms of device time per medt_512 step,
//     1.37 times its 0.278 ms bound (1.09-1.77 times at the sites whose
//     bound is at least 10 us), and 0.116 ms per MedT-128 step.
// qkv (and the backward's dqkv) are float32 or bf16 (the element type T of
// the templates): the q/k slab is staged raw and converted where it is
// read, and each dqkv value is rounded once where it is stored, so a bf16
// qkv gives the float32 kernels' sums and table gradients on its upcast,
// bit for bit, and their dqkv rounded once.
// At the wide widths, every even gp up to 128 outside 2, 4, 8 and 16 (the
// axial-attention classifiers' sites at gp 12 to 128; c = 6 to 64), the
// per-stripe sums above no longer fit: the c(c+1)/2 pair sums of a stripe
// (528 at c = 32) and the staged slab and tables pass a block's shared
// memory. There the entry points take kernels of their own
// (csrc/moments_wide.cu, whose header says how), on float32 or bf16 qkv
// alike, under this file's finalizes: the forward
// (moments_wide_fwd_kernel, the factored sums over a staged q/k slab) with
// one partial slot per block of its tile (moments_wide.cuh:
// wide_fwd_tile); the backward
// (moments_wide_dqk_kernel, then with positions moments_wide_tab_kernel)
// with its own tile and table-partial slots
// (moments_wide.cuh: wide_dqk_tile, wide_dqk_rows, wide_bwd_slots), at
// spans up to kMaxBwdSpan (256), as the narrow widths.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"
#include "moments_wide.cuh"
#include "reduce.cuh"

namespace {

using flash2::from_f32;
using flash2::to_f32;
using medt::warp_sum;

__host__ __device__ constexpr int pairs(int C) { return C * (C + 1) / 2; }

// index of (min(c, d), max(c, d)) in the row-major upper triangle
__host__ __device__ constexpr int pair_index(int c, int d, int C) {
  return c <= d ? c * C - c * (c - 1) / 2 + (d - c)
                : d * C - d * (d - 1) / 2 + (c - d);
}

// (c, d) of the t-th pair of the row-major upper triangle
template <int C>
__device__ __forceinline__ void pair_of(int t, int& c, int& d) {
  c = 0;
  while (t >= C - c) {
    t -= C - c;
    ++c;
  }
  d = c + t;
}

// The forward's tile (the wrapper mirrors these: ops/moments.py,
// FWD_STRIPES): a block of kFwdThreads threads owns one group and
// kFwdStripes stripes, the lanes of a warp; the finalize adds its tiles'
// partials kFwdGroupTiles at a time, then the groups in order, as the
// first design added its warps within a block of 128 stripes, then its
// blocks.
constexpr int kFwdStripes = 32;
constexpr int kFwdThreads = 256;
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdGroupTiles = 4;
// the largest q/k slab (2c rows x L x kFwdStripes elements) the forward
// stages in shared memory; past it the items read device memory
constexpr int kFwdSlabFloats = 32768;

template <class T>
struct MomFwdArgs {
  const T* qkv;
  const float* r_q;
  const float* e_q;
  const float* r_k;
  const float* e_k;
  float* part;     // (g * tiles, 6) tile partials
  int L, S;
  bool slab;       // stage the tile's q/k slab in shared memory
  bool vec;        // with 16-byte copies along the stripe axis
};

// The forward's shared memory, in bytes: the q/k slab (of T) when staged,
// the tables when staged (TAB: r_q, the symmetrised e_q pairs, r_k, the
// e_k pairs, 2c + 2 pairs(c) rows of L) and each item's per-stripe sum.
template <int C, bool HAS_POS, bool TAB, class T>
constexpr size_t fwd_smem_bytes(int L, bool slab) {
  constexpr int T1 = 2 * C + 2 * pairs(C);
  return (slab ? (size_t)2 * C * L * kFwdStripes * sizeof(T) : 0) +
         ((TAB ? (size_t)T1 * L : 0) +
          (size_t)(T1 + (HAS_POS ? 4 : 0)) * kFwdStripes) *
             sizeof(float);
}

// One launch per call, then moments_finalize. The block stages its tile's
// q/k slab in shared memory by cp.async (16-byte copies where S % 4 == 0),
// each element read once from device memory; a slab over kFwdSlabFloats
// (gp * L over 1024, off every path) is read from device memory by the
// items instead. Each of the block's items is one per-stripe sum over the
// span, taken by one warp (lane = stripe) in row order: qs[c], ks[c] (c
// each), qq[c,d], kk[c,d] (the pairs c <= d) and, with positions, the
// table terms s1_qr, s2_qr, s1_kr, s2_kr; the items run on all eight
// warps, each warp a q-side sum and its k-side twin at once. Then warp 0
// forms each stripe's s1_qk, s2_qk, and warp_sum gives the tile's partial
// of six. Every sum, per stripe and across stripes, is taken in the first
// design's order and rounding, so the forward gives its bits: the train
// step on the kernels is held to plain cores within a bound set by float32
// spread, and other orders of the same accuracy moved a MedT-128 batch-16
// step beyond it (up to 2.8 times, PERF.md). With TAB the tables are
// staged in shared memory, the e tables as their symmetrised pairs e[c,d]
// + e[d,c] (c < d) and e[c,c].
template <int C, bool HAS_POS, bool TAB, class T>
__global__ void __launch_bounds__(kFwdThreads)
moments_fwd_kernel(MomFwdArgs<T> a) {
  constexpr int P = pairs(C);
  constexpr int T1 = 2 * C + 2 * P;
  static_assert(HAS_POS || !TAB, "tables only with positions");
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, S = a.S, gi = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kFwdStripes + lane;
  const bool valid = s < S;
  const size_t LS = (size_t)L * S;
  T* slab = reinterpret_cast<T*>(smem);       // (2c, L, kFwdStripes)
  float* tabs =
      reinterpret_cast<float*>(slab + (a.slab ? 2 * C * L * kFwdStripes : 0));
  float* sums = tabs + (TAB ? T1 * L : 0);    // (T1 + 4, kFwdStripes)
  // A stripe past the edge reads zeros: every sum gets 0 from it.
  const T* tile = a.qkv + (size_t)gi * 4 * C * LS;
  if (a.slab) {
    flash2::stage_runs<kFwdStripes, kFwdThreads>(
        slab, tile + blockIdx.x * kFwdStripes, S, 2 * C * L,
        S - blockIdx.x * kFwdStripes, a.vec, threadIdx.x);
    flash2::cp_async_commit();
  }
  auto at = [&](int row, int l) {
    return a.slab ? to_f32(slab[(row * L + l) * kFwdStripes + lane])
                  : (valid ? to_f32(__ldg(tile + row * LS + (size_t)l * S + s))
                           : 0.f);
  };

  if constexpr (TAB) {
    for (int e = threadIdx.x; e < T1 * L; e += kFwdThreads) {
      const int row = e / L, l = e - row * L;
      const bool on_k = row >= C + P;
      const int rk = on_k ? row - (C + P) : row;  // within q's or k's rows
      float v;
      if (rk < C) {
        v = __ldg((on_k ? a.r_k : a.r_q) + rk * L + l);
      } else {
        const float* x = on_k ? a.e_k : a.e_q;
        int c, d;
        pair_of<C>(rk - C, c, d);
        v = d == c ? __ldg(x + (c * C + d) * L + l)
                   : __ldg(x + (c * C + d) * L + l) +
                         __ldg(x + (d * C + c) * L + l);
      }
      tabs[e] = v;
    }
  }
  flash2::cp_async_wait<0>();
  __syncthreads();
  // r[c, l] and the symmetrised e pair t at row l, of q's (K = 0) or k's
  // (K = 1) tables
  auto r_at = [&](int K, int c, int l) {
    if constexpr (TAB) return tabs[(K * (C + P) + c) * L + l];
    return __ldg((K ? a.r_k : a.r_q) + c * L + l);
  };
  auto e_at = [&](int K, int t, int c, int d, int l) {
    if constexpr (TAB) return tabs[(K * (C + P) + C + t) * L + l];
    const float* x = K ? a.e_k : a.e_q;
    const size_t cd = ((size_t)c * C + d) * L + l;
    const size_t dc = ((size_t)d * C + c) * L + l;
    return d == c ? __ldg(x + cd) : __ldg(x + cd) + __ldg(x + dc);
  };

  // Each warp takes a q-side sum and its k-side twin together, two
  // independent chains; the longest (the table terms) go first.
  // Pair j: j < 2 with positions: (s2_qr, s2_kr), (s1_qr, s1_kr); then
  // the pairs (qq[t], kk[t]); then (qs[c], ks[c]).
  constexpr int NT = HAS_POS ? 2 : 0;  // table pairs
  for (int j = warp; j < NT + P + C; j += kFwdWarps) {
    float acc[2] = {0.f, 0.f};
    int slot[2];                       // items of the two sums
    if (j < NT) {
      const bool second = j == 0;      // s2 (pairs) before s1
      slot[0] = T1 + (second ? 1 : 0);
      slot[1] = T1 + (second ? 3 : 2);
      if (second) {
        for (int l = 0; l < L; ++l) {
#pragma unroll
          for (int K = 0; K < 2; ++K) {
            float x[C];
#pragma unroll
            for (int c = 0; c < C; ++c) x[c] = at(K * C + c, l);
            int t = 0;
#pragma unroll
            for (int c = 0; c < C; ++c) {
#pragma unroll
              for (int d = c; d < C; ++d, ++t) {
                const float w = x[c] * x[d];
                acc[K] += w * e_at(K, t, c, d, l);
              }
            }
          }
        }
      } else {
        for (int l = 0; l < L; ++l) {
#pragma unroll
          for (int K = 0; K < 2; ++K) {
#pragma unroll
            for (int c = 0; c < C; ++c)
              acc[K] += at(K * C + c, l) * r_at(K, c, l);
          }
        }
      }
    } else if (j < NT + P) {           // qq[c, d], kk[c, d]
      const int t = j - NT;
      int c, d;
      pair_of<C>(t, c, d);
      slot[0] = 2 * C + t;
      slot[1] = 2 * C + P + t;
#pragma unroll 8
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int K = 0; K < 2; ++K) {
          // with positions the first design shared the rounded product
          // with s2_qr, so it added it rounded; without, it fused the two
          const float x = at(K * C + c, l), y = at(K * C + d, l);
          acc[K] = HAS_POS ? __fadd_rn(acc[K], __fmul_rn(x, y))
                           : fmaf(x, y, acc[K]);
        }
      }
    } else {                           // qs[c], ks[c]
      const int c = j - NT - P;
      slot[0] = c;
      slot[1] = C + c;
#pragma unroll 8
      for (int l = 0; l < L; ++l) {
        acc[0] += at(c, l);
        acc[1] += at(C + c, l);
      }
    }
    sums[slot[0] * kFwdStripes + lane] = acc[0];
    sums[slot[1] * kFwdStripes + lane] = acc[1];
  }
  __syncthreads();
  if (warp == 0) {
    const float* st = sums + lane;  // this stripe's item it at st[it * 32]
    float s1qk = 0.f, s2qk = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
      s1qk += st[c * kFwdStripes] * st[(C + c) * kFwdStripes];
    int t = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int d = c; d < C; ++d, ++t) {
        s2qk += (d == c ? 1.f : 2.f) * (st[(2 * C + t) * kFwdStripes] *
                                        st[(2 * C + P + t) * kFwdStripes]);
      }
    }
    float v[6] = {s1qk, s2qk, 0.f, 0.f, 0.f, 0.f};
    if constexpr (HAS_POS) {
#pragma unroll
      for (int k = 0; k < 4; ++k) v[2 + k] = st[(T1 + k) * kFwdStripes];
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float w = warp_sum(v[k]);
      if (lane == 0)
        a.part[((size_t)gi * gridDim.x + blockIdx.x) * 6 + k] = w;
    }
  }
}

// (g, 8) from the (g, tiles, 6) partials of the forward, columns 6, 7
// zero: a warp per (group, column); lane l adds the kFwdGroupTiles
// partials of groups l, l + 32, ... in order, then lane 0 adds the groups
// in order.
__global__ void __launch_bounds__(kFwdThreads)
moments_finalize_kernel(const float* __restrict__ part,
                        float* __restrict__ out, int tiles, int g) {
  const int w = (int)((blockIdx.x * kFwdThreads + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (w >= g * 8) return;
  const int gi = w / 8, col = w - gi * 8;
  const float* p = part + (size_t)gi * tiles * 6 + col;
  const int groups = (tiles + kFwdGroupTiles - 1) / kFwdGroupTiles;
  float v = 0.f;
  for (int g0 = 0; col < 6 && g0 < groups; g0 += 32) {
    const int b = g0 + lane;
    float vb = 0.f;
    if (b < groups) {
#pragma unroll
      for (int k = 0; k < kFwdGroupTiles; ++k) {
        const int t = b * kFwdGroupTiles + k;
        vb += t < tiles ? p[(size_t)t * 6] : 0.f;
      }
    }
    const int n = min(32, groups - g0);
    for (int i = 0; i < n; ++i) v += __shfl_sync(0xffffffffu, vb, i);
  }
  if (lane == 0) out[w] = v;
}

// The backward's tile (the wrapper mirrors these: ops/moments.py). A block
// of kBwdThreads threads owns one group and a tile of TS stripes, TS the
// largest of kMaxTile, ..., kMinTile whose q/k slab (2c rows x L x TS) fits
// kSlabFloats and whose grid has at least kMinBlocks blocks (one per SM of
// an H100); at kMinTile either may be exceeded.
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;
constexpr int kSlabFloats = 16384;
constexpr int kMinTile = 8;
constexpr int kMaxTile = 32;
constexpr int kMinBlocks = 132;
constexpr int kMaxBwdSpan = 256;

int bwd_tile(int c, int L, int S, int g) {
  int ts = kMaxTile;
  while (ts > kMinTile &&
         (2 * c * L * ts > kSlabFloats ||
          (long long)g * ((S + ts - 1) / ts) < kMinBlocks)) {
    ts /= 2;
  }
  return ts;
}

// With positions the r and e tables (2c + 2c^2 rows of L) are staged in
// shared memory beside the slab at c <= 4; at c = 8 (gp 16, off every
// path) they would not fit beside it at long spans and are read from L2.
template <int C, bool HAS_POS>
constexpr bool kStageTables = HAS_POS && C <= 4;

// The backward's shared memory, in bytes: the q/k slab (of T), the warp
// and tile sums, the tables when staged.
template <int C, int TS, bool HAS_POS, class T>
constexpr size_t bwd_smem_bytes(int L) {
  constexpr int T1 = 2 * C + 2 * pairs(C);
  constexpr int T2 = 2 * C + 2 * C * C;
  return (size_t)2 * C * L * TS * sizeof(T) +
         ((size_t)(kBwdWarps + 1) * T1 * TS +
          (kStageTables<C, HAS_POS> ? (size_t)T2 * L : 0)) *
             sizeof(float);
}

template <class T>
struct MomBwdArgs {
  const T* qkv;
  const float* r_q;
  const float* e_q;
  const float* r_k;
  const float* e_k;
  const float* ct;
  T* dqkv;
  float* part;   // (g * tiles, 2c + 2c^2, L) table-gradient partials
  int L, S;
  bool vec;      // 16-byte copies along the stripe axis
};

// One launch per call (and, with positions, tab_finalize after it).
// Thread t of a block works on stripe s = t % TS of the tile and rows
// l = t / TS, t / TS + NR, ... (NR = kBwdThreads / TS row groups):
//   1. stage the tile's q/k slab (2c rows x L x TS) in shared memory, and
//      the r and e tables (kStageTables);
//   2. the per-stripe sums qs, ks, qq, kk over the span: each thread over
//      its rows, then the lanes of a warp that share a stripe by shuffles,
//      then the warps in a fixed order;
//   3. dq, dk of every (row, stripe) of the tile from the slab and the
//      sums, and the zero v rows: each q/k element is read from device
//      memory once, each dqkv element written once;
//   4. with positions, the table-gradient partial of the tile, one value
//      per (table row, position): a thread sums the tile's TS stripes from
//      the slab, starting at a stripe rotated by the position so the lanes
//      of a warp read distinct banks; its slot of the partials is written
//      once, and tab_finalize sums the slots in index order.
template <int C, int TS, bool HAS_POS, class T>
__global__ void __launch_bounds__(kBwdThreads)
moments_bwd_kernel(MomBwdArgs<T> a) {
  constexpr int P = pairs(C);
  constexpr int T1 = 2 * C + 2 * P;       // qs, ks, qq, kk
  constexpr int T2 = 2 * C + 2 * C * C;   // dr_q, de_q, dr_k, de_k rows
  constexpr int NR = kBwdThreads / TS;
  static_assert(TS <= 32 && 32 % TS == 0, "whole stripe tiles per warp");
  extern __shared__ __align__(16) float smem[];
  const int L = a.L, S = a.S;
  const int gi = blockIdx.y, s0 = blockIdx.x * TS;
  const int tid = threadIdx.x, s = tid % TS, r = tid / TS;
  const int lane = tid & 31, warp = tid >> 5;
  const size_t LS = (size_t)L * S;
  T* slab = reinterpret_cast<T*>(smem);        // (2c, L, TS)
  float* wpart = reinterpret_cast<float*>(slab + 2 * C * L * TS);
                                               // (kBwdWarps, T1, TS)
  float* stats = wpart + kBwdWarps * T1 * TS;  // (T1, TS)
  float* tabs = stats + T1 * TS;               // r_q, e_q, r_k, e_k

  flash2::stage_runs<TS, kBwdThreads>(
      slab, a.qkv + (size_t)gi * 4 * C * LS + s0, S, 2 * C * L, S - s0,
      a.vec, tid);
  flash2::cp_async_commit();
  constexpr bool TAB = kStageTables<C, HAS_POS>;
  if constexpr (TAB) {
    const int cl = C * L, ccl = C * C * L;
    for (int e = tid; e < cl; e += kBwdThreads) {
      tabs[e] = __ldg(a.r_q + e);
      tabs[cl + ccl + e] = __ldg(a.r_k + e);
    }
    for (int e = tid; e < ccl; e += kBwdThreads) {
      tabs[cl + e] = __ldg(a.e_q + e);
      tabs[2 * cl + ccl + e] = __ldg(a.e_k + e);
    }
  }
  flash2::cp_async_wait<0>();
  __syncthreads();

  auto qk_at = [&](int l, float (&q)[C], float (&k)[C]) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      q[c] = to_f32(slab[(c * L + l) * TS + s]);
      k[c] = to_f32(slab[((C + c) * L + l) * TS + s]);
    }
  };

  {  // 2. per-stripe sums
    float acc[T1];
#pragma unroll
    for (int t = 0; t < T1; ++t) acc[t] = 0.f;
    for (int l = r; l < L; l += NR) {
      float q[C], k[C];
      qk_at(l, q, k);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        acc[c] += q[c];
        acc[C + c] += k[c];
      }
      int t = 2 * C;
#pragma unroll
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int d = c; d < C; ++d, ++t) {
          acc[t] += q[c] * q[d];
          acc[t + P] += k[c] * k[d];
        }
      }
    }
#pragma unroll
    for (int t = 0; t < T1; ++t) {
#pragma unroll
      for (int o = TS; o < 32; o <<= 1)
        acc[t] += __shfl_xor_sync(0xffffffffu, acc[t], o);
    }
    if (lane < TS) {
#pragma unroll
      for (int t = 0; t < T1; ++t) wpart[(warp * T1 + t) * TS + s] = acc[t];
    }
    __syncthreads();
    for (int e = tid; e < T1 * TS; e += kBwdThreads) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kBwdWarps; ++w) v += wpart[w * T1 * TS + e];
      stats[e] = v;
    }
    __syncthreads();
  }

  // 3. dq, dk and the zero v rows
  float st[T1];
#pragma unroll
  for (int t = 0; t < T1; ++t) st[t] = stats[t * TS + s];
  const float* cg = a.ct + gi * 8;
  const float c0 = cg[0], c1 = cg[1], c2 = cg[2], c3 = cg[3], c4 = cg[4],
              c5 = cg[5];
  const bool valid = s0 + s < S;
  T* out = a.dqkv + (size_t)gi * 4 * C * LS + s0 + s;
  const float* r_q = TAB ? tabs : a.r_q;
  const float* e_q = TAB ? tabs + C * L : a.e_q;
  const float* r_k = TAB ? tabs + (C + C * C) * L : a.r_k;
  const float* e_k = TAB ? tabs + (2 * C + C * C) * L : a.e_k;
  for (int l = r; valid && l < L; l += NR) {
    float q[C], k[C];
    qk_at(l, q, k);
    T* o = out + (size_t)l * S;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float aq = 0.f, ak = 0.f;
#pragma unroll
      for (int d = 0; d < C; ++d) {
        const int pd = pair_index(c, d, C);
        aq += st[2 * C + P + pd] * q[d];  // kk[c,d] q[d]
        ak += st[2 * C + pd] * k[d];      // qq[c,d] k[d]
      }
      float dq = c0 * st[C + c] + 2.f * c1 * aq;
      float dk = c0 * st[c] + 2.f * c1 * ak;
      if constexpr (HAS_POS) {
        float eq = 0.f, ek = 0.f;
#pragma unroll
        for (int d = 0; d < C; ++d) {
          const size_t cd = ((size_t)c * C + d) * L + l;
          const size_t dc = ((size_t)d * C + c) * L + l;
          eq += (e_q[cd] + e_q[dc]) * q[d];
          ek += (e_k[cd] + e_k[dc]) * k[d];
        }
        dq += c2 * r_q[c * L + l] + c3 * eq;
        dk += c4 * r_k[c * L + l] + c5 * ek;
      }
      o[c * LS] = from_f32<T>(dq);
      o[(C + c) * LS] = from_f32<T>(dk);
    }
#pragma unroll
    for (int p = 0; p < 2 * C; ++p)  // v rows
      o[(2 * C + p) * LS] = from_f32<T>(0.f);
  }

  if constexpr (HAS_POS) {
    // 4. the tile's table-gradient partial: distinct rows dr_q (C), de_q
    // pairs (P), dr_k (C), de_k pairs (P), each at every position
    float* part = a.part + ((size_t)gi * gridDim.x + blockIdx.x) * T2 * L;
    for (int e = tid; e < T1 * L; e += kBwdThreads) {
      const int t = e / L, l = e - t * L;
      const bool on_k = t >= C + P;
      const int tk = on_k ? t - (C + P) : t;   // within q's or k's rows
      const int base = on_k ? C : 0;           // k's rows of the slab
      float sum = 0.f;
      int c, d, out_row;
      if (tk < C) {
        c = d = tk;
        const T* x = slab + ((base + c) * L + l) * TS;
#pragma unroll 8
        for (int j = 0; j < TS; ++j) sum += to_f32(x[(j + l) % TS]);
        out_row = (on_k ? C + C * C : 0) + c;
        part[out_row * L + l] = (on_k ? c4 : c2) * sum;
      } else {
        pair_of<C>(tk - C, c, d);
        const T* x = slab + ((base + c) * L + l) * TS;
        const T* y = slab + ((base + d) * L + l) * TS;
#pragma unroll 8
        for (int j = 0; j < TS; ++j) {
          const int jj = (j + l) % TS;
          sum += to_f32(x[jj]) * to_f32(y[jj]);
        }
        const float v = (on_k ? c5 : c3) * sum;
        const int e0 = on_k ? 2 * C + C * C : C;   // first de row
        part[(e0 + c * C + d) * L + l] = v;
        part[(e0 + d * C + c) * L + l] = v;
      }
    }
  }
}

template <int C, bool HAS_POS, bool TAB, class T>
cudaError_t fwd_variant(const MomFwdArgs<T>& a, int g, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<C, HAS_POS, TAB, T>(a.L, a.slab);
  auto kernel = moments_fwd_kernel<C, HAS_POS, TAB, T>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kFwdStripes - 1) / kFwdStripes, g);
  kernel<<<grid, kFwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// With positions the tables are staged at c <= 4 and spans up to
// kMaxBwdSpan, else read from L2 (gp 16, or longer spans: off every path).
template <int C, class T>
cudaError_t fwd_c(const MomFwdArgs<T>& a, int g, bool pos,
                  cudaStream_t stream) {
  if (!pos) return fwd_variant<C, false, false>(a, g, stream);
  if constexpr (C <= 4) {
    if (a.L <= kMaxBwdSpan) return fwd_variant<C, true, true>(a, g, stream);
  }
  return fwd_variant<C, true, false>(a, g, stream);
}

// dtables[e] = sum_{p < P} part[p * E + e]: a block takes 32 consecutive
// elements (lane = element), its kFinWarps2 warps fixed contiguous ranges
// of the P slots, and their sums are added in warp order. 32 warps a block,
// not reduce.cuh's 8: E is small (2c + 2c^2 rows of L) and P large (one
// slot per block of the backward), so the sum is latency-bound.
constexpr int kFinWarps2 = 32;

__global__ void __launch_bounds__(kFinWarps2 * 32)
tab_finalize_kernel(const float* __restrict__ part, float* __restrict__ out,
                    int P, int E) {
  __shared__ float sums[kFinWarps2][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + lane;
  const int p0 = (int)((long long)P * w / kFinWarps2);
  const int p1 = (int)((long long)P * (w + 1) / kFinWarps2);
  float acc = 0.f;
  if (e < E) {
#pragma unroll 4
    for (int p = p0; p < p1; ++p) acc += part[(size_t)p * E + e];
  }
  sums[w][lane] = acc;
  __syncthreads();
  if (w == 0 && e < E) {
    float v = 0.f;
#pragma unroll
    for (int k = 0; k < kFinWarps2; ++k) v += sums[k][lane];
    out[e] = v;
  }
}

template <int C, int TS, bool HAS_POS, class T>
cudaError_t bwd_variant(const MomBwdArgs<T>& a, int g, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<C, TS, HAS_POS, T>(a.L);
  auto kernel = moments_bwd_kernel<C, TS, HAS_POS, T>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + TS - 1) / TS, g);
  kernel<<<grid, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int C, class T>
cudaError_t bwd_c(const MomBwdArgs<T>& a, int g, int ts, bool pos,
                  cudaStream_t stream) {
  switch (ts) {
    case 32: return pos ? bwd_variant<C, 32, true>(a, g, stream)
                        : bwd_variant<C, 32, false>(a, g, stream);
    case 16: return pos ? bwd_variant<C, 16, true>(a, g, stream)
                        : bwd_variant<C, 16, false>(a, g, stream);
    default: return pos ? bwd_variant<C, 8, true>(a, g, stream)
                        : bwd_variant<C, 8, false>(a, g, stream);
  }
}

// The wide widths (every even gp up to 128 outside 2, 4, 8 and 16) run the
// kernels of csrc/moments_wide.cu (its own source, so the two compile in
// parallel) under this file's finalizes: the forward's partials one slot
// per block of its tile (moments_wide.cuh: wide_fwd_tile stripes), the
// backward's this file's layout.
constexpr bool is_wide(int gp) {
  return gp != 2 && gp != 4 && gp != 8 && gp != 16;
}
static_assert(kFwdThreads == medt_moments::kWideThreads &&
                  kBwdThreads == medt_moments::kWideThreads,
              "moments_wide.cu's blocks are this file's");

bool bad_geometry(int g, int gp, int L, int S) {
  return g < 1 || g > 65535 || S < 1 || L < 1 || L > 65535 || gp < 2 ||
         gp > 128 || gp % 2 != 0;
}

// stripes a forward block: kFwdStripes, or at a wide gp the wide forward's
// tile; the forward's partials have one slot per block
int fwd_tile(int g, int gp, int L, int S) {
  return is_wide(gp) ? medt_moments::wide_fwd_tile(gp / 2, L, S, g)
                     : kFwdStripes;
}

template <class T>
int moments_fwd(const T* qkv, const float* r_q, const float* e_q,
                const float* r_k, const float* e_k, float* out, float* part,
                int g, int gp, int L, int S, int has_pos, int n_part,
                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_geometry(g, gp, L, S)) return (int)cudaErrorInvalidValue;
  const int ts = fwd_tile(g, gp, L, S);
  const int tiles = (S + ts - 1) / ts;
  if (n_part != g * tiles) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  const MomFwdArgs<T> a{qkv, r_q, e_q, r_k, e_k, part, L, S,
                        (long long)gp * L * kFwdStripes <= kFwdSlabFloats,
                        S % flash2::kChunk<T> == 0 && flash2::aligned16(qkv)};
  cudaError_t err;
  if (is_wide(gp)) {
    err = medt_moments::wide_fwd(qkv, r_q, e_q, r_k, e_k, part, g, gp / 2,
                                 L, S, pos, stream);
  } else {
    switch (gp / 2) {
      case 1: err = fwd_c<1>(a, g, pos, stream); break;
      case 2: err = fwd_c<2>(a, g, pos, stream); break;
      case 4: err = fwd_c<4>(a, g, pos, stream); break;
      default: err = fwd_c<8>(a, g, pos, stream); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  moments_finalize_kernel<<<(g * 8 * 32 + kFwdThreads - 1) / kFwdThreads,
                            kFwdThreads, 0, stream>>>(part, out, tiles, g);
  return (int)cudaGetLastError();
}

template <class T>
int moments_bwd(const T* qkv, const float* r_q, const float* e_q,
                const float* r_k, const float* e_k, const float* ct, T* dqkv,
                float* dtables, float* part, int g, int gp, int L, int S,
                int has_pos, int n_part, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_geometry(g, gp, L, S) || L > kMaxBwdSpan) {
    return (int)cudaErrorInvalidValue;
  }
  const int c = gp / 2;
  const int ts = bwd_tile(c, L, S, g);
  const int tiles = (S + ts - 1) / ts;
  if (is_wide(gp)) {
    if (has_pos && n_part != medt_moments::wide_bwd_slots(L, S)) {
      return (int)cudaErrorInvalidValue;
    }
  } else if (tiles > 65535 || (has_pos && n_part != g * tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  const MomBwdArgs<T> a{qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, L, S,
                        S % flash2::kChunk<T> == 0 && flash2::aligned16(qkv)};
  cudaError_t err;
  if (is_wide(gp)) {
    err = medt_moments::wide_bwd(qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, g,
                                 c, L, S, pos, stream);
  } else {
    switch (c) {
      case 1: err = bwd_c<1>(a, g, ts, pos, stream); break;
      case 2: err = bwd_c<2>(a, g, ts, pos, stream); break;
      case 4: err = bwd_c<4>(a, g, ts, pos, stream); break;
      default: err = bwd_c<8>(a, g, ts, pos, stream); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  if (pos) {
    const int E = (2 * c + 2 * c * c) * L;
    tab_finalize_kernel<<<(E + 31) / 32, kFinWarps2 * 32, 0, stream>>>(
        part, dtables, n_part, E);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward: out (g, 8); part scratch (n_part, 6), a slot per block
// (medt_moment_sums_fwd_slots).
int medt_moment_sums_fwd(const float* qkv, const float* r_q, const float* e_q,
                         const float* r_k, const float* e_k, float* out,
                         float* part, int g, int gp, int L, int S,
                         int has_pos, int n_part, void* stream) {
  return moments_fwd(qkv, r_q, e_q, r_k, e_k, out, part, g, gp, L, S,
                     has_pos, n_part, stream);
}

// The same on bf16 qkv: the sums are the float32 entry point's on the
// upcast qkv, bit for bit.
int medt_moment_sums_fwd_bf16(const __nv_bfloat16* qkv, const float* r_q,
                              const float* e_q, const float* r_k,
                              const float* e_k, float* out, float* part,
                              int g, int gp, int L, int S, int has_pos,
                              int n_part, void* stream) {
  return moments_fwd(qkv, r_q, e_q, r_k, e_k, out, part, g, gp, L, S,
                     has_pos, n_part, stream);
}

// The forward's partial slots, the n_part its entry points take: g *
// ceil(S / kFwdStripes), or at a wide gp g * ceil(S / wide_fwd_tile); -1
// for a geometry they refuse.
int medt_moment_sums_fwd_slots(int g, int gp, int L, int S) {
  if (bad_geometry(g, gp, L, S)) return -1;
  const int ts = fwd_tile(g, gp, L, S);
  return g * ((S + ts - 1) / ts);
}

// Backward: dqkv (g, 2gp, L, S), v rows written zero; dtables (2c + 2c^2,
// L) = dr_q (c, L), de_q (c, c, L), dr_k, de_k (unused without positions);
// part: the table-gradient partials (g * ceil(S / TS), 2c + 2c^2, L), TS
// as bwd_tile gives it, or at a wide gp (wide_bwd_slots, 2c + 2c^2, L)
// (unused without positions). Spans up to 256.
int medt_moment_sums_bwd(const float* qkv, const float* r_q, const float* e_q,
                         const float* r_k, const float* e_k, const float* ct,
                         float* dqkv, float* dtables, float* part, int g,
                         int gp, int L, int S, int has_pos, int n_part,
                         void* stream) {
  return moments_bwd(qkv, r_q, e_q, r_k, e_k, ct, dqkv, dtables, part, g, gp,
                     L, S, has_pos, n_part, stream);
}

// The same on bf16 qkv: the table gradients are the float32 entry point's
// on the upcast qkv, dqkv (bf16) its dqkv rounded once.
int medt_moment_sums_bwd_bf16(const __nv_bfloat16* qkv, const float* r_q,
                              const float* e_q, const float* r_k,
                              const float* e_k, const float* ct,
                              __nv_bfloat16* dqkv, float* dtables,
                              float* part, int g, int gp, int L, int S,
                              int has_pos, int n_part, void* stream) {
  return moments_bwd(qkv, r_q, e_q, r_k, e_k, ct, dqkv, dtables, part, g, gp,
                     L, S, has_pos, n_part, stream);
}

}  // extern "C"
