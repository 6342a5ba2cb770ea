// Similarity-BN batch moments at the wide widths, forward and backward, for
// Hopper (sm_90a): the kernels that csrc/moments.cu's entry points run at
// every even gp up to 128 outside 2, 4, 8 and 16 (c = gp/2 from 3 to 64),
// in a source of their own so that the two compile in parallel.
//
// Replaces, at those widths, the Pallas TPU kernels of
// medt_tpu/ops/pallas_moments.py that csrc/moments.cu replaces at gp 2, 4,
// 8 and 16: moment_sums_core's forward (_moments_kernel) and backward
// (_moments_bwd_kernel); the sums and the backward's formulas are
// moments.cu's (see its header).
//   * moments_wide_fwd_kernel: JAX's factored sums (s1_qk from the
//     channel sums, s2_qk from the upper triangles of sum_l q_c q_d and
//     sum_l k_c k_d, per stripe; the position terms from the Gram over the
//     block's stripes at each row l against e and r), so a stripe costs
//     about c^2 L FMAs from shared memory and no table is read per (row,
//     stripe). A block owns one group and
//     wide_fwd_tile's ts stripes (32 down to 4, so that the grid keeps 264
//     blocks), reads each q and k element from device memory once into a
//     shared slab (the whole span where it fits 96 KB: every path site),
//     and its threads take 4 x 4 register tiles of the upper triangle of
//     the Gram (below); one partial slot a block, summed by moments.cu's
//     finalize in a fixed order. Every site takes the factored form: at
//     the gp-96 sites of span 7 (c > L) the direct L^2 c form would do
//     fewer FMAs, but both are far under the launch's latency there.
//     What bounds it: latency and, at large c and small ts, the L2 reads
//     of e (each block reads all of it: 16 c^2 L bytes).
//   * the backward, two launches. What bounds it: per stripe the dq/dk
//     work is 3cL^2 FMAs (w = c0 + 2 c1 qk, then K w^T and Q w) and the
//     e terms 2c^2 L, the table partial c^2 L (the Gram of q, and of k,
//     over the stripes); at the classifiers' sites (spans 7-56, c 6-48) a
//     launch moves a few MB, so it is bound by latency and by how many
//     blocks keep the SMs busy. The first design had one thread per
//     (row, stripe) over tiles of 8 stripes (56 items on a 256-thread
//     block at span 7, 56 blocks for 132 SMs), computed qk twice, read
//     each operand four times per pair and re-read e + e^T per (row,
//     stripe), and its table partial was 2c + 2c^2 rows of sums a block.
//     moments_wide_dqk_kernel: a block owns one group and wide_dqk_tile's
//     TS stripes (8 down to 1, so the grid keeps 264 blocks), stages their
//     q/k slab in shared memory, forms each stripe's L x L w once (in
//     tiles of rows where it passes the shared memory, spans above about
//     160, the dk sums carried over the tiles) and takes every dq and dk
//     (and the zero v rows) from the staged slab;
//     moments_wide_tab_kernel (positions only): a block per (position,
//     q or k, stripe split) sums, over every group, the Gram of x and its
//     r column as a register-tiled product (4 x 4 outputs a thread, the
//     upper triangle only, each value written to [c][d] and [d][c]),
//     wide_bwd_slots splits, one partial slot each; moments.cu's
//     tab_finalize sums the slots in a fixed order. No atomics.
// qkv (and dqkv) are float32 or bf16: bf16 is converted where it is read
// and dqkv rounded once where it is stored, so every other output equals
// the float32 kernel's on the upcast qkv. Kernels launch on the caller's
// stream, allocate nothing and do not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"
#include "moments_wide.cuh"
#include "reduce.cuh"

namespace {

using flash2::from_f32;
using flash2::to_f32;
using medt::warp_sum;
using medt_moments::kWideTabStripes;
using medt_moments::kWideThreads;

constexpr int kWideWarps = kWideThreads / 32;

template <class T>
struct FwdArgs {
  const T* qkv;
  const float* r_q;
  const float* e_q;
  const float* r_k;
  const float* e_k;
  float* part;     // (g * tiles, 6) tile partials
  int L, S;
};

template <class T>
struct BwdArgs {
  const T* qkv;
  const float* r_q;
  const float* e_q;
  const float* r_k;
  const float* e_k;
  const float* ct;
  T* dqkv;
  float* part;   // (g * tiles, 2c + 2c^2, L) table-gradient partials
  int L, S;
};

template <class T>
__device__ __forceinline__ float ldf(const T* p) {
  return to_f32(__ldg(p));
}

// The backward's q/k tile (moments_wide.cuh: wide_dqk_tile,
// wide_dqk_rows): a block owns one group and TS stripes, TS the largest of
// 8, 4, 2, 1 whose slab (q and k, 2c x L, and w, L x Lw, a stripe) fits
// kWideSlabFloats and whose grid keeps kWideMinBlocks blocks; w is formed
// LT rows at a time, LT = L unless a stripe's slab and whole w pass
// kWideMaxSmemFloats (spans above about 160, where TS is 1), and then the
// dk sums carry over the row tiles in shared memory (c x L more floats).
__host__ __device__ constexpr int w_stride(int L) { return L | 1; }

__host__ __device__ constexpr int dqk_stripe_floats(int c, int L, int lt) {
  return 2 * c * L + lt * w_stride(L) + (lt < L ? c * L : 0);
}

// sum_d e2[c,d,l] x[d,l], e2 = e + e^T, over a staged x (c rows of L)
__device__ __forceinline__ float e2_dot(const float* et, const float* x,
                                        int c, int l, int C, int L) {
  float ed = 0.f;
  for (int d = 0; d < C; ++d) {
    ed = fmaf(__ldg(et + ((size_t)c * C + d) * L + l) +
                  __ldg(et + ((size_t)d * C + c) * L + l),
              x[d * L + l], ed);
  }
  return ed;
}

// dq, dk and the zero v rows. A block stages its TS stripes' q and k (2c x
// L each) in shared memory, then per tile of LT rows l forms each stripe's
// w[l][j] = c0 + 2 c1 qk_lj once and takes
//   dq[c,l] = sum_j k[c,j] w[l][j]  (+ c2 r_q[c,l] + c3 sum_d e2_q[c,d,l]
//   q[d,l]) for the tile's rows, and the tile's terms of
//   dk[c,j] = sum_l q[c,l] w[l][j] for every key j (k's terms alike once
//   the last tile is in), e2 = e + e^T, every sum from the staged slab in
//   index order, so that the row tiles do not change a bit.
template <bool HAS_POS, class T>
__global__ void __launch_bounds__(kWideThreads)
moments_wide_dqk_kernel(BwdArgs<T> a, int ts, int C, int lt) {
  extern __shared__ float4 smem4[];
  const int L = a.L, S = a.S, Lw = w_stride(L), gi = blockIdx.y;
  float* Qs = reinterpret_cast<float*>(smem4);  // [t][q c, then k c][l]
  float* W = Qs + (size_t)ts * 2 * C * L;       // [t][lt][Lw]
  float* DK = W + (size_t)ts * lt * Lw;         // [t][c][j], when lt < L
  const int s0 = blockIdx.x * ts;
  const size_t LS = (size_t)L * S;
  const T* base = a.qkv + (size_t)gi * 4 * C * LS + s0;
  T* out = a.dqkv + (size_t)gi * 4 * C * LS + s0;
  const float* cg = a.ct + gi * 8;
  const float c0 = cg[0], c1 = cg[1], c2 = cg[2], c3 = cg[3], c4 = cg[4],
              c5 = cg[5];
  const int nst = min(ts, S - s0);
  const int nslab = 2 * C * L * ts;
  const bool tiled = lt < L;
  for (int e = threadIdx.x; e < nslab; e += kWideThreads) {
    const int t = e % ts, rest = e / ts, l = rest % L, row = rest / L;
    const float v = t < nst ? ldf(base + row * LS + (size_t)l * S + t) : 0.f;
    Qs[((size_t)t * 2 * C + row) * L + l] = v;  // q rows then k rows
  }
  if (tiled) {
    for (int e = threadIdx.x; e < ts * C * L; e += kWideThreads) DK[e] = 0.f;
  }
  __syncthreads();
  const size_t stripe = (size_t)2 * C * L;
  for (int l0 = 0; l0 < L; l0 += lt) {
    const int nl = min(lt, L - l0);
    const bool last = l0 + nl == L;
    for (int e = threadIdx.x; e < ts * nl * L; e += kWideThreads) {
      const int j = e % L, rest = e / L, lr = rest % nl, t = rest / nl;
      const float* q = Qs + t * stripe;
      const float* k = q + (size_t)C * L;
      float d = 0.f;
      for (int c = 0; c < C; ++c) d = fmaf(q[c * L + l0 + lr], k[c * L + j], d);
      W[((size_t)t * lt + lr) * Lw + j] = fmaf(2.f * c1, d, c0);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < C * nl * ts; e += kWideThreads) {
      const int t = e % ts, rest = e / ts, lr = rest % nl, c = rest / nl;
      const int l = l0 + lr;
      const float* q = Qs + t * stripe;
      const float* k = q + (size_t)C * L;
      const float* w = W + ((size_t)t * lt + lr) * Lw;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(k[c * L + j], w[j], acc);
      if constexpr (HAS_POS) {
        acc += c2 * __ldg(a.r_q + c * L + l) + c3 * e2_dot(a.e_q, q, c, l, C, L);
      }
      if (t < nst) {
        out[c * LS + (size_t)l * S + t] = from_f32<T>(acc);
        out[(2 * C + c) * LS + (size_t)l * S + t] = from_f32<T>(0.f);
      }
    }
    for (int e = threadIdx.x; e < C * L * ts; e += kWideThreads) {
      const int t = e % ts, rest = e / ts, j = rest % L, c = rest / L;
      const float* q = Qs + t * stripe;
      const float* k = q + (size_t)C * L;
      const float* w = W + (size_t)t * lt * Lw + j;
      float* dk = DK + ((size_t)t * C + c) * L + j;
      float acc = tiled ? *dk : 0.f;
      for (int lr = 0; lr < nl; ++lr) {
        acc = fmaf(q[c * L + l0 + lr], w[(size_t)lr * Lw], acc);
      }
      if (!last) {
        *dk = acc;
        continue;
      }
      if constexpr (HAS_POS) {
        acc += c4 * __ldg(a.r_k + c * L + j) + c5 * e2_dot(a.e_k, k, c, j, C, L);
      }
      if (t < nst) {
        out[(C + c) * LS + (size_t)j * S + t] = from_f32<T>(acc);
        out[(3 * C + c) * LS + (size_t)j * S + t] = from_f32<T>(0.f);
      }
    }
    __syncthreads();  // the next tile writes W and reads DK
  }
}

// The table partials (positions only): a block per (position l, q or k,
// split of the stripes) sums, over every group and its split's stripes,
//   G[c][d] = sum ct_e[g] x[c,l,s] x[d,l,s]  and  R[c] = sum ct_r[g] x[c,l,s]
// (x = q with ct_e, ct_r = c3, c2; x = k with c5, c4) as a register-tiled
// product: the stripes staged kWideTabStripes at a time, x padded with a
// ones channel at c4 = round4(c) so that R is the Gram's last column; a
// thread holds a 4 x 4 tile of the upper triangle (NSUB threads share a
// tile's stripes when tiles are fewer than threads, summed in a fixed
// order), each value written to [c][d] and [d][c]. One slot per split.
struct MomTab {
  int C4, X, NB, NT, NSUB;
  __host__ __device__ MomTab(int c) {
    C4 = (c + 3) & ~3;
    X = C4 + 4;  // channels of a staged stripe: x, then the ones channel
    NB = X / 4;
    NT = NB * (NB + 1) / 2;
    NSUB = NT >= kWideThreads ? 1 : kWideThreads / NT;
  }
  __host__ __device__ int smem_floats() const {
    const int stage = kWideTabStripes * X;
    const int red = NSUB > 1 ? NSUB * NT * 16 : 0;
    return stage > red ? stage : red;
  }
};

template <class T>
__global__ void __launch_bounds__(kWideThreads)
moments_wide_tab_kernel(BwdArgs<T> a, int g, int C, int nsplit) {
  extern __shared__ float4 smem4[];
  float* X = reinterpret_cast<float*>(smem4);  // [t][X]
  const int L = a.L, S = a.S, l = blockIdx.x, K = blockIdx.y;
  const int split = blockIdx.z, tid = threadIdx.x;
  const MomTab sh(C);
  const int u = sh.NSUB > 1 ? tid / sh.NT : 0;
  const int t0 = sh.NSUB > 1 ? tid % sh.NT : tid;
  const int s_lo = (int)((long long)S * split / nsplit);
  const int s_hi = (int)((long long)S * (split + 1) / nsplit);
  const size_t LS = (size_t)L * S;
  // this thread's tile (a <= b), or none; at most one when NT <= threads
  // (kWideThreads >= NT for c <= 64: 153 tiles at c = 64)
  int ta = 0, tb = 0;
  const bool active = u < sh.NSUB && t0 < sh.NT;
  if (active) {
    int rem = t0;
    while (rem >= sh.NB - ta) {
      rem -= sh.NB - ta;
      ++ta;
    }
    tb = ta + rem;
  }
  float tot[4][4], acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int q = 0; q < 4; ++q) tot[r][q] = 0.f;
  }
  for (int gi = 0; gi < g; ++gi) {
    const T* x = a.qkv + ((size_t)gi * 4 * C + K * C) * LS + (size_t)l * S;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
    }
    for (int s0 = s_lo; s0 < s_hi; s0 += kWideTabStripes) {
      const int nst = min(kWideTabStripes, s_hi - s0);
      for (int e = tid; e < sh.X * kWideTabStripes; e += kWideThreads) {
        const int t = e % kWideTabStripes, c = e / kWideTabStripes;
        float v = 0.f;
        if (t < nst) v = c < C ? ldf(x + c * LS + s0 + t) : c == sh.C4 ? 1.f : 0.f;
        X[t * sh.X + c] = v;
      }
      __syncthreads();
      if (active) {
        for (int t = u; t < nst; t += sh.NSUB) {
          const float4 av = *reinterpret_cast<const float4*>(X + t * sh.X + 4 * ta);
          const float4 bv = *reinterpret_cast<const float4*>(X + t * sh.X + 4 * tb);
          const float ar[4] = {av.x, av.y, av.z, av.w};
          const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(ar[r], br[q], acc[r][q]);
          }
        }
      }
      __syncthreads();
    }
    const float* cg = a.ct + gi * 8;
    const float we = K ? cg[5] : cg[3], wr = K ? cg[4] : cg[2];
    const float w = tb == sh.NB - 1 ? wr : we;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) tot[r][q] = fmaf(w, acc[r][q], tot[r][q]);
    }
  }
  if (sh.NSUB > 1) {
    if (active) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int q = 0; q < 4; ++q) X[(u * sh.NT + t0) * 16 + r * 4 + q] = tot[r][q];
      }
    }
    __syncthreads();
    if (tid >= sh.NT) return;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float v = 0.f;
        for (int w = 0; w < sh.NSUB; ++w) v += X[(w * sh.NT + tid) * 16 + r * 4 + q];
        tot[r][q] = v;
      }
    }
  } else if (!active) {
    return;
  }
  // rows: dr_q (C), de_q (C * C, [c][d]), dr_k (C), de_k (C * C)
  const int T2 = 2 * C + 2 * C * C;
  float* part = a.part + ((size_t)split * T2 + K * (C + C * C)) * L + l;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int c = 4 * ta + r;
    if (c >= C) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int d = 4 * tb + q;
      if (tb == sh.NB - 1) {
        if (d == sh.C4) part[(size_t)c * L] = tot[r][q];
      } else if (d < C) {
        part[(size_t)(C + c * C + d) * L] = tot[r][q];
        if (ta != tb) part[(size_t)(C + d * C + c) * L] = tot[r][q];
      }
    }
  }
}

// The forward at the wide widths, factored as JAX's kernel takes it
// (medt_tpu/ops/pallas_moments.py): a block owns one group and ts stripes
// (moments_wide.cuh: wide_fwd_tile) and stages their q and k rows once,
// [l][stripe][channel] (channels padded to MomTab's X: zeros to c4, a ones
// channel at c4, zeros; zero past S), lc rows l at a time
// (wide_fwd_rows: the whole span wherever it fits). Its threads then take
// 4 x 4 tiles of the upper triangle of the (X x X) Gram, as
// moments_wide_tab_kernel does:
//   pass A (qk), a unit per (tile, stripe): the Gram of q and of k over the
//     stripe's rows l; after the last rows, s2_qk += f sum QQ KK (f = 2 off
//     the diagonal, where the tile stands for its mirror too) and, on the
//     ones column, s1_qk += sum_c Qs_c Ks_c (Qs = sum_l q);
//   pass B (positions), a unit per (tile, row l), l fastest so that the
//     reads of e run along L: the Gram over the block's stripes at row l,
//     contracted with e_q[:, :, l] (e + e^T off the diagonal) for s2_qr and,
//     on the ones column, with r_q[:, l] for s1_qr; k's alike.
// Where the span does not fit (ts = 1, lc < L) a thread holds at most one
// pass-A unit (153 tiles at c = 64) and carries its Gram over the chunks.
// The thread sums go to the block's slot by warp_sum and the warps in
// order; moments.cu's finalize adds the slots in a fixed order.
template <bool HAS_POS, class T>
__global__ void __launch_bounds__(kWideThreads)
moments_wide_fwd_kernel(FwdArgs<T> a, int C, int ts, int lc) {
  extern __shared__ float4 smem4[];
  __shared__ float wsum[kWideWarps][6];
  const MomTab sh(C);
  const int NB = sh.NB, NT = sh.NT, C4 = sh.C4;
  const int pt = medt_moments::fwd_stripe_pitch(C);   // floats a stripe
  const int pl = medt_moments::fwd_row_pitch(C, ts);  // floats a row l
  float* XQ = reinterpret_cast<float*>(smem4);        // [lc][ts][pt]
  float* XK = XQ + (size_t)lc * pl;
  const int L = a.L, S = a.S, gi = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int s0 = blockIdx.x * ts, nst = min(ts, S - s0);
  const size_t LS = (size_t)L * S;
  const T* qb = a.qkv + (size_t)gi * 4 * C * LS + s0;
  const T* kb = qb + (size_t)C * LS;
  // (ta, tb) of a tile index, row-major over the upper triangle
  auto tile = [&](int t, int& ta, int& tb) {
    ta = 0;
    while (t >= NB - ta) {
      t -= NB - ta;
      ++ta;
    }
    tb = ta + t;
  };
  auto quad = [](const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  };
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float aq[4][4], ak[4][4];
  for (int l0 = 0; l0 < L; l0 += lc) {
    const int nl = min(lc, L - l0);
    const bool last = l0 + nl == L;
    __syncthreads();  // the last chunk's reads are done
    // a 16-byte chunk of channels of one (row, stripe) a step, stripes
    // fastest: four reads along S, one conflict-free 16-byte store
    for (int e = tid; e < nl * NB * ts; e += kWideThreads) {
      const int t = e % ts, kq = (e / ts) % NB, l = e / (ts * NB);
      float xq[4], xk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int ch = 4 * kq + u;
        const bool in = t < nst && ch < C;
        const size_t o = ch * LS + (size_t)(l0 + l) * S + t;
        const float one = t < nst && ch == C4 ? 1.f : 0.f;
        xq[u] = in ? to_f32(qb[o]) : one;
        xk[u] = in ? to_f32(kb[o]) : one;
      }
      const size_t o = (size_t)l * pl + t * pt + 4 * kq;
      *reinterpret_cast<float4*>(XQ + o) = make_float4(xq[0], xq[1], xq[2],
                                                       xq[3]);
      *reinterpret_cast<float4*>(XK + o) = make_float4(xk[0], xk[1], xk[2],
                                                       xk[3]);
    }
    __syncthreads();
    // pass A: per stripe, the Gram of q and of k over the rows
    for (int u = tid; u < NT * ts; u += kWideThreads) {
      int ta, tb;
      tile(u % NT, ta, tb);
      const int t = u / NT;
      if (l0 == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) aq[i][j] = ak[i][j] = 0.f;
        }
      }
      const float* pq = XQ + t * pt;
      const float* pk = XK + t * pt;
      for (int l = 0; l < nl; ++l, pq += pl, pk += pl) {
        float q0[4], q1[4], k0[4], k1[4];
        quad(pq + 4 * ta, q0);
        quad(pq + 4 * tb, q1);
        quad(pk + 4 * ta, k0);
        quad(pk + 4 * tb, k1);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            aq[i][j] = fmaf(q0[i], q1[j], aq[i][j]);
            ak[i][j] = fmaf(k0[i], k1[j], ak[i][j]);
          }
        }
      }
      if (!last) continue;
      if (tb < NB - 1) {
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) d = fmaf(aq[i][j], ak[i][j], d);
        }
        v[1] = fmaf(ta == tb ? 1.f : 2.f, d, v[1]);
      } else if (ta < NB - 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) v[0] = fmaf(aq[i][0], ak[i][0], v[0]);
      }
    }
    if constexpr (HAS_POS) {
      // pass B: per row l, the Gram over the block's stripes
      for (int u = tid; u < NT * nl; u += kWideThreads) {
        const int l = u % nl, gl = l0 + l;
        int ta, tb;
        tile(u / nl, ta, tb);
        if (ta == NB - 1) continue;  // the ones channel with itself
        float gq[4][4], gk[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 4; ++j) gq[i][j] = gk[i][j] = 0.f;
        }
        const float* pq = XQ + (size_t)l * pl;
        const float* pk = XK + (size_t)l * pl;
        for (int t = 0; t < ts; ++t, pq += pt, pk += pt) {
          float q0[4], q1[4], k0[4], k1[4];
          quad(pq + 4 * ta, q0);
          quad(pq + 4 * tb, q1);
          quad(pk + 4 * ta, k0);
          quad(pk + 4 * tb, k1);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              gq[i][j] = fmaf(q0[i], q1[j], gq[i][j]);
              gk[i][j] = fmaf(k0[i], k1[j], gk[i][j]);
            }
          }
        }
        if (tb == NB - 1) {  // the ones column: sum_s x[c], against r
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = 4 * ta + i;
            if (c < C) {
              v[2] = fmaf(gq[i][0], __ldg(a.r_q + (size_t)c * L + gl), v[2]);
              v[4] = fmaf(gk[i][0], __ldg(a.r_k + (size_t)c * L + gl), v[4]);
            }
          }
          continue;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * ta + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int d = 4 * tb + j;
            if (c < C && d < C) {
              const size_t cd = ((size_t)c * C + d) * L + gl;
              const size_t dc = ((size_t)d * C + c) * L + gl;
              float eq = __ldg(a.e_q + cd), ek = __ldg(a.e_k + cd);
              if (ta != tb) {
                eq += __ldg(a.e_q + dc);
                ek += __ldg(a.e_k + dc);
              }
              v[3] = fmaf(gq[i][j], eq, v[3]);
              v[5] = fmaf(gk[i][j], ek, v[5]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float w = warp_sum(v[k]);
    if (lane == 0) wsum[warp][k] = w;
  }
  __syncthreads();
  if (tid < 6) {
    float w = 0.f;
#pragma unroll
    for (int k = 0; k < kWideWarps; ++k) w += wsum[k][tid];
    a.part[((size_t)gi * gridDim.x + blockIdx.x) * 6 + tid] = w;
  }
}

template <class T>
cudaError_t fwd(const T* qkv, const float* r_q, const float* e_q,
                const float* r_k, const float* e_k, float* part, int g, int C,
                int L, int S, bool pos, cudaStream_t stream) {
  const FwdArgs<T> a{qkv, r_q, e_q, r_k, e_k, part, L, S};
  const int ts = medt_moments::wide_fwd_tile(C, L, S, g);
  const int lc = medt_moments::wide_fwd_rows(C, L, ts);
  const size_t smem = (size_t)2 * lc * medt_moments::fwd_row_pitch(C, ts) *
                      sizeof(float);
  auto kernel = pos ? moments_wide_fwd_kernel<true, T>
                    : moments_wide_fwd_kernel<false, T>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((S + ts - 1) / ts, g), kWideThreads, smem, stream>>>(a, C, ts,
                                                                    lc);
  return cudaGetLastError();
}

template <class T>
cudaError_t bwd(const T* qkv, const float* r_q, const float* e_q,
                const float* r_k, const float* e_k, const float* ct, T* dqkv,
                float* part, int g, int C, int L, int S, bool pos,
                cudaStream_t stream) {
  const BwdArgs<T> a{qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, L, S};
  const int ts = medt_moments::wide_dqk_tile(C, L, S, g);
  const int lt = medt_moments::wide_dqk_rows(C, L);
  const size_t smem =
      (size_t)ts * dqk_stripe_floats(C, L, lt) * sizeof(float);
  auto dqk = pos ? moments_wide_dqk_kernel<true, T>
                 : moments_wide_dqk_kernel<false, T>;
  cudaError_t err = flash2::allow_smem(dqk, smem);
  if (err != cudaSuccess) return err;
  dqk<<<dim3((S + ts - 1) / ts, g), kWideThreads, smem, stream>>>(a, ts, C,
                                                                 lt);
  err = cudaGetLastError();
  if (err != cudaSuccess || !pos) return err;
  const int nsplit = medt_moments::wide_bwd_slots(L, S);
  const MomTab sh(C);
  const size_t smem_t = (size_t)sh.smem_floats() * sizeof(float);
  err = flash2::allow_smem(moments_wide_tab_kernel<T>, smem_t);
  if (err != cudaSuccess) return err;
  moments_wide_tab_kernel<T><<<dim3(L, 2, nsplit), kWideThreads, smem_t,
                               stream>>>(a, g, C, nsplit);
  return cudaGetLastError();
}

}  // namespace

namespace medt_moments {

cudaError_t wide_fwd(const float* qkv, const float* r_q, const float* e_q,
                     const float* r_k, const float* e_k, float* part, int g,
                     int c, int L, int S, bool pos, cudaStream_t stream) {
  return fwd(qkv, r_q, e_q, r_k, e_k, part, g, c, L, S, pos, stream);
}

cudaError_t wide_fwd(const __nv_bfloat16* qkv, const float* r_q,
                     const float* e_q, const float* r_k, const float* e_k,
                     float* part, int g, int c, int L, int S, bool pos,
                     cudaStream_t stream) {
  return fwd(qkv, r_q, e_q, r_k, e_k, part, g, c, L, S, pos, stream);
}

cudaError_t wide_bwd(const float* qkv, const float* r_q, const float* e_q,
                     const float* r_k, const float* e_k, const float* ct,
                     float* dqkv, float* part, int g, int c, int L, int S,
                     bool pos, cudaStream_t stream) {
  return bwd(qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, g, c, L, S, pos,
             stream);
}

cudaError_t wide_bwd(const __nv_bfloat16* qkv, const float* r_q,
                     const float* e_q, const float* r_k, const float* e_k,
                     const float* ct, __nv_bfloat16* dqkv, float* part, int g,
                     int c, int L, int S, bool pos, cudaStream_t stream) {
  return bwd(qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, g, c, L, S, pos,
             stream);
}

}  // namespace medt_moments
