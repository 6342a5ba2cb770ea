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
//   * moments_wide_fwd_kernel (a first design, for correctness): a block
//     owns one group and kWideFwdStripes stripes (lane = stripe), its warps
//     take the rows l in turn; a thread sums its (l, stripe)'s terms
//     directly: qk_lj over the keys j (s1_qk and s2_qk as sums of qk and
//     qk^2, which equal the factored forms), and with positions sum_c q r_q
//     and sum_cd q q e_q at row l (k's alike); the block's sums go to its
//     slot of moments.cu's partials by warp_sum and its warps in order.
//     Instantiated per register bucket CM of c (8, 16, 32, 64), c at run
//     time. It reads q and k again from L1/L2 for every row and its table
//     terms cost c^2 a row: latency-bound, and at bucket 64 ptxas spills.
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
using medt_moments::kWideFwdStripes;
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

constexpr int cm_bucket(int c) {
  return c <= 8 ? 8 : c <= 16 ? 16 : c <= 32 ? 32 : 64;
}

template <class T>
__device__ __forceinline__ float ldf(const T* p) {
  return to_f32(__ldg(p));
}

// Forward at the wide widths: a thread per (row l, stripe), rows l = warp,
// warp + kWideWarps, ...; each stripe past the edge adds 0.
template <int CM, bool HAS_POS, class T>
__global__ void __launch_bounds__(kWideThreads)
moments_wide_fwd_kernel(FwdArgs<T> a, int C) {
  __shared__ float wsum[kWideWarps][6];
  const int L = a.L, S = a.S, gi = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s = blockIdx.x * kWideFwdStripes + lane;
  const bool valid = s < S;
  const size_t LS = (size_t)L * S;
  const T* base = a.qkv + (size_t)gi * 4 * C * LS + (valid ? s : 0);
  auto at = [&](int row, int l) {
    return valid ? ldf(base + row * LS + (size_t)l * S) : 0.f;
  };
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int l = warp; l < L; l += kWideWarps) {
    float x[CM];
#pragma unroll
    for (int c = 0; c < CM; ++c) x[c] = c < C ? at(c, l) : 0.f;
    for (int j = 0; j < L; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) d = fmaf(x[c], at(C + c, j), d);
      }
      v[0] += d;
      v[1] = fmaf(d, d, v[1]);
    }
    if constexpr (HAS_POS) {
#pragma unroll
      for (int K = 0; K < 2; ++K) {
        if (K == 1) {
#pragma unroll
          for (int c = 0; c < CM; ++c) x[c] = c < C ? at(C + c, l) : 0.f;
        }
        const float* r = K ? a.r_k : a.r_q;
        const float* e = K ? a.e_k : a.e_q;
        float s1 = 0.f, s2 = 0.f;
        // c unrolled (x[c] from registers); d not, its x[d] read again
        // from L1: two unrolled loops over c^2 (e) loads spilled
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (c < C) {
            s1 = fmaf(x[c], __ldg(r + c * L + l), s1);
            float ed = 0.f;
#pragma unroll 4
            for (int d = 0; d < C; ++d)
              ed = fmaf(__ldg(e + ((size_t)c * C + d) * L + l),
                        at(K * C + d, l), ed);
            s2 = fmaf(x[c], ed, s2);
          }
        }
        v[2 + 2 * K] += s1;
        v[3 + 2 * K] += s2;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float w = warp_sum(v[k]);
    if (lane == 0) wsum[warp][k] = w;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float w = 0.f;
#pragma unroll
    for (int k = 0; k < kWideWarps; ++k) w += wsum[k][threadIdx.x];
    a.part[((size_t)gi * gridDim.x + blockIdx.x) * 6 + threadIdx.x] = w;
  }
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

template <int CM, class T>
cudaError_t wide_fwd_cm(const FwdArgs<T>& a, int g, int C, bool pos,
                        cudaStream_t stream) {
  const dim3 grid((a.S + kWideFwdStripes - 1) / kWideFwdStripes, g);
  if (pos) {
    moments_wide_fwd_kernel<CM, true, T><<<grid, kWideThreads, 0, stream>>>(
        a, C);
  } else {
    moments_wide_fwd_kernel<CM, false, T><<<grid, kWideThreads, 0, stream>>>(
        a, C);
  }
  return cudaGetLastError();
}

template <class T>
cudaError_t fwd(const T* qkv, const float* r_q, const float* e_q,
                const float* r_k, const float* e_k, float* part, int g, int C,
                int L, int S, bool pos, cudaStream_t stream) {
  const FwdArgs<T> a{qkv, r_q, e_q, r_k, e_k, part, L, S};
  switch (cm_bucket(C)) {
    case 8: return wide_fwd_cm<8>(a, g, C, pos, stream);
    case 16: return wide_fwd_cm<16>(a, g, C, pos, stream);
    case 32: return wide_fwd_cm<32>(a, g, C, pos, stream);
    default: return wide_fwd_cm<64>(a, g, C, pos, stream);
  }
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
