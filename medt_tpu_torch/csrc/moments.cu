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
// forward's bytes). Design:
//   * forward, one thread per (gi, stripe s) walking the span: the
//     per-stripe sums qs, ks, qq, kk and the table terms stay in registers;
//     warp shuffles and a fixed-order sum of the block's warps give one
//     (g, block) partial of the six sums, summed in index order by a
//     second kernel — the TPU kernel's resident (g, 8) block becomes a
//     deterministic two-level reduction;
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
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"
#include "reduce.cuh"

namespace {

using medt::kBlockStripes;
using medt::kWarps;
using medt::warp_sum;

__host__ __device__ constexpr int pairs(int C) { return C * (C + 1) / 2; }

// index of (min(c, d), max(c, d)) in the row-major upper triangle
__host__ __device__ constexpr int pair_index(int c, int d, int C) {
  return c <= d ? c * C - c * (c - 1) / 2 + (d - c)
                : d * C - d * (d - 1) / 2 + (c - d);
}

template <int C, bool HAS_POS>
__global__ void __launch_bounds__(kBlockStripes)
moments_fwd_kernel(const float* __restrict__ qkv, const float* __restrict__ r_q,
                   const float* __restrict__ e_q, const float* __restrict__ r_k,
                   const float* __restrict__ e_k, float* __restrict__ part,
                   int L, int S) {
  __shared__ float w_part[kWarps][6];
  const int gi = blockIdx.y;
  const int s = blockIdx.x * kBlockStripes + threadIdx.x;
  const bool valid = s < S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t LS = (size_t)L * S;
  const float* base = qkv + (size_t)gi * 4 * C * LS + (valid ? s : 0);

  float qs[C], ks[C], qq[pairs(C)], kk[pairs(C)];
#pragma unroll
  for (int c = 0; c < C; ++c) qs[c] = ks[c] = 0.f;
#pragma unroll
  for (int t = 0; t < pairs(C); ++t) qq[t] = kk[t] = 0.f;
  float s1qr = 0.f, s2qr = 0.f, s1kr = 0.f, s2kr = 0.f;

  for (int l = 0; l < L; ++l) {
    float q[C], k[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      q[c] = valid ? base[c * LS + (size_t)l * S] : 0.f;
      k[c] = valid ? base[(C + c) * LS + (size_t)l * S] : 0.f;
      qs[c] += q[c];
      ks[c] += k[c];
    }
    int t = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int d = c; d < C; ++d, ++t) {
        const float wq = q[c] * q[d], wk = k[c] * k[d];
        qq[t] += wq;
        kk[t] += wk;
        if constexpr (HAS_POS) {
          const size_t cd = ((size_t)c * C + d) * L + l;
          const size_t dc = ((size_t)d * C + c) * L + l;
          const float eq = d == c ? e_q[cd] : e_q[cd] + e_q[dc];
          const float ek = d == c ? e_k[cd] : e_k[cd] + e_k[dc];
          s2qr += wq * eq;
          s2kr += wk * ek;
        }
      }
    }
    if constexpr (HAS_POS) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s1qr += q[c] * r_q[c * L + l];
        s1kr += k[c] * r_k[c * L + l];
      }
    }
  }
  float s1qk = 0.f, s2qk = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) s1qk += qs[c] * ks[c];
  {
    int t = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int d = c; d < C; ++d, ++t) {
        s2qk += (d == c ? 1.f : 2.f) * (qq[t] * kk[t]);
      }
    }
  }

  const float sums[6] = {s1qk, s2qk, s1qr, s2qr, s1kr, s2kr};
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) w_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += w_part[w][threadIdx.x];
    part[((size_t)gi * gridDim.x + blockIdx.x) * 6 + threadIdx.x] = v;
  }
}

// (g, 8) from the (g, blocks, 6) partials; columns 6, 7 zero.
__global__ void moments_finalize_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int blocks,
                                        int g) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g * 8) return;
  const int gi = t / 8, col = t - gi * 8;
  float v = 0.f;
  if (col < 6) {
    for (int b = 0; b < blocks; ++b) v += part[((size_t)gi * blocks + b) * 6 + col];
  }
  out[t] = v;
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

template <int C, int TS, bool HAS_POS>
constexpr size_t bwd_smem_floats(int L) {
  constexpr int T1 = 2 * C + 2 * pairs(C);
  constexpr int T2 = 2 * C + 2 * C * C;
  return (size_t)2 * C * L * TS + (size_t)(kBwdWarps + 1) * T1 * TS +
         (kStageTables<C, HAS_POS> ? (size_t)T2 * L : 0);
}

struct MomBwdArgs {
  const float* qkv;
  const float* r_q;
  const float* e_q;
  const float* r_k;
  const float* e_k;
  const float* ct;
  float* dqkv;
  float* part;   // (g * tiles, 2c + 2c^2, L) table-gradient partials
  int L, S;
  bool vec;      // 16-byte copies along the stripe axis
};

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
template <int C, int TS, bool HAS_POS>
__global__ void __launch_bounds__(kBwdThreads)
moments_bwd_kernel(MomBwdArgs a) {
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
  float* slab = smem;                          // (2c, L, TS)
  float* wpart = slab + 2 * C * L * TS;        // (kBwdWarps, T1, TS)
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
      q[c] = slab[(c * L + l) * TS + s];
      k[c] = slab[((C + c) * L + l) * TS + s];
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
  float* out = a.dqkv + (size_t)gi * 4 * C * LS + s0 + s;
  const float* r_q = TAB ? tabs : a.r_q;
  const float* e_q = TAB ? tabs + C * L : a.e_q;
  const float* r_k = TAB ? tabs + (C + C * C) * L : a.r_k;
  const float* e_k = TAB ? tabs + (2 * C + C * C) * L : a.e_k;
  for (int l = r; valid && l < L; l += NR) {
    float q[C], k[C];
    qk_at(l, q, k);
    float* o = out + (size_t)l * S;
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
      o[c * LS] = dq;
      o[(C + c) * LS] = dk;
    }
#pragma unroll
    for (int p = 0; p < 2 * C; ++p) o[(2 * C + p) * LS] = 0.f;  // v rows
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
        const float* x = slab + ((base + c) * L + l) * TS;
#pragma unroll 8
        for (int j = 0; j < TS; ++j) sum += x[(j + l) % TS];
        out_row = (on_k ? C + C * C : 0) + c;
        part[out_row * L + l] = (on_k ? c4 : c2) * sum;
      } else {
        pair_of<C>(tk - C, c, d);
        const float* x = slab + ((base + c) * L + l) * TS;
        const float* y = slab + ((base + d) * L + l) * TS;
#pragma unroll 8
        for (int j = 0; j < TS; ++j) {
          const int jj = (j + l) % TS;
          sum += x[jj] * y[jj];
        }
        const float v = (on_k ? c5 : c3) * sum;
        const int e0 = on_k ? 2 * C + C * C : C;   // first de row
        part[(e0 + c * C + d) * L + l] = v;
        part[(e0 + d * C + c) * L + l] = v;
      }
    }
  }
}

template <int C, bool HAS_POS>
void fwd_c(const float* qkv, const float* r_q, const float* e_q,
           const float* r_k, const float* e_k, float* part, int g, int L,
           int S, cudaStream_t stream) {
  const dim3 grid(medt::stripe_blocks(S), g);
  moments_fwd_kernel<C, HAS_POS><<<grid, kBlockStripes, 0, stream>>>(
      qkv, r_q, e_q, r_k, e_k, part, L, S);
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

template <int C, int TS, bool HAS_POS>
cudaError_t bwd_variant(const MomBwdArgs& a, int g, cudaStream_t stream) {
  const size_t smem = bwd_smem_floats<C, TS, HAS_POS>(a.L) * sizeof(float);
  auto kernel = moments_bwd_kernel<C, TS, HAS_POS>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + TS - 1) / TS, g);
  kernel<<<grid, kBwdThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int C>
cudaError_t bwd_c(const MomBwdArgs& a, int g, int ts, bool pos,
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

bool bad_geometry(int g, int gp, int L, int S) {
  return g < 1 || g > 65535 || S < 1 || L < 1 || L > 65535 ||
         medt::stripe_blocks(S) > 65535 ||
         !(gp == 2 || gp == 4 || gp == 8 || gp == 16);
}

}  // namespace

extern "C" {

// Forward: out (g, 8); part scratch (g * ceil(S/128), 6).
int medt_moment_sums_fwd(const float* qkv, const float* r_q, const float* e_q,
                         const float* r_k, const float* e_k, float* out,
                         float* part, int g, int gp, int L, int S,
                         int has_pos, int n_part, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = medt::stripe_blocks(S);
  if (bad_geometry(g, gp, L, S) || n_part != g * blocks) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
#define MEDT_FWD(C) \
  (pos ? fwd_c<C, true>(qkv, r_q, e_q, r_k, e_k, part, g, L, S, stream) \
       : fwd_c<C, false>(qkv, r_q, e_q, r_k, e_k, part, g, L, S, stream))
  switch (gp / 2) {
    case 1: MEDT_FWD(1); break;
    case 2: MEDT_FWD(2); break;
    case 4: MEDT_FWD(4); break;
    case 8: MEDT_FWD(8); break;
  }
#undef MEDT_FWD
  moments_finalize_kernel<<<(g * 8 + 127) / 128, 128, 0, stream>>>(
      part, out, blocks, g);
  return (int)cudaGetLastError();
}

// Backward: dqkv (g, 2gp, L, S), v rows written zero; dtables (2c + 2c^2,
// L) = dr_q (c, L), de_q (c, c, L), dr_k, de_k (unused without positions);
// part: the table-gradient partials (g * ceil(S / TS), 2c + 2c^2, L), TS
// as bwd_tile gives it (unused without positions). Spans up to 256.
int medt_moment_sums_bwd(const float* qkv, const float* r_q, const float* e_q,
                         const float* r_k, const float* e_k, const float* ct,
                         float* dqkv, float* dtables, float* part, int g,
                         int gp, int L, int S, int has_pos, int n_part,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (bad_geometry(g, gp, L, S) || L > kMaxBwdSpan) {
    return (int)cudaErrorInvalidValue;
  }
  const int c = gp / 2;
  const int ts = bwd_tile(c, L, S, g);
  const int tiles = (S + ts - 1) / ts;
  if (tiles > 65535 || (has_pos && n_part != g * tiles)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  const MomBwdArgs a{qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, L, S,
                     S % 4 == 0 && flash2::aligned16(qkv)};
  cudaError_t err;
  switch (c) {
    case 1: err = bwd_c<1>(a, g, ts, pos, stream); break;
    case 2: err = bwd_c<2>(a, g, ts, pos, stream); break;
    case 4: err = bwd_c<4>(a, g, ts, pos, stream); break;
    default: err = bwd_c<8>(a, g, ts, pos, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  if (pos) {
    const int E = (2 * c + 2 * c * c) * L;
    tab_finalize_kernel<<<(E + 31) / 32, kFinWarps2 * 32, 0, stream>>>(
        part, dtables, n_part, E);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
