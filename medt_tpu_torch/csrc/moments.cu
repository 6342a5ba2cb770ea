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
// (forward) or twice (backward) for ~c^2 operations, far below the card's
// 20 float32 operations per byte. Design:
//   * forward, one thread per (gi, stripe s) walking the span: the
//     per-stripe sums qs, ks, qq, kk and the table terms stay in registers;
//     warp shuffles and a fixed-order sum of the block's warps give one
//     (g, block) partial of the six sums, summed in index order by a
//     second kernel (reduce.cuh) — the TPU kernel's resident (g, 8) block
//     becomes a deterministic two-level reduction;
//   * backward, pass 1 = the forward's per-stripe sums written to scratch;
//     pass 2, one thread per (gi, l, s): dq, dk of that element, and the
//     block's table-gradient partial of row l (all its threads share l);
//     pass 3 sums the partials.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"

namespace {

using medt::kBlockStripes;
using medt::kWarps;
using medt::warp_sum;

__host__ __device__ constexpr int pairs(int C) { return C * (C + 1) / 2; }

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

// Backward pass 1: per-stripe sums, stats[gi][t][s] with t over
// qs (C), ks (C), qq (pairs), kk (pairs).
template <int C>
__global__ void __launch_bounds__(kBlockStripes)
moments_stripe_stats_kernel(const float* __restrict__ qkv,
                            float* __restrict__ stats, int L, int S) {
  constexpr int T1 = 2 * C + 2 * pairs(C);
  const int gi = blockIdx.y;
  const int s = blockIdx.x * kBlockStripes + threadIdx.x;
  if (s >= S) return;
  const size_t LS = (size_t)L * S;
  const float* base = qkv + (size_t)gi * 4 * C * LS + s;
  float acc[T1];
#pragma unroll
  for (int t = 0; t < T1; ++t) acc[t] = 0.f;
  for (int l = 0; l < L; ++l) {
    float q[C], k[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      q[c] = base[c * LS + (size_t)l * S];
      k[c] = base[(C + c) * LS + (size_t)l * S];
      acc[c] += q[c];
      acc[C + c] += k[c];
    }
    int t = 2 * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int d = c; d < C; ++d, ++t) {
        acc[t] += q[c] * q[d];
        acc[t + pairs(C)] += k[c] * k[d];
      }
    }
  }
  float* out = stats + (size_t)gi * T1 * S + s;
#pragma unroll
  for (int t = 0; t < T1; ++t) out[(size_t)t * S] = acc[t];
}

__device__ __forceinline__ int pair_index(int c, int d, int C) {
  // index of (min, max) in the row-major upper triangle
  const int a = c < d ? c : d, b = c < d ? d : c;
  return a * C - a * (a - 1) / 2 + (b - a);
}

// Backward pass 2: one thread per (gi, l, s).
template <int C, bool HAS_POS>
__global__ void __launch_bounds__(kBlockStripes)
moments_bwd_kernel(const float* __restrict__ qkv, const float* __restrict__ r_q,
                   const float* __restrict__ e_q, const float* __restrict__ r_k,
                   const float* __restrict__ e_k, const float* __restrict__ ct,
                   const float* __restrict__ stats, float* __restrict__ dqkv,
                   float* __restrict__ part, int L, int S) {
  constexpr int P = pairs(C);
  constexpr int T1 = 2 * C + 2 * P;
  constexpr int T2 = 2 * C + 2 * C * C;  // dr_q, de_q, dr_k, de_k rows
  __shared__ float w_part[HAS_POS ? kWarps * T2 : 1];
  const int l = blockIdx.x;
  const int gi = blockIdx.z;
  const int s = blockIdx.y * kBlockStripes + threadIdx.x;
  const bool valid = s < S;
  const int sc = valid ? s : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t LS = (size_t)L * S;
  const float* base = qkv + (size_t)gi * 4 * C * LS + (size_t)l * S + sc;
  const float* st = stats + (size_t)gi * T1 * S + sc;
  const float* cg = ct + gi * 8;
  const float c0 = cg[0], c1 = cg[1], c2 = cg[2], c3 = cg[3], c4 = cg[4],
              c5 = cg[5];

  float q[C], k[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // past the ragged edge: zeros, so the table sums get nothing from it
    q[c] = valid ? base[c * LS] : 0.f;
    k[c] = valid ? base[(C + c) * LS] : 0.f;
  }
  if (valid) {
    float* out = dqkv + (size_t)gi * 4 * C * LS + (size_t)l * S + s;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float aq = 0.f, ak = 0.f;
#pragma unroll
      for (int d = 0; d < C; ++d) {
        const int pd = pair_index(c, d, C);
        aq += st[(size_t)(2 * C + P + pd) * S] * q[d];  // kk[c,d] q[d]
        ak += st[(size_t)(2 * C + pd) * S] * k[d];      // qq[c,d] k[d]
      }
      float dq = c0 * st[(size_t)(C + c) * S] + 2.f * c1 * aq;
      float dk = c0 * st[(size_t)c * S] + 2.f * c1 * ak;
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
      out[c * LS] = dq;
      out[(C + c) * LS] = dk;
    }
#pragma unroll
    for (int p = 0; p < 2 * C; ++p) out[(2 * C + p) * LS] = 0.f;  // v rows
  }

  if constexpr (HAS_POS) {
    // table-gradient terms of row l, summed over the block's stripes
    auto put = [&](int t, float v) {
      v = warp_sum(v);
      if (lane == 0) w_part[warp * T2 + t] = v;
    };
    const int dq0 = 0, eq0 = C, dk0 = C + C * C, ek0 = 2 * C + C * C;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      put(dq0 + c, c2 * q[c]);
      put(dk0 + c, c4 * k[c]);
#pragma unroll
      for (int d = 0; d < C; ++d) {
        put(eq0 + c * C + d, c3 * (q[c] * q[d]));
        put(ek0 + c * C + d, c5 * (k[c] * k[d]));
      }
    }
    __syncthreads();
    const int blocks = gridDim.y;
    for (int t = threadIdx.x; t < T2; t += kBlockStripes) {
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += w_part[w * T2 + t];
      part[(((size_t)gi * blocks + blockIdx.y) * T2 + t) * L + l] = v;
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

template <int C, bool HAS_POS>
void bwd_c(const float* qkv, const float* r_q, const float* e_q,
           const float* r_k, const float* e_k, const float* ct, float* stats,
           float* dqkv, float* part, int g, int L, int S, cudaStream_t stream) {
  const int blocks = medt::stripe_blocks(S);
  moments_stripe_stats_kernel<C><<<dim3(blocks, g), kBlockStripes, 0, stream>>>(
      qkv, stats, L, S);
  moments_bwd_kernel<C, HAS_POS><<<dim3(L, blocks, g), kBlockStripes, 0, stream>>>(
      qkv, r_q, e_q, r_k, e_k, ct, stats, dqkv, part, L, S);
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
// scratch: stats (g, 2c + c(c+1), S), part (g * ceil(S/128), 2c + 2c^2, L).
int medt_moment_sums_bwd(const float* qkv, const float* r_q, const float* e_q,
                         const float* r_k, const float* e_k, const float* ct,
                         float* dqkv, float* dtables, float* stats,
                         float* part, int g, int gp, int L, int S,
                         int has_pos, int n_part, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = medt::stripe_blocks(S);
  if (bad_geometry(g, gp, L, S) || (has_pos && n_part != g * blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
#define MEDT_BWD(C)                                                         \
  (pos ? bwd_c<C, true>(qkv, r_q, e_q, r_k, e_k, ct, stats, dqkv, part, g, \
                        L, S, stream)                                       \
       : bwd_c<C, false>(qkv, r_q, e_q, r_k, e_k, ct, stats, dqkv, part, g, \
                         L, S, stream))
  switch (gp / 2) {
    case 1: MEDT_BWD(1); break;
    case 2: MEDT_BWD(2); break;
    case 4: MEDT_BWD(4); break;
    case 8: MEDT_BWD(8); break;
  }
#undef MEDT_BWD
  if (pos) {
    const int c = gp / 2;
    medt::sum_partials(part, dtables, n_part, (size_t)(2 * c + 2 * c * c) * L,
                       stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
