// Similarity-BN batch moments at the wide widths, forward and backward, for
// Hopper (sm_90a): the kernels that csrc/moments.cu's entry points run at
// every even gp up to 128 outside 2, 4, 8 and 16 (c = gp/2 from 3 to 64),
// in a source of their own so that the two compile in parallel.
//
// Replaces, at those widths, the Pallas TPU kernels of
// medt_tpu/ops/pallas_moments.py that csrc/moments.cu replaces at gp 2, 4,
// 8 and 16: moment_sums_core's forward (_moments_kernel) and backward
// (_moments_bwd_kernel); the sums and the backward's formulas are
// moments.cu's (see its header). Design, for correctness first:
//   * moments_wide_fwd_kernel: a block owns one group and kWideFwdStripes
//     stripes (lane = stripe), its warps take the rows l in turn; a thread
//     sums its (l, stripe)'s terms directly: qk_lj over the keys j (s1_qk
//     and s2_qk as sums of qk and qk^2, which equal the factored forms),
//     and with positions sum_c q r_q and sum_cd q q e_q at row l (k's
//     alike); the block's sums go to its slot of moments.cu's partials by
//     warp_sum and its warps in order;
//   * moments_wide_bwd_kernel: a block owns one group and the backward's
//     tile of ts stripes (moments.cu's bwd_tile); a thread per (row l,
//     stripe) writes dq[., l] = sum_j k[., j] (ct0 + 2 ct1 qk_lj) plus the
//     table terms, and dk alike, with c accumulators, and the zero v rows;
//     then, with positions, the tile's table partial, one value per (table
//     row, position) over its ts stripes.
// Each is instantiated per register bucket CM of c (8, 16, 32, 64) and
// takes c at run time; every loop over channels stops at c, so a width's
// sums run in the same order whichever bucket takes it. qkv (and dqkv) are
// float32 or bf16: bf16 is converted where it is read and dqkv rounded
// once where it is stored. What bounds it on the H100: device memory at
// the bound (each q/k element read once for ~c^2 operations); these
// kernels read q and k again from L1/L2 for every row and their table
// terms cost c^2 a row (at gp 128 the backward's tile partial alone is
// 8320 rows of L), so they are latency-bound, and at bucket 64 ptxas
// spills registers. They launch on the caller's stream, allocate nothing
// and do not synchronise.

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

// Backward at the wide widths over tiles of ts stripes (bwd_tile): dq, dk
// and the zero v rows, a thread per (row l, stripe); then, with positions,
// the tile's table partial.
template <int CM, bool HAS_POS, class T>
__global__ void __launch_bounds__(kWideThreads)
moments_wide_bwd_kernel(BwdArgs<T> a, int ts, int C) {
  const int T2 = 2 * C + 2 * C * C;
  const int L = a.L, S = a.S, gi = blockIdx.y, s0 = blockIdx.x * ts;
  const size_t LS = (size_t)L * S;
  const T* base = a.qkv + (size_t)gi * 4 * C * LS;
  T* out = a.dqkv + (size_t)gi * 4 * C * LS;
  const float* cg = a.ct + gi * 8;
  const float c0 = cg[0], c1 = cg[1], c2 = cg[2], c3 = cg[3], c4 = cg[4],
              c5 = cg[5];
  for (int e = threadIdx.x; e < L * ts; e += kWideThreads) {
    const int l = e / ts, s = s0 + e % ts;
    if (s >= S) continue;
    const T* col = base + s;  // (row, position) at col[row * LS + pos * S]
#pragma unroll
    for (int K = 0; K < 2; ++K) {  // dq (x = q), then dk (x = k)
      const int mine = K ? C : 0, other = K ? 0 : C;
      float x[CM], acc[CM];
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        x[c] = c < C ? ldf(col + (mine + c) * LS + (size_t)l * S) : 0.f;
        acc[c] = 0.f;
      }
      for (int j = 0; j < L; ++j) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (c < C)
            d = fmaf(x[c], ldf(col + (other + c) * LS + (size_t)j * S), d);
        }
        const float w = fmaf(2.f * c1, d, c0);
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (c < C)
            acc[c] = fmaf(ldf(col + (other + c) * LS + (size_t)j * S), w,
                          acc[c]);
        }
      }
      if constexpr (HAS_POS) {
        const float* r = K ? a.r_k : a.r_q;
        const float* et = K ? a.e_k : a.e_q;
        const float cr = K ? c4 : c2, ce = K ? c5 : c3;
        // c unrolled (acc[c] in registers); d not, its x[d] read again
        // from L1 (see the forward)
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (c < C) {
            float ed = 0.f;
#pragma unroll 4
            for (int d = 0; d < C; ++d) {
              ed = fmaf(__ldg(et + ((size_t)c * C + d) * L + l) +
                            __ldg(et + ((size_t)d * C + c) * L + l),
                        ldf(col + (mine + d) * LS + (size_t)l * S), ed);
            }
            acc[c] += cr * __ldg(r + c * L + l) + ce * ed;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C)
          out[(mine + c) * LS + (size_t)l * S + s] = from_f32<T>(acc[c]);
      }
    }
    for (int p = 0; p < 2 * C; ++p)  // v rows
      out[(2 * C + p) * LS + (size_t)l * S + s] = from_f32<T>(0.f);
  }
  if constexpr (HAS_POS) {
    // rows: dr_q (C), de_q (C * C, [c][d]), dr_k (C), de_k (C * C)
    float* part = a.part + ((size_t)gi * gridDim.x + blockIdx.x) * T2 * L;
    const int s1 = min(s0 + ts, S);
    for (int e = threadIdx.x; e < T2 * L; e += kWideThreads) {
      const int row = e / L, l = e - row * L;
      const bool on_k = row >= C + C * C;
      const int rk = on_k ? row - (C + C * C) : row;
      const T* x = base + (on_k ? C : 0) * LS + (size_t)l * S;
      float sum = 0.f;
      if (rk < C) {
        for (int s = s0; s < s1; ++s) sum += ldf(x + rk * LS + s);
        part[e] = (on_k ? c4 : c2) * sum;
      } else {
        const int c = (rk - C) / C, d = (rk - C) % C;
        for (int s = s0; s < s1; ++s)
          sum = fmaf(ldf(x + c * LS + s), ldf(x + d * LS + s), sum);
        part[e] = (on_k ? c5 : c3) * sum;
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

template <int CM, class T>
cudaError_t wide_bwd_cm(const BwdArgs<T>& a, int g, int ts, int C,
                        bool pos, cudaStream_t stream) {
  const dim3 grid((a.S + ts - 1) / ts, g);
  if (pos) {
    moments_wide_bwd_kernel<CM, true, T><<<grid, kWideThreads, 0, stream>>>(
        a, ts, C);
  } else {
    moments_wide_bwd_kernel<CM, false, T><<<grid, kWideThreads, 0, stream>>>(
        a, ts, C);
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
                float* part, int g, int ts, int C, int L, int S, bool pos,
                cudaStream_t stream) {
  const BwdArgs<T> a{qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, L, S};
  switch (cm_bucket(C)) {
    case 8: return wide_bwd_cm<8>(a, g, ts, C, pos, stream);
    case 16: return wide_bwd_cm<16>(a, g, ts, C, pos, stream);
    case 32: return wide_bwd_cm<32>(a, g, ts, C, pos, stream);
    default: return wide_bwd_cm<64>(a, g, ts, C, pos, stream);
  }
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
                     float* dqkv, float* part, int g, int ts, int c, int L,
                     int S, bool pos, cudaStream_t stream) {
  return bwd(qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, g, ts, c, L, S, pos,
             stream);
}

cudaError_t wide_bwd(const __nv_bfloat16* qkv, const float* r_q,
                     const float* e_q, const float* r_k, const float* e_k,
                     const float* ct, __nv_bfloat16* dqkv, float* part, int g,
                     int ts, int c, int L, int S, bool pos,
                     cudaStream_t stream) {
  return bwd(qkv, r_q, e_q, r_k, e_k, ct, dqkv, part, g, ts, c, L, S, pos,
             stream);
}

}  // namespace medt_moments
