// The stripe-major logits -> softmax -> (sv, sve) chain, shared by the
// fused eval kernel (csrc/axial_eval_fwd.cu) and the forward of the
// train-mode stripe core (csrc/axial_stripe_fwd.cu). Each source supplies
// an epilogue that stores the result: the eval kernel applies the folded
// output BN, the train forward writes sv and sve themselves.
//
// Per stripe s, group gi and query row i:
//   logit[j] = (qk*a0 + a1) [+ (qr*a2 + a3) + (kr*a4 + a5)]
//     qk = sum_c q[c,i] k[c,j]
//     qr = sum_c q[c,i] qemb[c,i,j],  kr = sum_c k[c,j] kemb[c,j,i]
//   p = softmax_j(logit)
//   sv[p] = sum_j p_j v[p,j],  sve[p] = sum_j p_j vemb[p,i,j]
// with a = sim_affine[gi, 0..5] (the folded similarity BN). Operands are
// stripe-major: q, k (S, g, c, L), v (S, g, gp, L), each with its own
// stripe and group strides and rows of L contiguous floats, so a caller can
// pass three views of one fused (S, g, 2gp, L) qkv without a split; the
// tables (c, L, L), (c, L, L), (gp, L, L) are dense and shared by every
// group. Everything is float32. Without positions (HAS_POS false) the
// tables are not read and sve is zero.
//
// Design, for the batch-1 shapes (S <= 64 stripes, L <= 64), where a launch
// moves about 1-2 MB and is bound by launch latency rather than by bytes
// or float32 operations:
//   * a block of 128 threads packs R query rows (R = min(L, 16)) of
//     SB = 128 / R stripes of one group: at L = 4 a block holds 32 stripes,
//     so short spans still fill the block; the grid is (stripe blocks,
//     groups, row chunks): at span 64 and 64 stripes, 8 x 8 x 4 blocks;
//   * the block stages its stripes' k and v rows and the R rows of the
//     three tables it needs in shared memory (kemb is read transposed there,
//     so its global read stays coalesced); strides are padded to odd
//     numbers of floats so the rows a warp reads fall in distinct banks;
//   * a thread keeps its whole logits row in registers and takes an exact
//     two-pass softmax (the MAXL template bounds the array); gp <= 16
//     accumulators for sv and sve live in registers;
//   * no tensor cores: contraction depths c <= 8 are far too shallow.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; launch_stripe_softmax returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Each source that includes this gets its own copy (anonymous namespace):
// the sources link into one library.
namespace medt {
namespace {

constexpr int kSoftmaxThreads = 128;
constexpr int kSoftmaxMaxSpan = 64;
constexpr int kSoftmaxMaxRows = 16;

__host__ __device__ inline int odd(int x) { return x | 1; }

struct StripeOperands {
  const float* q;        // (S, g, c, L), strides q_ss, q_sg
  const float* k;        // (S, g, c, L), strides k_ss, k_sg
  const float* v;        // (S, g, gp, L), strides v_ss, v_sg
  const float* qemb;     // (c, L, L) [c, i, j]
  const float* kemb;     // (c, L, L) [c, j, i]
  const float* vemb;     // (gp, L, L) [p, i, j]
  const float* sim_aff;  // (g, 8)
  long long q_ss, q_sg, k_ss, k_sg, v_ss, v_sg;
  int S, g, L, R, SB;    // R, SB: set by launch_stripe_softmax
};

template <int GP, bool HAS_POS>
__host__ __device__ inline size_t softmax_smem_floats(int L, int R, int SB) {
  constexpr int C = GP / 2;
  const size_t tables = HAS_POS ? (size_t)(2 * C + GP) * R * odd(L) : 0;
  return tables + (size_t)SB * (odd(C * L) + odd(GP * L));
}

// Epi::store<GP, HAS_POS>(params, out_off, gi, L, acc_v, acc_e, inv_l)
// writes the row: out_off = ((s * g + gi) * GP) * L + i indexes a dense
// (S, g, GP, L) output at plane 0, and sv[p] = acc_v[p] * inv_l,
// sve[p] = acc_e[p] * inv_l.
template <class Epi, int GP, int MAXL, bool HAS_POS>
__global__ void __launch_bounds__(kSoftmaxThreads)
stripe_softmax_kernel(StripeOperands x, typename Epi::Params ep) {
  constexpr int C = GP / 2;
  extern __shared__ float smem[];
  const int L = x.L, R = x.R, SB = x.SB;
  const int Lo = odd(L), KS = odd(C * L), VS = odd(GP * L);
  float* t_q = smem;                                   // [C][R][Lo]
  float* t_k = t_q + (HAS_POS ? C * R * Lo : 0);       // [C][R][Lo]
  float* t_v = t_k + (HAS_POS ? C * R * Lo : 0);       // [GP][R][Lo]
  float* s_k = t_v + (HAS_POS ? GP * R * Lo : 0);      // [SB][KS]
  float* s_v = s_k + SB * KS;                          // [SB][VS]

  const int s0 = blockIdx.x * SB;
  const int gi = blockIdx.y;
  const int i0 = blockIdx.z * R;
  const int tid = threadIdx.x;

  if constexpr (HAS_POS) {
    // qemb[c, i, j] and vemb[p, i, j]: rows i0..i0+R, j minor (coalesced)
    for (int t = tid; t < C * R * L; t += kSoftmaxThreads) {
      const int c = t / (R * L), rem = t - c * R * L;
      const int il = rem / L, j = rem - il * L, i = i0 + il;
      t_q[(c * R + il) * Lo + j] =
          i < L ? x.qemb[((size_t)c * L + i) * L + j] : 0.f;
    }
    for (int t = tid; t < GP * R * L; t += kSoftmaxThreads) {
      const int p = t / (R * L), rem = t - p * R * L;
      const int il = rem / L, j = rem - il * L, i = i0 + il;
      t_v[(p * R + il) * Lo + j] =
          i < L ? x.vemb[((size_t)p * L + i) * L + j] : 0.f;
    }
    // kemb[c, j, i], read with i minor (coalesced), stored as [c][i][j]
    for (int t = tid; t < C * L * R; t += kSoftmaxThreads) {
      const int c = t / (L * R), rem = t - c * L * R;
      const int j = rem / R, il = rem - j * R, i = i0 + il;
      t_k[(c * R + il) * Lo + j] =
          i < L ? x.kemb[((size_t)c * L + j) * L + i] : 0.f;
    }
  }
  // the block's stripes: k rows (c, j) and v rows (p, j), each contiguous
  for (int t = tid; t < SB * C * L; t += kSoftmaxThreads) {
    const int sl = t / (C * L), r = t - sl * (C * L), s = s0 + sl;
    s_k[sl * KS + r] = s < x.S ? x.k[s * x.k_ss + gi * x.k_sg + r] : 0.f;
  }
  for (int t = tid; t < SB * GP * L; t += kSoftmaxThreads) {
    const int sl = t / (GP * L), r = t - sl * (GP * L), s = s0 + sl;
    s_v[sl * VS + r] = s < x.S ? x.v[s * x.v_ss + gi * x.v_sg + r] : 0.f;
  }
  __syncthreads();

  const int sl = tid / R, il = tid - sl * R;
  const int s = s0 + sl, i = i0 + il;
  if (sl >= SB || s >= x.S || i >= L) return;

  const float* a = x.sim_aff + gi * 8;
  const float a0 = a[0], a1 = a[1];
  float a2 = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f;
  if constexpr (HAS_POS) {
    a2 = a[2]; a3 = a[3]; a4 = a[4]; a5 = a[5];
  }

  float qv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qv[c] = x.q[s * x.q_ss + gi * x.q_sg + c * L + i];
  }

  const float* ks = s_k + sl * KS;
  const float* vs = s_v + sl * VS;
  float lg[MAXL];
  float mx = -3.402823466e38f;
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    if (j < L) {
      float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float kv = ks[c * L + j];
        qk += qv[c] * kv;
        if constexpr (HAS_POS) {
          qr += qv[c] * t_q[(c * R + il) * Lo + j];
          kr += kv * t_k[(c * R + il) * Lo + j];
        }
      }
      float xl = qk * a0 + a1;
      if constexpr (HAS_POS) xl = xl + (qr * a2 + a3) + (kr * a4 + a5);
      lg[j] = xl;
      mx = fmaxf(mx, xl);
    }
  }

  float l = 0.f;
  float acc_v[GP], acc_e[GP];
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    acc_v[p] = 0.f;
    acc_e[p] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < MAXL; ++j) {
    if (j < L) {
      const float e = expf(lg[j] - mx);
      l += e;
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        acc_v[p] += e * vs[p * L + j];
        if constexpr (HAS_POS) acc_e[p] += e * t_v[(p * R + il) * Lo + j];
      }
    }
  }

  const size_t out_off = ((size_t)s * x.g + gi) * GP * L + i;
  Epi::template store<GP, HAS_POS>(ep, out_off, gi, L, acc_v, acc_e,
                                   1.f / l);
}

template <class Epi, int GP, int MAXL, bool HAS_POS>
int stripe_softmax_instance(const StripeOperands& x,
                            const typename Epi::Params& ep,
                            cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * softmax_smem_floats<GP, HAS_POS>(x.L, x.R, x.SB);
  auto kernel = stripe_softmax_kernel<Epi, GP, MAXL, HAS_POS>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((x.S + x.SB - 1) / x.SB, x.g, (x.L + x.R - 1) / x.R);
  kernel<<<grid, kSoftmaxThreads, bytes, stream>>>(x, ep);
  return (int)cudaGetLastError();
}

template <class Epi, int GP, bool HAS_POS>
int stripe_softmax_span(const StripeOperands& x,
                        const typename Epi::Params& ep, cudaStream_t stream) {
#define MEDT_SOFTMAX_LAUNCH(MAXL) \
  return stripe_softmax_instance<Epi, GP, MAXL, HAS_POS>(x, ep, stream)
  if (x.L <= 8) MEDT_SOFTMAX_LAUNCH(8);
  if (x.L <= 16) MEDT_SOFTMAX_LAUNCH(16);
  if (x.L <= 32) MEDT_SOFTMAX_LAUNCH(32);
  MEDT_SOFTMAX_LAUNCH(64);
#undef MEDT_SOFTMAX_LAUNCH
}

template <class Epi, bool HAS_POS>
int stripe_softmax_gp(int gp, const StripeOperands& x,
                      const typename Epi::Params& ep, cudaStream_t stream) {
  switch (gp) {
    case 2: return stripe_softmax_span<Epi, 2, HAS_POS>(x, ep, stream);
    case 4: return stripe_softmax_span<Epi, 4, HAS_POS>(x, ep, stream);
    case 8: return stripe_softmax_span<Epi, 8, HAS_POS>(x, ep, stream);
    case 16: return stripe_softmax_span<Epi, 16, HAS_POS>(x, ep, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Checks the geometry, sets the block shape and launches the instance for
// (gp, L, has_pos).
template <class Epi>
int launch_stripe_softmax(StripeOperands x, int gp, int has_pos,
                          const typename Epi::Params& ep, void* stream_ptr) {
  if (x.S < 1 || x.g < 1 || x.g > 65535 || x.L < 1 ||
      x.L > kSoftmaxMaxSpan) {
    return (int)cudaErrorInvalidValue;
  }
  x.R = x.L < kSoftmaxMaxRows ? x.L : kSoftmaxMaxRows;
  x.SB = kSoftmaxThreads / x.R;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (has_pos) return stripe_softmax_gp<Epi, true>(gp, x, ep, stream);
  return stripe_softmax_gp<Epi, false>(gp, x, ep, stream);
}

}  // namespace
}  // namespace medt
