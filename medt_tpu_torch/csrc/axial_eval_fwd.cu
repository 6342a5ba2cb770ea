// Fused eval-mode axial attention over stripe-major operands, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel medt_tpu/ops/pallas_axial.py::
// axial_attention_fused (body _attn_kernel). It runs where the lanes family
// has too few stripes to fill a block: batch-1 evaluation (test and predict
// CLIs). Per stripe s, group gi and query row i:
//   logit[j] = (qk*a0 + a1) [+ (qr*a2 + a3) + (kr*a4 + a5)]
//     qk = sum_c q[c,i] k[c,j]
//     qr = sum_c q[c,i] qemb[c,i,j],  kr = sum_c k[c,j] kemb[c,j,i]
//   p = softmax_j(logit)
//   sv[p] = sum_j p_j v[p,j],  sve[p] = sum_j p_j vemb[p,i,j]
//   out[s,gi,p,i] = (sv*oa0[p] + oa1[p]) + (sve*oa2[p] + oa3[p])
// with a = sim_affine[gi, 0..5] (the folded similarity BN) and
// oa = out_affine[gi, 0..3, :] (the folded output BN, f_sv in oa0).
// Operands are stripe-major: q, k (S, g, c, L), v (S, g, gp, L), each with
// its own stripe and group strides and rows of L contiguous floats, so the
// wrapper can pass three views of one fused (S, g, 2gp, L) qkv without a
// split; the tables (c, L, L), (c, L, L), (gp, L, L) are shared by every
// group; out is a dense (S, g, gp, L). Everything is float32.
//
// What bounds it on the H100: at the batch-1 shapes (S <= 64 stripes) one
// launch moves well under 1 MB, so it is bound by launch latency, not by
// bytes or float32 operations. The design keeps the work per launch in one
// wave and every operand out of repeated device-memory reads:
//   * a block of 128 threads packs R query rows (R = min(L, 16)) of
//     SB = 128 / R stripes of one group: at L = 4 a block holds 32 stripes,
//     so short spans still fill the block; the grid is (stripe blocks,
//     groups, row chunks);
//   * the block stages its stripes' k and v rows and the R rows of the
//     three tables it needs in shared memory (kemb is read transposed there,
//     so its global read stays coalesced); strides are padded to odd
//     numbers of floats so the warp's rows fall in distinct banks;
//   * L <= 64, so a thread keeps its whole logits row in registers and
//     takes an exact two-pass softmax (the MAXL template bounds the array);
//     gp <= 16 accumulators for sv and sve live in registers;
//   * the output affine is applied before the one write of each output;
//   * no tensor cores: contraction depths c <= 8 are far too shallow.
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSpan = 64;
constexpr int kMaxRows = 16;

__host__ __device__ inline int odd(int x) { return x | 1; }

struct Geometry {
  int S, g, L, R, SB;
};

template <int GP, bool HAS_POS>
__host__ __device__ inline size_t smem_floats(int L, int R, int SB) {
  constexpr int C = GP / 2;
  const size_t tables = HAS_POS ? (size_t)(2 * C + GP) * R * odd(L) : 0;
  return tables + (size_t)SB * (odd(C * L) + odd(GP * L));
}

template <int GP, int MAXL, bool HAS_POS>
__global__ void __launch_bounds__(kThreads)
axial_eval_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ qemb,
                      const float* __restrict__ kemb,
                      const float* __restrict__ vemb,
                      const float* __restrict__ sim_aff,
                      const float* __restrict__ out_aff,
                      float* __restrict__ out, long long q_ss, long long q_sg,
                      long long k_ss, long long k_sg, long long v_ss,
                      long long v_sg, Geometry geo) {
  constexpr int C = GP / 2;
  extern __shared__ float smem[];
  const int L = geo.L, R = geo.R, SB = geo.SB;
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
    for (int t = tid; t < C * R * L; t += kThreads) {
      const int c = t / (R * L), rem = t - c * R * L;
      const int il = rem / L, j = rem - il * L, i = i0 + il;
      t_q[(c * R + il) * Lo + j] =
          i < L ? qemb[((size_t)c * L + i) * L + j] : 0.f;
    }
    for (int t = tid; t < GP * R * L; t += kThreads) {
      const int p = t / (R * L), rem = t - p * R * L;
      const int il = rem / L, j = rem - il * L, i = i0 + il;
      t_v[(p * R + il) * Lo + j] =
          i < L ? vemb[((size_t)p * L + i) * L + j] : 0.f;
    }
    // kemb[c, j, i], read with i minor (coalesced), stored as [c][i][j]
    for (int t = tid; t < C * L * R; t += kThreads) {
      const int c = t / (L * R), rem = t - c * L * R;
      const int j = rem / R, il = rem - j * R, i = i0 + il;
      t_k[(c * R + il) * Lo + j] =
          i < L ? kemb[((size_t)c * L + j) * L + i] : 0.f;
    }
  }
  // the block's stripes: k rows (c, j) and v rows (p, j), each contiguous
  for (int t = tid; t < SB * C * L; t += kThreads) {
    const int sl = t / (C * L), r = t - sl * (C * L), s = s0 + sl;
    s_k[sl * KS + r] = s < geo.S ? k[s * k_ss + gi * k_sg + r] : 0.f;
  }
  for (int t = tid; t < SB * GP * L; t += kThreads) {
    const int sl = t / (GP * L), r = t - sl * (GP * L), s = s0 + sl;
    s_v[sl * VS + r] = s < geo.S ? v[s * v_ss + gi * v_sg + r] : 0.f;
  }
  __syncthreads();

  const int sl = tid / R, il = tid - sl * R;
  const int s = s0 + sl, i = i0 + il;
  if (sl >= SB || s >= geo.S || i >= L) return;

  const float* a = sim_aff + gi * 8;
  const float a0 = a[0], a1 = a[1];
  float a2 = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f;
  if constexpr (HAS_POS) {
    a2 = a[2]; a3 = a[3]; a4 = a[4]; a5 = a[5];
  }

  float qv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) qv[c] = q[s * q_ss + gi * q_sg + c * L + i];

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
      float x = qk * a0 + a1;
      if constexpr (HAS_POS) x = x + (qr * a2 + a3) + (kr * a4 + a5);
      lg[j] = x;
      mx = fmaxf(mx, x);
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

  const float inv_l = 1.f / l;
  const float* oa = out_aff + (size_t)gi * 4 * GP;
  float* o = out + ((size_t)s * geo.g + gi) * GP * L + i;
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    const float sv = acc_v[p] * inv_l, sve = acc_e[p] * inv_l;
    o[p * L] = (sv * oa[p] + oa[GP + p]) + (sve * oa[2 * GP + p] +
                                           oa[3 * GP + p]);
  }
}

template <int GP, int MAXL, bool HAS_POS>
int launch_instance(const float* q, const float* k, const float* v,
                    const float* qemb, const float* kemb, const float* vemb,
                    const float* sim_aff, const float* out_aff, float* out,
                    long long q_ss, long long q_sg, long long k_ss,
                    long long k_sg, long long v_ss, long long v_sg,
                    Geometry geo, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * smem_floats<GP, HAS_POS>(geo.L, geo.R, geo.SB);
  auto kernel = axial_eval_fwd_kernel<GP, MAXL, HAS_POS>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((geo.S + geo.SB - 1) / geo.SB, geo.g,
                  (geo.L + geo.R - 1) / geo.R);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, qemb, kemb, vemb,
                                            sim_aff, out_aff, out, q_ss,
                                            q_sg, k_ss, k_sg, v_ss, v_sg, geo);
  return (int)cudaGetLastError();
}

template <int GP, bool HAS_POS>
int launch_span(const float* q, const float* k, const float* v,
                const float* qemb, const float* kemb, const float* vemb,
                const float* sim_aff, const float* out_aff, float* out,
                long long q_ss, long long q_sg, long long k_ss, long long k_sg,
                long long v_ss, long long v_sg, Geometry geo,
                cudaStream_t stream) {
#define MEDT_EVAL_LAUNCH(MAXL)                                               \
  return launch_instance<GP, MAXL, HAS_POS>(q, k, v, qemb, kemb, vemb,       \
                                            sim_aff, out_aff, out, q_ss,     \
                                            q_sg, k_ss, k_sg, v_ss, v_sg,    \
                                            geo, stream)
  if (geo.L <= 8) MEDT_EVAL_LAUNCH(8);
  if (geo.L <= 16) MEDT_EVAL_LAUNCH(16);
  if (geo.L <= 32) MEDT_EVAL_LAUNCH(32);
  MEDT_EVAL_LAUNCH(64);
#undef MEDT_EVAL_LAUNCH
}

template <bool HAS_POS>
int launch_gp(int gp, const float* q, const float* k, const float* v,
              const float* qemb, const float* kemb, const float* vemb,
              const float* sim_aff, const float* out_aff, float* out,
              long long q_ss, long long q_sg, long long k_ss, long long k_sg,
              long long v_ss, long long v_sg, Geometry geo,
              cudaStream_t stream) {
  switch (gp) {
#define MEDT_EVAL_GP(GP)                                                     \
  case GP:                                                                   \
    return launch_span<GP, HAS_POS>(q, k, v, qemb, kemb, vemb, sim_aff,      \
                                    out_aff, out, q_ss, q_sg, k_ss, k_sg,    \
                                    v_ss, v_sg, geo, stream);
    MEDT_EVAL_GP(2)
    MEDT_EVAL_GP(4)
    MEDT_EVAL_GP(8)
    MEDT_EVAL_GP(16)
#undef MEDT_EVAL_GP
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k (S, g, c, L), v (S, g, gp, L): stripe stride *_ss and group stride
// *_sg in floats, rows of L contiguous floats. Tables are not read when
// has_pos == 0 (the position-free mode); out (S, g, gp, L) dense.
int medt_axial_eval_fwd(const float* q, const float* k, const float* v,
                        const float* qemb, const float* kemb,
                        const float* vemb, const float* sim_aff,
                        const float* out_aff, float* out, long long q_ss,
                        long long q_sg, long long k_ss, long long k_sg,
                        long long v_ss, long long v_sg, int S, int g, int gp,
                        int L, int has_pos, void* stream_ptr) {
  if (S < 1 || g < 1 || g > 65535 || L < 1 || L > kMaxSpan) {
    return (int)cudaErrorInvalidValue;
  }
  Geometry geo;
  geo.S = S;
  geo.g = g;
  geo.L = L;
  geo.R = L < kMaxRows ? L : kMaxRows;
  geo.SB = kThreads / geo.R;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (has_pos) {
    return launch_gp<true>(gp, q, k, v, qemb, kemb, vemb, sim_aff, out_aff,
                           out, q_ss, q_sg, k_ss, k_sg, v_ss, v_sg, geo,
                           stream);
  }
  return launch_gp<false>(gp, q, k, v, qemb, kemb, vemb, sim_aff, out_aff,
                          out, q_ss, q_sg, k_ss, k_sg, v_ss, v_sg, geo,
                          stream);
}

}  // extern "C"
