// Forward axial attention at long spans (64 < L <= 256), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash2_lanes_core of
// medt_tpu/ops/pallas_axial_lanes.py (forward pallas_call; body
// _flash2_fwd_kernel): the query- and key-streamed lanes attention of the
// 512 px models' global branch. Per group gi, query row i and stripe s:
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//     qk = sum_c q[c,i,s] k[c,j,s]
//     qr = sum_c q[c,i,s] qemb[c,i,j],  kr = sum_c k[c,j,s] kemb_t[c,i,j]
//   sim = softmax_j(logit)
//   sv[p,i,s] = sum_j sim[j] v[p,j,s],  sve[p,i,s] = sum_j sim[j] vemb[p,i,j]
// on the fused qkv tensor (g, 2gp, L, S): rows [0:c] = q, [c:gp] = k,
// [gp:2gp] = v, c = gp/2; outputs sv, sve (g, gp, L, S) and the row max m
// and softmax denominator l (g, L, S) that the backward rebuilds p from.
// Everything is float32.
//
// The TPU kernel streams query blocks (Ib rows) and key blocks through
// VMEM, with the tables pre-blocked so that its key loop slices no lane
// axis. None of that carries over. On the H100:
//   * one thread per (gi, i, s); s is the minor axis of every tensor, so a
//     warp's loads and stores are 128 contiguous bytes. The query axis is
//     the grid's fastest axis, so the L blocks that read the same k/v
//     columns run together and take them from L2;
//   * keys are streamed: an online softmax over blocks of 16 keys keeps
//     only 16 logits, the running max and sum and gp <= 16 accumulators
//     each for sv and sve in registers, whatever the span;
//   * the block stages the table rows of its query, qemb[:, i, :],
//     kemb_t[:, i, :] and vemb[:, i, :] ((2c + gp) * L floats, 8 KB at
//     L = 256 with gp = 4), in dynamic shared memory sized from L at launch;
//     every thread of the block reads the same address. Above 48 KB the
//     launch opts in to more shared memory and returns the error if the
//     card refuses it (no smaller fallback);
//   * no tensor cores: the contraction depth c <= 8 is far too shallow.
// What bounds it: per (i, j) pair ~6c + 4gp + 8 float32 operations on
// operands read from L2 (k, v) and shared memory (tables); making it fast
// is later work (PERF.md records its time against the bound).
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns the first CUDA error of its launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;   // stripes per block
constexpr int kKeyBlock = 16;   // keys per online-softmax step
constexpr int kMaxSpan = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kThreads)
flash2_fwd_kernel(const float* __restrict__ qkv,
                  const float* __restrict__ qemb,
                  const float* __restrict__ kemb_t,
                  const float* __restrict__ vemb,
                  const float* __restrict__ aff, float* __restrict__ sv,
                  float* __restrict__ sve, float* __restrict__ m_out,
                  float* __restrict__ l_out, int L, int S) {
  constexpr int C = GP / 2;
  extern __shared__ float smem[];
  float* t_q = smem;           // qemb[c, i, :]
  float* t_k = t_q + C * L;    // kemb_t[c, i, :]
  float* t_v = t_k + C * L;    // vemb[p, i, :]

  const int i = blockIdx.x;
  const int gi = blockIdx.z;
  const int s = blockIdx.y * kThreads + threadIdx.x;

  if constexpr (HAS_POS) {
    for (int t = threadIdx.x; t < C * L; t += kThreads) {
      const int c = t / L, j = t - c * L;
      const size_t src = ((size_t)c * L + i) * L + j;
      t_q[t] = qemb[src];
      t_k[t] = kemb_t[src];
    }
    for (int t = threadIdx.x; t < GP * L; t += kThreads) {
      const int p = t / L, j = t - p * L;
      t_v[t] = vemb[((size_t)p * L + i) * L + j];
    }
    __syncthreads();
  }
  if (s >= S) return;

  const float a0 = aff[gi * 8 + 0], a1 = aff[gi * 8 + 1];
  const float a2 = aff[gi * 8 + 2], a3 = aff[gi * 8 + 3];
  const float a4 = aff[gi * 8 + 4], a5 = aff[gi * 8 + 5];

  const size_t LS = (size_t)L * S;
  // element (row r, position j) of this group and stripe: base[r*LS + j*S]
  const float* base = qkv + (size_t)gi * 2 * GP * LS + s;

  float q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = base[c * LS + (size_t)i * S];

  float m = -1e30f, l = 0.f;
  float acc_v[GP], acc_e[GP];
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    acc_v[p] = 0.f;
    acc_e[p] = 0.f;
  }

  for (int j0 = 0; j0 < L; j0 += kKeyBlock) {
    float lg[kKeyBlock];
    float bmax = -1e30f;
#pragma unroll
    for (int jj = 0; jj < kKeyBlock; ++jj) {
      const int j = j0 + jj;
      lg[jj] = -1e30f;
      if (j < L) {
        float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float kv = base[(C + c) * LS + (size_t)j * S];
          qk += q[c] * kv;
          if constexpr (HAS_POS) {
            qr += q[c] * t_q[c * L + j];
            kr += kv * t_k[c * L + j];
          }
        }
        float x = qk * a0 + a1;
        if constexpr (HAS_POS) x += (qr * a2 + a3) + (kr * a4 + a5);
        lg[jj] = x;
        bmax = fmaxf(bmax, x);
      }
    }
    const float m_new = fmaxf(m, bmax);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      acc_v[p] *= alpha;
      if constexpr (HAS_POS) acc_e[p] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < kKeyBlock; ++jj) {
      const int j = j0 + jj;
      if (j < L) {
        const float e = expf(lg[jj] - m_new);
        l += e;
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          acc_v[p] += e * base[(GP + p) * LS + (size_t)j * S];
          if constexpr (HAS_POS) acc_e[p] += e * t_v[p * L + j];
        }
      }
    }
    m = m_new;
  }

  const float inv_l = 1.f / l;
  const size_t out0 = (size_t)gi * GP * LS + (size_t)i * S + s;
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    sv[out0 + p * LS] = acc_v[p] * inv_l;
    if constexpr (HAS_POS) sve[out0 + p * LS] = acc_e[p] * inv_l;
  }
  const size_t row = ((size_t)gi * L + i) * S + s;
  m_out[row] = m;
  l_out[row] = l;
}

template <int GP, bool HAS_POS>
cudaError_t launch_variant(const float* qkv, const float* qemb,
                           const float* kemb_t, const float* vemb,
                           const float* aff, float* sv, float* sve, float* m,
                           float* l, int g, int L, int S,
                           cudaStream_t stream) {
  const size_t smem = HAS_POS ? (size_t)2 * GP * L * sizeof(float) : 0;
  auto kernel = flash2_fwd_kernel<GP, HAS_POS>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(L, (S + kThreads - 1) / kThreads, g);
  kernel<<<grid, kThreads, smem, stream>>>(qkv, qemb, kemb_t, vemb, aff, sv,
                                           sve, m, l, L, S);
  return cudaGetLastError();
}

template <int GP>
cudaError_t launch_gp(const float* qkv, const float* qemb,
                      const float* kemb_t, const float* vemb,
                      const float* aff, float* sv, float* sve, float* m,
                      float* l, int g, int L, int S, bool has_pos,
                      cudaStream_t stream) {
  return has_pos
             ? launch_variant<GP, true>(qkv, qemb, kemb_t, vemb, aff, sv, sve,
                                        m, l, g, L, S, stream)
             : launch_variant<GP, false>(qkv, qemb, kemb_t, vemb, aff, sv,
                                         sve, m, l, g, L, S, stream);
}

}  // namespace

extern "C" {

// Spans 1..256 (the model routes 65..256 here). sve is not written when
// has_pos == 0; m and l are (g, L, S) each.
int medt_flash2_lanes_fwd(const float* qkv, const float* qemb,
                          const float* kemb_t, const float* vemb,
                          const float* aff, float* sv, float* sve, float* m,
                          float* l, int g, int gp, int L, int S, int has_pos,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (g < 1 || S < 1 || L < 1 || L > kMaxSpan || g > 65535 ||
      (S + kThreads - 1) / kThreads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  cudaError_t err;
  switch (gp) {
    case 2: err = launch_gp<2>(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g,
                               L, S, pos, stream); break;
    case 4: err = launch_gp<4>(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g,
                               L, S, pos, stream); break;
    case 8: err = launch_gp<8>(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g,
                               L, S, pos, stream); break;
    case 16: err = launch_gp<16>(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l,
                                 g, L, S, pos, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
