// Forward axial attention over the stripe-lane layout at spans up to 16,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lanes_attn_core of
// medt_tpu/ops/pallas_axial_lanes.py (body _fwd_kernel: spans <= 16, the
// whole (L, L) tile). The flash contract (spans 17..64) has its own tiled
// forward, csrc/axial_flash_fwd.cu. Per group gi, query row i and stripe s:
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//     qk = sum_c q[c,i,s] k[c,j,s]
//     qr = sum_c q[c,i,s] qemb[c,i,j],  kr = sum_c k[c,j,s] kemb_t[c,i,j]
//   sim = softmax_j(logit)
//   sv[p,i,s] = sum_j sim[j] v[p,j,s],  sve[p,i,s] = sum_j sim[j] vemb[p,i,j]
// on the fused qkv tensor (g, 2gp, L, S): rows [0:c] = q, [c:gp] = k,
// [gp:2gp] = v, c = gp/2; outputs sv, sve (g, gp, L, S).
// Everything is float32.
//
// What bounds it on the H100: per (i, j) pair the kernel does ~6c + 4gp + 8
// flops on operands that it loads once per query row, so the arithmetic
// (float32, outside the tensor cores: contraction depths c <= 8 are far
// too shallow for wgmma) and the L2 traffic both exceed the
// compulsory device-memory traffic (each qkv element read once, each
// output written once). What the design does about it:
//   * one thread per (gi, i, s); s is the minor axis of every tensor, so a
//     warp's loads and stores are 128 contiguous bytes;
//   * the grid's fastest axis is the query row i: the L blocks that read the
//     same k/v columns run together, so k/v come from L2 after the first
//     read and device memory sees each byte about once;
//   * the group-shared tables are read at row i only: the block stages
//     qemb[:, i, :], kemb_t[:, i, :] and vemb[:, i, :] (<= 8 KB) in shared
//     memory, where every thread of the block reads the same address;
//   * the logits of all L <= 16 keys stay in registers; gp <= 16
//     accumulators for sv and sve live in registers;
//   * no shared-memory tiling of k/v and no tensor cores yet: making it fast
//     is later work (PERF.md records its time against the bound).
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 128;   // stripes per block
constexpr int kKeyBlock = 16;   // keys per softmax step
constexpr int kMaxSpan = 16;    // the whole span is one key block

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kThreads)
axial_lanes_fwd_kernel(const float* __restrict__ qkv,
                       const float* __restrict__ qemb,
                       const float* __restrict__ kemb_t,
                       const float* __restrict__ vemb,
                       const float* __restrict__ aff,
                       float* __restrict__ sv, float* __restrict__ sve,
                       int L, int S) {
  constexpr int C = GP / 2;
  __shared__ float t_q[HAS_POS ? C * kMaxSpan : 1];
  __shared__ float t_k[HAS_POS ? C * kMaxSpan : 1];
  __shared__ float t_v[HAS_POS ? GP * kMaxSpan : 1];

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
}

template <int GP>
void launch_gp(const float* qkv, const float* qemb, const float* kemb_t,
               const float* vemb, const float* aff, float* sv, float* sve,
               int g, int L, int S, bool has_pos, cudaStream_t stream) {
  const dim3 grid(L, (S + kThreads - 1) / kThreads, g);
  if (has_pos) {
    axial_lanes_fwd_kernel<GP, true><<<grid, kThreads, 0, stream>>>(
        qkv, qemb, kemb_t, vemb, aff, sv, sve, L, S);
  } else {
    axial_lanes_fwd_kernel<GP, false><<<grid, kThreads, 0, stream>>>(
        qkv, qemb, kemb_t, vemb, aff, sv, sve, L, S);
  }
}

}  // namespace

extern "C" {

// Spans <= 16 (lanes_attn_core). sve is not written when has_pos == 0.
int medt_lanes_attn_fwd(const float* qkv, const float* qemb,
                        const float* kemb_t, const float* vemb,
                        const float* aff, float* sv, float* sve, int g, int gp,
                        int L, int S, int has_pos, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (g < 1 || S < 1 || L < 1 || L > kMaxSpan || g > 65535 ||
      (S + kThreads - 1) / kThreads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  switch (gp) {
    case 2: launch_gp<2>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L, S, pos,
                         stream); break;
    case 4: launch_gp<4>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L, S, pos,
                         stream); break;
    case 8: launch_gp<8>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L, S, pos,
                         stream); break;
    case 16: launch_gp<16>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L, S,
                           pos, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
