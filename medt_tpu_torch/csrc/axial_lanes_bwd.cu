// Backward of the lanes-attention cores, for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of medt_tpu/ops/pallas_axial_lanes.py:
//   * the lanes backward _bwd_rule (body _bwd_kernel): spans <= 16, the
//     softmax recomputed from the logits;
//   * the flash backward _flash_bwd_rule (body _flash_bwd_kernel): spans
//     up to 64, probabilities rebuilt from the forward's saved row max m
//     and denominator l, and delta from its saved outputs sv, sve.
// Same forward as csrc/axial_lanes_fwd.cu (per group gi, query i, key j,
// stripe s; c = gp/2):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   sv[p,i] = sum_j p_ij v[p,j],  sve[p,i] = sum_j p_ij vemb[p,i,j]
// Given dsv, dsve (g, gp, L, S), with
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   delta_i = sum_j p_ij dsim_ij = sum_p dsv[p,i] sv[p,i] + dsve[p,i] sve[p,i]
//   dlog_ij = p_ij (dsim_ij - delta_i)
// it writes the fused dqkv (g, 2gp, L, S):
//   dq[c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])
//   dv[p,j] = sum_i p_ij dsv[p,i]
// the table gradients, summed over every group and stripe,
//   dqemb[c,i,j] = a2 sum dlog_ij q[c,i],  dkemb_t[c,i,j] = a4 sum dlog_ij k[c,j]
//   dvemb[p,i,j] = sum p_ij dsve[p,i]
// and daff (g, 8) = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog,
//                    sum dlog*kr, sum dlog, 0, 0] (rows 2..5 zero w/o pos).
//
// The TPU kernel holds a whole (L, Jb, Sb) tile per program and
// accumulates the table and affine gradients in VMEM blocks that stay
// resident across its sequential grid. Here blocks run in parallel, so:
//   * row pass, one thread per (gi, query i, stripe s): the softmax stats
//     (recomputed by an online pass for lanes, read for flash), delta, dq,
//     and, per key j, the table-gradient terms of row i, summed over the
//     block's 128 stripes by warp shuffles into per-warp shared slots; each
//     block writes its (2gp, i, :) table partial and its daff partial;
//   * column pass, one thread per (gi, key j, stripe s): recomputes p_ij
//     from the row pass's (m, l, delta) and sums dk, dv over i — the
//     column sums a row thread cannot form without atomics;
//   * two small kernels sum the partials in a fixed order (reduce.cuh).
// What bounds it on the H100: like the forward, arithmetic and L2 traffic
// on the L x L pairs (each pass recomputes the logits; the table-gradient
// shuffles add ~10 gp operations per pair with positions), far above the
// compulsory device-memory traffic. Making it fast is later work (PERF.md).
// Kernels launch on the caller's stream, allocate nothing (the wrapper
// passes scratch) and do not synchronise; the entry points return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"

namespace {

using medt::kBlockStripes;
using medt::kWarps;
using medt::warp_sum;

constexpr int kMaxSpan = 64;

struct BwdArgs {
  const float* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  const float* aff;
  const float* sv;    // flash: saved forward outputs; lanes: null
  const float* sve;
  const float* dsv;
  const float* dsve;
  float* m;           // flash: the saved row max; lanes: scratch written
  float* l;           // by the row pass
  float* delta;       // scratch (g, L, S)
  float* dqkv;
  float* tab_part;    // (g * blocks, 2gp, L, L) with positions
  float* aff_part;    // (L * blocks, g, 4)
  int g, L, S;
  bool recompute;     // lanes: recompute (m, l) and delta from the logits
};

// Dynamic shared memory of the row pass, in floats: table rows
// (2c + gp) * L, per-warp table-gradient slots kWarps * L * 2gp, per-warp
// daff slots kWarps * 4.
inline size_t row_smem_bytes(int gp, int L, bool has_pos) {
  const size_t tabs = has_pos ? (size_t)(2 * gp) * L : 0;
  const size_t slots = has_pos ? (size_t)kWarps * L * 2 * gp : 0;
  return (tabs + slots + kWarps * 4) * sizeof(float);
}

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kBlockStripes)
lanes_bwd_row_kernel(BwdArgs a) {
  constexpr int C = GP / 2;
  constexpr int T = 2 * GP;  // table-gradient rows: dqemb c, dkemb_t c, dvemb gp
  extern __shared__ float smem[];
  const int L = a.L, S = a.S;
  float* t_q = smem;                    // qemb[c, i, :]
  float* t_k = t_q + C * L;             // kemb_t[c, i, :]
  float* t_v = t_k + C * L;             // vemb[p, i, :]
  float* w_tab = HAS_POS ? t_v + GP * L : smem;  // [warp][j][T]
  float* w_aff = HAS_POS ? w_tab + kWarps * L * T : smem;  // [warp][4]

  const int i = blockIdx.x;
  const int gi = blockIdx.z;
  const int s = blockIdx.y * kBlockStripes + threadIdx.x;
  const bool valid = s < S;
  // A thread past the ragged edge computes stripe 0 with a zero upstream
  // gradient: every sum it joins gets exactly 0 from it.
  const int sc = valid ? s : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if constexpr (HAS_POS) {
    for (int t = threadIdx.x; t < C * L; t += kBlockStripes) {
      const int c = t / L, j = t - c * L;
      const size_t src = ((size_t)c * L + i) * L + j;
      t_q[t] = a.qemb[src];
      t_k[t] = a.kemb_t[src];
    }
    for (int t = threadIdx.x; t < GP * L; t += kBlockStripes) {
      const int p = t / L, j = t - p * L;
      t_v[t] = a.vemb[((size_t)p * L + i) * L + j];
    }
    __syncthreads();
  }

  const float* af = a.aff + gi * 8;
  const float a0 = af[0], a1 = af[1], a2 = af[2], a3 = af[3], a4 = af[4],
              a5 = af[5];
  const size_t LS = (size_t)L * S;
  const float* base = a.qkv + (size_t)gi * 2 * GP * LS + sc;
  const size_t out_i = (size_t)gi * GP * LS + (size_t)i * S + sc;

  float q[C], gv[GP], ge[GP];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = base[c * LS + (size_t)i * S];
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    gv[p] = valid ? a.dsv[out_i + p * LS] : 0.f;
    ge[p] = (HAS_POS && valid) ? a.dsve[out_i + p * LS] : 0.f;
  }

  auto logit_parts = [&](int j, const float* kj, float& qk, float& qr,
                         float& kr) {
    qk = qr = kr = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qk += q[c] * kj[c];
      if constexpr (HAS_POS) {
        qr += q[c] * t_q[c * L + j];
        kr += kj[c] * t_k[c * L + j];
      }
    }
  };
  auto logit = [&](float qk, float qr, float kr) {
    float x = qk * a0 + a1;
    if constexpr (HAS_POS) x += (qr * a2 + a3) + (kr * a4 + a5);
    return x;
  };

  const size_t row = ((size_t)gi * L + i) * S + sc;
  float m, l, delta = 0.f;
  if (a.recompute) {
    // online softmax over the keys, as the forward kernel runs it
    float acc_v[GP], acc_e[GP];
#pragma unroll
    for (int p = 0; p < GP; ++p) acc_v[p] = acc_e[p] = 0.f;
    m = -1e30f;
    l = 0.f;
    for (int j = 0; j < L; ++j) {
      float kj[C], qk, qr, kr;
#pragma unroll
      for (int c = 0; c < C; ++c) kj[c] = base[(C + c) * LS + (size_t)j * S];
      logit_parts(j, kj, qk, qr, kr);
      const float x = logit(qk, qr, kr);
      const float m_new = fmaxf(m, x);
      const float alpha = expf(m - m_new);
      const float e = expf(x - m_new);
      l = l * alpha + e;
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        acc_v[p] = acc_v[p] * alpha + e * base[(GP + p) * LS + (size_t)j * S];
        if constexpr (HAS_POS) acc_e[p] = acc_e[p] * alpha + e * t_v[p * L + j];
      }
      m = m_new;
    }
    const float inv_l = 1.f / l;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      delta += gv[p] * (acc_v[p] * inv_l);
      if constexpr (HAS_POS) delta += ge[p] * (acc_e[p] * inv_l);
    }
  } else {
    m = a.m[row];
    l = a.l[row];
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      delta += gv[p] * a.sv[out_i + p * LS];
      if constexpr (HAS_POS) delta += ge[p] * a.sve[out_i + p * LS];
    }
  }
  const float inv_l = 1.f / l;

  float dq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dq[c] = 0.f;
  float s_qk = 0.f, s_b = 0.f, s_qr = 0.f, s_kr = 0.f;
  for (int j = 0; j < L; ++j) {
    float kj[C], qk, qr, kr;
#pragma unroll
    for (int c = 0; c < C; ++c) kj[c] = base[(C + c) * LS + (size_t)j * S];
    logit_parts(j, kj, qk, qr, kr);
    const float pj = expf(logit(qk, qr, kr) - m) * inv_l;
    float dsim = 0.f;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      dsim += gv[p] * base[(GP + p) * LS + (size_t)j * S];
      if constexpr (HAS_POS) dsim += ge[p] * t_v[p * L + j];
    }
    const float dlog = pj * (dsim - delta);
    s_b += dlog;
    s_qk += dlog * qk;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dq[c] += (dlog * a0) * kj[c];
      if constexpr (HAS_POS) dq[c] += (dlog * a2) * t_q[c * L + j];
    }
    if constexpr (HAS_POS) {
      s_qr += dlog * qr;
      s_kr += dlog * kr;
      float* slot = w_tab + ((size_t)warp * L + j) * T;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float tq = warp_sum((dlog * a2) * q[c]);
        const float tk = warp_sum((dlog * a4) * kj[c]);
        if (lane == 0) {
          slot[c] = tq;
          slot[C + c] = tk;
        }
      }
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        const float tv = warp_sum(pj * ge[p]);
        if (lane == 0) slot[2 * C + p] = tv;
      }
    }
  }

  if (valid) {
    const size_t dq0 = (size_t)gi * 2 * GP * LS + (size_t)i * S + s;
#pragma unroll
    for (int c = 0; c < C; ++c) a.dqkv[dq0 + c * LS] = dq[c];
    if (a.recompute) {
      a.m[row] = m;
      a.l[row] = l;
    }
    a.delta[row] = delta;
  }

  const float sums[4] = {s_qk, s_b, s_qr, s_kr};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) w_aff[warp * 4 + k] = v;
  }
  __syncthreads();
  const int blocks = gridDim.y;
  if (threadIdx.x < 4) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += w_aff[w * 4 + threadIdx.x];
    a.aff_part[(((size_t)i * blocks + blockIdx.y) * a.g + gi) * 4 +
               threadIdx.x] = v;
  }
  if constexpr (HAS_POS) {
    float* part = a.tab_part +
                  ((size_t)gi * blocks + blockIdx.y) * T * L * L +
                  (size_t)i * L;
    for (int t = threadIdx.x; t < L * T; t += kBlockStripes) {
      const int j = t / T, r = t - j * T;
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += w_tab[((size_t)w * L + j) * T + r];
      part[(size_t)r * L * L + j] = v;
    }
  }
}

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kBlockStripes)
lanes_bwd_col_kernel(BwdArgs a) {
  constexpr int C = GP / 2;
  __shared__ float c_q[HAS_POS ? C * kMaxSpan : 1];  // qemb[c, :, j]
  __shared__ float c_k[HAS_POS ? C * kMaxSpan : 1];  // kemb_t[c, :, j]
  __shared__ float c_v[HAS_POS ? GP * kMaxSpan : 1];  // vemb[p, :, j]
  const int L = a.L, S = a.S;
  const int j = blockIdx.x;
  const int gi = blockIdx.z;
  const int s = blockIdx.y * kBlockStripes + threadIdx.x;

  if constexpr (HAS_POS) {
    for (int t = threadIdx.x; t < C * L; t += kBlockStripes) {
      const int c = t / L, i = t - c * L;
      const size_t src = ((size_t)c * L + i) * L + j;
      c_q[t] = a.qemb[src];
      c_k[t] = a.kemb_t[src];
    }
    for (int t = threadIdx.x; t < GP * L; t += kBlockStripes) {
      const int p = t / L, i = t - p * L;
      c_v[t] = a.vemb[((size_t)p * L + i) * L + j];
    }
    __syncthreads();
  }
  if (s >= S) return;

  const float* af = a.aff + gi * 8;
  const float a0 = af[0], a1 = af[1], a2 = af[2], a3 = af[3], a4 = af[4],
              a5 = af[5];
  const size_t LS = (size_t)L * S;
  const float* base = a.qkv + (size_t)gi * 2 * GP * LS + s;
  const float* gvb = a.dsv + (size_t)gi * GP * LS + s;
  const float* geb = HAS_POS ? a.dsve + (size_t)gi * GP * LS + s : nullptr;
  const size_t row0 = (size_t)gi * LS + s;

  float kj[C], vj[GP], dk[C], dv[GP];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    kj[c] = base[(C + c) * LS + (size_t)j * S];
    dk[c] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    vj[p] = base[(GP + p) * LS + (size_t)j * S];
    dv[p] = 0.f;
  }

  for (int i = 0; i < L; ++i) {
    float qi[C], qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qi[c] = base[c * LS + (size_t)i * S];
      qk += qi[c] * kj[c];
      if constexpr (HAS_POS) {
        qr += qi[c] * c_q[c * L + i];
        kr += kj[c] * c_k[c * L + i];
      }
    }
    float x = qk * a0 + a1;
    if constexpr (HAS_POS) x += (qr * a2 + a3) + (kr * a4 + a5);
    const size_t row = row0 + (size_t)i * S;
    const float pij = expf(x - a.m[row]) * (1.f / a.l[row]);
    float dsim = 0.f;
    float gi_v[GP];
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      gi_v[p] = gvb[p * LS + (size_t)i * S];
      dsim += gi_v[p] * vj[p];
      if constexpr (HAS_POS) dsim += geb[p * LS + (size_t)i * S] * c_v[p * L + i];
    }
    const float dlog = pij * (dsim - a.delta[row]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[c] += (dlog * a0) * qi[c];
      if constexpr (HAS_POS) dk[c] += (dlog * a4) * c_k[c * L + i];
    }
#pragma unroll
    for (int p = 0; p < GP; ++p) dv[p] += pij * gi_v[p];
  }

  const size_t out0 = (size_t)gi * 2 * GP * LS + (size_t)j * S + s;
#pragma unroll
  for (int c = 0; c < C; ++c) a.dqkv[out0 + (C + c) * LS] = dk[c];
#pragma unroll
  for (int p = 0; p < GP; ++p) a.dqkv[out0 + (GP + p) * LS] = dv[p];
}

// daff (g, 8) from the (L * blocks, g, 4) partials, summed in index order.
__global__ void daff_finalize_kernel(const float* __restrict__ part,
                                     float* __restrict__ daff, int P, int g,
                                     int has_pos) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g * 8) return;
  const int gi = t / 8, col = t - gi * 8;
  // column -> partial: 0 qk, 1/3/5 the bias sum, 2 qr, 4 kr; 6, 7 zero
  const int src[8] = {0, 1, 2, 1, 3, 1, -1, -1};
  const int k = (col >= 2 && !has_pos) ? -1 : src[col];
  float v = 0.f;
  if (k >= 0) {
    for (int p = 0; p < P; ++p) v += part[((size_t)p * g + gi) * 4 + k];
  }
  daff[t] = v;
}

template <int GP, bool HAS_POS>
void launch_gp(const BwdArgs& a, cudaStream_t stream) {
  const int blocks = medt::stripe_blocks(a.S);
  const dim3 grid(a.L, blocks, a.g);
  lanes_bwd_row_kernel<GP, HAS_POS>
      <<<grid, kBlockStripes, row_smem_bytes(GP, a.L, HAS_POS), stream>>>(a);
  lanes_bwd_col_kernel<GP, HAS_POS><<<grid, kBlockStripes, 0, stream>>>(a);
}

// dtables: (2gp, L, L) = dqemb (c rows), dkemb_t (c rows), dvemb (gp rows).
int launch(const BwdArgs& a, float* dtables, float* daff, int gp, int has_pos,
           int n_tab_part, int n_aff_part, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = medt::stripe_blocks(a.S);
  if (a.g < 1 || a.S < 1 || a.L < 1 || a.L > kMaxSpan || a.g > 65535 ||
      blocks > 65535 || n_aff_part != a.L * blocks ||
      (has_pos && n_tab_part != a.g * blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  switch (gp) {
    case 2: pos ? launch_gp<2, true>(a, stream) : launch_gp<2, false>(a, stream); break;
    case 4: pos ? launch_gp<4, true>(a, stream) : launch_gp<4, false>(a, stream); break;
    case 8: pos ? launch_gp<8, true>(a, stream) : launch_gp<8, false>(a, stream); break;
    case 16: pos ? launch_gp<16, true>(a, stream) : launch_gp<16, false>(a, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (pos) {
    medt::sum_partials(a.tab_part, dtables, n_tab_part,
                       (size_t)2 * gp * a.L * a.L, stream);
  }
  daff_finalize_kernel<<<(a.g * 8 + 127) / 128, 128, 0, stream>>>(
      a.aff_part, daff, n_aff_part, a.g, has_pos);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes backward (spans <= 16): (m, l) and delta recomputed; m, l, delta
// are scratch (g, L, S). Partials: tab_part (g * ceil(S/128), 2gp, L, L)
// (unused without positions), aff_part (L * ceil(S/128), g, 4).
int medt_lanes_attn_bwd(const float* qkv, const float* qemb,
                        const float* kemb_t, const float* vemb,
                        const float* aff, const float* dsv, const float* dsve,
                        float* dqkv, float* dtables, float* daff, float* m,
                        float* l, float* delta, float* tab_part,
                        float* aff_part, int g, int gp, int L, int S,
                        int has_pos, int n_tab_part, int n_aff_part,
                        void* stream) {
  if (L > 16) return (int)cudaErrorInvalidValue;
  const BwdArgs a{qkv, qemb, kemb_t, vemb, aff, nullptr, nullptr, dsv, dsve,
                  m, l, delta, dqkv, tab_part, aff_part, g, L, S, true};
  return launch(a, dtables, daff, gp, has_pos, n_tab_part, n_aff_part,
                stream);
}

// Flash backward (spans <= 64): m, l, sv, sve are the forward's saved
// outputs (m, l read only); delta is scratch (g, L, S).
int medt_flash_lanes_bwd(const float* qkv, const float* qemb,
                         const float* kemb_t, const float* vemb,
                         const float* aff, const float* m, const float* l,
                         const float* sv, const float* sve, const float* dsv,
                         const float* dsve, float* dqkv, float* dtables,
                         float* daff, float* delta, float* tab_part,
                         float* aff_part, int g, int gp, int L, int S,
                         int has_pos, int n_tab_part, int n_aff_part,
                         void* stream) {
  const BwdArgs a{qkv, qemb, kemb_t, vemb, aff, sv, sve, dsv, dsve,
                  const_cast<float*>(m), const_cast<float*>(l), delta, dqkv,
                  tab_part, aff_part, g, L, S, false};
  return launch(a, dtables, daff, gp, has_pos, n_tab_part, n_aff_part,
                stream);
}

}  // extern "C"
