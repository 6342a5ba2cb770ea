// Backward of the stripe-major train-mode attention core, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel medt_tpu/ops/pallas_axial_train.py::
// _fused_bwd_rule (pl.pallas_call at :306, body _bwd_kernel). Same forward
// as csrc/axial_stripe_fwd.cu (per stripe s, group gi, query i, key j;
// c = gp/2; layouts stripe-major: q, k, v views with free stripe and group
// strides and rows of L contiguous floats, as the forward takes them; the
// upstream and input gradients dense):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   sv[p,i] = sum_j p_ij v[p,j],  sve[p,i] = sum_j p_ij vemb[p,i,j]
// Given dsv, dsve (S, g, gp, L), with
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   delta_i = sum_j p_ij dsim_ij = sum_p dsv[p,i] sv[p,i] + dsve[p,i] sve[p,i]
//   dlog_ij = p_ij (dsim_ij - delta_i)
// it writes
//   dq[s,gi,c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[s,gi,c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb[c,j,i])
//   dv[s,gi,p,j] = sum_i p_ij dsv[p,i]
// the table gradients, summed over every stripe and group,
//   dqemb[c,i,j] = sum a2 dlog_ij q[c,i]
//   dkemb[c,j,i] = sum a4 dlog_ij k[c,j]
//   dvemb[p,i,j] = sum p_ij dsve[p,i]
// and daff (g, 8) = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog,
//                    sum dlog*kr, sum dlog, 0, 0] (columns 2..5 zero
//                    without positions), as _bwd_kernel lays it out.
//
// The TPU kernel walks stripe blocks in order and accumulates the table and
// affine gradients in VMEM blocks that stay resident across its grid. Here
// blocks run in parallel, so the scheme of csrc/axial_lanes_bwd.cu is
// taken over to the stripe-major layout:
//   * row pass, one thread per (stripe s, group gi, query i), a block one
//     warp of 32 stripes at one (i, gi): the softmax statistics m, l
//     recomputed by an online pass (which also gives sv, sve and so
//     delta), then dq, and per key j the table-gradient terms of row i,
//     summed over the warp's stripes by shuffles and written by lane 0 to
//     the block's slot of a partial buffer; likewise the daff sums;
//   * column pass, one thread per (s, gi, key j): rebuilds p_ij from the row
//     pass's (m, l, delta) and sums dk, dv over i, the column sums that a
//     row thread cannot form without atomics;
//   * two small kernels (csrc/reduce.cuh) sum the partials in index order.
// No atomics: every call gives the same bits. The partial buffers, from the
// wrapper (ops/axial_train.py): tables (g * ceil(S/32), 2gp, L, L) floats
// with positions, none without; daff (L * ceil(S/32), g, 4) floats. At the
// batch-1 sites (g = 8): span 64, gp 2, S 64: 16 x 4 x 64 x 64 (1 MB);
// span 64, gp 4, S 64: 16 x 8 x 64 x 64 (2 MB); span 32, gp 4, S 32:
// 8 x 8 x 32 x 32 (256 KB); span 32, gp 8, S 32: 8 x 16 x 32 x 32
// (512 KB); off the path, span 64, gp 8, S 64: 16 x 16 x 64 x 64 (4 MB).
// Besides it keeps m, l, delta (S, g, L) as scratch.
//
// What bounds it on the H100: at batch 1 a call moves a few MB (the
// partials included) and does about 0.1-0.3 GFLOP, a few microseconds at
// the card's peaks, so launch latency and the short grids dominate: a
// simple kernel that is right, with a warp per block so the stripes of a
// warp share the reductions. Each pass recomputes the logits from k and
// the table rows, read through L1 (the per-stripe rows are strided in the
// stripe-major layout); the block's table row or column is staged in shared
// memory. Kernels launch on the caller's stream, allocate nothing (the
// wrapper passes scratch) and do not synchronise; the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"

namespace {

using medt::warp_sum;

constexpr int kStripes = 32;  // threads per block: one warp of stripes
constexpr int kMaxSpan = 64;

inline int stripe_blocks(int S) { return (S + kStripes - 1) / kStripes; }

struct BwdArgs {
  const float* q;       // (S, g, c, L), strides q_ss, q_sg
  const float* k;       // (S, g, c, L), strides k_ss, k_sg
  const float* v;       // (S, g, gp, L), strides v_ss, v_sg
  const float* qemb;    // (c, L, L) [c, i, j]
  const float* kemb;    // (c, L, L) [c, j, i]
  const float* vemb;    // (gp, L, L) [p, i, j]
  const float* aff;     // (g, 8)
  const float* dsv;     // (S, g, gp, L)
  const float* dsve;    // (S, g, gp, L), with positions
  float* dq;
  float* dk;
  float* dv;
  float* m;             // scratch (S, g, L): the row pass writes, the
  float* l;             // column pass reads
  float* delta;
  float* tab_part;      // (g * blocks, 2gp, L, L) with positions
  float* aff_part;      // (L * blocks, g, 4)
  long long q_ss, q_sg, k_ss, k_sg, v_ss, v_sg;
  int S, g, L;
};

// Dynamic shared memory of the row pass: the block's row of the three
// tables, (2c + gp) * L floats, with positions.
inline size_t row_smem_bytes(int gp, int L, bool has_pos) {
  return has_pos ? (size_t)(2 * gp) * L * sizeof(float) : 0;
}

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kStripes)
stripe_bwd_row_kernel(BwdArgs a) {
  constexpr int C = GP / 2;
  constexpr int T = 2 * GP;  // table-gradient rows: dqemb c, dkemb c, dvemb gp
  extern __shared__ float smem[];
  const int L = a.L, S = a.S, g = a.g;
  float* t_q = smem;         // qemb[c, i, :]  as [c][j]
  float* t_k = t_q + C * L;  // kemb[c, :, i]  as [c][j]
  float* t_v = t_k + C * L;  // vemb[p, i, :]  as [p][j]

  const int i = blockIdx.x;
  const int gi = blockIdx.z;
  const int s = blockIdx.y * kStripes + threadIdx.x;
  const bool valid = s < S;
  // A thread past the ragged edge computes stripe 0 with a zero upstream
  // gradient: every sum it joins gets exactly 0 from it.
  const int sc = valid ? s : 0;
  const int lane = threadIdx.x;

  if constexpr (HAS_POS) {
    for (int t = lane; t < C * L; t += kStripes) {
      const int c = t / L, j = t - c * L;
      t_q[t] = a.qemb[((size_t)c * L + i) * L + j];
      t_k[t] = a.kemb[((size_t)c * L + j) * L + i];
    }
    for (int t = lane; t < GP * L; t += kStripes) {
      const int p = t / L, j = t - p * L;
      t_v[t] = a.vemb[((size_t)p * L + i) * L + j];
    }
    __syncthreads();
  }

  const float* af = a.aff + gi * 8;
  const float a0 = af[0], a1 = af[1];
  float a2 = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f;
  if constexpr (HAS_POS) {
    a2 = af[2]; a3 = af[3]; a4 = af[4]; a5 = af[5];
  }
  const size_t sg = (size_t)sc * g + gi;
  const float* qs = a.q + sc * a.q_ss + gi * a.q_sg;   // q[s, gi, c, :]
  const float* ks = a.k + sc * a.k_ss + gi * a.k_sg;
  const float* vs = a.v + sc * a.v_ss + gi * a.v_sg;

  float q[C], gv[GP], ge[GP];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = qs[c * L + i];
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    gv[p] = valid ? a.dsv[(sg * GP + p) * L + i] : 0.f;
    ge[p] = (HAS_POS && valid) ? a.dsve[(sg * GP + p) * L + i] : 0.f;
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

  // online softmax over the keys: m, l and the outputs, for delta
  float acc_v[GP], acc_e[GP];
#pragma unroll
  for (int p = 0; p < GP; ++p) acc_v[p] = acc_e[p] = 0.f;
  float m = -1e30f, l = 0.f;
  for (int j = 0; j < L; ++j) {
    float kj[C], qk, qr, kr;
#pragma unroll
    for (int c = 0; c < C; ++c) kj[c] = ks[c * L + j];
    logit_parts(j, kj, qk, qr, kr);
    const float x = logit(qk, qr, kr);
    const float m_new = fmaxf(m, x);
    const float alpha = expf(m - m_new);
    const float e = expf(x - m_new);
    l = l * alpha + e;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      acc_v[p] = acc_v[p] * alpha + e * vs[p * L + j];
      if constexpr (HAS_POS) acc_e[p] = acc_e[p] * alpha + e * t_v[p * L + j];
    }
    m = m_new;
  }
  const float inv_l = 1.f / l;
  float delta = 0.f;
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    delta += gv[p] * (acc_v[p] * inv_l);
    if constexpr (HAS_POS) delta += ge[p] * (acc_e[p] * inv_l);
  }

  const int blocks = gridDim.y;
  float* part = a.tab_part + ((size_t)gi * blocks + blockIdx.y) * T * L * L;
  const size_t LL = (size_t)L * L;
  float dq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dq[c] = 0.f;
  float s_qk = 0.f, s_b = 0.f, s_qr = 0.f, s_kr = 0.f;
  for (int j = 0; j < L; ++j) {
    float kj[C], qk, qr, kr;
#pragma unroll
    for (int c = 0; c < C; ++c) kj[c] = ks[c * L + j];
    logit_parts(j, kj, qk, qr, kr);
    const float pj = expf(logit(qk, qr, kr) - m) * inv_l;
    float dsim = 0.f;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      dsim += gv[p] * vs[p * L + j];
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
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float tq = warp_sum((dlog * a2) * q[c]);
        const float tk = warp_sum((dlog * a4) * kj[c]);
        if (lane == 0) {
          part[c * LL + (size_t)i * L + j] = tq;         // dqemb[c, i, j]
          part[(C + c) * LL + (size_t)j * L + i] = tk;   // dkemb[c, j, i]
        }
      }
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        const float tv = warp_sum(pj * ge[p]);
        if (lane == 0) part[(2 * C + p) * LL + (size_t)i * L + j] = tv;
      }
    }
  }

  if (valid) {
#pragma unroll
    for (int c = 0; c < C; ++c) a.dq[(sg * C + c) * L + i] = dq[c];
    const size_t row = sg * L + i;
    a.m[row] = m;
    a.l[row] = l;
    a.delta[row] = delta;
  }

  const float sums[4] = {s_qk, s_b, s_qr, s_kr};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float v = warp_sum(sums[t]);
    if (lane == 0) {
      a.aff_part[(((size_t)i * blocks + blockIdx.y) * g + gi) * 4 + t] = v;
    }
  }
}

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kStripes)
stripe_bwd_col_kernel(BwdArgs a) {
  constexpr int C = GP / 2;
  __shared__ float c_q[HAS_POS ? C * kMaxSpan : 1];   // qemb[c, :, j]
  __shared__ float c_k[HAS_POS ? C * kMaxSpan : 1];   // kemb[c, j, :]
  __shared__ float c_v[HAS_POS ? GP * kMaxSpan : 1];  // vemb[p, :, j]
  const int L = a.L, S = a.S, g = a.g;
  const int j = blockIdx.x;
  const int gi = blockIdx.z;
  const int s = blockIdx.y * kStripes + threadIdx.x;

  if constexpr (HAS_POS) {
    for (int t = threadIdx.x; t < C * L; t += kStripes) {
      const int c = t / L, i = t - c * L;
      c_q[t] = a.qemb[((size_t)c * L + i) * L + j];
      c_k[t] = a.kemb[((size_t)c * L + j) * L + i];
    }
    for (int t = threadIdx.x; t < GP * L; t += kStripes) {
      const int p = t / L, i = t - p * L;
      c_v[t] = a.vemb[((size_t)p * L + i) * L + j];
    }
    __syncthreads();
  }
  if (s >= S) return;

  const float* af = a.aff + gi * 8;
  const float a0 = af[0], a1 = af[1];
  float a2 = 0.f, a3 = 0.f, a4 = 0.f, a5 = 0.f;
  if constexpr (HAS_POS) {
    a2 = af[2]; a3 = af[3]; a4 = af[4]; a5 = af[5];
  }
  const size_t sg = (size_t)s * g + gi;
  const float* qs = a.q + s * a.q_ss + gi * a.q_sg;
  const float* ks = a.k + s * a.k_ss + gi * a.k_sg;
  const float* vs = a.v + s * a.v_ss + gi * a.v_sg;
  const float* gvs = a.dsv + sg * GP * L;
  const float* ges = HAS_POS ? a.dsve + sg * GP * L : nullptr;
  const float* mrow = a.m + sg * L;
  const float* lrow = a.l + sg * L;
  const float* drow = a.delta + sg * L;

  float kj[C], vj[GP], dk[C], dv[GP];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    kj[c] = ks[c * L + j];
    dk[c] = 0.f;
  }
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    vj[p] = vs[p * L + j];
    dv[p] = 0.f;
  }

  for (int i = 0; i < L; ++i) {
    float qi[C], qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qi[c] = qs[c * L + i];
      qk += qi[c] * kj[c];
      if constexpr (HAS_POS) {
        qr += qi[c] * c_q[c * L + i];
        kr += kj[c] * c_k[c * L + i];
      }
    }
    float x = qk * a0 + a1;
    if constexpr (HAS_POS) x += (qr * a2 + a3) + (kr * a4 + a5);
    const float pij = expf(x - mrow[i]) * (1.f / lrow[i]);
    float dsim = 0.f;
    float gi_v[GP];
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      gi_v[p] = gvs[p * L + i];
      dsim += gi_v[p] * vj[p];
      if constexpr (HAS_POS) dsim += ges[p * L + i] * c_v[p * L + i];
    }
    const float dlog = pij * (dsim - drow[i]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[c] += (dlog * a0) * qi[c];
      if constexpr (HAS_POS) dk[c] += (dlog * a4) * c_k[c * L + i];
    }
#pragma unroll
    for (int p = 0; p < GP; ++p) dv[p] += pij * gi_v[p];
  }

#pragma unroll
  for (int c = 0; c < C; ++c) a.dk[(sg * C + c) * L + j] = dk[c];
#pragma unroll
  for (int p = 0; p < GP; ++p) a.dv[(sg * GP + p) * L + j] = dv[p];
}

template <int GP, bool HAS_POS>
void launch_gp(const BwdArgs& a, cudaStream_t stream) {
  const dim3 grid(a.L, stripe_blocks(a.S), a.g);
  stripe_bwd_row_kernel<GP, HAS_POS>
      <<<grid, kStripes, row_smem_bytes(GP, a.L, HAS_POS), stream>>>(a);
  stripe_bwd_col_kernel<GP, HAS_POS><<<grid, kStripes, 0, stream>>>(a);
}

}  // namespace

extern "C" {

// q, k, v: stripe stride *_ss and group stride *_sg in floats, rows of L
// contiguous floats; dsv, dsve, dq, dk, dv dense.
// dtables: (2gp, L, L) = dqemb (c rows, [c, i, j]), dkemb (c rows,
// [c, j, i]), dvemb (gp rows, [p, i, j]); not written without positions.
// m, l, delta: scratch (S, g, L). Partials: tab_part (g * ceil(S/32), 2gp,
// L, L) with positions, aff_part (L * ceil(S/32), g, 4).
int medt_stripe_attn_bwd(const float* q, const float* k, const float* v,
                         const float* qemb, const float* kemb,
                         const float* vemb, const float* aff,
                         const float* dsv, const float* dsve, float* dq,
                         float* dk, float* dv, float* dtables, float* daff,
                         float* m, float* l, float* delta, float* tab_part,
                         float* aff_part, long long q_ss, long long q_sg,
                         long long k_ss, long long k_sg, long long v_ss,
                         long long v_sg, int S, int g, int gp, int L,
                         int has_pos, int n_tab_part, int n_aff_part,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = S > 0 ? stripe_blocks(S) : 0;
  if (g < 1 || S < 1 || L < 1 || L > kMaxSpan || g > 65535 ||
      blocks > 65535 || n_aff_part != L * blocks ||
      (has_pos && n_tab_part != g * blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs a{q, k, v, qemb, kemb, vemb, aff, dsv, dsve, dq, dk, dv,
                  m, l, delta, tab_part, aff_part, q_ss, q_sg, k_ss, k_sg,
                  v_ss, v_sg, S, g, L};
  const bool pos = has_pos != 0;
  switch (gp) {
    case 2:
      pos ? launch_gp<2, true>(a, stream) : launch_gp<2, false>(a, stream);
      break;
    case 4:
      pos ? launch_gp<4, true>(a, stream) : launch_gp<4, false>(a, stream);
      break;
    case 8:
      pos ? launch_gp<8, true>(a, stream) : launch_gp<8, false>(a, stream);
      break;
    case 16:
      pos ? launch_gp<16, true>(a, stream) : launch_gp<16, false>(a, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (pos) {
    medt::sum_partials(tab_part, dtables, n_tab_part,
                       (size_t)2 * gp * L * L, stream);
  }
  medt::daff_finalize(aff_part, daff, n_aff_part, g, has_pos, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
