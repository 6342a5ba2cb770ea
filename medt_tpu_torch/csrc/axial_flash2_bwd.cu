// Backward of the long-span lanes attention (64 < L <= 256), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of flash2_lanes_core's backward,
// _flash2_bwd_rule (body _flash2_bwd_kernel) in
// medt_tpu/ops/pallas_axial_lanes.py. The forward is csrc/axial_flash2_fwd.cu
// (per group gi, query i, key j, stripe s; c = gp/2):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   sv[p,i] = sum_j p_ij v[p,j],  sve[p,i] = sum_j p_ij vemb[p,i,j]
// and p is rebuilt from its saved row max m and denominator l. Given dsv,
// dsve (g, gp, L, S), with
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   delta_i = sum_p dsv[p,i] sv[p,i] + dsve[p,i] sve[p,i]   (saved sv, sve)
//   dlog_ij = p_ij (dsim_ij - delta_i)
// it writes the fused dqkv (g, 2gp, L, S):
//   dq[c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])
//   dv[p,j] = sum_i p_ij dsv[p,i]
// the table gradients (2gp, L, L), summed over every group and stripe,
//   dqemb[c,i,j] = a2 sum dlog_ij q[c,i],  dkemb_t[c,i,j] = a4 sum dlog_ij k[c,j]
//   dvemb[p,i,j] = sum p_ij dsve[p,i]
// and daff (g, 8) = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog,
//                    sum dlog*kr, sum dlog, 0, 0] (rows 2..5 zero w/o pos).
//
// The TPU kernel sweeps query blocks innermost so that dk/dv stay resident
// in VMEM, and emits per-program table partials that XLA sums. On the H100
// blocks run in parallel and in no order, so the sums over queries and
// over stripes are taken without atomics, in a fixed order:
//   * row pass, one thread per (gi, query i, stripe s): delta from the saved
//     outputs, then a stream over the keys (nothing of length L is held in
//     registers) that rebuilds p_ij, forms dlog_ij, accumulates dq and the
//     daff sums, and, per key, sums the table-gradient terms of row i over
//     the block's 128 stripes by warp shuffles into per-warp shared slots.
//     The block writes its (2gp, row i, L) table partial and its daff
//     partial. Its dynamic shared memory, (2gp + 4 * 2gp) * L floats (40 KB
//     at L = 256 with gp = 4; 160 KB with gp = 16), is sized from L at
//     launch; above 48 KB the launch opts in and returns the error if the
//     card refuses (no smaller fallback);
//   * column pass, one thread per (gi, key j, stripe s): streams the
//     queries, rebuilds p_ij from the row pass's (m, l, delta) and sums dk,
//     dv over i, the column sums a row thread cannot form without atomics.
//     It stages column j of the tables (2gp * L floats) the same way;
//   * reduce.cuh sums the partials in index order: the table partials
//     (g * ceil(S/128), 2gp, L, L) floats, 134 MB at batch 4 for the
//     (256, 4) site, which the wrapper allocates from the shape, and the
//     daff partials (L * ceil(S/128), g, 4).
// What bounds it: both passes recompute the logits of all L x L pairs, and
// the row pass adds ~10 gp shuffle operations per pair with positions;
// far above the compulsory device-memory traffic. Making it fast is later
// work (PERF.md records its time against the bound).
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns the first CUDA error of its launches.

#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"

namespace {

using medt::kBlockStripes;
using medt::kWarps;
using medt::warp_sum;

constexpr int kMaxSpan = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

struct Flash2BwdArgs {
  const float* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  const float* aff;
  const float* m;     // the forward's saved row max (g, L, S)
  const float* l;     // and softmax denominator
  const float* sv;    // the forward's saved outputs (g, gp, L, S)
  const float* sve;
  const float* dsv;
  const float* dsve;
  float* delta;       // scratch (g, L, S), written by the row pass
  float* dqkv;
  float* tab_part;    // (g * blocks, 2gp, L, L) with positions
  float* aff_part;    // (L * blocks, g, 4)
  int g, L, S;
};

// Dynamic shared memory of the row pass, in floats: table rows 2gp * L,
// per-warp table-gradient slots kWarps * L * 2gp, per-warp daff slots
// kWarps * 4.
inline size_t row_smem_bytes(int gp, int L, bool has_pos) {
  const size_t tabs = has_pos ? (size_t)(2 * gp) * L : 0;
  const size_t slots = has_pos ? (size_t)kWarps * L * 2 * gp : 0;
  return (tabs + slots + kWarps * 4) * sizeof(float);
}

// Column pass: table column j, 2gp * L floats.
inline size_t col_smem_bytes(int gp, int L, bool has_pos) {
  return has_pos ? (size_t)(2 * gp) * L * sizeof(float) : 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kBlockStripes)
flash2_bwd_row_kernel(Flash2BwdArgs a) {
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
  const size_t row = ((size_t)gi * L + i) * S + sc;

  float q[C], gv[GP], ge[GP];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = base[c * LS + (size_t)i * S];
  float delta = 0.f;
#pragma unroll
  for (int p = 0; p < GP; ++p) {
    gv[p] = valid ? a.dsv[out_i + p * LS] : 0.f;
    ge[p] = (HAS_POS && valid) ? a.dsve[out_i + p * LS] : 0.f;
    delta += gv[p] * a.sv[out_i + p * LS];
    if constexpr (HAS_POS) delta += ge[p] * a.sve[out_i + p * LS];
  }
  const float m = a.m[row];
  const float inv_l = 1.f / a.l[row];

  float dq[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dq[c] = 0.f;
  float s_qk = 0.f, s_b = 0.f, s_qr = 0.f, s_kr = 0.f;
  for (int j = 0; j < L; ++j) {
    float kj[C], qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      kj[c] = base[(C + c) * LS + (size_t)j * S];
      qk += q[c] * kj[c];
      if constexpr (HAS_POS) {
        qr += q[c] * t_q[c * L + j];
        kr += kj[c] * t_k[c * L + j];
      }
    }
    float x = qk * a0 + a1;
    if constexpr (HAS_POS) x += (qr * a2 + a3) + (kr * a4 + a5);
    const float pj = expf(x - m) * inv_l;
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
    // partial (r, i, j) for r < T, j < L; j fastest so the writes coalesce
    float* part = a.tab_part +
                  ((size_t)gi * blocks + blockIdx.y) * T * L * L +
                  (size_t)i * L;
    for (int t = threadIdx.x; t < L * T; t += kBlockStripes) {
      const int r = t / L, j = t - r * L;
      float v = 0.f;
      for (int w = 0; w < kWarps; ++w) v += w_tab[((size_t)w * L + j) * T + r];
      part[(size_t)r * L * L + j] = v;
    }
  }
}

template <int GP, bool HAS_POS>
__global__ void __launch_bounds__(kBlockStripes)
flash2_bwd_col_kernel(Flash2BwdArgs a) {
  constexpr int C = GP / 2;
  extern __shared__ float smem[];
  const int L = a.L, S = a.S;
  float* c_q = smem;            // qemb[c, :, j]
  float* c_k = c_q + C * L;     // kemb_t[c, :, j]
  float* c_v = c_k + C * L;     // vemb[p, :, j]
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

template <int GP, bool HAS_POS>
cudaError_t launch_variant(const Flash2BwdArgs& a, cudaStream_t stream) {
  auto row = flash2_bwd_row_kernel<GP, HAS_POS>;
  auto col = flash2_bwd_col_kernel<GP, HAS_POS>;
  const size_t row_smem = row_smem_bytes(GP, a.L, HAS_POS);
  const size_t col_smem = col_smem_bytes(GP, a.L, HAS_POS);
  cudaError_t err = allow_smem(row, row_smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(col, col_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.L, medt::stripe_blocks(a.S), a.g);
  row<<<grid, kBlockStripes, row_smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  col<<<grid, kBlockStripes, col_smem, stream>>>(a);
  return cudaGetLastError();
}

template <int GP>
cudaError_t launch_gp(const Flash2BwdArgs& a, bool has_pos,
                      cudaStream_t stream) {
  return has_pos ? launch_variant<GP, true>(a, stream)
                 : launch_variant<GP, false>(a, stream);
}

}  // namespace

extern "C" {

// m, l, sv, sve are the forward's saved outputs; delta is scratch (g, L, S).
// dtables: (2gp, L, L) = dqemb (c rows), dkemb_t (c rows), dvemb (gp rows),
// not written without positions. Partials: tab_part (g * ceil(S/128), 2gp,
// L, L) (unused without positions), aff_part (L * ceil(S/128), g, 4).
// sve and dsve are not read without positions.
int medt_flash2_lanes_bwd(const float* qkv, const float* qemb,
                          const float* kemb_t, const float* vemb,
                          const float* aff, const float* m, const float* l,
                          const float* sv, const float* sve, const float* dsv,
                          const float* dsve, float* dqkv, float* dtables,
                          float* daff, float* delta, float* tab_part,
                          float* aff_part, int g, int gp, int L, int S,
                          int has_pos, int n_tab_part, int n_aff_part,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int blocks = medt::stripe_blocks(S);
  if (g < 1 || S < 1 || L < 1 || L > kMaxSpan || g > 65535 ||
      blocks > 65535 || n_aff_part != L * blocks ||
      (has_pos && n_tab_part != g * blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  const Flash2BwdArgs a{qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv,
                        dsve, delta, dqkv, tab_part, aff_part, g, L, S};
  const bool pos = has_pos != 0;
  cudaError_t err;
  switch (gp) {
    case 2: err = launch_gp<2>(a, pos, stream); break;
    case 4: err = launch_gp<4>(a, pos, stream); break;
    case 8: err = launch_gp<8>(a, pos, stream); break;
    case 16: err = launch_gp<16>(a, pos, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  if (pos) {
    medt::sum_partials(tab_part, dtables, n_tab_part,
                       (size_t)2 * gp * L * L, stream);
  }
  medt::daff_finalize(aff_part, daff, n_aff_part, g, has_pos, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
