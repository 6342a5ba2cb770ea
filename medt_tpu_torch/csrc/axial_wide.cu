// The lanes-contract attention core at wide group planes (gp 32 and 64),
// forward and backward, for Hopper (sm_90a).
//
// Replaces, at gp 32 and 64, the Pallas TPU kernels of
// medt_tpu/ops/pallas_axial_lanes.py that the kernels of
// csrc/axial_lanes_{fwd,bwd}.cu (lanes_attn_core, spans <= 16) and
// csrc/axial_flash_{fwd,bwd}.cu (flash_lanes_core, spans 17..64) replace
// at gp <= 16: the forwards _fwd_kernel and _flash_fwd_kernel and the
// backwards _bwd_kernel and _flash_bwd_kernel. The axial-attention
// classifiers (axial26s at s = 0.5) run their layer-3 and layer-4 sites at
// gp 32 and 64; the segmentation models never pass gp 16. The contract is
// the lanes one (ops/axial_lanes.py): qkv (g, 2gp, L, S), tables qemb,
// kemb_t (c, L, L) and vemb (gp, L, L), affine (g, 8) -> sv, sve (g, gp, L,
// S), and the flash contract's row max m and denominator l (g, L, S); the
// backward gives dqkv, the table gradients (2gp, L, L) and daff (g, 8).
// Everything is float32 (the bf16 entry points stop at gp 16).
//
// Design, for correctness first (the designs for gp <= 16 do not scale:
// csrc/wide_attn.cuh says why):
//   * forward: csrc/wide_attn.cuh's body, one query row a thread, the value
//     channels in chunks of 16; with save_ml it also writes m and l;
//   * backward, four launches, for the lanes contract (softmax recomputed
//     from the logits) and the flash contract (probabilities from the saved
//     m, l; delta from the saved sv, sve) alike:
//       1. rows, thread (query i, stripe): the probabilities p_ij and dsim_ij
//          of its row into scratch (g, L, L, S), then dlog_ij over dsim, dq
//          (c accumulators) and the row's daff sums, reduced per block in a
//          fixed order into one slot of the daff partials;
//       2. columns, thread (key j, stripe): dk (c accumulators) from dlog,
//          and dv from p in chunks of 16 value channels;
//       3. positions only: a warp per (table row, i, j) and group sums its
//          term over the stripes (lanes over stripes, coalesced; warp_sum),
//          one slot per group;
//       4. medt::bwd_finalize sums the slots in a fixed order.
//     The scratch costs 2 g L^2 S floats (5.6 MB at the widest axial26s
//     site: span 28, gp 32, 224 stripes); no float atomics, the same bits
//     every run.
// What bounds it on the H100: device memory at its bound (each input read
// once, each output written once); this design also writes and reads the
// (g, L, L, S) scratch twice and re-reads k, v and the tables per row
// from L1/L2, so it is latency- and L2-bound at these sizes.
// Kernels launch on the caller's stream, allocate nothing (the wrapper
// passes the scratch) and do not synchronise; the entry points return the
// first CUDA error of their launches.

#include <cuda_runtime.h>
#include <stddef.h>

#include "reduce.cuh"
#include "wide_attn.cuh"

namespace {

using medt::warp_sum;
using wide::kChunkP;
using wide::kRows;
using wide::kStripes;
using wide::kThreads;
using wide::Lanes;

// sv, sve (g, gp, L, S) and, for the flash contract, m and l (g, L, S)
struct LanesEpilogue {
  struct Params {
    float* sv;
    float* sve;
    float* m;  // null: the lanes contract, no statistics
    float* l;
    int L, S;
  };
  template <int GP, bool POS>
  __device__ __forceinline__ static void store(const Params& e, int gi, int i,
                                               int s, int p0,
                                               const float (&sv)[kChunkP],
                                               const float (&sve)[kChunkP]) {
    const size_t LS = (size_t)e.L * e.S;
    const size_t o = ((size_t)gi * GP + p0) * LS + (size_t)i * e.S + s;
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) {
      e.sv[o + u * LS] = sv[u];
      if constexpr (POS) e.sve[o + u * LS] = sve[u];
    }
  }
  __device__ __forceinline__ static void stats(const Params& e, int gi, int i,
                                               int s, float m, float l) {
    if (e.m == nullptr) return;
    const size_t o = ((size_t)gi * e.L + i) * e.S + s;
    e.m[o] = m;
    e.l[o] = l;
  }
};

struct BwdArgs {
  Lanes x;
  const float* aff;
  const float* m;     // saved (flash contract) or null (lanes contract)
  const float* l;
  const float* sv;
  const float* sve;
  const float* dsv;   // (g, gp, L, S)
  const float* dsve;
  float* dqkv;        // (g, 2gp, L, S)
  float* prob;        // (g, L, L, S) scratch: p_ij
  float* dlog;        // (g, L, L, S) scratch: dsim_ij, then dlog_ij
  float* tab_part;    // (g, 2gp, L, L), positions only
  float* aff_part;    // (ceil(L / kRows) * ceil(S / kStripes), g, 4)
};

__device__ __forceinline__ size_t pair_at(const BwdArgs& a, int gi, int i,
                                          int j, int s) {
  const int L = a.x.L;
  return (((size_t)gi * L + i) * L + j) * a.x.S + s;
}

__device__ __forceinline__ size_t plane_at(const BwdArgs& a, int gi, int p,
                                           int gp, int i, int s) {
  return (((size_t)gi * gp + p) * a.x.L + i) * a.x.S + s;
}

// 1. thread (query i, stripe s): probabilities, dsim, dlog, dq, daff sums
template <int GP, bool POS>
__global__ void __launch_bounds__(kThreads) wide_rows_kernel(BwdArgs a) {
  constexpr int C = GP / 2;
  __shared__ float wsum[kThreads / 32][4];
  const Lanes& x = a.x;
  const int L = x.L, S = x.S;
  const int s = blockIdx.x * kStripes + threadIdx.x;
  const int i = blockIdx.y * kRows + threadIdx.y;
  const int gi = blockIdx.z;
  const int tid = threadIdx.y * kStripes + threadIdx.x;
  const bool active = s < S && i < L;
  float af[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) af[k] = __ldg(a.aff + gi * 8 + k);
  float s_qk = 0.f, s_b = 0.f, s_qr = 0.f, s_kr = 0.f;
  if (active) {
    float q[C];
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = x.q(gi, c, i, s);
    float* prow = a.prob + pair_at(a, gi, i, 0, s);   // + j * S
    float* drow = a.dlog + pair_at(a, gi, i, 0, s);
    // logits, then the softmax from (m, l), recomputed or saved
    float m = -3.0e38f;
    for (int j = 0; j < L; ++j) {
      float qk, qr, kr;
      const float lg = wide::logit<C, POS>(x, q, gi, i, j, s, af, qk, qr, kr);
      prow[(size_t)j * S] = lg;
      m = fmaxf(m, lg);
    }
    float l = 0.f;
    const size_t row = ((size_t)gi * L + i) * S + s;
    if (a.m != nullptr) {
      m = a.m[row];
      l = a.l[row];
    } else {
      for (int j = 0; j < L; ++j) l += expf(prow[(size_t)j * S] - m);
    }
    const float inv_l = 1.f / l;
    // dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
    float delta = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = expf(prow[(size_t)j * S] - m) * inv_l;
      prow[(size_t)j * S] = p;
      float d = 0.f;
#pragma unroll 16
      for (int pp = 0; pp < GP; ++pp) {
        d = fmaf(__ldg(a.dsv + plane_at(a, gi, pp, GP, i, s)),
                 x.v(gi, pp, j, s), d);
        if constexpr (POS) {
          d = fmaf(__ldg(a.dsve + plane_at(a, gi, pp, GP, i, s)),
                   x.tv(pp, i, j), d);
        }
      }
      drow[(size_t)j * S] = d;
      delta = fmaf(p, d, delta);
    }
    if (a.m != nullptr) {  // the flash contract: delta from the outputs
      delta = 0.f;
#pragma unroll 16
      for (int pp = 0; pp < GP; ++pp) {
        const size_t o = plane_at(a, gi, pp, GP, i, s);
        delta = fmaf(a.dsv[o], a.sv[o], delta);
        if constexpr (POS) delta = fmaf(a.dsve[o], a.sve[o], delta);
      }
    }
    // dlog_ij = p_ij (dsim_ij - delta); dq (one accumulator a channel:
    // dq[c] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])) and the daff sums
    float dq[C];
#pragma unroll
    for (int c = 0; c < C; ++c) dq[c] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float dl = prow[(size_t)j * S] * (drow[(size_t)j * S] - delta);
      drow[(size_t)j * S] = dl;
      float qk, qr, kr;
      wide::logit<C, POS>(x, q, gi, i, j, s, af, qk, qr, kr);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float w = af[0] * x.k(gi, c, j, s);
        if constexpr (POS) w = fmaf(af[2], x.tq(c, i, j), w);
        dq[c] = fmaf(dl, w, dq[c]);
      }
      s_b += dl;
      s_qk = fmaf(dl, qk, s_qk);
      if constexpr (POS) {
        s_qr = fmaf(dl, qr, s_qr);
        s_kr = fmaf(dl, kr, s_kr);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) a.dqkv[plane_at(a, gi, c, 2 * GP, i, s)] = dq[c];
  }
  const float sums[4] = {s_qk, s_b, s_qr, s_kr};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(sums[k]);
    if ((tid & 31) == 0) wsum[tid >> 5][k] = v;
  }
  __syncthreads();
  if (tid < 4) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v += wsum[w][tid];
    const size_t slot = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    a.aff_part[(slot * gridDim.z + gi) * 4 + tid] = v;
  }
}

// 2. thread (key j, stripe s): dk from dlog, dv from p
template <int GP, bool POS>
__global__ void __launch_bounds__(kThreads) wide_cols_kernel(BwdArgs a) {
  constexpr int C = GP / 2;
  const Lanes& x = a.x;
  const int L = x.L, S = x.S;
  const int s = blockIdx.x * kStripes + threadIdx.x;
  const int j = blockIdx.y * kRows + threadIdx.y;
  const int gi = blockIdx.z;
  if (s >= S || j >= L) return;
  const float a0 = __ldg(a.aff + gi * 8), a4 = __ldg(a.aff + gi * 8 + 4);
  float dk[C];
#pragma unroll
  for (int c = 0; c < C; ++c) dk[c] = 0.f;
  for (int i = 0; i < L; ++i) {
    const float dl = a.dlog[pair_at(a, gi, i, j, s)];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float w = a0 * x.q(gi, c, i, s);
      if constexpr (POS) w = fmaf(a4, x.tk(c, i, j), w);
      dk[c] = fmaf(dl, w, dk[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    a.dqkv[plane_at(a, gi, C + c, 2 * GP, j, s)] = dk[c];
  for (int p0 = 0; p0 < GP; p0 += kChunkP) {
    float dv[kChunkP];
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) dv[u] = 0.f;
    for (int i = 0; i < L; ++i) {
      const float pr = a.prob[pair_at(a, gi, i, j, s)];
#pragma unroll
      for (int u = 0; u < kChunkP; ++u) {
        dv[u] = fmaf(pr, __ldg(a.dsv + plane_at(a, gi, p0 + u, GP, i, s)),
                     dv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunkP; ++u)
      a.dqkv[plane_at(a, gi, GP + p0 + u, 2 * GP, j, s)] = dv[u];
  }
}

// 3. (positions) a warp per (table row, i, j) of group gi: its term summed
// over the stripes, one slot per group of the table partials
//   dqemb[c,i,j] = a2 sum_s dlog_ij q[c,i],  dkemb_t[c,i,j] = a4 sum_s
//   dlog_ij k[c,j],  dvemb[p,i,j] = sum_s p_ij dsve[p,i]
constexpr int kTabWarps = 8;

template <int GP>
__global__ void __launch_bounds__(kTabWarps * 32) wide_tables_kernel(
    BwdArgs a) {
  constexpr int C = GP / 2;
  const Lanes& x = a.x;
  const int L = x.L, S = x.S, LL = L * L;
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kTabWarps + (threadIdx.x >> 5);
  const int gi = blockIdx.y;
  if (e >= 2 * GP * LL) return;  // whole warps
  const int rr = e / LL, ij = e - rr * LL, i = ij / L, j = ij - i * L;
  float v = 0.f;
  for (int s = lane; s < S; s += 32) {
    const size_t pij = pair_at(a, gi, i, j, s);
    if (rr < C) {
      v = fmaf(a.dlog[pij], x.q(gi, rr, i, s), v);
    } else if (rr < 2 * C) {
      v = fmaf(a.dlog[pij], x.k(gi, rr - C, j, s), v);
    } else {
      v = fmaf(a.prob[pij], __ldg(a.dsve + plane_at(a, gi, rr - 2 * C, GP, i,
                                                     s)), v);
    }
  }
  v = warp_sum(v);
  if (lane == 0) {
    const float scale = rr < C       ? __ldg(a.aff + gi * 8 + 2)
                        : rr < 2 * C ? __ldg(a.aff + gi * 8 + 4)
                                     : 1.f;
    a.tab_part[((size_t)gi * 2 * GP + rr) * LL + ij] = scale * v;
  }
}

template <int GP, bool POS>
cudaError_t bwd_launches(const BwdArgs& a, int g, cudaStream_t stream) {
  const dim3 grid((a.x.S + kStripes - 1) / kStripes,
                  (a.x.L + kRows - 1) / kRows, g);
  const dim3 block(kStripes, kRows);
  wide_rows_kernel<GP, POS><<<grid, block, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_cols_kernel<GP, POS><<<grid, block, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !POS) return err;
  const int elems = 2 * GP * a.x.L * a.x.L;
  wide_tables_kernel<GP><<<dim3((elems + kTabWarps - 1) / kTabWarps, g),
                           kTabWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

bool bad_geometry(int g, int gp, int L, int S) {
  return g < 1 || g > 65535 || S < 1 || L < 1 || L > wide::kMaxSpan ||
         (gp != 32 && gp != 64);
}

}  // namespace

extern "C" {

// The lanes (save_ml == 0) or flash (save_ml != 0: m, l (g, L, S) written)
// forward at gp 32 or 64 and spans up to 64. sve is not written without
// positions.
int medt_wide_attn_fwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, float* sv, float* sve, float* m,
                       float* l, int g, int gp, int L, int S, int has_pos,
                       int save_ml, void* stream) {
  if (bad_geometry(g, gp, L, S)) return (int)cudaErrorInvalidValue;
  const Lanes x{qkv, qemb, kemb_t, vemb, gp, L, S};
  const LanesEpilogue::Params e{sv, sve, save_ml ? m : nullptr,
                                save_ml ? l : nullptr, L, S};
  return wide::launch_fwd<Lanes, LanesEpilogue>(
      x, e, aff, g, has_pos != 0, static_cast<cudaStream_t>(stream));
}

// The backward at gp 32 or 64, spans up to 64: the lanes contract (saved
// == 0: m, l, sv, sve not read) or the flash contract (saved != 0). dtables
// (2gp, L, L) and tab_part (g, 2gp, L, L) are not touched without
// positions, nor dsve read; prob and dlog are (g, L, L, S) scratch;
// aff_part holds n_aff_part = ceil(L / 4) * ceil(S / 32) slots of (g, 4).
int medt_wide_attn_bwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, const float* m, const float* l,
                       const float* sv, const float* sve, const float* dsv,
                       const float* dsve, float* dqkv, float* dtables,
                       float* daff, float* prob, float* dlog, float* tab_part,
                       float* aff_part, int g, int gp, int L, int S,
                       int has_pos, int saved, int n_aff_part, void* stream) {
  const int slots = ((L + kRows - 1) / kRows) * ((S + kStripes - 1) / kStripes);
  if (bad_geometry(g, gp, L, S) || n_aff_part != slots) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pos = has_pos != 0;
  const BwdArgs a{Lanes{qkv, qemb, kemb_t, vemb, gp, L, S}, aff,
                  saved ? m : nullptr, saved ? l : nullptr, sv, sve, dsv,
                  dsve, dqkv, prob, dlog, tab_part, aff_part};
  cudaError_t err;
  if (gp == 32) {
    err = pos ? bwd_launches<32, true>(a, g, st)
              : bwd_launches<32, false>(a, g, st);
  } else {
    err = pos ? bwd_launches<64, true>(a, g, st)
              : bwd_launches<64, false>(a, g, st);
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(tab_part, dtables, pos ? g : 0, (size_t)2 * gp * L * L,
                     aff_part, daff, n_aff_part, g, has_pos, st);
  return (int)cudaGetLastError();
}

}  // extern "C"
