// The lanes-contract attention core at wide group planes (every even gp up
// to 128 outside 2, 4, 8 and 16), forward and backward, for Hopper (sm_90a).
//
// Replaces, at those widths, the Pallas TPU kernels of
// medt_tpu/ops/pallas_axial_lanes.py that the kernels of
// csrc/axial_lanes_{fwd,bwd}.cu (lanes_attn_core, spans <= 16) and
// csrc/axial_flash_{fwd,bwd}.cu (flash_lanes_core, spans 17..64) replace
// at gp 2, 4, 8 and 16: the forwards _fwd_kernel and _flash_fwd_kernel and
// the backwards _bwd_kernel and _flash_bwd_kernel. The axial-attention
// classifiers run their sites at gp 12 to 128 (axial26s and axial50s at
// 32 and 64 in layers 3-4; axial50m 12, 24, 48, 96; axial50l 32, 64, 128
// beside 16); the segmentation models never pass gp 16. The contract is
// the lanes one (ops/axial_lanes.py): qkv (g, 2gp, L, S), tables qemb,
// kemb_t (c, L, L) and vemb (gp, L, L), affine (g, 8) -> sv, sve (g, gp, L,
// S), and the flash contract's row max m and denominator l (g, L, S); the
// backward gives dqkv, the table gradients (2gp, L, L) and daff (g, 8).
// qkv (and dqkv) are float32 or bf16 (the _bf16 entry points): bf16 is
// converted where it is read and dqkv rounded once where it is stored, so
// every other output equals the float32 entry point's on the upcast qkv,
// bit for bit, and dqkv is its dqkv rounded once.
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
//     The scratch costs 2 g L^2 S floats (90 MB at axial50m's widest train
//     site: span 56, 448 stripes); no float atomics, the same bits every
//     run. Each kernel is instantiated per register bucket of c
//     (wide::cm_bucket) and takes gp at run time, as the forward does.
// What bounds it on the H100: device memory at its bound (each input read
// once, each output written once); this design also writes and reads the
// (g, L, L, S) scratch twice and re-reads k, v and the tables per row
// from L1/L2, so it is latency- and L2-bound at these sizes.
// Kernels launch on the caller's stream, allocate nothing (the wrapper
// passes the scratch) and do not synchronise; the entry points return the
// first CUDA error of their launches.

#include <cuda_bf16.h>
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
    int gp, L, S;
  };
  template <bool POS>
  __device__ __forceinline__ static void store(const Params& e, int gi, int i,
                                               int s, int p0, int n,
                                               const float (&sv)[kChunkP],
                                               const float (&sve)[kChunkP]) {
    const size_t LS = (size_t)e.L * e.S;
    const size_t o = ((size_t)gi * e.gp + p0) * LS + (size_t)i * e.S + s;
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) {
      if (u < n) {
        e.sv[o + u * LS] = sv[u];
        if constexpr (POS) e.sve[o + u * LS] = sve[u];
      }
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

template <class T>
struct BwdArgs {
  Lanes<T> x;
  const float* aff;
  const float* m;     // saved (flash contract) or null (lanes contract)
  const float* l;
  const float* sv;
  const float* sve;
  const float* dsv;   // (g, gp, L, S)
  const float* dsve;
  T* dqkv;            // (g, 2gp, L, S)
  float* prob;        // (g, L, L, S) scratch: p_ij
  float* dlog;        // (g, L, L, S) scratch: dsim_ij, then dlog_ij
  float* tab_part;    // (g, 2gp, L, L), positions only
  float* aff_part;    // (ceil(L / kRows) * ceil(S / kStripes), g, 4)
};

template <class T>
__device__ __forceinline__ size_t pair_at(const BwdArgs<T>& a, int gi, int i,
                                          int j, int s) {
  const int L = a.x.L;
  return (((size_t)gi * L + i) * L + j) * a.x.S + s;
}

template <class T>
__device__ __forceinline__ size_t plane_at(const BwdArgs<T>& a, int gi, int p,
                                           int gp, int i, int s) {
  return (((size_t)gi * gp + p) * a.x.L + i) * a.x.S + s;
}

// 1. thread (query i, stripe s): probabilities, dsim, dlog, dq, daff sums
template <int CM, bool POS, class T>
__global__ void __launch_bounds__(kThreads) wide_rows_kernel(BwdArgs<T> a) {
  __shared__ float wsum[kThreads / 32][4];
  const Lanes<T>& x = a.x;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2;
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
    float q[CM];
    wide::load_q(x, q, gi, i, s);
    float* prow = a.prob + pair_at(a, gi, i, 0, s);   // + j * S
    float* drow = a.dlog + pair_at(a, gi, i, 0, s);
    // logits, then the softmax from (m, l), recomputed or saved
    float m = -3.0e38f;
    for (int j = 0; j < L; ++j) {
      float qk, qr, kr;
      const float lg = wide::logit<CM, POS>(x, q, gi, i, j, s, af, qk, qr,
                                            kr);
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
#pragma unroll 4
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
#pragma unroll 4
      for (int pp = 0; pp < GP; ++pp) {
        const size_t o = plane_at(a, gi, pp, GP, i, s);
        delta = fmaf(a.dsv[o], a.sv[o], delta);
        if constexpr (POS) delta = fmaf(a.dsve[o], a.sve[o], delta);
      }
    }
    // dlog_ij = p_ij (dsim_ij - delta); dq (one accumulator a channel:
    // dq[c] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])) and the daff sums
    float dq[CM];
#pragma unroll
    for (int c = 0; c < CM; ++c) dq[c] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float dl = prow[(size_t)j * S] * (drow[(size_t)j * S] - delta);
      drow[(size_t)j * S] = dl;
      float qk, qr, kr;
      wide::logit<CM, POS>(x, q, gi, i, j, s, af, qk, qr, kr);
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          float w = af[0] * x.k(gi, c, j, s);
          if constexpr (POS) w = fmaf(af[2], x.tq(c, i, j), w);
          dq[c] = fmaf(dl, w, dq[c]);
        }
      }
      s_b += dl;
      s_qk = fmaf(dl, qk, s_qk);
      if constexpr (POS) {
        s_qr = fmaf(dl, qr, s_qr);
        s_kr = fmaf(dl, kr, s_kr);
      }
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        a.dqkv[plane_at(a, gi, c, 2 * GP, i, s)] = flash2::from_f32<T>(dq[c]);
      }
    }
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
template <int CM, bool POS, class T>
__global__ void __launch_bounds__(kThreads) wide_cols_kernel(BwdArgs<T> a) {
  const Lanes<T>& x = a.x;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2;
  const int s = blockIdx.x * kStripes + threadIdx.x;
  const int j = blockIdx.y * kRows + threadIdx.y;
  const int gi = blockIdx.z;
  if (s >= S || j >= L) return;
  const float a0 = __ldg(a.aff + gi * 8), a4 = __ldg(a.aff + gi * 8 + 4);
  float dk[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) dk[c] = 0.f;
  for (int i = 0; i < L; ++i) {
    const float dl = a.dlog[pair_at(a, gi, i, j, s)];
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        float w = a0 * x.q(gi, c, i, s);
        if constexpr (POS) w = fmaf(a4, x.tk(c, i, j), w);
        dk[c] = fmaf(dl, w, dk[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c < C) {
      a.dqkv[plane_at(a, gi, C + c, 2 * GP, j, s)] =
          flash2::from_f32<T>(dk[c]);
    }
  }
  for (int p0 = 0; p0 < GP; p0 += kChunkP) {
    const int n = min(kChunkP, GP - p0);
    float dv[kChunkP];
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) dv[u] = 0.f;
    for (int i = 0; i < L; ++i) {
      const float pr = a.prob[pair_at(a, gi, i, j, s)];
#pragma unroll
      for (int u = 0; u < kChunkP; ++u) {
        if (u < n) {
          dv[u] = fmaf(pr, __ldg(a.dsv + plane_at(a, gi, p0 + u, GP, i, s)),
                       dv[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) {
      if (u < n) {
        a.dqkv[plane_at(a, gi, GP + p0 + u, 2 * GP, j, s)] =
            flash2::from_f32<T>(dv[u]);
      }
    }
  }
}

// 3. (positions) a warp per (table row, i, j) of group gi: its term summed
// over the stripes, one slot per group of the table partials
//   dqemb[c,i,j] = a2 sum_s dlog_ij q[c,i],  dkemb_t[c,i,j] = a4 sum_s
//   dlog_ij k[c,j],  dvemb[p,i,j] = sum_s p_ij dsve[p,i]
constexpr int kTabWarps = 8;

template <class T>
__global__ void __launch_bounds__(kTabWarps * 32) wide_tables_kernel(
    BwdArgs<T> a) {
  const Lanes<T>& x = a.x;
  const int L = x.L, S = x.S, LL = L * L, GP = x.gp, C = GP / 2;
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

template <int CM, bool POS, class T>
cudaError_t bwd_launches(const BwdArgs<T>& a, int g, cudaStream_t stream) {
  const dim3 grid((a.x.S + kStripes - 1) / kStripes,
                  (a.x.L + kRows - 1) / kRows, g);
  const dim3 block(kStripes, kRows);
  wide_rows_kernel<CM, POS, T><<<grid, block, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wide_cols_kernel<CM, POS, T><<<grid, block, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !POS) return err;
  const int elems = 2 * a.x.gp * a.x.L * a.x.L;
  wide_tables_kernel<T><<<dim3((elems + kTabWarps - 1) / kTabWarps, g),
                          kTabWarps * 32, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int CM, class T>
cudaError_t bwd_cm(const BwdArgs<T>& a, int g, bool pos, cudaStream_t st) {
  return pos ? bwd_launches<CM, true, T>(a, g, st)
             : bwd_launches<CM, false, T>(a, g, st);
}

bool bad_geometry(int g, int gp, int L, int S) {
  return g < 1 || g > 65535 || S < 1 || L < 1 || L > wide::kMaxSpan ||
         !wide::gp_ok(gp);
}

template <class T>
int wide_fwd(const T* qkv, const float* qemb, const float* kemb_t,
             const float* vemb, const float* aff, float* sv, float* sve,
             float* m, float* l, int g, int gp, int L, int S, int has_pos,
             int save_ml, void* stream) {
  if (bad_geometry(g, gp, L, S)) return (int)cudaErrorInvalidValue;
  const Lanes<T> x{qkv, qemb, kemb_t, vemb, gp, L, S};
  const LanesEpilogue::Params e{sv, sve, save_ml ? m : nullptr,
                                save_ml ? l : nullptr, gp, L, S};
  return wide::launch_fwd<Lanes<T>, LanesEpilogue>(
      x, e, aff, g, has_pos != 0, static_cast<cudaStream_t>(stream));
}

template <class T>
int wide_bwd(const T* qkv, const float* qemb, const float* kemb_t,
             const float* vemb, const float* aff, const float* m,
             const float* l, const float* sv, const float* sve,
             const float* dsv, const float* dsve, T* dqkv, float* dtables,
             float* daff, float* prob, float* dlog, float* tab_part,
             float* aff_part, int g, int gp, int L, int S, int has_pos,
             int saved, int n_aff_part, void* stream) {
  const int slots = ((L + kRows - 1) / kRows) * ((S + kStripes - 1) / kStripes);
  if (bad_geometry(g, gp, L, S) || n_aff_part != slots) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pos = has_pos != 0;
  const BwdArgs<T> a{Lanes<T>{qkv, qemb, kemb_t, vemb, gp, L, S}, aff,
                     saved ? m : nullptr, saved ? l : nullptr, sv, sve, dsv,
                     dsve, dqkv, prob, dlog, tab_part, aff_part};
  cudaError_t err;
  switch (wide::cm_bucket(gp / 2)) {
    case 8: err = bwd_cm<8>(a, g, pos, st); break;
    case 16: err = bwd_cm<16>(a, g, pos, st); break;
    case 32: err = bwd_cm<32>(a, g, pos, st); break;
    default: err = bwd_cm<64>(a, g, pos, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(tab_part, dtables, pos ? g : 0, (size_t)2 * gp * L * L,
                     aff_part, daff, n_aff_part, g, has_pos, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The lanes (save_ml == 0) or flash (save_ml != 0: m, l (g, L, S) written)
// forward at any even gp up to 128 and spans up to 64. sve is not written
// without positions.
int medt_wide_attn_fwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, float* sv, float* sve, float* m,
                       float* l, int g, int gp, int L, int S, int has_pos,
                       int save_ml, void* stream) {
  return wide_fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S,
                  has_pos, save_ml, stream);
}

// The same on bf16 qkv: the float32 entry point's outputs on the upcast
// qkv, bit for bit.
int medt_wide_attn_fwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                            const float* kemb_t, const float* vemb,
                            const float* aff, float* sv, float* sve,
                            float* m, float* l, int g, int gp, int L, int S,
                            int has_pos, int save_ml, void* stream) {
  return wide_fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S,
                  has_pos, save_ml, stream);
}

// The backward at any even gp up to 128, spans up to 64: the lanes
// contract (saved == 0: m, l, sv, sve not read) or the flash contract
// (saved != 0). dtables (2gp, L, L) and tab_part (g, 2gp, L, L) are not
// touched without positions, nor dsve read; prob and dlog are (g, L, L, S)
// scratch; aff_part holds n_aff_part = ceil(L / 4) * ceil(S / 32) slots of
// (g, 4).
int medt_wide_attn_bwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, const float* m, const float* l,
                       const float* sv, const float* sve, const float* dsv,
                       const float* dsve, float* dqkv, float* dtables,
                       float* daff, float* prob, float* dlog, float* tab_part,
                       float* aff_part, int g, int gp, int L, int S,
                       int has_pos, int saved, int n_aff_part, void* stream) {
  return wide_bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve,
                  dqkv, dtables, daff, prob, dlog, tab_part, aff_part, g, gp,
                  L, S, has_pos, saved, n_aff_part, stream);
}

// The same on bf16 qkv: dqkv (bf16) is the float32 entry point's dqkv on
// the upcast qkv rounded once, every other output its own, bit for bit.
int medt_wide_attn_bwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                            const float* kemb_t, const float* vemb,
                            const float* aff, const float* m, const float* l,
                            const float* sv, const float* sve,
                            const float* dsv, const float* dsve,
                            __nv_bfloat16* dqkv, float* dtables, float* daff,
                            float* prob, float* dlog, float* tab_part,
                            float* aff_part, int g, int gp, int L, int S,
                            int has_pos, int saved, int n_aff_part,
                            void* stream) {
  return wide_bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve,
                  dqkv, dtables, daff, prob, dlog, tab_part, aff_part, g, gp,
                  L, S, has_pos, saved, n_aff_part, stream);
}

}  // extern "C"
