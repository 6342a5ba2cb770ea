// The attention forward at wide group planes (every even gp up to 128
// outside the narrow designs' 2, 4, 8 and 16), for Hopper (sm_90a): the
// body that the lanes and flash forwards (csrc/axial_wide.cu) and the eval
// kernel (csrc/axial_eval_fwd.cu) take at those widths.
//
// Per group gi, query row i and stripe s (c = gp/2), as every forward of
// the port:
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//   sim = softmax_j(logit),  sv[p] = sum_j sim[j] v[p,j],
//   sve[p] = sum_j sim[j] vemb[p,i,j]
// The layouts differ only in where a q, k or v element and a table entry
// lie, so a layout struct (Lanes: the fused (g, 2gp, L, S) qkv of float or
// bf16 and kemb_t [c, i, j]; Stripes: float (S, g, rows, L) views and kemb
// [c, j, i]) gives the addresses and an epilogue writes each output.
//
// Why a body of its own: the designs for gp <= 16 keep a row's sv and sve
// accumulators (acc_v[RI][GP], acc_e[RI][GP]) and every key's k and v
// columns in registers and shared memory. At gp 64 that is 128 floats a
// row in registers and, for the lanes forward's 32-stripe tile, 192 KB of
// k and v rows in shared memory, past the 227 KB a block may hold once
// the tables are staged. This body keeps one query row per thread (lane =
// stripe, so a warp's loads of a k or v row are contiguous in the lanes
// layout): its q row in registers, its logits and then its softmax weights
// in shared memory (at most 64 a thread, 32 KB a block), and the value
// channels in chunks of kChunkP, the last one partial where kChunkP does
// not divide gp, so that a thread never holds more than 2 * kChunkP
// accumulators; the softmax statistics (m, l) are computed once per row,
// before the first chunk.
//
// Widths: the kernels are instantiated per bucket CM of c (8, 16, 32, 64:
// gp up to 16, 32, 64, 128, cm_bucket below) and take c itself at run
// time; a q row is CM registers of which the first c are read, and every
// loop over channels stops at c (or gp), so the sums of a width are taken
// in the same order, with the same roundings, whichever bucket runs them.
// At gp 128 a thread holds 64 q floats and 32 accumulators; ptxas spills
// a few of them at bucket 64 (72 bytes with positions). Staging the q row
// in shared memory there instead removed no time (0 to 3.5 % slower at
// eight bucket-64 sites on the H100, PERF.md), so the row stays in
// registers.
//
// qkv of bf16 (Lanes<__nv_bfloat16>) is converted to float where it is read
// (exact), so its outputs equal the float32 body's on the upcast qkv.
//
// What bounds it on the H100: at the axial classifiers' sites (spans 7 to
// 56, 7-448 stripes, g = 8) a launch moves under 40 MB, so latency and the
// L1/L2 traffic of re-reading k, v and the tables for every query row (24
// to 700 times its bound at axial50m's and axial50l's sites, PERF.md); a
// simple kernel that is right, per the port's rule, to be made fast later.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"

namespace wide {
namespace {

constexpr int kStripes = 32;   // threads of a block along the stripes
constexpr int kRows = 4;       // query rows (or keys) of a block
constexpr int kThreads = kStripes * kRows;
constexpr int kChunkP = 16;    // value channels a thread holds at once
constexpr int kMaxSpan = 64;
constexpr int kMaxGp = 128;

// the narrow designs' widths; every other even gp up to kMaxGp is wide
__host__ __device__ constexpr bool is_wide(int gp) {
  return gp != 2 && gp != 4 && gp != 8 && gp != 16;
}

__host__ __device__ constexpr bool gp_ok(int gp) {
  return gp >= 2 && gp <= kMaxGp && gp % 2 == 0;
}

// the register bucket of c = gp / 2
__host__ __device__ constexpr int cm_bucket(int c) {
  return c <= 8 ? 8 : c <= 16 ? 16 : c <= 32 ? 32 : 64;
}

template <class T>
__device__ __forceinline__ float ld(const T* p) {
  return flash2::to_f32(__ldg(p));
}

// The fused lanes layout: qkv (g, 2gp, L, S) of T, rows [0:c] q, [c:gp] k,
// [gp:2gp] v; tables qemb, kemb_t [c, i, j], vemb [p, i, j].
template <class T>
struct Lanes {
  const T* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  int gp, L, S;

  __device__ __forceinline__ float row(int gi, int r, int pos, int s) const {
    return ld(qkv + (((size_t)gi * 2 * gp + r) * L + pos) * S + s);
  }
  __device__ __forceinline__ float q(int gi, int c, int pos, int s) const {
    return row(gi, c, pos, s);
  }
  __device__ __forceinline__ float k(int gi, int c, int pos, int s) const {
    return row(gi, gp / 2 + c, pos, s);
  }
  __device__ __forceinline__ float v(int gi, int p, int pos, int s) const {
    return row(gi, gp + p, pos, s);
  }
  __device__ __forceinline__ float tq(int c, int i, int j) const {
    return __ldg(qemb + ((size_t)c * L + i) * L + j);
  }
  __device__ __forceinline__ float tk(int c, int i, int j) const {
    return __ldg(kemb_t + ((size_t)c * L + i) * L + j);
  }
  __device__ __forceinline__ float tv(int p, int i, int j) const {
    return __ldg(vemb + ((size_t)p * L + i) * L + j);
  }
};

// The stripe-major layout of the eval kernel: q, k (S, g, c, L) and v (S,
// g, gp, L) with free stripe and group strides, rows of L contiguous
// floats; tables qemb [c, i, j], kemb [c, j, i], vemb [p, i, j].
struct Stripes {
  const float* qp;
  const float* kp;
  const float* vp;
  const float* qemb;
  const float* kemb;
  const float* vemb;
  long long q_ss, q_sg, k_ss, k_sg, v_ss, v_sg;
  int gp, L, S;

  __device__ __forceinline__ float q(int gi, int c, int pos, int s) const {
    return __ldg(qp + s * q_ss + gi * q_sg + (size_t)c * L + pos);
  }
  __device__ __forceinline__ float k(int gi, int c, int pos, int s) const {
    return __ldg(kp + s * k_ss + gi * k_sg + (size_t)c * L + pos);
  }
  __device__ __forceinline__ float v(int gi, int p, int pos, int s) const {
    return __ldg(vp + s * v_ss + gi * v_sg + (size_t)p * L + pos);
  }
  __device__ __forceinline__ float tq(int c, int i, int j) const {
    return __ldg(qemb + ((size_t)c * L + i) * L + j);
  }
  __device__ __forceinline__ float tk(int c, int i, int j) const {
    return __ldg(kemb + ((size_t)c * L + j) * L + i);
  }
  __device__ __forceinline__ float tv(int p, int i, int j) const {
    return __ldg(vemb + ((size_t)p * L + i) * L + j);
  }
};

// A q row of c channels into CM registers (the rest zero).
template <int CM, class Lay>
__device__ __forceinline__ void load_q(const Lay& x, float (&q)[CM], int gi,
                                       int i, int s) {
  const int C = x.gp / 2;
#pragma unroll
  for (int c = 0; c < CM; ++c) q[c] = c < C ? x.q(gi, c, i, s) : 0.f;
}

// The logit of query i and key j of stripe s: q (the query's row, in
// registers) against k's column j; qk, qr and kr come back to the caller.
template <int CM, bool POS, class Lay>
__device__ __forceinline__ float logit(const Lay& x, const float (&q)[CM],
                                       int gi, int i, int j, int s,
                                       const float* a, float& qk, float& qr,
                                       float& kr) {
  const int C = x.gp / 2;
  qk = qr = kr = 0.f;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c < C) {
      const float kc = x.k(gi, c, j, s);
      qk = fmaf(q[c], kc, qk);
      if constexpr (POS) {
        qr = fmaf(q[c], x.tq(c, i, j), qr);
        kr = fmaf(kc, x.tk(c, i, j), kr);
      }
    }
  }
  float lg = qk * a[0] + a[1];
  if constexpr (POS) lg += (qr * a[2] + a[3]) + (kr * a[4] + a[5]);
  return lg;
}

// A block of kStripes x kRows threads, thread (stripe, query row); grid
// (ceil(S / kStripes), ceil(L / kRows), g). Epi provides
//   struct Params;
//   template <bool POS> static void store(const Params&, int gi, int i,
//       int s, int p0, int n, const float (&sv)[kChunkP],
//       const float (&sve)[kChunkP]);   planes p0 .. p0 + n, normalised
//   static void stats(const Params&, int gi, int i, int s, float m, float l);
template <int CM, bool POS, class Lay, class Epi>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(Lay x, typename Epi::Params e, const float* __restrict__ aff) {
  __shared__ float w[kMaxSpan][kThreads];  // logits, then softmax weights
  const int t = threadIdx.y * kStripes + threadIdx.x;
  const int s = blockIdx.x * kStripes + threadIdx.x;
  const int i = blockIdx.y * kRows + threadIdx.y;
  const int gi = blockIdx.z;
  const int L = x.L, GP = x.gp;
  if (s >= x.S || i >= L) return;  // no barrier below
  float a[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = __ldg(aff + gi * 8 + k);
  float q[CM];
  load_q(x, q, gi, i, s);

  float m = -3.0e38f;
  for (int j = 0; j < L; ++j) {
    float qk, qr, kr;
    const float lg = logit<CM, POS>(x, q, gi, i, j, s, a, qk, qr, kr);
    w[j][t] = lg;
    m = fmaxf(m, lg);
  }
  float l = 0.f;
  for (int j = 0; j < L; ++j) {
    const float p = expf(w[j][t] - m);
    w[j][t] = p;
    l += p;
  }
  const float inv_l = 1.f / l;
  for (int p0 = 0; p0 < GP; p0 += kChunkP) {
    const int n = min(kChunkP, GP - p0);
    float sv[kChunkP], sve[kChunkP];
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) sv[u] = sve[u] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = w[j][t];
#pragma unroll
      for (int u = 0; u < kChunkP; ++u) {
        if (u < n) {
          sv[u] = fmaf(p, x.v(gi, p0 + u, j, s), sv[u]);
          if constexpr (POS) sve[u] = fmaf(p, x.tv(p0 + u, i, j), sve[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) {
      sv[u] *= inv_l;
      sve[u] *= inv_l;
    }
    Epi::template store<POS>(e, gi, i, s, p0, n, sv, sve);
  }
  Epi::stats(e, gi, i, s, m, l);
}

template <int CM, class Lay, class Epi>
void launch_fwd_cm(const Lay& x, const typename Epi::Params& e,
                   const float* aff, dim3 grid, bool pos,
                   cudaStream_t stream) {
  const dim3 block(kStripes, kRows);
  if (pos) {
    wide_fwd_kernel<CM, true, Lay, Epi><<<grid, block, 0, stream>>>(x, e, aff);
  } else {
    wide_fwd_kernel<CM, false, Lay, Epi><<<grid, block, 0, stream>>>(x, e,
                                                                     aff);
  }
}

template <class Lay, class Epi>
int launch_fwd(const Lay& x, const typename Epi::Params& e, const float* aff,
               int g, bool pos, cudaStream_t stream) {
  if (x.S < 1 || g < 1 || g > 65535 || x.L < 1 || x.L > kMaxSpan ||
      !gp_ok(x.gp)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((x.S + kStripes - 1) / kStripes, (x.L + kRows - 1) / kRows,
                  g);
  switch (cm_bucket(x.gp / 2)) {
    case 8: launch_fwd_cm<8, Lay, Epi>(x, e, aff, grid, pos, stream); break;
    case 16: launch_fwd_cm<16, Lay, Epi>(x, e, aff, grid, pos, stream); break;
    case 32: launch_fwd_cm<32, Lay, Epi>(x, e, aff, grid, pos, stream); break;
    default: launch_fwd_cm<64, Lay, Epi>(x, e, aff, grid, pos, stream); break;
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wide
