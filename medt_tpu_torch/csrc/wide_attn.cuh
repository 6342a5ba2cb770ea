// The attention forward at wide group planes (gp 32 and 64), for Hopper
// (sm_90a): the body that the lanes and flash forwards
// (csrc/axial_wide.cu) and the eval kernel (csrc/axial_eval_fwd.cu) take
// at those widths.
//
// Per group gi, query row i and stripe s (c = gp/2), as every forward of
// the port:
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//   sim = softmax_j(logit),  sv[p] = sum_j sim[j] v[p,j],
//   sve[p] = sum_j sim[j] vemb[p,i,j]
// The layouts differ only in where a q, k or v element and a table entry
// lie, so a layout struct (Lanes: the fused (g, 2gp, L, S) qkv and kemb_t
// [c, i, j]; Stripes: (S, g, rows, L) views and kemb [c, j, i]) gives the
// addresses and an epilogue writes each output.
//
// Why a body of its own: the designs for gp <= 16 keep a row's sv and sve
// accumulators (acc_v[RI][GP], acc_e[RI][GP]) and every key's k and v
// columns in registers and shared memory. At gp 64 that is 128 floats a
// row in registers and, for the lanes forward's 32-stripe tile, 192 KB of
// k and v rows in shared memory, past the 227 KB a block may hold once
// the tables are staged. This body keeps one query row per thread (lane =
// stripe, so a warp's loads of a k or v row are 128 contiguous bytes in
// the lanes layout): its q row (c floats) in registers, its logits and
// then its softmax weights in shared memory (at most 64 a thread, 32 KB a
// block), and the value channels in chunks of kChunkP, so that a thread
// never holds more than 2 * kChunkP accumulators; the softmax statistics
// (m, l) are computed once per row, before the first chunk. What bounds it
// on the H100: at the axial26s sites (span 14 and 28, 112-224 stripes, g
// = 8) a launch moves under 4 MB, so latency and the L1/L2 traffic of
// re-reading k, v and the tables for every query row; a simple kernel that
// is right, per the port's rule, to be made fast later.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace wide {
namespace {

constexpr int kStripes = 32;   // threads of a block along the stripes
constexpr int kRows = 4;       // query rows (or keys) of a block
constexpr int kThreads = kStripes * kRows;
constexpr int kChunkP = 16;    // value channels a thread holds at once
constexpr int kMaxSpan = 64;

// The fused lanes layout: qkv (g, 2gp, L, S), rows [0:c] q, [c:gp] k,
// [gp:2gp] v; tables qemb, kemb_t [c, i, j], vemb [p, i, j].
struct Lanes {
  const float* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  int gp, L, S;

  __device__ __forceinline__ float row(int gi, int r, int pos, int s) const {
    return __ldg(qkv + (((size_t)gi * 2 * gp + r) * L + pos) * S + s);
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

// The logit of query i and key j of stripe s: q (the query's row, in
// registers) against k's column j; qk, qr and kr come back for the
// backward's sums.
template <int C, bool POS, class Lay>
__device__ __forceinline__ float logit(const Lay& x, const float (&q)[C],
                                       int gi, int i, int j, int s,
                                       const float* a, float& qk, float& qr,
                                       float& kr) {
  qk = qr = kr = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float kc = x.k(gi, c, j, s);
    qk = fmaf(q[c], kc, qk);
    if constexpr (POS) {
      qr = fmaf(q[c], x.tq(c, i, j), qr);
      kr = fmaf(kc, x.tk(c, i, j), kr);
    }
  }
  float lg = qk * a[0] + a[1];
  if constexpr (POS) lg += (qr * a[2] + a[3]) + (kr * a[4] + a[5]);
  return lg;
}

// A block of kStripes x kRows threads, thread (stripe, query row); grid
// (ceil(S / kStripes), ceil(L / kRows), g). Epi provides
//   struct Params;
//   template <int GP, bool POS> static void store(const Params&, int gi,
//       int i, int s, int p0, const float (&sv)[kChunkP],
//       const float (&sve)[kChunkP]);   planes p0 .. p0 + kChunkP, normalised
//   static void stats(const Params&, int gi, int i, int s, float m, float l);
template <int GP, bool POS, class Lay, class Epi>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(Lay x, typename Epi::Params e, const float* __restrict__ aff) {
  constexpr int C = GP / 2;
  static_assert(GP % kChunkP == 0, "whole value-channel chunks");
  __shared__ float w[kMaxSpan][kThreads];  // logits, then softmax weights
  const int t = threadIdx.y * kStripes + threadIdx.x;
  const int s = blockIdx.x * kStripes + threadIdx.x;
  const int i = blockIdx.y * kRows + threadIdx.y;
  const int gi = blockIdx.z;
  const int L = x.L;
  if (s >= x.S || i >= L) return;  // no barrier below
  float a[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = __ldg(aff + gi * 8 + k);
  float q[C];
#pragma unroll
  for (int c = 0; c < C; ++c) q[c] = x.q(gi, c, i, s);

  float m = -3.0e38f;
  for (int j = 0; j < L; ++j) {
    float qk, qr, kr;
    const float lg = logit<C, POS>(x, q, gi, i, j, s, a, qk, qr, kr);
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
    float sv[kChunkP], sve[kChunkP];
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) sv[u] = sve[u] = 0.f;
    for (int j = 0; j < L; ++j) {
      const float p = w[j][t];
#pragma unroll
      for (int u = 0; u < kChunkP; ++u) {
        sv[u] = fmaf(p, x.v(gi, p0 + u, j, s), sv[u]);
        if constexpr (POS) sve[u] = fmaf(p, x.tv(p0 + u, i, j), sve[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kChunkP; ++u) {
      sv[u] *= inv_l;
      sve[u] *= inv_l;
    }
    Epi::template store<GP, POS>(e, gi, i, s, p0, sv, sve);
  }
  Epi::stats(e, gi, i, s, m, l);
}

template <class Lay, class Epi>
int launch_fwd(const Lay& x, const typename Epi::Params& e, const float* aff,
               int g, bool pos, cudaStream_t stream) {
  if (x.S < 1 || g < 1 || g > 65535 || x.L < 1 || x.L > kMaxSpan) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((x.S + kStripes - 1) / kStripes, (x.L + kRows - 1) / kRows,
                  g);
  const dim3 block(kStripes, kRows);
#define MEDT_WIDE_FWD(GP, POS) \
  wide_fwd_kernel<GP, POS, Lay, Epi><<<grid, block, 0, stream>>>(x, e, aff)
  switch (x.gp) {
    case 32:
      if (pos) MEDT_WIDE_FWD(32, true); else MEDT_WIDE_FWD(32, false);
      break;
    case 64:
      if (pos) MEDT_WIDE_FWD(64, true); else MEDT_WIDE_FWD(64, false);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MEDT_WIDE_FWD
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wide
