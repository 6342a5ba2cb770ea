// The attention forward at wide group planes (every even gp up to 128
// outside the narrow designs' 2, 4, 8 and 16), for Hopper (sm_90a): the
// body that the lanes and flash forwards (csrc/axial_wide.cu) and the eval
// kernel (csrc/axial_eval_fwd.cu) take at those widths, and the layouts
// that the wide backwards (csrc/axial_wide_bwd.cu, csrc/wide_long.cuh)
// share with it.
//
// Per group gi, query row i and stripe s (c = gp/2), as every forward of
// the port:
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//   sim = softmax_j(logit),  sv[p] = sum_j sim[j] v[p,j],
//   sve[p] = sum_j sim[j] vemb[p,i,j]
// The layouts differ only in where a q, k or v element and a table entry
// lie, so a layout struct (Lanes: the fused (g, 2gp, L, S) qkv of float or
// bf16 and kemb_t [c, i, j]; Stripes: float (S, g, rows, L) views and kemb
// [c, j, i]) gives the addresses and how a chunk of k or v rows is staged,
// and an epilogue writes each output.
//
// Design (wide_fwd_kernel): a block owns one group, a tile of ts stripes
// (8, 16 or 32: lane = stripe, 32 / ts row groups a warp) and a tile of rb
// query rows; a thread holds R query rows (2, or 4 at spans up to 16) of
// one stripe. The logits are summed in rounds of nrl channels: the block
// stages the round's k and q rows (cp.async 16-byte copies on the lanes
// layout where S allows, a 16-byte load converted to float for bf16,
// 4-byte copies elsewhere; the stripe-major layout is transposed into the
// same shared layout, its stripe pitch ts + 1 so that neither the staging
// writes nor the lane reads conflict) and, with positions, its rows' qemb
// and kemb entries ([row][channel][key], so that a 16-byte load gives four
// keys and every lane of a row group reads the same address: a
// broadcast); the registers take them kFwdChunk channels at a time. Each
// shared load of k[c][j][s] then feeds R rows' qk (and the kr of R rows,
// from the broadcast table), and each table quad feeds four keys. The
// logits (R x L floats a thread, in shared memory) carry over the rounds;
// the softmax statistics are taken once, in log2 units (exp2 with a
// pre-scaled log2 e), and the logits become the weights. The value planes
// follow in rounds of nrv: v rows and vemb entries staged the same way, R x
// kFwdChunk sv and sve accumulators a thread. A round holds as many
// channels as keep the grid's blocks resident (pick_fwd): the short spans
// and small grids take all their channels in one or two rounds, the large
// grids keep two or more blocks an SM. At small grids (a batch of one,
// the deep sites) the value planes split across blocks (grid axis y),
// each block recomputing the logits of its rows, so that every sum keeps
// one order; the keys never split. Every block has kFwdWarps warps to
// stage, whatever its rows need. Sums run in a fixed order: no atomics,
// the same bits on every run.
//
// No tensor cores: the bound is float32 FMA (67 TFLOP/s, chip_smoke.py's
// work()), and TF32's 10-bit mantissa would break the forward's atol 1e-4
// on logits of this size.
//
// Widths: every loop over channels or planes stops at c (or gp), so one
// instance serves every gp; only R, the positions and the layout are
// template arguments. The backward's register bucket of c (cm_bucket) and
// its chunk of value channels (kChunkP) stay here for the backwards.
//
// qkv of bf16 (Lanes<__nv_bfloat16>) is converted to float where it is
// staged or read (exact), so its outputs equal the float32 body's on the
// upcast qkv.
//
// What bounds it on the H100: at the axial classifiers' sites (spans 7 to
// 56, 7-768 stripes, g = 8) a launch moves under 40 MB and does under 2
// GFLOP: shared-memory loads (about one load for every 3 FMAs), the
// shared memory that the logits take (R x L floats a thread: two 128-thread
// blocks an SM at span 56) and, at the small grids, latency; 8-10x the
// float32 bound at axial50m's large sites, and at the deep and batch-1
// sites under the host work of a wrapper call (PERF.md). ptxas
// keeps every instance in registers (56-167 a thread, no spill; the
// launch bounds ask for one block an SM, so it may take past 128).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"

namespace wide {
namespace {

constexpr int kChunkP = 16;    // value channels a backward thread holds
constexpr int kMaxSpan = 64;
constexpr int kMaxGp = 128;
// the forward: channels (logits) or planes (values) a chunk, warps a
// block at most, and the grid it aims for (two blocks an SM)
constexpr int kFwdChunk = 4;
constexpr int kFwdWarps = 4;
constexpr int kFwdThreads = kFwdWarps * 32;
constexpr int kFwdTargetBlocks = 264;

// the narrow designs' widths; every other even gp up to kMaxGp is wide
__host__ __device__ constexpr bool is_wide(int gp) {
  return gp != 2 && gp != 4 && gp != 8 && gp != 16;
}

__host__ __device__ constexpr bool gp_ok(int gp) {
  return gp >= 2 && gp <= kMaxGp && gp % 2 == 0;
}

// the register bucket of c = gp / 2 (the backwards' instances)
__host__ __device__ constexpr int cm_bucket(int c) {
  return c <= 8 ? 8 : c <= 16 ? 16 : c <= 32 ? 32 : 64;
}

template <class T>
__device__ __forceinline__ float ld(const T* p) {
  return flash2::to_f32(__ldg(p));
}

// one element into shared memory as float: a 4-byte cp.async for a float,
// a converting load for a bf16 (zero where !ok)
__device__ __forceinline__ void put(float* dst, const float* src, bool ok,
                                    const float* any) {
  flash2::cp_async4(dst, ok ? src : any, ok);
}
__device__ __forceinline__ void put(float* dst, const __nv_bfloat16* src,
                                    bool ok, const __nv_bfloat16*) {
  *dst = ok ? flash2::to_f32(*src) : 0.f;
}

// A table as the forward stages it: entry (ch, i, j) at p[(ch L + i) L + j],
// or with tr at p[(ch L + j) L + i] (kemb [c, j, i])
struct Tab {
  const float* p;
  bool tr;
};

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
  // the tables, for staging
  __device__ __forceinline__ Tab tab_q() const { return {qemb, false}; }
  __device__ __forceinline__ Tab tab_k() const { return {kemb_t, false}; }
  __device__ __forceinline__ Tab tab_v() const { return {vemb, false}; }

  // Stage rows r0 .. r0 + nr of group gi (q: r0 = c0, k: c + c0, v: gp +
  // p0) at positions p0 .. p0 + np and stripes s0 .. s0 + ts into
  // dst[(u * np + j) * tsp + x], zero past n rows, L and S. A thread keeps
  // one run offset x (ts is a power of two) and walks the rows (u, j) by
  // a fixed step, so no index is divided. vec: 16-byte copies (S a
  // multiple of the 4 floats or 8 bf16 of one, qkv 16-byte aligned; ts
  // and s0 are multiples of 8, so a copy is all valid or all past the
  // edge): cp.async for float, a load converted to two 16-byte stores for
  // bf16.
  __device__ __forceinline__ void stage(float* dst, int gi, int r0, int n,
                                        int nr, int p0, int np, int s0,
                                        int ts, int tsp, bool vec, int tid,
                                        int nt) const {
    const T* src = qkv + (((size_t)gi * 2 * gp + r0) * L + p0) * S + s0;
    const int vs = S - s0, vp = L - p0;
    constexpr int V = flash2::kChunk<T>;   // elements a 16-byte copy
    const int w = vec ? ts / V : ts;       // copies a row run (power of 2)
    const int x = (tid & (w - 1)) * (vec ? V : 1), step = nt / w;
    const int du = step / np, dj = step - du * np;
    int j = tid / w, u = j / np;
    j -= u * np;
    for (; u < nr; u += du, j += dj) {
      if (j >= np) {
        j -= np;
        ++u;
        if (u >= nr) break;
      }
      const bool ok = u < n && j < vp && x < vs;
      const T* from = src + ((size_t)u * L + j) * S + x;
      float* to = dst + (u * np + j) * tsp + x;
      if (!vec) {
        put(to, from, ok, qkv);
      } else if constexpr (sizeof(T) == 4) {
        flash2::cp_async16(to, ok ? from : qkv, ok);
      } else {  // 8 bf16 in one load, converted, two 16-byte stores
        uint4 raw = make_uint4(0, 0, 0, 0);
        if (ok) raw = __ldg(reinterpret_cast<const uint4*>(from));
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&raw);
        const float2 a = __bfloat1622float2(h[0]),
                     b = __bfloat1622float2(h[1]),
                     c = __bfloat1622float2(h[2]),
                     d = __bfloat1622float2(h[3]);
        reinterpret_cast<float4*>(to)[0] = make_float4(a.x, a.y, b.x, b.y);
        reinterpret_cast<float4*>(to)[1] = make_float4(c.x, c.y, d.x, d.y);
      }
    }
  }
  __device__ __forceinline__ void stage_q(float* dst, int gi, int c0, int n,
                                          int nr, int, int i0, int rb,
                                          int s0, int ts, int tsp, bool vec,
                                          int tid, int nt) const {
    stage(dst, gi, c0, n, nr, i0, rb, s0, ts, tsp, vec, tid, nt);
  }
  __device__ __forceinline__ void stage_k(float* dst, int gi, int c0, int n,
                                          int nr, int, int l4, int s0,
                                          int ts, int tsp, bool vec, int tid,
                                          int nt) const {
    stage(dst, gi, gp / 2 + c0, n, nr, 0, l4, s0, ts, tsp, vec, tid, nt);
  }
  __device__ __forceinline__ void stage_v(float* dst, int gi, int p0, int n,
                                          int nr, int, int l4, int s0,
                                          int ts, int tsp, bool vec, int tid,
                                          int nt) const {
    stage(dst, gi, gp + p0, n, nr, 0, l4, s0, ts, tsp, vec, tid, nt);
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

  __device__ __forceinline__ Tab tab_q() const { return {qemb, false}; }
  __device__ __forceinline__ Tab tab_k() const { return {kemb, true}; }
  __device__ __forceinline__ Tab tab_v() const { return {vemb, false}; }

  // rows r0 .. r0 + nr of the (S, g, rows, L) view at base, positions p0
  // .. p0 + np, transposed into dst[(u * np + j) * tsp + x] (positions
  // fastest, so the reads run along L), zero past n rows, L and S; the
  // element (j, u, x) walked by a fixed step (nr a power of two, lg_nr its
  // log), so no index is divided
  __device__ __forceinline__ void stage(float* dst, const float* base,
                                        long long ss, long long sg, int gi,
                                        int r0, int n, int nr, int lg_nr,
                                        int p0, int np, int s0, int ts,
                                        int tsp, int tid, int nt) const {
    const int dux = nt / np, dj = nt - dux * np;
    int ux = tid / np, j = tid - ux * np;
    for (;; ux += dux, j += dj) {
      if (j >= np) {
        j -= np;
        ++ux;
      }
      const int u = ux & (nr - 1), x = ux >> lg_nr, s = s0 + x;
      if (x >= ts) break;
      const bool ok = u < n && p0 + j < L && s < S;
      put(dst + (u * np + j) * tsp + x,
          base + s * ss + gi * sg + (size_t)(r0 + u) * L + p0 + j, ok, base);
    }
  }
  __device__ __forceinline__ void stage_q(float* dst, int gi, int c0, int n,
                                          int nr, int lg_nr, int i0, int rb,
                                          int s0, int ts, int tsp, bool,
                                          int tid, int nt) const {
    stage(dst, qp, q_ss, q_sg, gi, c0, n, nr, lg_nr, i0, rb, s0, ts, tsp,
          tid, nt);
  }
  __device__ __forceinline__ void stage_k(float* dst, int gi, int c0, int n,
                                          int nr, int lg_nr, int l4, int s0,
                                          int ts, int tsp, bool, int tid,
                                          int nt) const {
    stage(dst, kp, k_ss, k_sg, gi, c0, n, nr, lg_nr, 0, l4, s0, ts, tsp,
          tid, nt);
  }
  __device__ __forceinline__ void stage_v(float* dst, int gi, int p0, int n,
                                          int nr, int lg_nr, int l4, int s0,
                                          int ts, int tsp, bool, int tid,
                                          int nt) const {
    stage(dst, vp, v_ss, v_sg, gi, p0, n, nr, lg_nr, 0, l4, s0, ts, tsp,
          tid, nt);
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

// The forward's tiles (pick_fwd below): ts stripes a block and tsp their
// pitch in shared memory, nt threads, rb rows a block, nps splits of the
// value planes of pps planes each, l4 = L rounded up to 4, nrl channels
// and nrv value planes (powers of two, kFwdChunk at least) staged a round
// and their logs lgl, lgv, vec as in Lanes::stage.
struct FwdTile {
  int ts, tsp, nt, rb, nps, pps, l4, nrl, nrv, lgl, lgv;
  bool vec;
};

// Stage table rows [r0, r0 + nr) of the block's query rows i0 .. i0 + rb
// at keys < l4 into dst[(rl * nr + u) * l4 + j], zero past n rows and L.
// The element (j, u, rl) is walked by a fixed step (nr a power of two,
// lg_nr its log): no index divided.
__device__ __forceinline__ void stage_table(float* dst, Tab t, int r0, int n,
                                            int nr, int lg_nr, int i0,
                                            int rb, int L, int l4, int tid,
                                            int nt) {
  const int dur = nt / l4, dj = nt - dur * l4;
  int ur = tid / l4, j = tid - ur * l4;
  for (;; ur += dur, j += dj) {
    if (j >= l4) {
      j -= l4;
      ++ur;
    }
    const int u = ur & (nr - 1), rl = ur >> lg_nr, i = i0 + rl;
    if (rl >= rb) break;
    const bool ok = u < n && i < L && j < L;
    const size_t at = t.tr ? ((size_t)(r0 + u) * L + j) * L + i
                           : ((size_t)(r0 + u) * L + i) * L + j;
    flash2::cp_async4(dst + ur * l4 + j, ok ? t.p + at : t.p, ok);
  }
}

__device__ __forceinline__ void fence() {
  flash2::cp_async_commit();
  flash2::cp_async_wait<0>();
  __syncthreads();
}

// Grid (ceil(S / ts), row tiles x nps, g), nt threads. Each round stages nr
// rows (q and k channels, or v planes) and their table entries; the
// registers take them kFwdChunk at a time. Epi provides
//   struct Params;
//   template <bool POS> static void store(const Params&, int gi, int i,
//       int s, int p0, int n, const float (&sv)[kFwdChunk],
//       const float (&sve)[kFwdChunk]);   planes p0 .. p0 + n, normalised
//   static void stats(const Params&, int gi, int i, int s, float m, float l);
template <int R, bool POS, class Lay, class Epi>
__global__ void __launch_bounds__(kFwdThreads, 1)
wide_fwd_kernel(Lay x, typename Epi::Params e, const float* __restrict__ aff,
                FwdTile tl) {
  extern __shared__ float4 smem4[];
  constexpr int CH = kFwdChunk;
  const int nt = tl.nt, ts = tl.ts, tsp = tl.tsp, l4 = tl.l4, nq = l4 / 4;
  const int rb = tl.rb, nrl = tl.nrl, nrv = tl.nrv;
  const int L = x.L, GP = x.gp, C = GP / 2;
  float4* W = smem4;                                 // [R][nq][nt] quads
  float* KV = reinterpret_cast<float*>(W + (size_t)R * nq * nt);
  float* Q = KV + (size_t)(nrl > nrv ? nrl : nrv) * l4 * tsp;  // [nrl][rb][tsp]
  float* TB = Q + (size_t)nrl * rb * tsp;  // [rb][nrl][l4] x 2, [rb][nrv][l4]
  const float4* TQ = reinterpret_cast<const float4*>(TB);
  const float4* TK = TQ + (size_t)rb * nrl * nq;
  const int tid = threadIdx.x, lane_s = tid % ts, rl0 = (tid / ts) * R;
  // the threads past the block's rows only stage
  const bool act = rl0 < rb;
  const int s0 = blockIdx.x * ts, s = s0 + lane_s;
  const int ps = blockIdx.y % tl.nps, i0 = (blockIdx.y / tl.nps) * rb;
  const int gi = blockIdx.z;
  const bool live = s < x.S;
  const float* af = aff + gi * 8;
  const float a0 = __ldg(af), a2 = __ldg(af + 2), a4 = __ldg(af + 4);
  const float cst =
      POS ? (__ldg(af + 1) + __ldg(af + 3)) + __ldg(af + 5) : __ldg(af + 1);

  // 1. logits: lg = cst + sum_c q (a0 k + a2 qemb) + (a4 k) kemb_t
  for (int r0 = 0; r0 < C; r0 += nrl) {
    const int n = min(nrl, C - r0);
    __syncthreads();  // the last round's reads are done
    x.stage_k(KV, gi, r0, n, nrl, tl.lgl, l4, s0, ts, tsp, tl.vec, tid,
              nt);
    x.stage_q(Q, gi, r0, n, nrl, tl.lgl, i0, rb, s0, ts, tsp, tl.vec, tid,
              nt);
    if constexpr (POS) {
      stage_table(TB, x.tab_q(), r0, n, nrl, tl.lgl, i0, rb, L, l4, tid, nt);
      stage_table(TB + (size_t)rb * nrl * l4, x.tab_k(), r0, n, nrl, tl.lgl,
                  i0, rb, L, l4, tid, nt);
    }
    fence();
    for (int u0 = 0; act && u0 < n; u0 += CH) {
      const bool first = r0 + u0 == 0;
      float q[R][CH];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < CH; ++u)
          q[r][u] = Q[((size_t)(u0 + u) * rb + rl0 + r) * tsp + lane_s];
      }
      for (int jq = 0; jq < nq; ++jq) {
        float lg[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 w = first ? make_float4(cst, cst, cst, cst)
                                 : W[((size_t)r * nq + jq) * nt + tid];
          lg[r][0] = w.x;
          lg[r][1] = w.y;
          lg[r][2] = w.z;
          lg[r][3] = w.w;
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const float* kp = KV + ((u0 + u) * l4 + 4 * jq) * tsp + lane_s;
          float k0[4], k4[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const float kv = kp[jj * tsp];
            k0[jj] = a0 * kv;
            k4[jj] = a4 * kv;
          }
#pragma unroll
          for (int r = 0; r < R; ++r) {
            if constexpr (POS) {
              const size_t o = ((size_t)(rl0 + r) * nrl + u0 + u) * nq + jq;
              const float4 qe = TQ[o], ke = TK[o];
              const float qv[4] = {qe.x, qe.y, qe.z, qe.w};
              const float kv[4] = {ke.x, ke.y, ke.z, ke.w};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                lg[r][jj] =
                    fmaf(q[r][u], fmaf(a2, qv[jj], k0[jj]), lg[r][jj]);
                lg[r][jj] = fmaf(k4[jj], kv[jj], lg[r][jj]);
              }
            } else {
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                lg[r][jj] = fmaf(q[r][u], k0[jj], lg[r][jj]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          W[((size_t)r * nq + jq) * nt + tid] =
              make_float4(lg[r][0], lg[r][1], lg[r][2], lg[r][3]);
        }
      }
    }
  }

  // 2. the softmax statistics of each row, the logits become its weights
  // (zero past L)
  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = l[r] = 0.f;
    if (!act) continue;
    float mx = -3.0e38f;
    for (int jq = 0; jq < nq; ++jq) {
      const float4 w = W[((size_t)r * nq + jq) * nt + tid];
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (4 * jq + jj < L) mx = fmaxf(mx, wv[jj]);
    }
    const float mb = mx * flash2::kLog2e;
    float sum = 0.f;
    for (int jq = 0; jq < nq; ++jq) {
      float4& w = W[((size_t)r * nq + jq) * nt + tid];
      float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        wv[jj] = 4 * jq + jj < L
                     ? flash2::ex2(fmaf(wv[jj], flash2::kLog2e, -mb))
                     : 0.f;
        sum += wv[jj];
      }
      w = make_float4(wv[0], wv[1], wv[2], wv[3]);
    }
    m[r] = mx;
    l[r] = sum;
  }

  // 3. this split's value planes, nr a round, CH at a time
  const int pa = ps * tl.pps, pb = min(GP, pa + tl.pps);
  for (int r0 = pa; r0 < pb; r0 += nrv) {
    const int n = min(nrv, pb - r0);
    __syncthreads();
    x.stage_v(KV, gi, r0, n, nrv, tl.lgv, l4, s0, ts, tsp, tl.vec, tid,
              nt);
    if constexpr (POS) {
      stage_table(TB, x.tab_v(), r0, n, nrv, tl.lgv, i0, rb, L, l4, tid, nt);
    }
    fence();
    for (int u0 = 0; act && u0 < n; u0 += CH) {
      float sv[R][CH], sve[R][CH];
#pragma unroll
      for (int r = 0; r < R; ++r) {
#pragma unroll
        for (int u = 0; u < CH; ++u) sv[r][u] = sve[r][u] = 0.f;
      }
      for (int jq = 0; jq < nq; ++jq) {
        float w[R][4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 wq = W[((size_t)r * nq + jq) * nt + tid];
          w[r][0] = wq.x;
          w[r][1] = wq.y;
          w[r][2] = wq.z;
          w[r][3] = wq.w;
        }
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          const float* vp = KV + ((u0 + u) * l4 + 4 * jq) * tsp + lane_s;
          float vv[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) vv[jj] = vp[jj * tsp];
#pragma unroll
          for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              sv[r][u] = fmaf(w[r][jj], vv[jj], sv[r][u]);
            if constexpr (POS) {
              const float4 ve = TQ[((size_t)(rl0 + r) * nrv + u0 + u) * nq + jq];
              const float ev[4] = {ve.x, ve.y, ve.z, ve.w};
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                sve[r][u] = fmaf(w[r][jj], ev[jj], sve[r][u]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = i0 + rl0 + r;
        if (!live || i >= L) continue;
        const float inv_l = 1.f / l[r];
#pragma unroll
        for (int u = 0; u < CH; ++u) {
          sv[r][u] *= inv_l;
          sve[r][u] *= inv_l;
        }
        Epi::template store<POS>(e, gi, i, s, r0 + u0, min(CH, n - u0),
                                 sv[r], sve[r]);
      }
    }
  }
  if (ps == 0 && act) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = i0 + rl0 + r;
      if (live && i < L) Epi::stats(e, gi, i, s, m[r], l[r]);
    }
  }
}

// The forward's tiles at a geometry: ts the least of 8, 16, 32 that holds
// S (32 past it); R = 4 rows a thread at spans up to 16 where that covers
// no more rows than R = 2, else 2 (the logits take R x L floats of shared
// memory a thread); as many warps as the rows need, at most kFwdWarps,
// and kFwdWarps always staging; the value planes split (kFwdChunk planes
// at least a split) until the grid reaches kFwdTargetBlocks blocks. A
// round stages a power of two of kFwdChunk channels or planes, the most
// that keeps the grid's blocks resident (kFwdSmFloats of shared memory an SM
// shared among as many blocks as the grid puts on it, up to kFwdSmemFloats),
// so that the small grids (short spans, a batch of one) take their
// channels in one or two rounds and the large ones keep their occupancy.
constexpr int kFwdSmemFloats = 28672;   // 112 KB: two blocks an SM
constexpr int kFwdSmFloats = 57344;     // 224 KB an SM
constexpr int kFwdSms = 132;

struct FwdPick {
  FwdTile t;
  int r;
  dim3 grid;
  size_t smem;
};

inline int pow2_floor(int v) {
  int p = 1;
  while (2 * p <= v) p *= 2;
  return p;
}

inline int log2_of(int p) {
  int l = 0;
  while ((1 << l) < p) ++l;
  return l;
}

inline FwdPick pick_fwd(int g, int gp, int L, int S, bool pos, bool stripes,
                        bool vec) {
  constexpr int CH = kFwdChunk;
  const int ts = S > 16 ? 32 : S > 8 ? 16 : 8;
  const int rg = 32 / ts;
  auto warps = [&](int r) {
    const int need = (L + rg * r - 1) / (rg * r);
    return need < kFwdWarps ? need : kFwdWarps;
  };
  auto covered = [&](int r) {
    const int rb = warps(r) * rg * r;
    return (L + rb - 1) / rb * rb;
  };
  const int r = L <= 16 && covered(4) <= covered(2) ? 4 : 2;
  const int rb = warps(r) * rg * r, nrt = (L + rb - 1) / rb;
  const long long base = (long long)((S + ts - 1) / ts) * nrt * g;
  const int chunks = (gp + CH - 1) / CH;
  long long want = (kFwdTargetBlocks + base - 1) / base;
  const int nps0 = want < chunks ? (int)want : chunks;
  const int pps = (chunks + nps0 - 1) / nps0 * CH;
  const int nps = (gp + pps - 1) / pps;
  const int l4 = (L + 3) & ~3, nt = kFwdThreads;
  const int tsp = stripes ? ts + 1 : ts;
  // floats of the logits, and of CH channels (k, q and two tables) a
  // round stages; the budget a block may take at this grid
  const int fixed = r * l4 * nt;
  const int per_l = CH * (l4 * tsp + rb * tsp + (pos ? 2 * rb * l4 : 0));
  const long long blocks = base * nps;
  const long long per_sm = (blocks + kFwdSms - 1) / kFwdSms;
  long long budget = kFwdSmFloats / (per_sm > 1 ? per_sm : 1);
  if (budget > kFwdSmemFloats) budget = kFwdSmemFloats;
  int m = (int)((budget - fixed) / per_l);
  m = pow2_floor(m < 1 ? 1 : m);
  const int c4 = (gp / 2 + CH - 1) / CH;
  int ml = 1;
  while (ml < m && ml < c4) ml *= 2;
  const int mv = m < pps / CH ? m : pow2_floor(pps / CH);
  const int nrl = ml * CH, nrv = mv * CH;
  const int kv = (nrl > nrv ? nrl : nrv) * l4 * tsp;
  const int tb = pos ? (2 * nrl > nrv ? 2 * nrl : nrv) * rb * l4 : 0;
  const size_t floats = (size_t)fixed + kv + (size_t)nrl * rb * tsp + tb;
  FwdPick p;
  p.t = FwdTile{ts, tsp, nt, rb, nps, pps, l4, nrl, nrv, log2_of(nrl),
                log2_of(nrv), vec};
  p.r = r;
  p.grid = dim3((S + ts - 1) / ts, nrt * nps, g);
  p.smem = floats * sizeof(float);
  return p;
}

template <int R, bool POS, class Lay, class Epi>
cudaError_t launch_fwd_r(const Lay& x, const typename Epi::Params& e,
                         const float* aff, const FwdPick& p,
                         cudaStream_t stream) {
  auto kernel = wide_fwd_kernel<R, POS, Lay, Epi>;
  const cudaError_t err = flash2::allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<p.grid, p.t.nt, p.smem, stream>>>(x, e, aff, p.t);
  return cudaGetLastError();
}

// stripes: the stripe-major layout (its staging pitch ts + 1); vec: the
// layout's rows may be staged by 16-byte copies
template <class Lay, class Epi>
int launch_fwd(const Lay& x, const typename Epi::Params& e, const float* aff,
               int g, bool pos, bool stripes, bool vec,
               cudaStream_t stream) {
  if (x.S < 1 || g < 1 || g > 65535 || x.L < 1 || x.L > kMaxSpan ||
      !gp_ok(x.gp)) {
    return (int)cudaErrorInvalidValue;
  }
  const FwdPick p = pick_fwd(g, x.gp, x.L, x.S, pos, stripes, vec);
  if (p.grid.y > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (p.r == 4) {
    err = pos ? launch_fwd_r<4, true, Lay, Epi>(x, e, aff, p, stream)
              : launch_fwd_r<4, false, Lay, Epi>(x, e, aff, p, stream);
  } else {
    err = pos ? launch_fwd_r<2, true, Lay, Epi>(x, e, aff, p, stream)
              : launch_fwd_r<2, false, Lay, Epi>(x, e, aff, p, stream);
  }
  return (int)err;
}

}  // namespace
}  // namespace wide
