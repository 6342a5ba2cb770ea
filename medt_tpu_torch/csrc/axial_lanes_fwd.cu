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
// qkv is float32 or bf16 (the element type T of the template): its rows
// are staged raw and converted where they are read, so a bf16 qkv gives the
// float32 kernel's sv and sve on its upcast, bit for bit (16-byte copies
// where S % 8 == 0 for bf16). Everything else is float32.
//
// What bounds it on the H100: device memory at its bound (each qkv element
// read once, each output written once), but in practice instruction issue
// and shared-memory reads: per (i, j) pair the kernel does ~6c + 4gp + 8
// flops plus the first design's expf (8 instructions), on operands of which
// c + gp come from shared memory, and contraction depths c <= 8 are far
// too shallow for the tensor cores. The first design read every key and
// value column from global memory once per query row, so about L times the
// compulsory bytes went through L2. What this design does about it:
//   * a block owns one group and a tile of 32 stripes, lane = stripe, so
//     every load and store of a warp is 128 contiguous bytes;
//   * the block stages its tile's k and v rows, (c + gp) L x 32 floats, and
//     the q rows of its query rows, once in shared memory with cp.async
//     (16-byte copies where S % 4 == 0 and qkv is 16-byte aligned, else
//     4-byte; the ragged last tile zero-filled by the copy itself); with
//     positions it stages the table rows of its query rows too, which every
//     thread then reads at the same address;
//   * each warp takes RI query rows (4 at gp <= 4, else 2; fewer at spans
//     up to 8, whose few rows are better spread over more warps), so every
//     k and v value it reads from shared memory serves RI rows; each row's
//     sv (and sve) are written once, coalesced;
//   * where g * ceil(S / 32) blocks would not give about two blocks per SM
//     (kTargetBlocks), the query rows are split into chunks, a second grid
//     axis (each chunk stages the tile's k and v again, from L2), as long
//     as a chunk keeps two warps' rows and four rows: the batch-1 sites
//     (S = 128, 256) and the medt_512 sites (16, gp, 1024); splits into
//     blocks of one or two rows (span 4) ran slower on the card;
//   * the shared-memory layout is strided by the span bucket (4, 8 or 16
//     keys), so its offsets in the unrolled loops are immediates;
//   * each output keeps the first design's arithmetic in its order (c
//     ascending, keys ascending, one 16-key online-softmax step, expf), so
//     only the data movement changed and the outputs keep its bits: the
//     forward feeds every train step, whose parity against plain cores is
//     sensitive to summation order;
//   * the logits of all L <= 16 keys and gp <= 16 accumulators for sv and
//     sve of each of the RI rows stay in registers.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; each entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"

namespace {

constexpr int kTile = 32;       // stripes per block: lane = stripe
constexpr int kWarps = 8;       // warps per block, at most
constexpr int kMaxSpan = 16;    // the whole span is one key block
// blocks below which the query rows split into chunks: about two per SM
// on the H100's 132
constexpr int kTargetBlocks = 264;

// Shared memory of one block, in bytes, for spans up to LB (the span
// bucket, which is also the one key block): q rows [R][C][kTile], k and v
// rows [C + GP][LB][kTile] of T, then with positions the float table rows
// [R][C][LB], [R][C][LB], [R][GP][LB]. Strides are compile-time where the
// unrolled loops index them, so every shared-memory offset there is an
// immediate.
template <int GP, bool HAS_POS, int LB, class T>
size_t smem_bytes(int R) {
  constexpr int C = GP / 2;
  return (size_t)kTile * (R * C + (C + GP) * LB) * sizeof(T) +
         (HAS_POS ? (size_t)R * (2 * C + GP) * LB * sizeof(float) : 0);
}

// n runs of kTile elements of qkv into shared memory: run b comes from
// src + off(b) and lands at dst + dst_run(b) * kTile; elements at or past
// vx (the stripes left in the tile) are zero-filled.
template <class T, class Off, class Dst>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int n,
                                           Off off, Dst dst_run, int vx,
                                           bool vec, int tid, int nt) {
  if (vec) {
    constexpr int V = flash2::kChunk<T>, XV = kTile / V;
    for (int e = tid; e < n * XV; e += nt) {
      const int b = e / XV, x = (e - b * XV) * V;
      const bool ok = x < vx;
      flash2::cp_async16(dst + dst_run(b) * kTile + x,
                         ok ? src + off(b) + x : src, ok);
    }
  } else {
    for (int e = tid; e < n * kTile; e += nt) {
      const int b = e / kTile, x = e - b * kTile;
      const bool ok = x < vx;
      flash2::copy_elem(dst + dst_run(b) * kTile + x,
                        ok ? src + off(b) + x : src, ok);
    }
  }
}

template <int GP, bool HAS_POS, int LB, int RI, class T>
__global__ void __launch_bounds__(kWarps * 32)
axial_lanes_fwd_kernel(const T* __restrict__ qkv,
                       const float* __restrict__ qemb,
                       const float* __restrict__ kemb_t,
                       const float* __restrict__ vemb,
                       const float* __restrict__ aff,
                       float* __restrict__ sv, float* __restrict__ sve,
                       int L, int S, int R, bool vec) {
  constexpr int C = GP / 2;
  using flash2::to_f32;
  extern __shared__ __align__(16) float smem[];
  T* s_q = reinterpret_cast<T*>(smem);      // [R][C][kTile]
  T* s_k = s_q + R * C * kTile;             // [C][LB][kTile]
  T* s_v = s_k + C * LB * kTile;            // [GP][LB][kTile]
  // [R][C][LB]
  float* t_q = reinterpret_cast<float*>(s_v + GP * LB * kTile);
  float* t_k = t_q + R * C * LB;            // [R][C][LB]
  float* t_v = t_k + R * C * LB;            // [R][GP][LB]

  const int s0 = blockIdx.x * kTile;
  const int i0 = blockIdx.y * R;
  const int gi = blockIdx.z;
  const int rows = min(R, L - i0);          // query rows of this block
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;

  const size_t LS = (size_t)L * S;
  const T* base = qkv + (size_t)gi * 2 * GP * LS + s0;
  const int vx = S - s0;
  // A run of kTile elements (row, position) lies at ((row) * L + position) *
  // S: q run b = (il, c) -> row c, position i0 + il; k and v run b -> row
  // C + b / L (v continues k), position b % L.
  stage_tile(s_q, base, rows * C,
             [&](int b) {
               const int il = b / C, c = b - il * C;
               return ((size_t)c * L + i0 + il) * S;
             },
             [](int b) { return b; }, vx, vec, tid, nt);
  stage_tile(s_k, base, (C + GP) * L,
             [&](int b) { return ((size_t)C * L + b) * S; },
             [&](int b) {
               const int r = b / L;
               return r * LB + (b - r * L);
             },
             vx, vec, tid, nt);
  if constexpr (HAS_POS) {
    // table rows i0 .. i0 + rows: qemb and kemb_t [c, i, j] land at
    // [il][c][j], vemb [p, i, j] at [il][p][j]
    for (int e = tid; e < rows * C * L; e += nt) {
      const int j = e % L, ic = e / L, c = ic % C, il = ic / C;
      const size_t src = ((size_t)c * L + i0 + il) * L + j;
      flash2::cp_async4(t_q + ic * LB + j, qemb + src, true);
      flash2::cp_async4(t_k + ic * LB + j, kemb_t + src, true);
    }
    for (int e = tid; e < rows * GP * L; e += nt) {
      const int j = e % L, ip = e / L, p = ip % GP, il = ip / GP;
      flash2::cp_async4(t_v + ip * LB + j,
                        vemb + ((size_t)p * L + i0 + il) * L + j, true);
    }
  }
  flash2::cp_async_commit();
  // the affine is read while the copies are in flight
  const float a0 = aff[gi * 8 + 0], a1 = aff[gi * 8 + 1];
  const float a2 = aff[gi * 8 + 2], a3 = aff[gi * 8 + 3];
  const float a4 = aff[gi * 8 + 4], a5 = aff[gi * 8 + 5];
  flash2::cp_async_wait<0>();
  __syncthreads();

  // each warp takes RI query rows at a time, so that every k and v value
  // read from shared memory serves RI rows (the kernel is bound by
  // shared-memory reads as much as by issue); each row's arithmetic is
  // the first design's, in its order
  const int s = s0 + lane;
  for (int il0 = warp * RI; il0 < rows; il0 += (nt >> 5) * RI) {
    float q[RI][C];
    const float* tq[RI];
    const float* tk[RI];
    const float* tv[RI];
#pragma unroll
    for (int u = 0; u < RI; ++u) {
      const int il = min(il0 + u, rows - 1);
#pragma unroll
      for (int c = 0; c < C; ++c)
        q[u][c] = to_f32(s_q[(il * C + c) * kTile + lane]);
      tq[u] = t_q + il * C * LB;            // + c * LB + j
      tk[u] = t_k + il * C * LB;
      tv[u] = t_v + il * GP * LB;           // + p * LB + j
    }

    // one online-softmax step over all LB >= L keys, as the first design's
    // first (and only) 16-key block; that step also scaled l and the sums,
    // still 0, by expf(-1e30 - m_new), a product that is exactly 0 and is
    // left out
    float lg[RI][LB], bmax[RI];
#pragma unroll
    for (int u = 0; u < RI; ++u) bmax[u] = -1e30f;
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      if (j < L) {
        float kv[C];
#pragma unroll
        for (int c = 0; c < C; ++c)
          kv[c] = to_f32(s_k[(c * LB + j) * kTile + lane]);
#pragma unroll
        for (int u = 0; u < RI; ++u) {
          float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            qk += q[u][c] * kv[c];
            if constexpr (HAS_POS) {
              qr += q[u][c] * tq[u][c * LB + j];
              kr += kv[c] * tk[u][c * LB + j];
            }
          }
          float x = qk * a0 + a1;
          if constexpr (HAS_POS) x += (qr * a2 + a3) + (kr * a4 + a5);
          lg[u][j] = x;
          bmax[u] = fmaxf(bmax[u], x);
        }
      }
    }
    float m_new[RI], l[RI], acc_v[RI][GP], acc_e[RI][GP];
#pragma unroll
    for (int u = 0; u < RI; ++u) {
      m_new[u] = fmaxf(-1e30f, bmax[u]);
      l[u] = 0.f;
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        acc_v[u][p] = 0.f;
        acc_e[u][p] = 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      if (j < L) {
        float e[RI];
#pragma unroll
        for (int u = 0; u < RI; ++u) {
          e[u] = expf(lg[u][j] - m_new[u]);
          l[u] += e[u];
        }
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          const float vv = to_f32(s_v[(p * LB + j) * kTile + lane]);
#pragma unroll
          for (int u = 0; u < RI; ++u) {
            acc_v[u][p] += e[u] * vv;
            if constexpr (HAS_POS) acc_e[u][p] += e[u] * tv[u][p * LB + j];
          }
        }
      }
    }

    if (s < S) {
#pragma unroll
      for (int u = 0; u < RI; ++u) {
        if (il0 + u < rows) {
          const float inv_l = 1.f / l[u];
          const size_t out0 =
              (size_t)gi * GP * LS + (size_t)(i0 + il0 + u) * S + s;
#pragma unroll
          for (int p = 0; p < GP; ++p) {
            sv[out0 + p * LS] = acc_v[u][p] * inv_l;
            if constexpr (HAS_POS) sve[out0 + p * LS] = acc_e[u][p] * inv_l;
          }
        }
      }
    }
  }
}

// Query rows a warp takes at a time: what the registers allow at the
// longest spans, and at span buckets 4 and 8 fewer, which leaves more warps
// for a short span's few rows.
template <int GP, int LB>
constexpr int rows_at_once() {
  return (GP <= 4 ? 4 : 2) < LB / 4 ? (GP <= 4 ? 4 : 2) : LB / 4;
}

// The query rows per block: all L, or chunks of them while the grid of
// g * tiles blocks would hold fewer than kTargetBlocks and a chunk still
// holds two warps' RI rows, and four rows at least.
inline int rows_per_block(int g, int tiles, int L, int RI) {
  int chunks = 1;
  while ((long long)g * tiles * chunks < kTargetBlocks &&
         L / (2 * chunks) >= (RI > 2 ? 2 * RI : 4)) {
    chunks *= 2;
  }
  return (L + chunks - 1) / chunks;
}

template <int GP, bool HAS_POS, int LB, class T>
int launch(const T* qkv, const float* qemb, const float* kemb_t,
           const float* vemb, const float* aff, float* sv, float* sve, int g,
           int L, int S, cudaStream_t stream) {
  constexpr int RI = rows_at_once<GP, LB>();

  const int tiles = (S + kTile - 1) / kTile;
  const int R = rows_per_block(g, tiles, L, RI);
  const dim3 grid(tiles, (L + R - 1) / R, g);
  const int threads = 32 * min(kWarps, (R + RI - 1) / RI);
  const size_t bytes = smem_bytes<GP, HAS_POS, LB, T>(R);
  auto kernel = axial_lanes_fwd_kernel<GP, HAS_POS, LB, RI, T>;
  const cudaError_t err = flash2::allow_smem(kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  const bool vec = S % flash2::kChunk<T> == 0 && flash2::aligned16(qkv);
  kernel<<<grid, threads, bytes, stream>>>(qkv, qemb, kemb_t, vemb, aff, sv,
                                           sve, L, S, R, vec);
  return (int)cudaGetLastError();
}

template <int GP, bool HAS_POS, class T>
int launch_span(const T* qkv, const float* qemb, const float* kemb_t,
                const float* vemb, const float* aff, float* sv, float* sve,
                int g, int L, int S, cudaStream_t stream) {
#define MEDT_LANES_LAUNCH(LB)                                               \
  return launch<GP, HAS_POS, LB, T>(qkv, qemb, kemb_t, vemb, aff, sv, sve, \
                                    g, L, S, stream)
  if (L <= 4) MEDT_LANES_LAUNCH(4);
  if (L <= 8) MEDT_LANES_LAUNCH(8);
  MEDT_LANES_LAUNCH(kMaxSpan);
#undef MEDT_LANES_LAUNCH
}

template <int GP, class T>
int launch_gp(const T* qkv, const float* qemb, const float* kemb_t,
              const float* vemb, const float* aff, float* sv, float* sve,
              int g, int L, int S, bool has_pos, cudaStream_t stream) {
  if (has_pos) {
    return launch_span<GP, true>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L,
                                 S, stream);
  }
  return launch_span<GP, false>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L,
                                S, stream);
}

template <class T>
int lanes_fwd(const T* qkv, const float* qemb, const float* kemb_t,
              const float* vemb, const float* aff, float* sv, float* sve,
              int g, int gp, int L, int S, int has_pos, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (g < 1 || S < 1 || L < 1 || L > kMaxSpan || g > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  switch (gp) {
    case 2: return launch_gp<2>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L,
                                S, pos, stream);
    case 4: return launch_gp<4>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L,
                                S, pos, stream);
    case 8: return launch_gp<8>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, L,
                                S, pos, stream);
    case 16: return launch_gp<16>(qkv, qemb, kemb_t, vemb, aff, sv, sve, g,
                                  L, S, pos, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Spans <= 16 (lanes_attn_core). sve is not written when has_pos == 0.
int medt_lanes_attn_fwd(const float* qkv, const float* qemb,
                        const float* kemb_t, const float* vemb,
                        const float* aff, float* sv, float* sve, int g, int gp,
                        int L, int S, int has_pos, void* stream) {
  return lanes_fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, gp, L, S,
                   has_pos, stream);
}

// The same on bf16 qkv (the JAX package's bf16 kernel I/O): sv and sve
// (float32) are the float32 entry point's on the upcast qkv, bit for bit.
int medt_lanes_attn_fwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                             const float* kemb_t, const float* vemb,
                             const float* aff, float* sv, float* sve, int g,
                             int gp, int L, int S, int has_pos,
                             void* stream) {
  return lanes_fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, g, gp, L, S,
                   has_pos, stream);
}

}  // extern "C"
