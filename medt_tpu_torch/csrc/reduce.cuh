// Deterministic reductions shared by the backward and moments kernels.
//
// The Pallas kernels these sources replace accumulate grid-wide sums in
// VMEM blocks that stay resident while the TPU walks its grid in order. On
// the H100 the blocks run in parallel and in no fixed order, so every such
// sum is taken in two levels instead: each block reduces its own stripes
// (warp shuffles, then its warps in a fixed order) into one slot of a
// partial buffer, and a second kernel sums the slots in index order. No
// float atomics: the same inputs give the same bits on every run.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

// Each source that includes this gets its own copy (anonymous namespace):
// the sources link into one library.
namespace medt {
namespace {

constexpr int kBlockStripes = 128;  // threads per block = stripes per block
constexpr int kWarps = kBlockStripes / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

inline int stripe_blocks(int S) {
  return (S + kBlockStripes - 1) / kBlockStripes;
}

// out[e] = sum_{p < P} part[p * E + e], p ascending.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int P,
                                    size_t E) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  float acc = 0.f;
  for (int p = 0; p < P; ++p) acc += part[(size_t)p * E + e];
  out[e] = acc;
}

inline void sum_partials(const float* part, float* out, int P, size_t E,
                         cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((E + threads - 1) / threads);
  sum_partials_kernel<<<blocks, threads, 0, stream>>>(part, out, P, E);
}

// The attention backward's daff (g, 8) from its (P, g, 4) partials
// [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog*kr], summed in index order.
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

inline void daff_finalize(const float* part, float* daff, int P, int g,
                          int has_pos, cudaStream_t stream) {
  daff_finalize_kernel<<<(g * 8 + 127) / 128, 128, 0, stream>>>(
      part, daff, P, g, has_pos);
}

// The attention backwards' last launch (lanes, flash, flash2): both
// grid-wide sums in one kernel, each in a fixed order.
//   * dtables[e] = sum_{p < P} tab_part[p * E + e]: a block takes 32
//     consecutive elements (lane = element, coalesced); its kFinWarps warps
//     take contiguous, fixed ranges of the P slots, and their sums are added
//     in warp order;
//   * daff (g, 8) from aff_part (Pa, g, 4) = [sum dlog*qk, sum dlog,
//     sum dlog*qr, sum dlog*kr]: one warp per (group, sum), the lanes over
//     fixed ranges of the Pa slots, then warp_sum; rows 2..5 are zero
//     without positions, rows 6, 7 always.
constexpr int kFinWarps = 8;

__global__ void __launch_bounds__(kFinWarps * 32)
bwd_finalize_kernel(const float* __restrict__ tab_part,
                    float* __restrict__ dtables, int P, size_t E,
                    unsigned tab_blocks, const float* __restrict__ aff_part,
                    float* __restrict__ daff, int Pa, int g, int has_pos) {
  __shared__ float sums[kFinWarps][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (blockIdx.x < tab_blocks) {
    const size_t e = (size_t)blockIdx.x * 32 + lane;
    const int p0 = (int)((long long)P * w / kFinWarps);
    const int p1 = (int)((long long)P * (w + 1) / kFinWarps);
    float acc = 0.f;
    if (e < E) {
      for (int p = p0; p < p1; ++p) acc += tab_part[(size_t)p * E + e];
    }
    sums[w][lane] = acc;
    __syncthreads();
    if (w == 0 && e < E) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kFinWarps; ++k) v += sums[k][lane];
      dtables[e] = v;
    }
    return;
  }
  const int q = (int)(blockIdx.x - tab_blocks) * kFinWarps + w;
  if (q >= g * 4) return;
  const int gi = q / 4, k = q % 4;
  const int p0 = (int)((long long)Pa * lane / 32);
  const int p1 = (int)((long long)Pa * (lane + 1) / 32);
  float v = 0.f;
  for (int p = p0; p < p1; ++p) v += aff_part[((size_t)p * g + gi) * 4 + k];
  v = warp_sum(v);
  if (lane == 0) {
    float* d = daff + gi * 8;
    const float pv = has_pos ? v : 0.f;
    if (k == 0) {
      d[0] = v;
      d[6] = 0.f;
      d[7] = 0.f;
    } else if (k == 1) {
      d[1] = v;
      d[3] = pv;
      d[5] = pv;
    } else {
      d[k == 2 ? 2 : 4] = pv;
    }
  }
}

// dtables (E floats) is not written when P == 0 (no positions).
inline void bwd_finalize(const float* tab_part, float* dtables, int P,
                         size_t E, const float* aff_part, float* daff, int Pa,
                         int g, int has_pos, cudaStream_t stream) {
  const unsigned tab_blocks = P > 0 ? (unsigned)((E + 31) / 32) : 0u;
  const unsigned aff_blocks = (unsigned)((g * 4 + kFinWarps - 1) / kFinWarps);
  bwd_finalize_kernel<<<tab_blocks + aff_blocks, kFinWarps * 32, 0,
                        stream>>>(tab_part, dtables, P, E, tab_blocks,
                                  aff_part, daff, Pa, g, has_pos);
}

}  // namespace
}  // namespace medt
