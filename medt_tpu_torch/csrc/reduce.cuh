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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The attention backwards' last launch (lanes, flash, flash2, stripe): both
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
