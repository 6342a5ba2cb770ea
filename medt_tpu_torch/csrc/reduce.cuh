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

}  // namespace
}  // namespace medt
