// The wide moments kernels' launchers (csrc/moments_wide.cu), called by
// csrc/moments.cu's entry points at the wide widths: every even gp up to
// 128 outside 2, 4, 8 and 16. They write moments.cu's partial layouts
// (the forward's (g * ceil(S / kWideFwdStripes), 6) tile sums; the
// backward's dqkv and, with positions, its (g * ceil(S / ts), 2c + 2c^2,
// L) table partials), which moments.cu's finalizes then sum; moments.cu
// checks its own tile constants against these. Each launches on `stream`
// and returns the launch's CUDA error.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace medt_moments {

constexpr int kWideFwdStripes = 32;  // stripes of a forward block
constexpr int kWideThreads = 256;    // threads of a block, both kernels

cudaError_t wide_fwd(const float* qkv, const float* r_q, const float* e_q,
                     const float* r_k, const float* e_k, float* part, int g,
                     int c, int L, int S, bool pos, cudaStream_t stream);
cudaError_t wide_fwd(const __nv_bfloat16* qkv, const float* r_q,
                     const float* e_q, const float* r_k, const float* e_k,
                     float* part, int g, int c, int L, int S, bool pos,
                     cudaStream_t stream);
cudaError_t wide_bwd(const float* qkv, const float* r_q, const float* e_q,
                     const float* r_k, const float* e_k, const float* ct,
                     float* dqkv, float* part, int g, int ts, int c, int L,
                     int S, bool pos, cudaStream_t stream);
cudaError_t wide_bwd(const __nv_bfloat16* qkv, const float* r_q,
                     const float* e_q, const float* r_k, const float* e_k,
                     const float* ct, __nv_bfloat16* dqkv, float* part, int g,
                     int ts, int c, int L, int S, bool pos,
                     cudaStream_t stream);

}  // namespace medt_moments
