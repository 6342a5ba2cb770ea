// The wide moments kernels' launchers (csrc/moments_wide.cu), called by
// csrc/moments.cu's entry points at the wide widths: every even gp up to
// 128 outside 2, 4, 8 and 16. They write moments.cu's partial layouts
// (the forward's (g * ceil(S / wide_fwd_tile), 6) tile sums; the
// backward's dqkv and, with positions, its (g * ceil(S / ts), 2c + 2c^2,
// L) table partials), which moments.cu's finalizes then sum; moments.cu
// checks its own tile constants against these. Each launches on `stream`
// and returns the launch's CUDA error.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace medt_moments {

constexpr int kWideThreads = 256;    // threads of a block, every kernel
// the backward's tiles (ops/moments.py mirrors the slots): the dq/dk
// kernel's stripes a block (wide_dqk_tile) and w rows a tile
// (wide_dqk_rows), and the table kernel's stripe splits, one partial slot
// each (wide_bwd_slots); spans up to moments.cu's kMaxBwdSpan (256)
constexpr int kWideMaxTile = 8;
constexpr int kWideSlabFloats = 12288;
constexpr int kWideMinBlocks = 264;
constexpr int kWideTabStripes = 32;
// the shared memory a dq/dk block may hold (224 KB of the 227 KB limit)
constexpr int kWideMaxSmemFloats = 56 * 1024;

// The forward's tile (its partials have one slot per block, a count that
// moments.cu's medt_moment_sums_fwd_slots gives the wrappers): a block
// stages its stripes' q and k rows, each stripe's row of channels padded
// to fwd_x (c rounded up to 4, then a ones channel and three zeros) and to
// an odd number of 16-byte chunks, each row l of stripes padded the same
// way, the whole span where it fits
// kWideFwdSmemFloats (two blocks an SM); ts is the largest of
// kWideFwdMaxTile, ..., kWideFwdMinTile stripes whose slab fits and whose
// grid keeps kWideMinBlocks blocks (below kWideFwdMinTile only where the
// span does not fit, down to 1 stripe, whose rows are then staged in
// chunks).
constexpr int kWideFwdMaxTile = 32;
constexpr int kWideFwdMinTile = 4;
constexpr int kWideFwdSmemFloats = 24576;

// floats of a stripe's staged row of channels, and of a row l of ts such
__host__ __device__ constexpr int odd_chunks(int floats) {
  return (floats / 4) % 2 ? floats : floats + 4;
}
__host__ __device__ constexpr int fwd_x(int c) { return ((c + 3) & ~3) + 4; }
__host__ __device__ constexpr int fwd_stripe_pitch(int c) {
  return odd_chunks(fwd_x(c));
}
__host__ __device__ constexpr int fwd_row_pitch(int c, int ts) {
  return odd_chunks(ts * fwd_stripe_pitch(c));
}

inline int wide_fwd_tile(int c, int L, int S, int g) {
  int ts = kWideFwdMaxTile;
  while (ts > 1 &&
         ((long long)2 * L * fwd_row_pitch(c, ts) > kWideFwdSmemFloats ||
          (ts > kWideFwdMinTile &&
           (long long)g * ((S + ts - 1) / ts) < kWideMinBlocks))) {
    ts /= 2;
  }
  return ts;
}

// rows l a forward block stages at a time: the whole span where it fits
inline int wide_fwd_rows(int c, int L, int ts) {
  const int most = kWideFwdSmemFloats / (2 * fwd_row_pitch(c, ts));
  return L < most ? L : most;
}

// the largest of 8, 4, 2, 1 stripes whose q/k slab and w matrices (2cL +
// L (L | 1) floats a stripe) fit kWideSlabFloats and whose grid keeps
// kWideMinBlocks blocks
inline int wide_dqk_tile(int c, int L, int S, int g) {
  int ts = kWideMaxTile;
  while (ts > 1 && ((long long)ts * (2 * c * L + L * (L | 1)) >
                        kWideSlabFloats ||
                    (long long)g * ((S + ts - 1) / ts) < kWideMinBlocks)) {
    ts /= 2;
  }
  return ts;
}

// rows of w a dq/dk block forms at a time: all L where a stripe's q/k slab
// and w (2cL + L (L | 1) floats) fit kWideMaxSmemFloats, else as many as
// fit beside the slab and the dk sums carried over the tiles (3cL floats;
// at least 31 rows at c = 64, L = 256)
inline int wide_dqk_rows(int c, int L) {
  const int Lw = L | 1;
  if (2 * c * L + L * Lw <= kWideMaxSmemFloats) return L;
  return (kWideMaxSmemFloats - 3 * c * L) / Lw;
}

// table-partial slots: splits of the stripes until 2L splits-blocks reach
// kWideMinBlocks, each split at least kWideTabStripes stripes
inline int wide_bwd_slots(int L, int S) {
  const int want = (kWideMinBlocks + 2 * L - 1) / (2 * L);
  const int most = (S + kWideTabStripes - 1) / kWideTabStripes;
  return want < most ? want : most;
}

cudaError_t wide_fwd(const float* qkv, const float* r_q, const float* e_q,
                     const float* r_k, const float* e_k, float* part, int g,
                     int c, int L, int S, bool pos, cudaStream_t stream);
cudaError_t wide_fwd(const __nv_bfloat16* qkv, const float* r_q,
                     const float* e_q, const float* r_k, const float* e_k,
                     float* part, int g, int c, int L, int S, bool pos,
                     cudaStream_t stream);
cudaError_t wide_bwd(const float* qkv, const float* r_q, const float* e_q,
                     const float* r_k, const float* e_k, const float* ct,
                     float* dqkv, float* part, int g, int c, int L, int S,
                     bool pos, cudaStream_t stream);
cudaError_t wide_bwd(const __nv_bfloat16* qkv, const float* r_q,
                     const float* e_q, const float* r_k, const float* e_k,
                     const float* ct, __nv_bfloat16* dqkv, float* part, int g,
                     int c, int L, int S, bool pos, cudaStream_t stream);

}  // namespace medt_moments
