// Forward of the flash lanes-attention core (spans up to 64), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel flash_lanes_core of
// medt_tpu/ops/pallas_axial_lanes.py (forward pallas_call; body
// _flash_fwd_kernel): the key-streamed lanes attention of spans 17..64 (the
// global branch of MedT-128, the local branch of the 512 px models), which
// also saves the row max m and the softmax denominator l that the backward
// (csrc/axial_flash_bwd.cu) rebuilds p from. The function is flash2's
// (spans up to 256), so both run the tiled forward of csrc/tiled_fwd.cuh,
// each with its own tile policy and entry point.
//
// The first CUDA design ran one thread per (group, query, stripe) on a grid
// (L, ceil(S/128), g): every (i, j) pair loaded k and v from device memory
// or L2, so the L query blocks of a stripe tile each re-read the whole k/v
// slab, nothing was staged in shared memory, and it paid an expf per pair
// and a rescale every 16 keys. On an H100 80GB HBM3 at 700 W: 5.84 ms per
// medt_512 batch-4 forward (8 launches), 35 times its 0.164 ms bound; 0.998
// ms per MedT-128 batch-16 forward (6 launches).
//
// This design runs the tiled forward under FlashFwdTiles: a block owns one
// group, 32 stripes (lane = stripe) and 8 warps' query rows (QT = 64, 32,
// 16, 8 at gp 2, 4, 8, 16), and stages the k/v rows and table tile of the
// whole span (64 keys at gp <= 4) in one cp.async pass, so a stripe tile's
// k/v are staged L / QT = 1-2 times at L = 64; the logits in log2 units
// with one exp2 per pair and a lazy rescale. Measured on an H100 80GB HBM3
// at 700 W (PERF.md, kernel row 3): 0.46 ms of device time per medt_512
// batch-4 forward, 2.83 times its 0.164 ms bound, and 0.20 ms per MedT-128
// batch-16 forward, 2.87 times; flash2's own tiles took 0.48 and 0.23.
// What bounds it is instruction issue in the pair loop (FMAs, the exp2,
// the table reads with positions), as flash2's.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns the first CUDA error of its launch.

#include "tiled_fwd.cuh"

extern "C" {

// Spans 1..64 (the model routes 17..64 here). sve is not written when
// has_pos == 0; m and l are (g, L, S) each.
int medt_flash_lanes_fwd(const float* qkv, const float* qemb,
                         const float* kemb_t, const float* vemb,
                         const float* aff, float* sv, float* sve, float* m,
                         float* l, int g, int gp, int L, int S, int has_pos,
                         void* stream) {
  return flash2::tiled_fwd<flash2::FlashFwdTiles>(
      qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S, has_pos,
      stream);
}

// The same on bf16 qkv (the JAX package's bf16 kernel I/O): each qkv value
// is converted where it is read, so sv, sve, m and l (float32) are the
// float32 entry point's on the upcast qkv, bit for bit.
int medt_flash_lanes_fwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                              const float* kemb_t, const float* vemb,
                              const float* aff, float* sv, float* sve,
                              float* m, float* l, int g, int gp, int L,
                              int S, int has_pos, void* stream) {
  return flash2::tiled_fwd<flash2::FlashFwdTiles>(
      qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S, has_pos,
      stream);
}

}  // extern "C"
