// Backward of the flash lanes-attention core (spans up to 64), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of flash_lanes_core's backward,
// _flash_bwd_rule (body _flash_bwd_kernel) in
// medt_tpu/ops/pallas_axial_lanes.py: the probabilities rebuilt from the
// forward's saved row max m and denominator l, delta from its saved
// outputs sv, sve. The function is flash2's (spans up to 256), so both run
// the tiled two-pass backward of csrc/tiled_bwd.cuh, each with its own tile
// policy and entry point.
//
// The first CUDA design ran one thread per (group, query or key, stripe):
// its row pass re-read all L keys' k and v from L2 for every query row and
// reduced each pair's 2gp table-gradient terms with 2gp warp_sums (40
// shuffles per key and warp at gp 4); its column pass reloaded q, m, l,
// delta, dsv and dsve from device memory for every pair; 4 launches a call
// with positions. On an H100 80GB HBM3 at 700 W: 2.64-2.78 ms per MedT-128
// batch-16 train step (6 launches; 2.56 ms of device time), 17-18x its
// 0.151 ms bound; 5.34-5.36 ms per medt_512 batch-4 step (8 launches).
//
// This design runs the tiled two-pass backward of csrc/tiled_bwd.cuh (the
// flash2 design, made a template over its tile policy):
//   * row pass: a block owns one group, 8 query rows (gp <= 4) and 128
//     stripes; k, v and the table tile are staged 16 keys at a time by
//     cp.async in a 2-slot ring; q, dsv, dsve of 4 stripes a lane in
//     registers; p = exp2 of the logit less the log2 normaliser that the
//     row pass also writes with delta; the table-gradient terms summed over
//     a lane's 4 stripes in registers, then reduce-scattered across the
//     warp (31 shuffles per 32 sums, not 5 per sum);
//   * column pass: a block owns one group, 32 keys (8 a thread at gp <= 4)
//     and 32 stripes, and stages q, dsv, dsve, delta and the normaliser of
//     16 queries at a time;
//   * one fused finalize sums the partials in a fixed order: three launches
//     a call.
// Its tiles are flash2's (FlashTiles only lowers the span limit): two
// policies sized for spans up to 64 measured slower (tiled_bwd.cuh).
// Measured on the same card (PERF.md, kernel row 4): 1.06-1.08 ms per
// MedT-128 step (0.82 ms of device time, 5.4x the bound; row pass 0.49,
// column pass 0.31, finalize 0.02), 1.70 ms per medt_512 step (1.41-1.46
// of device time, 4.2-4.3x its 0.336 ms bound). Registers as flash2's:
// row pass 120-255, column pass 128-248, no spills.
// What bounds it: instruction issue in the pair loops (FMAs, one exp2, and
// with positions the reduce-scatter) at 8 resident warps per SM; at the
// (32, 4, 512) site and in back-to-back calls, the host's cost per call
// (checks, 3 allocations, the ctypes call, 3 launches: 80-110 us).

#include "tiled_bwd.cuh"

extern "C" {

// m, l, sv, sve are the forward's saved outputs; scratch holds 2 * g * L * S
// floats. Partials: tab_part (g * ceil(S/128), 2gp, L, L) (unused without
// positions), aff_part (ceil(L/QB) * ceil(S/128), g, 4), QB by gp as
// FlashTiles gives it (8, 8, 4, 2).
int medt_flash_lanes_bwd(const float* qkv, const float* qemb,
                         const float* kemb_t, const float* vemb,
                         const float* aff, const float* m, const float* l,
                         const float* sv, const float* sve, const float* dsv,
                         const float* dsve, float* dqkv, float* dtables,
                         float* daff, float* scratch, float* tab_part,
                         float* aff_part, int g, int gp, int L, int S,
                         int has_pos, int n_tab_part, int n_aff_part,
                         void* stream) {
  return flash2::tiled_bwd<flash2::FlashTiles>(
      qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve, dqkv, dtables,
      daff, scratch, tab_part, aff_part, g, gp, L, S, has_pos, n_tab_part,
      n_aff_part, stream);
}

// The same on bf16 qkv (the JAX package's bf16 kernel I/O): qkv values
// are converted where they are read and each dqkv value is rounded once to
// bf16 where it is stored, so the table and daff gradients are the float32
// entry point's on the upcast qkv and dqkv is its dqkv rounded once.
int medt_flash_lanes_bwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                              const float* kemb_t, const float* vemb,
                              const float* aff, const float* m, const float* l,
                              const float* sv, const float* sve,
                              const float* dsv, const float* dsve,
                              __nv_bfloat16* dqkv, float* dtables, float* daff,
                              float* scratch, float* tab_part, float* aff_part,
                              int g, int gp, int L, int S, int has_pos,
                              int n_tab_part, int n_aff_part, void* stream) {
  return flash2::tiled_bwd<flash2::FlashTiles>(
      qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve, dqkv, dtables,
      daff, scratch, tab_part, aff_part, g, gp, L, S, has_pos, n_tab_part,
      n_aff_part, stream);
}

}  // extern "C"
