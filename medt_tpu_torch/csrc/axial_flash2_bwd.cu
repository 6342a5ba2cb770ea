// Backward of the long-span lanes attention (64 < L <= 256), for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of flash2_lanes_core's backward,
// _flash2_bwd_rule (body _flash2_bwd_kernel) in
// medt_tpu/ops/pallas_axial_lanes.py. The forward is csrc/axial_flash2_fwd.cu
// (per group gi, query i, key j, stripe s; c = gp/2):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   sv[p,i] = sum_j p_ij v[p,j],  sve[p,i] = sum_j p_ij vemb[p,i,j]
// and p is rebuilt from its saved row max m and denominator l. Given dsv,
// dsve (g, gp, L, S), with
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   delta_i = sum_p dsv[p,i] sv[p,i] + dsve[p,i] sve[p,i]   (saved sv, sve)
//   dlog_ij = p_ij (dsim_ij - delta_i)
// it writes the fused dqkv (g, 2gp, L, S):
//   dq[c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])
//   dv[p,j] = sum_i p_ij dsv[p,i]
// the table gradients (2gp, L, L), summed over every group and stripe,
//   dqemb[c,i,j] = a2 sum dlog_ij q[c,i],  dkemb_t[c,i,j] = a4 sum dlog_ij k[c,j]
//   dvemb[p,i,j] = sum p_ij dsve[p,i]
// and daff (g, 8) = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog,
//                    sum dlog*kr, sum dlog, 0, 0] (rows 2..5 zero w/o pos).
//
// The TPU kernel sweeps query blocks innermost so that dk/dv stay resident
// in VMEM, and emits per-program table partials that XLA sums. On the H100
// blocks run in parallel and in no order, so the sums over queries and over
// stripes are taken without atomics, in a fixed order, by two passes and
// the index-order reductions of reduce.cuh.
//
// The first CUDA design took 46.12 ms per medt_512 batch-4 train step, 19.1
// times its bound: its row pass read k and v from device memory for every
// pair and summed each pair's 2gp table-gradient terms over the block's
// stripes with 2gp warp_sums (about 40 shuffles per warp and key at gp 4);
// its column pass (59 % of the time) reloaded q, m, l, delta, dsv and dsve
// from device memory for every pair (about 28 GB of L2 reads per launch at
// (256, 4, 1024)).
//
// This design tiles both passes and stages their operands in shared memory
// by cp.async: the tiled backward of csrc/tiled_bwd.cuh, which the flash
// backward (spans up to 64, csrc/axial_flash_bwd.cu) shares. Its tiles
// (Flash2Tiles): the row pass 8 warps, 8 query rows per block at gp <= 4
// (4 at gp 8, 2 at gp 16) over 128 stripes, keys staged 16 at a time at
// gp <= 4; the column pass 4 warps of 8 keys a thread at gp <= 4 (4, 2 at
// gp 8, 16), 16 queries per stage (8 at gp 8, 16). The table partials are
// (g * ceil(S/128), 2gp, L, L) floats (134 MB at batch 4 for the (256, 4)
// site).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, kernel row 6): 10.48-
// 10.51 ms per medt_512 batch-4 train step, 4.3 times its 2.418 ms bound
// (float32 operations): row pass 6.39 ms, column pass 3.65, reductions
// 0.23. What bounds it now is instruction issue in the two pair loops, at
// about half the SM's rate, from 8 resident warps per SM (up to 255
// registers a thread): the row pass pays, beside its FMAs, the
// reduce-scatter's shuffles, selects and adds for every JS keys.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns the first CUDA error of its launches
// (three: row pass, column pass, medt::bwd_finalize).

#include "tiled_bwd.cuh"

extern "C" {

// m, l, sv, sve are the forward's saved outputs; scratch holds 2 * g * L * S
// floats (delta, then the row normaliser mm). Partials: tab_part (g *
// ceil(S/128), 2gp, L, L) (unused without positions), aff_part (ceil(L/QB)
// * ceil(S/128), g, 4), QB by gp as Flash2Tiles gives it (8, 8, 4, 2).
int medt_flash2_lanes_bwd(const float* qkv, const float* qemb,
                          const float* kemb_t, const float* vemb,
                          const float* aff, const float* m, const float* l,
                          const float* sv, const float* sve, const float* dsv,
                          const float* dsve, float* dqkv, float* dtables,
                          float* daff, float* scratch, float* tab_part,
                          float* aff_part, int g, int gp, int L, int S,
                          int has_pos, int n_tab_part, int n_aff_part,
                          void* stream) {
  return flash2::tiled_bwd<flash2::Flash2Tiles>(
      qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve, dqkv, dtables,
      daff, scratch, tab_part, aff_part, g, gp, L, S, has_pos, n_tab_part,
      n_aff_part, stream);
}

// The same on bf16 qkv (the JAX package's bf16 kernel I/O): qkv values
// are converted where they are read and each dqkv value is rounded once to
// bf16 where it is stored, so the table and daff gradients are the float32
// entry point's on the upcast qkv and dqkv is its dqkv rounded once.
int medt_flash2_lanes_bwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                               const float* kemb_t, const float* vemb,
                               const float* aff, const float* m, const float* l,
                               const float* sv, const float* sve,
                               const float* dsv, const float* dsve,
                               __nv_bfloat16* dqkv, float* dtables, float* daff,
                               float* scratch, float* tab_part, float* aff_part,
                               int g, int gp, int L, int S, int has_pos,
                               int n_tab_part, int n_aff_part, void* stream) {
  return flash2::tiled_bwd<flash2::Flash2Tiles>(
      qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv, dsve, dqkv, dtables,
      daff, scratch, tab_part, aff_part, g, gp, L, S, has_pos, n_tab_part,
      n_aff_part, stream);
}

}  // extern "C"
