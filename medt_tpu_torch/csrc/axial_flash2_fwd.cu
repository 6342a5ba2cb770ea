// Forward axial attention at long spans (64 < L <= 256), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash2_lanes_core of
// medt_tpu/ops/pallas_axial_lanes.py (forward pallas_call; body
// _flash2_fwd_kernel): the query- and key-streamed lanes attention of the
// 512 px models' global branch. Per group gi, query row i and stripe s:
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//     qk = sum_c q[c,i,s] k[c,j,s]
//     qr = sum_c q[c,i,s] qemb[c,i,j],  kr = sum_c k[c,j,s] kemb_t[c,i,j]
//   sim = softmax_j(logit)
//   sv[p,i,s] = sum_j sim[j] v[p,j,s],  sve[p,i,s] = sum_j sim[j] vemb[p,i,j]
// on the fused qkv tensor (g, 2gp, L, S): rows [0:c] = q, [c:gp] = k,
// [gp:2gp] = v, c = gp/2; outputs sv, sve (g, gp, L, S) and the row max m
// and softmax denominator l (g, L, S) that the backward rebuilds p from.
// Everything is float32.
//
// The first CUDA design (one thread per (gi, i, s), k and v read from
// device memory for every (i, j) pair) took 14.64 ms per medt_512 batch-4
// forward, 13.3 times its bound: each of the L query blocks of a stripe
// tile re-read the whole k/v slab through L2 (about 42 GB of L2 reads per
// forward), and every pair paid 2c + gp separate shared-memory loads of
// the tables. It was bound by L2 traffic and load instructions.
//
// This design tiles the block and stages its operands: the tiled forward
// of csrc/tiled_fwd.cuh, which the flash forward (spans up to 64,
// csrc/axial_flash_fwd.cu) shares. Its tiles (Flash2FwdTiles): a block owns
// one group, QT = 32, 16, 8, 4 query rows (gp 2, 4, 8, 16) and 32 stripes
// (lane = stripe), 4 warps of QI = QT / 4 query rows a thread, and stages
// each 16-key block's k/v rows and table tile by cp.async into a 2-slot
// ring; the logits in log2 units with one exp2 per pair and a lazy rescale.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md, kernel row 5): 3.27-3.30
// ms per medt_512 batch-4 forward, 2.96-2.99 times its 1.105 ms bound
// (float32 operations); 0.95 ms, 3.0 times, per (256, 4, 1024) launch.
// What bounds it now is instruction issue, at about half the SM's rate:
// FMAs, one MUFU.EX2 and the shared-memory reads of each pair, from 8
// resident warps per SM (240-250 registers a thread with positions), which
// do not hide the latency of the loads, the exp2 and the FMA chains; the
// per-row rescale test also splits the unrolled row loop into blocks.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry point returns the first CUDA error of its launch.

#include "tiled_fwd.cuh"

extern "C" {

// Spans 1..256 (the model routes 65..256 here). sve is not written when
// has_pos == 0; m and l are (g, L, S) each.
int medt_flash2_lanes_fwd(const float* qkv, const float* qemb,
                          const float* kemb_t, const float* vemb,
                          const float* aff, float* sv, float* sve, float* m,
                          float* l, int g, int gp, int L, int S, int has_pos,
                          void* stream) {
  return flash2::tiled_fwd<flash2::Flash2FwdTiles>(
      qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S, has_pos,
      stream);
}

// The same on bf16 qkv (the JAX package's bf16 kernel I/O): each qkv value
// is converted where it is read, so sv, sve, m and l (float32) are the
// float32 entry point's on the upcast qkv, bit for bit.
int medt_flash2_lanes_fwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                               const float* kemb_t, const float* vemb,
                               const float* aff, float* sv, float* sve,
                               float* m, float* l, int g, int gp, int L,
                               int S, int has_pos, void* stream) {
  return flash2::tiled_fwd<flash2::Flash2FwdTiles>(
      qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S, has_pos,
      stream);
}

}  // extern "C"
