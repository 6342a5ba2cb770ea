// Forward of the stripe-major train-mode attention core, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel medt_tpu/ops/pallas_axial_train.py::
// fused_attn_core forward (pl.pallas_call at :265, body _fwd_kernel). It
// runs the global-branch sites of a train step at batch 1 and 2 (spans 32
// and 64 with fewer than 128 stripes), where the lanes family has too few
// stripes to fill its blocks. Per stripe s, group gi and query row i:
//   logit[j] = (qk*a0 + a1) [+ (qr*a2 + a3) + (kr*a4 + a5)]
//     qk = sum_c q[c,i] k[c,j]
//     qr = sum_c q[c,i] qemb[c,i,j],  kr = sum_c k[c,j] kemb[c,j,i]
//   p = softmax_j(logit)
//   sv[s,gi,p,i] = sum_j p_j v[p,j],  sve[s,gi,p,i] = sum_j p_j vemb[p,i,j]
// with a = sim_affine[gi, 0..5] (the similarity BN folded from the batch
// moments). q, k (S, g, c, L) and v (S, g, gp, L) are stripe-major views
// (free stripe and group strides, rows of L contiguous floats), so the
// wrapper passes three views of one stripe-major qkv; the outputs sv and
// sve are dense (S, g, gp, L); the tables (c, L, L), (c, L, L), (gp, L, L)
// are shared by every group. Everything is float32. Without positions
// (has_pos == 0) the tables are not read and sve is not written.
//
// What bounds it on the H100: at the batch-1 shapes (S = 32 or 64 stripes)
// one launch moves about 2 MB and does under 0.1 GFLOP (at span 64, gp 4:
// ~0.7 us of device memory at 3.35 TB/s), so latency, shared-memory reads
// and the L2 traffic of restaging the tables bound it. The logits ->
// softmax -> sv/sve body, its tiles and its staging are the eval kernel's
// (csrc/stripe_attn_fwd.cuh, shared with csrc/axial_eval_fwd.cu), and so
// is its arithmetic: log2 units, exp2, the per-group shifts a1, a3, a5
// dropped (exact for a softmax; the backward recomputes the softmax its own
// way from the saved inputs). This source holds only its epilogue, which
// stages no affine past the similarity one and writes sv and sve
// themselves for the planes each lane holds after the reduce-scatter. The
// kernel launches on the caller's stream, allocates nothing and does not
// synchronise; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "stripe_attn_fwd.cuh"

namespace {

struct TrainEpilogue {
  struct Params {
    float* sv;   // (S, g, gp, L)
    float* sve;  // (S, g, gp, L), with positions
  };
  static constexpr int kAffinePerPlane = 0;
  // a small grid takes blocks of fewer warps (kMinBlocks)
  static constexpr bool kFillGrid = true;
  __device__ __forceinline__ static const float* affine(const Params&, int,
                                                        int, int) {
    return nullptr;  // nothing is staged past the similarity affine
  }
  template <int GP, bool HAS_POS, int NP>
  __device__ __forceinline__ static void store(
      const Params& e, const float*, size_t off, int L, int p0,
      const float (&acc_v)[GP], const float (&acc_e)[GP], float inv_l) {
#pragma unroll
    for (int t = 0; t < NP; ++t) {
      const size_t o = off + (size_t)(p0 + t) * L;
      e.sv[o] = acc_v[t] * inv_l;
      if constexpr (HAS_POS) e.sve[o] = acc_e[t] * inv_l;
    }
  }
};

}  // namespace

extern "C" {

// q, k (S, g, c, L), v (S, g, gp, L): stripe stride *_ss and group stride
// *_sg in floats, rows of L contiguous floats; sv and sve (S, g, gp, L)
// dense. Tables are not read, and sve is not written, when has_pos == 0.
int medt_stripe_attn_fwd(const float* q, const float* k, const float* v,
                         const float* qemb, const float* kemb,
                         const float* vemb, const float* sim_aff, float* sv,
                         float* sve, long long q_ss, long long q_sg,
                         long long k_ss, long long k_sg, long long v_ss,
                         long long v_sg, int S, int g, int gp, int L,
                         int has_pos, void* stream_ptr) {
  const medt::StripeArgs x{q, k, v, qemb, kemb, vemb, sim_aff,
                           q_ss, q_sg, k_ss, k_sg, v_ss, v_sg,
                           S, g, L, 0, false, false};
  return medt::launch_stripe_fwd<TrainEpilogue>(x, gp, has_pos, {sv, sve},
                                                stream_ptr);
}

}  // extern "C"
