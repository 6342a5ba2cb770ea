// Fused eval-mode axial attention over stripe-major operands, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel medt_tpu/ops/pallas_axial.py::
// axial_attention_fused (body _attn_kernel). It runs where the lanes family
// has too few stripes to fill a block: batch-1 evaluation (test and predict
// CLIs, the trainer's validation), spans up to 64 under 128 stripes. Per
// stripe s, group gi and query row i, with sv and sve from the logits ->
// softmax -> (sv, sve) body of csrc/stripe_attn_fwd.cuh:
//   out[s,gi,p,i] = (sv*oa0[p] + oa1[p]) + (sve*oa2[p] + oa3[p])
// with oa = out_affine[gi, 0..3, :] (the folded output BN, f_sv in oa0).
// q, k and v are three views of one fused (S, g, 2gp, L) qkv (their stripe
// and group strides are free; rows of L contiguous floats), so the wrapper
// does not split it; the tables (c, L, L), (c, L, L), (gp, L, L) are dense
// and shared by every group; out is a dense (S, g, gp, L). Everything is
// float32. Without positions the tables are not read and sve is zero.
//
// What bounds it on the H100, and what the shared body does about it, is
// in csrc/stripe_attn_fwd.cuh: latency, shared-memory reads and the L2
// traffic of restaging the tables, at about 1-2 MB and under 0.1 GFLOP a
// launch. This source holds only its epilogue, which stages the (g, 4, gp)
// output affine beside the similarity affine of each (stripe, group) pair
// and writes each plane that a lane holds after the body's reduce-scatter;
// the summation order is the body's own (eval has no step parity to keep).
// At every even gp up to 128 outside 2, 4, 8 and 16 (the axial-attention
// classifiers' sites at gp 12 to 128) the entry point takes
// csrc/wide_attn.cuh's body instead (a block stages its stripes' k and v
// rows, transposed from this layout, and its rows' tables in rounds of
// channels or planes; a thread takes R query rows of one stripe), under
// the same epilogue arithmetic (EvalWide below): the shared
// body's per-pair accumulators and staged tables are sized for gp <= 16.
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "stripe_attn_fwd.cuh"
#include "wide_attn.cuh"

namespace {

struct EvalEpilogue {
  struct Params {
    const float* out_aff;  // (g, 4, gp)
    float* out;            // (S, g, gp, L)
  };
  // a pair stages its group's [4][gp] output affine
  static constexpr int kAffinePerPlane = 4;
  // its blocks keep their widest warps whatever the grid
  static constexpr bool kFillGrid = false;
  __device__ __forceinline__ static const float* affine(const Params& e,
                                                        int gi, int GP,
                                                        int t) {
    return e.out_aff + gi * 4 * GP + t;
  }
  template <int GP, bool HAS_POS, int NP>
  __device__ __forceinline__ static void store(
      const Params& e, const float* oa, size_t off, int L, int p0,
      const float (&acc_v)[GP], const float (&acc_e)[GP], float inv_l) {
    float* o = e.out + off;
#pragma unroll
    for (int t = 0; t < NP; ++t) {
      const int p = p0 + t;
      const float sv = acc_v[t] * inv_l;
      const float sve = HAS_POS ? acc_e[t] * inv_l : 0.f;
      o[p * L] = (sv * oa[p] + oa[GP + p]) +
                 (sve * oa[2 * GP + p] + oa[3 * GP + p]);
    }
  }
};

// The same epilogue over csrc/wide_attn.cuh's body (the wide widths).
struct EvalWide {
  struct Params {
    const float* out_aff;  // (g, 4, gp)
    float* out;            // (S, g, gp, L)
    int g, gp, L;
  };
  template <bool POS>
  __device__ __forceinline__ static void store(
      const Params& e, int gi, int i, int s, int p0, int n,
      const float (&sv)[wide::kFwdChunk],
      const float (&sve)[wide::kFwdChunk]) {
    const int GP = e.gp;
    const float* oa = e.out_aff + gi * 4 * GP;
    float* o = e.out + ((size_t)s * e.g + gi) * GP * e.L + i;
#pragma unroll
    for (int u = 0; u < wide::kFwdChunk; ++u) {
      if (u < n) {
        const int p = p0 + u;
        const float x = POS ? sve[u] : 0.f;
        o[(size_t)p * e.L] = (sv[u] * oa[p] + oa[GP + p]) +
                             (x * oa[2 * GP + p] + oa[3 * GP + p]);
      }
    }
  }
  __device__ __forceinline__ static void stats(const Params&, int, int, int,
                                               float, float) {}
};

}  // namespace

extern "C" {

// q, k (S, g, c, L), v (S, g, gp, L): stripe stride *_ss and group stride
// *_sg in floats, rows of L contiguous floats. Tables are not read when
// has_pos == 0 (the position-free mode); out (S, g, gp, L) dense.
int medt_axial_eval_fwd(const float* q, const float* k, const float* v,
                        const float* qemb, const float* kemb,
                        const float* vemb, const float* sim_aff,
                        const float* out_aff, float* out, long long q_ss,
                        long long q_sg, long long k_ss, long long k_sg,
                        long long v_ss, long long v_sg, int S, int g, int gp,
                        int L, int has_pos, void* stream_ptr) {
  if (wide::is_wide(gp)) {
    const wide::Stripes x{q, k, v, qemb, kemb, vemb, q_ss, q_sg, k_ss,
                          k_sg, v_ss, v_sg, gp, L, S};
    return wide::launch_fwd<wide::Stripes, EvalWide>(
        x, {out_aff, out, g, gp, L}, sim_aff, g, has_pos != 0, true, false,
        static_cast<cudaStream_t>(stream_ptr));
  }
  const medt::StripeArgs x{q, k, v, qemb, kemb, vemb, sim_aff,
                           q_ss, q_sg, k_ss, k_sg, v_ss, v_sg,
                           S, g, L, 0, false, false};
  return medt::launch_stripe_fwd<EvalEpilogue>(x, gp, has_pos,
                                               {out_aff, out}, stream_ptr);
}

}  // extern "C"
