// Fused eval-mode axial attention over stripe-major operands, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel medt_tpu/ops/pallas_axial.py::
// axial_attention_fused (body _attn_kernel). It runs where the lanes family
// has too few stripes to fill a block: batch-1 evaluation (test and predict
// CLIs). Per stripe s, group gi and query row i it takes sv and sve from
// the chain in csrc/stripe_softmax.cuh (logits with the folded similarity
// BN, softmax over the keys j) and writes
//   out[s,gi,p,i] = (sv*oa0[p] + oa1[p]) + (sve*oa2[p] + oa3[p])
// with oa = out_affine[gi, 0..3, :] (the folded output BN, f_sv in oa0):
// the output affine is applied before the one write of each output. q, k
// and v are three views of one fused (S, g, 2gp, L) qkv (their stripe and
// group strides are free; rows of L contiguous floats), so the wrapper does
// not split it; out is a dense (S, g, gp, L). Everything is float32.
//
// What bounds it on the H100: at the batch-1 shapes (S <= 64 stripes) one
// launch moves well under 1 MB, so it is bound by launch latency, not by
// bytes or float32 operations; the block shape and the staging are the
// header's. The kernel launches on the caller's stream, allocates nothing
// and does not synchronise; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

#include "stripe_softmax.cuh"

namespace {

struct EvalFwdEpilogue {
  struct Params {
    const float* out_aff;  // (g, 4, gp)
    float* out;            // (S, g, gp, L)
  };
  template <int GP, bool HAS_POS>
  __device__ __forceinline__ static void store(
      const Params& e, size_t off, int gi, int L, const float (&acc_v)[GP],
      const float (&acc_e)[GP], float inv_l) {
    const float* oa = e.out_aff + (size_t)gi * 4 * GP;
    float* o = e.out + off;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      const float sv = acc_v[p] * inv_l, sve = acc_e[p] * inv_l;
      o[p * L] = (sv * oa[p] + oa[GP + p]) + (sve * oa[2 * GP + p] +
                                             oa[3 * GP + p]);
    }
  }
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
  const medt::StripeOperands x{q, k, v, qemb, kemb, vemb, sim_aff,
                               q_ss, q_sg, k_ss, k_sg, v_ss, v_sg,
                               S, g, L, 0, 0};
  return medt::launch_stripe_softmax<EvalFwdEpilogue>(
      x, gp, has_pos, {out_aff, out}, stream_ptr);
}

}  // extern "C"
