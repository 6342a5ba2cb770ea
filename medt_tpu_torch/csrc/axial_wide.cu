// The lanes-contract attention forward at wide group planes (every even gp
// up to 128 outside 2, 4, 8 and 16), for Hopper (sm_90a); the backward is
// csrc/axial_wide_bwd.cu, its own source so that the two compile in
// parallel.
//
// Replaces, at those widths, the Pallas TPU kernels of
// medt_tpu/ops/pallas_axial_lanes.py that csrc/axial_lanes_fwd.cu
// (lanes_attn_core, spans <= 16) and csrc/axial_flash_fwd.cu
// (flash_lanes_core, spans 17..64) replace at gp 2, 4, 8 and 16: the
// forwards _fwd_kernel and _flash_fwd_kernel. The axial-attention
// classifiers run their sites at gp 12 to 128 (axial26s and axial50s at
// 32 and 64 in layers 3-4; axial50m 12, 24, 48, 96; axial50l 32, 64, 128
// beside 16); the segmentation models never pass gp 16. The contract is
// the lanes one (ops/axial_lanes.py): qkv (g, 2gp, L, S), tables qemb,
// kemb_t (c, L, L) and vemb (gp, L, L), affine (g, 8) -> sv, sve (g, gp, L,
// S), and the flash contract's row max m and denominator l (g, L, S). qkv
// is float32 or bf16 (the _bf16 entry point): bf16 is converted where it
// is read, so the outputs equal the float32 entry point's on the upcast
// qkv, bit for bit.
//
// Design: csrc/wide_attn.cuh's body (wide_fwd_kernel): a block stages the
// k and v rows of its group, stripes and keys and its rows' table entries
// in shared memory in rounds of channels or planes, and a thread takes R
// query rows of one stripe, so that each staged load feeds R rows (or
// four keys); with save_ml it also writes m and l. What bounds it on
// the H100: shared-memory loads, and at small grids latency
// (wide_attn.cuh).
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry points return the first CUDA error of their
// launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "wide_attn.cuh"

namespace {

using wide::kFwdChunk;
using wide::Lanes;

// sv, sve (g, gp, L, S) and, for the flash contract, m and l (g, L, S)
struct LanesEpilogue {
  struct Params {
    float* sv;
    float* sve;
    float* m;  // null: the lanes contract, no statistics
    float* l;
    int gp, L, S;
  };
  template <bool POS>
  __device__ __forceinline__ static void store(const Params& e, int gi, int i,
                                               int s, int p0, int n,
                                               const float (&sv)[kFwdChunk],
                                               const float (&sve)[kFwdChunk]) {
    const size_t LS = (size_t)e.L * e.S;
    const size_t o = ((size_t)gi * e.gp + p0) * LS + (size_t)i * e.S + s;
#pragma unroll
    for (int u = 0; u < kFwdChunk; ++u) {
      if (u < n) {
        e.sv[o + u * LS] = sv[u];
        if constexpr (POS) e.sve[o + u * LS] = sve[u];
      }
    }
  }
  __device__ __forceinline__ static void stats(const Params& e, int gi, int i,
                                               int s, float m, float l) {
    if (e.m == nullptr) return;
    const size_t o = ((size_t)gi * e.L + i) * e.S + s;
    e.m[o] = m;
    e.l[o] = l;
  }
};

bool bad_geometry(int g, int gp, int L, int S) {
  return g < 1 || g > 65535 || S < 1 || L < 1 || L > wide::kMaxSpan ||
         !wide::gp_ok(gp);
}

template <class T>
int wide_fwd(const T* qkv, const float* qemb, const float* kemb_t,
             const float* vemb, const float* aff, float* sv, float* sve,
             float* m, float* l, int g, int gp, int L, int S, int has_pos,
             int save_ml, void* stream) {
  if (bad_geometry(g, gp, L, S)) return (int)cudaErrorInvalidValue;
  const Lanes<T> x{qkv, qemb, kemb_t, vemb, gp, L, S};
  const LanesEpilogue::Params e{sv, sve, save_ml ? m : nullptr,
                                save_ml ? l : nullptr, gp, L, S};
  const bool vec = S % flash2::kChunk<T> == 0 && flash2::aligned16(qkv);
  return wide::launch_fwd<Lanes<T>, LanesEpilogue>(
      x, e, aff, g, has_pos != 0, false, vec,
      static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// The lanes (save_ml == 0) or flash (save_ml != 0: m, l (g, L, S) written)
// forward at any even gp up to 128 and spans up to 64. sve is not written
// without positions.
int medt_wide_attn_fwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, float* sv, float* sve, float* m,
                       float* l, int g, int gp, int L, int S, int has_pos,
                       int save_ml, void* stream) {
  return wide_fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S,
                  has_pos, save_ml, stream);
}

// The same on bf16 qkv: the float32 entry point's outputs on the upcast
// qkv, bit for bit.
int medt_wide_attn_fwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                            const float* kemb_t, const float* vemb,
                            const float* aff, float* sv, float* sve,
                            float* m, float* l, int g, int gp, int L, int S,
                            int has_pos, int save_ml, void* stream) {
  return wide_fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp, L, S,
                  has_pos, save_ml, stream);
}

}  // extern "C"
