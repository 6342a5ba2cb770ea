// The tiled forward of the flash contract, shared by the flash (spans up
// to 64, csrc/axial_flash_fwd.cu) and flash2 (spans up to 256,
// csrc/axial_flash2_fwd.cu) entry points, each with its own tile policy.
//
// Per group gi, query row i and stripe s (c = gp/2):
//   logit[j] = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5]
//     qk = sum_c q[c,i,s] k[c,j,s]
//     qr = sum_c q[c,i,s] qemb[c,i,j],  kr = sum_c k[c,j,s] kemb_t[c,i,j]
//   sim = softmax_j(logit)
//   sv[p,i,s] = sum_j sim[j] v[p,j,s],  sve[p,i,s] = sum_j sim[j] vemb[p,i,j]
// on the fused qkv tensor (g, 2gp, L, S): rows [0:c] = q, [c:gp] = k,
// [gp:2gp] = v; outputs sv, sve (g, gp, L, S) and the row max m and softmax
// denominator l (g, L, S) from which the backward (csrc/tiled_bwd.cuh)
// rebuilds p. qkv is float32 or bf16 (the element type T of the
// template): its values are staged raw and converted where they are read,
// so a bf16 qkv gives exactly the float32 kernel's outputs on its upcast;
// everything else is float32.
//
// The design (flash2's, made a template over its tile policy):
//   * a block owns one group, a tile of QT query rows and a tile of 32
//     stripes, and walks the keys in staged blocks of KB. Its warps share
//     the stripes (lane = stripe, so k/v reads are one 128-byte row per
//     warp); each thread holds QI query rows of its stripe in registers
//     with their online-softmax state and gp + gp accumulators;
//   * each key block's k and v rows for the block's stripes and the table
//     tile (qemb, kemb_t, vemb at the block's query rows x the key block)
//     are staged in shared memory by cp.async (csrc/flash2_tiles.cuh): into
//     a ring of kStages = 2 slots, so the next block loads while this one is
//     computed, or, with kStages = 1, into one slot that is loaded, waited
//     for and computed in turn (a policy whose KB covers the whole span
//     stages it once). A staged k/v value serves QI queries, a staged table
//     value the warp's 32 stripes (a broadcast read, 16 bytes over JS = 4
//     keys); L2 reads of k/v are L / QT times the slab;
//   * the logits are kept in log2 units with a0, a2, a4 and log2(e) folded
//     into per-thread copies of q and k; the biases a1, a3, a5 cancel in the
//     softmax and come back only in m. The running max is rescaled lazily:
//     only when a step of JS keys tops the reference by more than 2^8, so
//     the inner loop is FMAs plus one exp2 per pair; the true max is kept
//     beside it for m, and l is rescaled to it once at the end;
//   * no tensor cores: the logit contraction has depth c = 1..2 on the
//     paths, and the deep sums (P.V over L keys with N = gp <= 4) would
//     lose the float32 accuracy the tolerances ask for in TF32.
//
// A tile policy TL gives: kMaxSpan; kWarps (warps per block); kStages (1 or
// 2); keys(gp) (KB, keys per staged block, a multiple of steps(gp));
// rows(gp) (QI, query rows per thread); steps(gp) (JS, keys per softmax
// step). The policies are at the end of this file.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash2_tiles.cuh"

namespace flash2 {
namespace {

constexpr int kFwdStripes = 32;   // stripes per block: one per lane
constexpr float kRescale = 8.f;   // lazy rescale threshold, log2 units

template <class TL, int GP>
struct FwdCfg {
  static constexpr int C = GP / 2;
  static constexpr int R = 2 * GP;  // table rows: qemb c, kemb_t c, vemb gp
  static constexpr int kWarps = TL::kWarps;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kStages = TL::kStages;
  static constexpr int QI = TL::rows(GP);   // query rows per thread
  static constexpr int JS = TL::steps(GP);  // keys per softmax step
  static constexpr int KB = TL::keys(GP);   // keys per staged block
  static constexpr int QT = kWarps * QI;    // query rows per block
  static constexpr int KV = (C + GP) * KB * kFwdStripes;
  static constexpr int TAB = R * QT * KB;
  static_assert(KB % JS == 0 && KB % 4 == 0, "whole steps per key block");
  static_assert(kStages == 1 || kStages == 2, "one slot or a 2-slot ring");
};

// One slot of the ring, in bytes: the k/v rows (KV elements of T), then
// with positions the table tile (TAB floats).
template <class TL, int GP, bool POS, class T>
__host__ __device__ constexpr int fwd_stage_bytes() {
  return FwdCfg<TL, GP>::KV * (int)sizeof(T) +
         (POS ? FwdCfg<TL, GP>::TAB * (int)sizeof(float) : 0);
}

template <class T>
struct FwdArgs {
  const T* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  const float* aff;
  float* sv;
  float* sve;
  float* m;
  float* l;
  int L, S;
  bool vec_s;  // 16-byte copies along the stripe axis (of qkv)
  bool vec_l;  // 16-byte copies along the key axis of the tables
};

// One staged key block (keys j0 .. j0 + KB, of which nvalid exist) for the
// thread's QI query rows. CHECK masks keys past the span.
template <class TL, int GP, bool POS, bool CHECK, class T>
__device__ __forceinline__ void fwd_block(
    const T* kv, const float* tab, int ql0, int lane, int nvalid,
    float a4s, const float (&q0)[FwdCfg<TL, GP>::QI][FwdCfg<TL, GP>::C],
    const float (&q2)[FwdCfg<TL, GP>::QI][FwdCfg<TL, GP>::C],
    float (&mref)[FwdCfg<TL, GP>::QI], float (&mtop)[FwdCfg<TL, GP>::QI],
    float (&lsum)[FwdCfg<TL, GP>::QI],
    float (&accv)[FwdCfg<TL, GP>::QI][GP],
    float (&acce)[FwdCfg<TL, GP>::QI][GP]) {
  using K = FwdCfg<TL, GP>;
  constexpr int C = K::C, QI = K::QI, JS = K::JS, QT = K::QT, KB = K::KB;
#pragma unroll 1
  for (int jb = 0; jb < KB; jb += JS) {
    if (CHECK && jb >= nvalid) break;
    float kk[JS][C], k4[JS][C], vv[JS][GP];
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kk[jj][c] = to_f32(kv[(c * KB + jb + jj) * kFwdStripes + lane]);
        k4[jj][c] = a4s * kk[jj][c];
      }
#pragma unroll
      for (int p = 0; p < GP; ++p)
        vv[jj][p] =
            to_f32(kv[((C + p) * KB + jb + jj) * kFwdStripes + lane]);
    }
#pragma unroll
    for (int qi = 0; qi < QI; ++qi) {
      const int ql = ql0 + qi;
      float x[JS];
#pragma unroll
      for (int jj = 0; jj < JS; ++jj) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc = fmaf(q0[qi][c], kk[jj][c], acc);
        x[jj] = acc;
      }
      if constexpr (POS) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float qe[JS], ke[JS];
          lds<JS>(qe, tab + (c * QT + ql) * KB + jb);
          lds<JS>(ke, tab + ((C + c) * QT + ql) * KB + jb);
#pragma unroll
          for (int jj = 0; jj < JS; ++jj) {
            x[jj] = fmaf(q2[qi][c], qe[jj], x[jj]);
            x[jj] = fmaf(k4[jj][c], ke[jj], x[jj]);
          }
        }
      }
      float bmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < JS; ++jj) {
        if (CHECK && jb + jj >= nvalid) x[jj] = -INFINITY;
        bmax = fmaxf(bmax, x[jj]);
      }
      mtop[qi] = fmaxf(mtop[qi], bmax);
      if (bmax > mref[qi] + kRescale) {
        const float alpha = ex2(mref[qi] - mtop[qi]);
        mref[qi] = mtop[qi];
        lsum[qi] *= alpha;
#pragma unroll
        for (int p = 0; p < GP; ++p) {
          accv[qi][p] *= alpha;
          if constexpr (POS) acce[qi][p] *= alpha;
        }
      }
      float e[JS];
#pragma unroll
      for (int jj = 0; jj < JS; ++jj) {
        e[jj] = ex2(x[jj] - mref[qi]);
        lsum[qi] += e[jj];
      }
#pragma unroll
      for (int p = 0; p < GP; ++p) {
#pragma unroll
        for (int jj = 0; jj < JS; ++jj)
          accv[qi][p] = fmaf(e[jj], vv[jj][p], accv[qi][p]);
        if constexpr (POS) {
          float ve[JS];
          lds<JS>(ve, tab + ((2 * C + p) * QT + ql) * KB + jb);
#pragma unroll
          for (int jj = 0; jj < JS; ++jj)
            acce[qi][p] = fmaf(e[jj], ve[jj], acce[qi][p]);
        }
      }
    }
  }
}

template <class TL, int GP, bool POS, class T>
__global__ void __launch_bounds__(FwdCfg<TL, GP>::kThreads)
tiled_fwd_kernel(FwdArgs<T> a) {
  using K = FwdCfg<TL, GP>;
  constexpr int C = K::C, QI = K::QI, QT = K::QT, KB = K::KB;
  constexpr int NT = K::kThreads, NSTAGE = K::kStages;
  constexpr int STAGE = fwd_stage_bytes<TL, GP, POS, T>();
  extern __shared__ __align__(16) float smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);

  const int L = a.L, S = a.S;
  const int i0 = blockIdx.x * QT, s0 = blockIdx.y * kFwdStripes;
  const int gi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = s0 + lane;
  const int ql0 = warp * QI;  // the thread's first query row in the tile
  const size_t LS = (size_t)L * S, LL = (size_t)L * L;
  const T* qkv = a.qkv + (size_t)gi * 2 * GP * LS;
  const int nkb = (L + KB - 1) / KB;

  auto load = [&](int kb) {
    unsigned char* st = ring + (kb % NSTAGE) * STAGE;
    const int j0 = kb * KB;
    stage<C + GP, KB, kFwdStripes, NT>(
        reinterpret_cast<T*>(st), qkv + C * LS + (size_t)j0 * S + s0, LS, S,
        L - j0, S - s0, a.vec_s, threadIdx.x);
    if constexpr (POS) {
      const size_t off = (size_t)i0 * L + j0;
      float* t = reinterpret_cast<float*>(st + K::KV * sizeof(T));
      stage<C, QT, KB, NT>(t, a.qemb + off, LL, L, L - i0, L - j0, a.vec_l,
                           threadIdx.x);
      stage<C, QT, KB, NT>(t + C * QT * KB, a.kemb_t + off, LL, L, L - i0,
                           L - j0, a.vec_l, threadIdx.x);
      stage<GP, QT, KB, NT>(t + 2 * C * QT * KB, a.vemb + off, LL, L, L - i0,
                            L - j0, a.vec_l, threadIdx.x);
    }
  };
  // the ring's first NSTAGE - 1 blocks; one slot: the first block
#pragma unroll
  for (int kb = 0; kb < (NSTAGE > 1 ? NSTAGE - 1 : 1); ++kb) {
    if (kb < nkb) load(kb);
    cp_async_commit();
  }

  const float* af = a.aff + gi * 8;
  const float a0s = af[0] * kLog2e, a2s = af[2] * kLog2e,
              a4s = af[4] * kLog2e;
  const float bias = POS ? (af[1] + af[3]) + af[5] : af[1];
  float q0[QI][C], q2[QI][C], mref[QI], mtop[QI], lsum[QI];
  float accv[QI][GP], acce[QI][GP];
#pragma unroll
  for (int qi = 0; qi < QI; ++qi) {
    const int i = i0 + ql0 + qi;
    const bool ok = i < L && s < S;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float q = ok ? to_f32(qkv[c * LS + (size_t)i * S + s]) : 0.f;
      q0[qi][c] = a0s * q;
      q2[qi][c] = a2s * q;
    }
    mref[qi] = -INFINITY;
    mtop[qi] = -INFINITY;
    lsum[qi] = 0.f;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      accv[qi][p] = 0.f;
      acce[qi][p] = 0.f;
    }
  }

  for (int kb = 0; kb < nkb; ++kb) {
    if constexpr (NSTAGE > 1) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();
      if (kb + NSTAGE - 1 < nkb) load(kb + NSTAGE - 1);
      cp_async_commit();
    } else {
      cp_async_wait<0>();
      __syncthreads();
    }
    const unsigned char* st = ring + (kb % NSTAGE) * STAGE;
    const T* kv = reinterpret_cast<const T*>(st);
    const float* tab =
        reinterpret_cast<const float*>(st + K::KV * sizeof(T));
    const int nvalid = L - kb * KB;
    if (nvalid >= KB) {
      fwd_block<TL, GP, POS, false>(kv, tab, ql0, lane, nvalid, a4s, q0, q2,
                                    mref, mtop, lsum, accv, acce);
    } else {
      fwd_block<TL, GP, POS, true>(kv, tab, ql0, lane, nvalid, a4s, q0, q2,
                                   mref, mtop, lsum, accv, acce);
    }
    if constexpr (NSTAGE == 1) {
      if (kb + 1 < nkb) {
        __syncthreads();  // every warp is done with the slot
        load(kb + 1);
        cp_async_commit();
      }
    }
  }

  if (s >= S) return;
#pragma unroll
  for (int qi = 0; qi < QI; ++qi) {
    const int i = i0 + ql0 + qi;
    if (i >= L) break;
    const float inv_l = 1.f / lsum[qi];
    const size_t out0 = (size_t)gi * GP * LS + (size_t)i * S + s;
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      a.sv[out0 + p * LS] = accv[qi][p] * inv_l;
      if constexpr (POS) a.sve[out0 + p * LS] = acce[qi][p] * inv_l;
    }
    const size_t row = ((size_t)gi * L + i) * S + s;
    a.m[row] = mtop[qi] * kLn2 + bias;
    a.l[row] = lsum[qi] * ex2(mref[qi] - mtop[qi]);
  }
}

template <class TL, int GP, bool POS, class T>
cudaError_t fwd_variant(const FwdArgs<T>& a, int g, cudaStream_t stream) {
  using K = FwdCfg<TL, GP>;
  const size_t smem =
      (size_t)K::kStages * fwd_stage_bytes<TL, GP, POS, T>();
  auto kernel = tiled_fwd_kernel<TL, GP, POS, T>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + K::QT - 1) / K::QT,
                  (a.S + kFwdStripes - 1) / kFwdStripes, g);
  kernel<<<grid, K::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The tile policies, sized on an H100 80GB HBM3 at 700 W (PERF.md, kernel
// rows 3 and 5). Flash2's: 4 warps, a 2-slot ring of 16-key blocks, QI = 8,
// 4, 2, 1 query rows a thread at gp 2, 4, 8, 16 (QT = 32, 16, 8, 4 per
// block) and JS = 4, 4, 2, 1 keys per softmax step. The flash contract
// (spans up to 64) stages the whole span at once where it fits: 8 warps
// (twice the query rows per block, so half the blocks re-stage a stripe
// tile's k/v), one slot of 64 keys at gp <= 4, 32 at gp 8, 16 at gp 16
// (at most 112 KB with positions).
struct Flash2FwdTiles {
  static constexpr int kMaxSpan = 256;
  static constexpr int kWarps = 4;
  static constexpr int kStages = 2;
  static constexpr int keys(int) { return 16; }
  static constexpr int rows(int gp) {
    return gp == 2 ? 8 : gp == 4 ? 4 : gp == 8 ? 2 : 1;
  }
  static constexpr int steps(int gp) { return gp <= 4 ? 4 : gp == 8 ? 2 : 1; }
};

struct FlashFwdTiles {
  static constexpr int kMaxSpan = 64;
  static constexpr int kWarps = 8;
  static constexpr int kStages = 1;
  static constexpr int keys(int gp) { return gp <= 4 ? 64 : gp == 8 ? 32 : 16; }
  static constexpr int rows(int gp) { return Flash2FwdTiles::rows(gp); }
  static constexpr int steps(int gp) { return Flash2FwdTiles::steps(gp); }
};

// The whole forward of one call under policy TL, qkv of element type T
// (float or bf16). sve is not written when has_pos == 0; m and l are (g, L,
// S) each. Returns the first CUDA error of its launch.
template <class TL, class T>
int tiled_fwd(const T* qkv, const float* qemb, const float* kemb_t,
              const float* vemb, const float* aff, float* sv, float* sve,
              float* m, float* l, int g, int gp, int L, int S, int has_pos,
              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (g < 1 || S < 1 || L < 1 || L > TL::kMaxSpan || g > 65535 ||
      (S + kFwdStripes - 1) / kFwdStripes > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  const FwdArgs<T> a{qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, L, S,
                  S % kChunk<T> == 0 && aligned16(qkv),
                  pos && L % 4 == 0 && aligned16(qemb) && aligned16(kemb_t) &&
                      aligned16(vemb)};
  cudaError_t err;
  switch (gp) {
    case 2: err = pos ? fwd_variant<TL, 2, true, T>(a, g, stream)
                      : fwd_variant<TL, 2, false, T>(a, g, stream); break;
    case 4: err = pos ? fwd_variant<TL, 4, true, T>(a, g, stream)
                      : fwd_variant<TL, 4, false, T>(a, g, stream); break;
    case 8: err = pos ? fwd_variant<TL, 8, true, T>(a, g, stream)
                      : fwd_variant<TL, 8, false, T>(a, g, stream); break;
    case 16: err = pos ? fwd_variant<TL, 16, true, T>(a, g, stream)
                       : fwd_variant<TL, 16, false, T>(a, g, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // namespace
}  // namespace flash2
