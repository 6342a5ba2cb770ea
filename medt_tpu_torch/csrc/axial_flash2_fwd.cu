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
// This design tiles the block and stages its operands:
//   * a block owns one group, a tile of QT query rows and a tile of 32
//     stripes, and walks the keys in blocks of kKB. Its 4 warps share the
//     stripes (lane = stripe, so k/v reads are one 128-byte row per warp);
//     each thread holds QI query rows of its stripe in registers with their
//     online-softmax state and gp + gp accumulators;
//   * each key block's k and v rows for the block's stripes and the table
//     tile (qemb, kemb_t, vemb at the block's query rows x the key block)
//     are staged in shared memory by cp.async into a ring of kStages slots
//     (csrc/flash2_tiles.cuh), so the next block loads while this one is
//     computed. A staged k/v value serves QI queries, a staged table value
//     the warp's 32 stripes (a broadcast read, 16 bytes over JS = 4 keys);
//     L2 reads of k/v drop from L to L / QT times the slab;
//   * the logits are kept in log2 units with a0, a2, a4 and log2(e) folded
//     into per-thread copies of q and k; the biases a1, a3, a5 cancel in the
//     softmax and come back only in m. The running max is rescaled lazily:
//     only when a block of JS keys tops the reference by more than 2^8, so
//     the inner loop is FMAs plus one exp2 per pair; the true max is kept
//     beside it for m, and l is rescaled to it once at the end;
//   * no tensor cores: the logit contraction has depth c = 1..2 on the
//     path, and the deep sums (P.V over L keys with N = gp <= 4) would lose
//     the float32 accuracy the tolerances ask for in TF32. Float32 CUDA
//     cores throughout.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "flash2_tiles.cuh"

namespace {

using flash2::kLn2;
using flash2::ex2;
using flash2::kLog2e;
using flash2::kStages;
using flash2::lds;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStripes = 32;    // stripes per block: one per lane
constexpr int kKB = 16;         // keys per staged block
constexpr int kMaxSpan = 256;
constexpr float kRescale = 8.f; // lazy rescale threshold, log2 units

template <int GP>
struct Cfg {
  static constexpr int C = GP / 2;
  static constexpr int R = 2 * GP;  // table rows: qemb c, kemb_t c, vemb gp
  // query rows per thread and keys per softmax step, sized to registers
  static constexpr int QI = GP == 2 ? 8 : GP == 4 ? 4 : GP == 8 ? 2 : 1;
  static constexpr int JS = GP <= 4 ? 4 : GP == 8 ? 2 : 1;
  static constexpr int QT = kWarps * QI;  // query rows per block
  static constexpr int KV = (C + GP) * kKB * kStripes;
  static constexpr int TAB = R * QT * kKB;
  static_assert(kKB % JS == 0, "whole steps per key block");
};

template <int GP, bool POS>
__host__ __device__ constexpr int stage_floats() {
  return Cfg<GP>::KV + (POS ? Cfg<GP>::TAB : 0);
}

struct FwdArgs {
  const float* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  const float* aff;
  float* sv;
  float* sve;
  float* m;
  float* l;
  int L, S;
  bool vec_s;  // 16-byte copies along the stripe axis
  bool vec_l;  // 16-byte copies along the key axis of the tables
};

// One key block (keys j0 .. j0 + kKB, of which nvalid exist) for the
// thread's QI query rows. CHECK masks keys past the span.
template <int GP, bool POS, bool CHECK>
__device__ __forceinline__ void fwd_block(
    const float* kv, const float* tab, int ql0, int lane, int nvalid,
    float a4s, const float (&q0)[Cfg<GP>::QI][Cfg<GP>::C],
    const float (&q2)[Cfg<GP>::QI][Cfg<GP>::C], float (&mref)[Cfg<GP>::QI],
    float (&mtop)[Cfg<GP>::QI], float (&lsum)[Cfg<GP>::QI],
    float (&accv)[Cfg<GP>::QI][GP], float (&acce)[Cfg<GP>::QI][GP]) {
  using K = Cfg<GP>;
  constexpr int C = K::C, QI = K::QI, JS = K::JS, QT = K::QT;
#pragma unroll 1
  for (int jb = 0; jb < kKB; jb += JS) {
    if (CHECK && jb >= nvalid) break;
    float kk[JS][C], k4[JS][C], vv[JS][GP];
#pragma unroll
    for (int jj = 0; jj < JS; ++jj) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        kk[jj][c] = kv[(c * kKB + jb + jj) * kStripes + lane];
        k4[jj][c] = a4s * kk[jj][c];
      }
#pragma unroll
      for (int p = 0; p < GP; ++p)
        vv[jj][p] = kv[((C + p) * kKB + jb + jj) * kStripes + lane];
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
          lds<JS>(qe, tab + (c * QT + ql) * kKB + jb);
          lds<JS>(ke, tab + ((C + c) * QT + ql) * kKB + jb);
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
          lds<JS>(ve, tab + ((2 * C + p) * QT + ql) * kKB + jb);
#pragma unroll
          for (int jj = 0; jj < JS; ++jj)
            acce[qi][p] = fmaf(e[jj], ve[jj], acce[qi][p]);
        }
      }
    }
  }
}

template <int GP, bool POS>
__global__ void __launch_bounds__(kThreads)
flash2_tiled_fwd_kernel(FwdArgs a) {
  using K = Cfg<GP>;
  constexpr int C = K::C, QI = K::QI, QT = K::QT;
  constexpr int STAGE = stage_floats<GP, POS>();
  extern __shared__ __align__(16) float smem[];

  const int L = a.L, S = a.S;
  const int i0 = blockIdx.x * QT, s0 = blockIdx.y * kStripes;
  const int gi = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = s0 + lane;
  const int ql0 = warp * QI;  // the thread's first query row in the tile
  const size_t LS = (size_t)L * S, LL = (size_t)L * L;
  const float* qkv = a.qkv + (size_t)gi * 2 * GP * LS;
  const int nkb = (L + kKB - 1) / kKB;

  auto load = [&](int kb) {
    float* st = smem + (kb % kStages) * STAGE;
    const int j0 = kb * kKB;
    flash2::stage<C + GP, kKB, kStripes, kThreads>(
        st, qkv + C * LS + (size_t)j0 * S + s0, LS, S, L - j0, S - s0,
        a.vec_s, threadIdx.x);
    if constexpr (POS) {
      const size_t off = (size_t)i0 * L + j0;
      float* t = st + K::KV;
      flash2::stage<C, QT, kKB, kThreads>(t, a.qemb + off, LL, L, L - i0,
                                          L - j0, a.vec_l, threadIdx.x);
      flash2::stage<C, QT, kKB, kThreads>(t + C * QT * kKB, a.kemb_t + off,
                                          LL, L, L - i0, L - j0, a.vec_l,
                                          threadIdx.x);
      flash2::stage<GP, QT, kKB, kThreads>(t + 2 * C * QT * kKB,
                                           a.vemb + off, LL, L, L - i0,
                                           L - j0, a.vec_l, threadIdx.x);
    }
  };
#pragma unroll
  for (int kb = 0; kb < kStages - 1; ++kb) {
    if (kb < nkb) load(kb);
    flash2::cp_async_commit();
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
      const float q = ok ? qkv[c * LS + (size_t)i * S + s] : 0.f;
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
    flash2::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kb + kStages - 1 < nkb) load(kb + kStages - 1);
    flash2::cp_async_commit();
    const float* kv = smem + (kb % kStages) * STAGE;
    const float* tab = kv + K::KV;
    const int nvalid = L - kb * kKB;
    if (nvalid >= kKB) {
      fwd_block<GP, POS, false>(kv, tab, ql0, lane, nvalid, a4s, q0, q2,
                                mref, mtop, lsum, accv, acce);
    } else {
      fwd_block<GP, POS, true>(kv, tab, ql0, lane, nvalid, a4s, q0, q2,
                               mref, mtop, lsum, accv, acce);
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

template <int GP, bool POS>
cudaError_t launch_variant(const FwdArgs& a, int g, cudaStream_t stream) {
  const size_t smem = (size_t)kStages * stage_floats<GP, POS>() *
                      sizeof(float);
  auto kernel = flash2_tiled_fwd_kernel<GP, POS>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.L + Cfg<GP>::QT - 1) / Cfg<GP>::QT,
                  (a.S + kStripes - 1) / kStripes, g);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int GP>
cudaError_t launch_gp(const FwdArgs& a, int g, bool has_pos,
                      cudaStream_t stream) {
  return has_pos ? launch_variant<GP, true>(a, g, stream)
                 : launch_variant<GP, false>(a, g, stream);
}

}  // namespace

extern "C" {

// Spans 1..256 (the model routes 65..256 here). sve is not written when
// has_pos == 0; m and l are (g, L, S) each.
int medt_flash2_lanes_fwd(const float* qkv, const float* qemb,
                          const float* kemb_t, const float* vemb,
                          const float* aff, float* sv, float* sve, float* m,
                          float* l, int g, int gp, int L, int S, int has_pos,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (g < 1 || S < 1 || L < 1 || L > kMaxSpan || g > 65535 ||
      (S + kStripes - 1) / kStripes > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const bool pos = has_pos != 0;
  const FwdArgs a{qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, L, S,
                  S % 4 == 0 && flash2::aligned16(qkv),
                  pos && L % 4 == 0 && flash2::aligned16(qemb) &&
                      flash2::aligned16(kemb_t) && flash2::aligned16(vemb)};
  cudaError_t err;
  switch (gp) {
    case 2: err = launch_gp<2>(a, g, pos, stream); break;
    case 4: err = launch_gp<4>(a, g, pos, stream); break;
    case 8: err = launch_gp<8>(a, g, pos, stream); break;
    case 16: err = launch_gp<16>(a, g, pos, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
