// Backward of the lanes-attention core (spans <= 16), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of lanes_attn_core's backward, _bwd_rule
// (body _bwd_kernel) in medt_tpu/ops/pallas_axial_lanes.py. Same forward as
// csrc/axial_lanes_fwd.cu (per group gi, query i, key j, stripe s;
// c = gp/2):
//   logit = qk*a0 + a1 [+ qr*a2 + a3 + kr*a4 + a5],  p = softmax_j(logit)
//   sv[p,i] = sum_j p_ij v[p,j],  sve[p,i] = sum_j p_ij vemb[p,i,j]
// and the softmax is recomputed from the logits. Given dsv, dsve (g, gp, L,
// S), with
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   delta_i = sum_j p_ij dsim_ij,   dlog_ij = p_ij (dsim_ij - delta_i)
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
// The first CUDA design ran the TPU kernel's row/column split as two
// kernels, one thread per (group, query or key, stripe): every row-pass
// block re-read all L keys' k and v from L2 and ran the keys twice (an
// online softmax to rebuild m, l and delta, then the gradient loop); (m, l,
// delta) went to a (g, L, S) scratch in device memory for the column pass,
// which recomputed every logit; with positions each key cost 2gp
// warp_sums. With the two reductions that made 3-4 launches and 8
// allocations a call. On an H100 80GB HBM3 at 700 W: 1.25-1.28 ms per
// MedT-128 batch-16 train step (16 launches) of CUDA events over
// back-to-back wrapper calls, 0.61 ms of it device time, 8.5x the 0.072 ms
// bound; 110-120 us of host time a call.
//
// This design is the card's counterpart of the TPU kernel's whole-tile
// program: one pass, in which a block owns one group and a chunk of NS
// stripes, NS = 256 / LP with LP = 4, 8 or 16 the span rounded up, so that
// the block's 256 threads are one (query or key, stripe) pair each. It
// stages the chunk's whole q, k, v, dsv (and dsve) tile in shared memory
// by cp.async (rows padded against bank conflicts; ragged stripes and rows
// past the span zero-filled), then:
//   * phase A, thread (query i, stripe): the row's logits and dsim in
//     registers, its max, exp2 weights, l and delta, then p and dlog, which
//     it stores in shared memory, and dq, written at once; the daff sums;
//   * phase B, thread (key j, stripe): dk and dv from the stored p and dlog
//     and the staged q and dsv, without recomputing a logit;
//   * phase C, positions only: thread per (table row, i, j) sums its
//     table-gradient term over the chunk's stripes in index order, in a
//     register that lives across the block's chunks (with positions a block
//     walks several chunks, so that the partials stay few).
// The keys run once per query, nothing goes through device memory between
// phases, and the block writes its daff (and table) partial once. A second
// launch sums the partials in a fixed order (medt::bwd_finalize): two
// launches a call, none with float atomics, the same bits every run.
// Measured on the same card (PERF.md, kernel row 2): 0.247 ms of device
// time per MedT-128 step (3.4x the bound; 5-48 us a call), 0.17 ms per
// medt_512 batch-4 step (8 launches; the first design 0.59); 1.03-1.22 ms
// of CUDA events, for the host's 80 us a call (checks, 3 allocations, the
// ctypes call, 2 launches) now sets the pace. Registers: 64-128 without
// positions, no spills; 126-255 with positions (8 bytes spilled at gp 8,
// span 8).
// What bounds the kernel: latency (one tile load, three phases, one write
// per block, 2 blocks of 8 warps per SM at 128 registers) and
// shared-memory reads in phases A and B (c + gp per pair each); a variant
// held to 3 blocks per SM spilled and was slower.
// qkv and dqkv are float32 or bf16 (the element type T of the template):
// the q, k, v rows are staged raw (rows padded to 16-byte runs) and
// converted where they are read, and each dqkv value is rounded once where
// it is stored, so a bf16 qkv gives the float32 kernel's table and daff
// gradients on its upcast, bit for bit, and its dqkv rounded once.
// Kernels launch on the caller's stream, allocate nothing (the wrapper
// passes the partials) and do not synchronise; the entry point returns the
// first CUDA error of its launches.

#include <cuda_runtime.h>
#include <stddef.h>

#include "flash2_tiles.cuh"
#include "reduce.cuh"

namespace {

using flash2::ex2;
using flash2::from_f32;
using flash2::kLog2e;
using flash2::to_f32;
using medt::warp_sum;

constexpr int kMaxSpan = 16;
// threads per block: one per (query or key, stripe) of a chunk. Mirrored by
// ops/axial_lanes.py (LANES_THREADS).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// With positions a block walks several chunks so that the table partials
// stay few: at most ceil(kGridBlocks / g) blocks per group. Mirrored by
// ops/axial_lanes.py (LANES_GRID_BLOCKS).
constexpr int kGridBlocks = 1056;

// The span rounded up to the kernel's bucket (4, 8 or 16).
inline int span_bucket(int L) { return L <= 4 ? 4 : L <= 8 ? 8 : 16; }

// Blocks per group: one per chunk of kThreads / LP stripes; with positions
// at most ceil(kGridBlocks / g).
inline int blocks_per_group(int g, int L, int S, bool pos) {
  const int ns = kThreads / span_bucket(L);
  const int chunks = (S + ns - 1) / ns;
  const int cap = (kGridBlocks + g - 1) / g;
  return pos && chunks > cap ? cap : chunks;
}

template <int GP, int LP, bool POS, class T>
struct Cfg {
  static constexpr int C = GP / 2;
  static constexpr int R = 2 * GP;  // table rows: qemb c, kemb_t c, vemb gp
  static constexpr int NS = kThreads / LP;  // stripes per chunk
  // row strides of the staged tiles: qkv's rows (of T) padded by one
  // 16-byte chunk, the float rows by 4
  static constexpr int NSPX = NS + flash2::kChunk<T>;
  static constexpr int NSP = NS + 4;
  static constexpr int PS = NS + 1;         // row stride of p and dlog
  // staged rows of qkv: q (c), k (c), v (gp), each LP x NSPX of T; then
  // the float rows dsv (gp), [dsve (gp)], each LP x NSP
  static constexpr int OK = C, OV = GP, OE = GP;
  static constexpr int XTILE = 2 * GP * LP * NSPX;
  static constexpr int GTILE = (POS ? 2 : 1) * GP * LP * NSP;
  static constexpr int PD = LP * LP * PS;   // p or dlog, [i][j][stripe]
  static constexpr int TAB = POS ? R * LP * LP : 0;  // tables, [row][i][j]
  static constexpr size_t BYTES =
      XTILE * sizeof(T) + (GTILE + 2 * PD + TAB + kWarps * 4) * sizeof(float);
  // table sums per thread in phase C
  static constexpr int TPT = POS ? (R * LP * LP + kThreads - 1) / kThreads : 0;
};

template <class T>
struct Args {
  const T* qkv;
  const float* qemb;
  const float* kemb_t;
  const float* vemb;
  const float* aff;
  const float* dsv;
  const float* dsve;
  T* dqkv;
  float* tab_part;    // (g * blocks, 2gp, L, L) with positions
  float* aff_part;    // (blocks, g, 4)
  int g, L, S;
  bool vec_s, vec_l;
};

template <int GP, int LP, bool POS, class T>
__global__ void __launch_bounds__(kThreads) lanes_bwd_kernel(Args<T> a) {
  using K = Cfg<GP, LP, POS, T>;
  constexpr int C = K::C, R = K::R, NS = K::NS, NSP = K::NSP,
                NSPX = K::NSPX, PS = K::PS;
  constexpr int RS = LP * NSP;    // one staged float row (dsv, dsve)
  constexpr int RSX = LP * NSPX;  // one staged row of qkv
  extern __shared__ __align__(16) float smem[];
  T* xtile = reinterpret_cast<T*>(smem);  // q, k, v
  float* tile = reinterpret_cast<float*>(xtile + K::XTILE);  // dsv, dsve
  float* sp = tile + K::GTILE;    // p
  float* sd = sp + K::PD;         // dlog
  float* tab = sd + K::PD;        // qemb (c), kemb_t (c), vemb (gp)
  float* wsum = tab + K::TAB;     // [warp][4]
  const float* tq = tab;
  const float* tk = tab + C * LP * LP;
  const float* tv = tab + 2 * C * LP * LP;

  const int L = a.L, S = a.S, gi = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid / NS, s = tid % NS;  // query (A) or key (B), stripe
  const size_t LS = (size_t)L * S, LL = (size_t)L * L;
  const T* qkv = a.qkv + (size_t)gi * 2 * GP * LS;
  const float* dsv = a.dsv + (size_t)gi * GP * LS;
  const float* dsve = POS ? a.dsve + (size_t)gi * GP * LS : nullptr;
  T* dqkv = a.dqkv + (size_t)gi * 2 * GP * LS;

  if constexpr (POS) {
    flash2::stage<C, LP, LP, kThreads>(tab, a.qemb, LL, L, L, L, a.vec_l,
                                       tid);
    flash2::stage<C, LP, LP, kThreads>(tab + C * LP * LP, a.kemb_t, LL, L, L,
                                       L, a.vec_l, tid);
    flash2::stage<GP, LP, LP, kThreads>(tab + 2 * C * LP * LP, a.vemb, LL, L,
                                        L, L, a.vec_l, tid);
  }
  const float* af = a.aff + gi * 8;
  const float a0 = af[0], a2 = af[2], a4 = af[4];
  const float a0s = a0 * kLog2e, a2s = a2 * kLog2e, a4s = a4 * kLog2e;

  float s_qk = 0.f, s_b = 0.f, s_qr = 0.f, s_kr = 0.f;
  float acc[K::TPT > 0 ? K::TPT : 1];
#pragma unroll
  for (int t = 0; t < K::TPT; ++t) acc[t] = 0.f;

  const int chunks = (S + NS - 1) / NS;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int s0 = chunk * NS;
    __syncthreads();  // the previous chunk's phases are done with the tile
    flash2::stage<2 * GP, LP, NS, kThreads, NSPX>(xtile, qkv + s0, LS, S,
                                                  L, S - s0, a.vec_s, tid);
    flash2::stage<GP, LP, NS, kThreads, NSP>(tile, dsv + s0, LS, S, L,
                                             S - s0, a.vec_s, tid);
    if constexpr (POS) {
      flash2::stage<GP, LP, NS, kThreads, NSP>(tile + K::OE * RS, dsve + s0,
                                               LS, S, L, S - s0, a.vec_s,
                                               tid);
    }
    flash2::cp_async_commit();
    flash2::cp_async_wait<0>();
    __syncthreads();
    // A stripe past the edge is staged as zeros: its dsim and delta are 0,
    // so its dlog is 0 and its p meets only zero dsv and dsve.
    const T* xcol = xtile + s;    // this thread's stripe: q, k, v
    const float* col = tile + s;  // and dsv, dsve
    const bool in_s = s0 + s < S;

    // -- phase A: thread (query i, stripe) ---------------------------------
    if (r < L) {
      const int i = r;
      float q[C], gv[GP], ge[GP];
#pragma unroll
      for (int c = 0; c < C; ++c) q[c] = to_f32(xcol[c * RSX + i * NSPX]);
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        gv[p] = col[p * RS + i * NSP];
        ge[p] = POS ? col[(K::OE + p) * RS + i * NSP] : 0.f;
      }
      float xs[LP], ds[LP], mx = -3.0e38f;
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        if (j < L) {
          float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float kc = to_f32(xcol[(K::OK + c) * RSX + j * NSPX]);
            qk = fmaf(q[c], kc, qk);
            if constexpr (POS) {
              qr = fmaf(q[c], tq[(c * LP + i) * LP + j], qr);
              kr = fmaf(kc, tk[(c * LP + i) * LP + j], kr);
            }
          }
          float x = a0s * qk;  // log2 units; the biases cancel
          if constexpr (POS) x = fmaf(a4s, kr, fmaf(a2s, qr, x));
          float d = 0.f;
#pragma unroll
          for (int p = 0; p < GP; ++p) {
            d = fmaf(gv[p], to_f32(xcol[(K::OV + p) * RSX + j * NSPX]), d);
            if constexpr (POS) d = fmaf(ge[p], tv[(p * LP + i) * LP + j], d);
          }
          xs[j] = x;
          ds[j] = d;
          mx = fmaxf(mx, x);
        }
      }
      float l = 0.f, wd = 0.f;
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        if (j < L) {
          const float e = ex2(xs[j] - mx);
          xs[j] = e;
          l += e;
          wd = fmaf(e, ds[j], wd);
        }
      }
      const float inv_l = 1.f / l;
      const float delta = wd * inv_l;
      float dA[C], dB[C];
#pragma unroll
      for (int c = 0; c < C; ++c) dA[c] = dB[c] = 0.f;
#pragma unroll
      for (int j = 0; j < LP; ++j) {
        if (j < L) {
          const float pr = xs[j] * inv_l;
          const float dl = pr * (ds[j] - delta);
          sp[(i * LP + j) * PS + s] = pr;
          sd[(i * LP + j) * PS + s] = dl;
          s_b += dl;
          float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float kc = to_f32(xcol[(K::OK + c) * RSX + j * NSPX]);
            qk = fmaf(q[c], kc, qk);
            dA[c] = fmaf(dl, kc, dA[c]);
            if constexpr (POS) {
              const float te = tq[(c * LP + i) * LP + j];
              qr = fmaf(q[c], te, qr);
              dB[c] = fmaf(dl, te, dB[c]);
              kr = fmaf(kc, tk[(c * LP + i) * LP + j], kr);
            }
          }
          s_qk = fmaf(dl, qk, s_qk);
          if constexpr (POS) {
            s_qr = fmaf(dl, qr, s_qr);
            s_kr = fmaf(dl, kr, s_kr);
          }
        }
      }
      if (in_s) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dqkv[c * LS + (size_t)i * S + s0 + s] =
              from_f32<T>(POS ? fmaf(a2, dB[c], a0 * dA[c]) : a0 * dA[c]);
        }
      }
    }
    __syncthreads();

    // -- phase B: thread (key j, stripe) -------------------------------------
    if (r < L) {
      const int j = r;
      float dk[C], dv[GP];
#pragma unroll
      for (int c = 0; c < C; ++c) dk[c] = 0.f;
#pragma unroll
      for (int p = 0; p < GP; ++p) dv[p] = 0.f;
#pragma unroll
      for (int i = 0; i < LP; ++i) {
        if (i < L) {
          const float dl = sd[(i * LP + j) * PS + s];
          const float pr = sp[(i * LP + j) * PS + s];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float w = a0 * to_f32(xcol[c * RSX + i * NSPX]);
            if constexpr (POS) w = fmaf(a4, tk[(c * LP + i) * LP + j], w);
            dk[c] = fmaf(dl, w, dk[c]);
          }
#pragma unroll
          for (int p = 0; p < GP; ++p)
            dv[p] = fmaf(pr, col[p * RS + i * NSP], dv[p]);
        }
      }
      if (in_s) {
        const size_t o = (size_t)j * S + s0 + s;
#pragma unroll
        for (int c = 0; c < C; ++c)
          dqkv[(C + c) * LS + o] = from_f32<T>(dk[c]);
#pragma unroll
        for (int p = 0; p < GP; ++p)
          dqkv[(GP + p) * LS + o] = from_f32<T>(dv[p]);
      }
    }

    // -- phase C (positions): the table-gradient terms over the chunk --------
    if constexpr (POS) {
#pragma unroll
      for (int t = 0; t < K::TPT; ++t) {
        const int e = tid + t * kThreads;
        const int rr = e / (LP * LP), i = (e / LP) % LP, j = e % LP;
        if (rr < R && i < L && j < L) {
          const float* w = (rr < 2 * C ? sd : sp) + (i * LP + j) * PS;
          float v = 0.f;
          if (rr < 2 * C) {  // q or k rows, of T
            const T* o = rr < C ? xtile + (rr * LP + i) * NSPX
                                : xtile + ((K::OK + rr - C) * LP + j) * NSPX;
#pragma unroll 4
            for (int u = 0; u < NS; ++u) v = fmaf(w[u], to_f32(o[u]), v);
          } else {           // dsve rows
            const float* o = tile + ((K::OE + rr - 2 * C) * LP + i) * NSP;
#pragma unroll 4
            for (int u = 0; u < NS; ++u) v = fmaf(w[u], o[u], v);
          }
          acc[t] += v;
        }
      }
    }
  }

  const float sums[4] = {s_qk, s_b, s_qr, s_kr};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) wsum[warp * 4 + k] = v;
  }
  __syncthreads();
  if (tid < 4) {
    float v = 0.f;
    for (int w = 0; w < kWarps; ++w) v += wsum[w * 4 + tid];
    a.aff_part[((size_t)blockIdx.x * a.g + gi) * 4 + tid] = v;
  }
  if constexpr (POS) {
    float* part =
        a.tab_part + ((size_t)gi * gridDim.x + blockIdx.x) * R * LL;
#pragma unroll
    for (int t = 0; t < K::TPT; ++t) {
      const int e = tid + t * kThreads;
      const int rr = e / (LP * LP), i = (e / LP) % LP, j = e % LP;
      if (rr < R && i < L && j < L) {
        const float scale = rr < C ? a2 : rr < 2 * C ? a4 : 1.f;
        part[((size_t)rr * L + i) * L + j] = acc[t] * scale;
      }
    }
  }
}

template <int GP, int LP, bool POS, class T>
cudaError_t launch_variant(const Args<T>& a, int blocks, cudaStream_t stream) {
  auto kernel = lanes_bwd_kernel<GP, LP, POS, T>;
  const size_t smem = Cfg<GP, LP, POS, T>::BYTES;
  cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, a.g), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int GP, class T>
cudaError_t launch_gp(const Args<T>& a, int blocks, bool pos,
                      cudaStream_t stream) {
  switch (span_bucket(a.L)) {
    case 4: return pos ? launch_variant<GP, 4, true>(a, blocks, stream)
                       : launch_variant<GP, 4, false>(a, blocks, stream);
    case 8: return pos ? launch_variant<GP, 8, true>(a, blocks, stream)
                       : launch_variant<GP, 8, false>(a, blocks, stream);
    default: return pos ? launch_variant<GP, 16, true>(a, blocks, stream)
                        : launch_variant<GP, 16, false>(a, blocks, stream);
  }
}

template <class T>
int lanes_bwd(const T* qkv, const float* qemb, const float* kemb_t,
              const float* vemb, const float* aff, const float* dsv,
              const float* dsve, T* dqkv, float* dtables, float* daff,
              float* tab_part, float* aff_part, int g, int gp, int L, int S,
              int has_pos, int n_tab_part, int n_aff_part,
              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool pos = has_pos != 0;
  if (g < 1 || g > 65535 || S < 1 || L < 1 || L > kMaxSpan ||
      (gp != 2 && gp != 4 && gp != 8 && gp != 16)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = blocks_per_group(g, L, S, pos);
  if (n_aff_part != blocks || (pos && n_tab_part != g * blocks)) {
    return (int)cudaErrorInvalidValue;
  }
  using flash2::aligned16;
  const bool vec_s = S % flash2::kChunk<T> == 0 && aligned16(qkv) &&
                     aligned16(dsv) && (!pos || aligned16(dsve));
  const bool vec_l = pos && L % 4 == 0 && aligned16(qemb) &&
                     aligned16(kemb_t) && aligned16(vemb);
  const Args<T> a{qkv, qemb, kemb_t, vemb, aff, dsv, dsve, dqkv, tab_part,
                  aff_part, g, L, S, vec_s, vec_l};
  cudaError_t err;
  switch (gp) {
    case 2: err = launch_gp<2>(a, blocks, pos, stream); break;
    case 4: err = launch_gp<4>(a, blocks, pos, stream); break;
    case 8: err = launch_gp<8>(a, blocks, pos, stream); break;
    default: err = launch_gp<16>(a, blocks, pos, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(tab_part, dtables, pos ? n_tab_part : 0,
                     (size_t)2 * gp * L * L, aff_part, daff, n_aff_part, g,
                     has_pos, stream);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtables: (2gp, L, L) = dqemb (c rows), dkemb_t (c rows), dvemb (gp rows),
// not written without positions. Partials, with B = blocks_per_group(g, L,
// S, has_pos): tab_part (g * B, 2gp, L, L) (unused without positions),
// aff_part (B, g, 4). dsve is not read without positions.
int medt_lanes_attn_bwd(const float* qkv, const float* qemb,
                        const float* kemb_t, const float* vemb,
                        const float* aff, const float* dsv, const float* dsve,
                        float* dqkv, float* dtables, float* daff,
                        float* tab_part, float* aff_part, int g, int gp,
                        int L, int S, int has_pos, int n_tab_part,
                        int n_aff_part, void* stream) {
  return lanes_bwd(qkv, qemb, kemb_t, vemb, aff, dsv, dsve, dqkv, dtables,
                   daff, tab_part, aff_part, g, gp, L, S, has_pos, n_tab_part,
                   n_aff_part, stream);
}

// The same on bf16 qkv (the JAX package's bf16 kernel I/O): the table and
// daff gradients are the float32 entry point's on the upcast qkv, dqkv
// (bf16) its dqkv rounded once.
int medt_lanes_attn_bwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                             const float* kemb_t, const float* vemb,
                             const float* aff, const float* dsv,
                             const float* dsve, __nv_bfloat16* dqkv,
                             float* dtables, float* daff, float* tab_part,
                             float* aff_part, int g, int gp, int L, int S,
                             int has_pos, int n_tab_part, int n_aff_part,
                             void* stream) {
  return lanes_bwd(qkv, qemb, kemb_t, vemb, aff, dsv, dsve, dqkv, dtables,
                   daff, tab_part, aff_part, g, gp, L, S, has_pos, n_tab_part,
                   n_aff_part, stream);
}

}  // extern "C"
