// The column pass of the long-span wide backward (csrc/axial_wide_long_bwd.cu,
// whose entry points launch it between the row and table passes), for
// Hopper (sm_90a), in a source of its own so that it compiles beside the
// row and table passes. What it replaces and the design: csrc/wide_long.cuh.
//
// long_col_kernel: a thread per (group, key j, stripe), a block 32 stripes
// x R keys (col_floats, pick_rows); per tile of KT queries the block stages
// their q, dsv (and dsve) rows, m, 1/l and delta (the row pass's) and the
// table entries (tile's queries, block's keys); each thread rebuilds p_ij
// and dlog_ij for the tile from its k row (registers) and v row (shared
// memory) and adds
//   dk[c,j] += dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])   (registers)
//   dv[p,j] += p_ij dsv[p,i]                            (shared memory)
// in query order; dk and dv are written once (bf16 rounded once).

#include "wide_long.cuh"

namespace wide_long {
namespace {

using flash2::from_f32;

template <class T>
struct ColArgs {
  wide::Lanes<T> x;
  const float* aff;
  const float* m;
  const float* l;
  const float* dsv;
  const float* dsve;
  const float* delta;
  T* dqkv;
};

// shared memory of a column-pass block of R keys: the q, dsv (and dsve)
// tile with m, 1/l and delta, the table tile, the threads' v rows and dv
// sums
inline int col_floats(int gp, bool pos, int R) {
  const int C = gp / 2, KT = key_tile(wide::cm_bucket(C));
  return (C + (pos ? 2 : 1) * gp + 3) * KT * kStripes +
         (pos ? (2 * C + gp) * KT * R : 0) + 2 * gp * kStripes * R;
}

template <int CM, bool POS, class T>
__global__ void __launch_bounds__(kStripes * kMaxRows, min_blocks(CM))
long_col_kernel(ColArgs<T> b) {
  constexpr int KT = key_tile(CM);
  extern __shared__ float sm[];
  const wide::Lanes<T>& x = b.x;
  const int R = blockDim.y, nt = kStripes * R;
  const int lane = threadIdx.x, y = threadIdx.y, t = y * kStripes + lane;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2;
  const int s0 = blockIdx.x * kStripes, jb = blockIdx.y * R;
  const int gi = blockIdx.z, s = s0 + lane, j = jb + y;
  const bool live = s < S && j < L;
  constexpr int TS = KT * kStripes;             // floats of a staged row
  float* Qs = sm;                               // [c][u][lane]
  float* DSs = Qs + C * TS;                     // [p][u][lane]
  float* DEs = DSs + GP * TS;                   // [p][u][lane], positions
  float* RW = DEs + (POS ? GP * TS : 0);        // m, 1/l, delta: [3][u][lane]
  float* Ts = RW + 3 * TS;                      // [r][ch][u], positions
  float* VC = Ts + (POS ? (2 * C + GP) * KT * R : 0);  // [p][t]
  float* DV = VC + GP * nt;                     // [p][t]
  // this key's table tile: qemb, kemb_t, vemb rows at fixed offsets
  const int NCH = 2 * C + GP;
  const float* Tq = Ts + y * NCH * KT;
  const float* Tk = Tq + C * KT;
  const float* Tv = Tk + C * KT;
  float a[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = __ldg(b.aff + gi * 8 + k);
  float kc[CM], dk[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    kc[c] = live && c < C ? x.k(gi, c, j, s) : 0.f;
    dk[c] = 0.f;
  }
  for (int p = 0; p < GP; ++p) {
    VC[p * nt + t] = live ? x.v(gi, p, j, s) : 0.f;
    DV[p * nt + t] = 0.f;
  }
  for (int i0 = 0; i0 < L; i0 += KT) {
    const int ni = min(KT, L - i0);
    __syncthreads();  // the last tile's reads are done
    stage_qkv<KT>(x, Qs, gi, 0, C, i0, ni, s0, t, nt);
    stage_f32<KT>(b.dsv, DSs, gi, GP, L, S, i0, ni, s0, t, nt);
    if constexpr (POS) stage_f32<KT>(b.dsve, DEs, gi, GP, L, S, i0, ni, s0, t, nt);
    stage_f32<KT>(b.m, RW, gi, 1, L, S, i0, ni, s0, t, nt);
    stage_f32<KT>(b.l, RW + TS, gi, 1, L, S, i0, ni, s0, t, nt, true);
    stage_f32<KT>(b.delta, RW + 2 * TS, gi, 1, L, S, i0, ni, s0, t, nt);
    if constexpr (POS) {
      for (int e = t; e < NCH * KT * R; e += nt) {
        const int u = e % KT, ch = (e / KT) % NCH, r = e / (KT * NCH);
        Ts[e] = (jb + r < L && u < ni) ? table_at(x, ch, i0 + u, jb + r)
                                       : 0.f;
      }
    }
    __syncthreads();
    if (!live) continue;
    float p[KT], dsim[KT];
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          const float qv = Qs[(c * KT + u) * kStripes + lane];
          qk = fmaf(qv, kc[c], qk);
          if constexpr (POS) {
            qr = fmaf(qv, Tq[c * KT + u], qr);
            kr = fmaf(kc[c], Tk[c * KT + u], kr);
          }
        }
      }
      float lg = qk * a[0] + a[1];
      if constexpr (POS) lg += (qr * a[2] + a[3]) + (kr * a[4] + a[5]);
      p[u] = u < ni ? expf(lg - RW[u * kStripes + lane]) *
                          RW[TS + u * kStripes + lane]
                    : 0.f;
      dsim[u] = 0.f;
    }
    for (int pp = 0; pp < GP; ++pp) {
      const float vv = VC[pp * nt + t];
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        dsim[u] = fmaf(DSs[(pp * KT + u) * kStripes + lane], vv, dsim[u]);
        if constexpr (POS) {
          dsim[u] = fmaf(DEs[(pp * KT + u) * kStripes + lane],
                         Tv[pp * KT + u], dsim[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      const float dl = p[u] * (dsim[u] - RW[2 * TS + u * kStripes + lane]);
      const float d0 = dl * a[0], d4 = dl * a[4];
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          float tt = d0 * Qs[(c * KT + u) * kStripes + lane];
          if constexpr (POS) tt = fmaf(d4, Tk[c * KT + u], tt);
          dk[c] += tt;
        }
      }
    }
    for (int pp = 0; pp < GP; ++pp) {
      float acc = DV[pp * nt + t];
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        acc = fmaf(p[u], DSs[(pp * KT + u) * kStripes + lane], acc);
      }
      DV[pp * nt + t] = acc;
    }
  }
  if (!live) return;
  const size_t LS = (size_t)L * S;
  T* out = b.dqkv + (size_t)gi * 2 * GP * LS + (size_t)j * S + s;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c < C) out[(C + c) * LS] = from_f32<T>(dk[c]);
  }
  for (int p = 0; p < GP; ++p) out[(GP + p) * LS] = from_f32<T>(DV[p * nt + t]);
}

template <int CM, bool POS, class T>
cudaError_t launch(const ColArgs<T>& b, int g, cudaStream_t stream) {
  const wide::Lanes<T>& x = b.x;
  const int R = pick_rows([&](int r) { return col_floats(x.gp, POS, r); });
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)col_floats(x.gp, POS, R) * sizeof(float);
  auto kernel = long_col_kernel<CM, POS, T>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((x.S + kStripes - 1) / kStripes, (x.L + R - 1) / R, g),
           dim3(kStripes, R), smem, stream>>>(b);
  return cudaGetLastError();
}

template <class T>
cudaError_t col(const T* qkv, const float* qemb, const float* kemb_t,
                const float* vemb, const float* aff, const float* m,
                const float* l, const float* dsv, const float* dsve,
                const float* delta, T* dqkv, int g, int gp, int L, int S,
                bool pos, cudaStream_t stream) {
  const ColArgs<T> b{{qkv, qemb, kemb_t, vemb, gp, L, S}, aff, m, l, dsv,
                     dsve, delta, dqkv};
  switch (wide::cm_bucket(gp / 2)) {
    case 8: return pos ? launch<8, true>(b, g, stream)
                       : launch<8, false>(b, g, stream);
    case 16: return pos ? launch<16, true>(b, g, stream)
                        : launch<16, false>(b, g, stream);
    case 32: return pos ? launch<32, true>(b, g, stream)
                        : launch<32, false>(b, g, stream);
    default: return pos ? launch<64, true>(b, g, stream)
                        : launch<64, false>(b, g, stream);
  }
}

}  // namespace

cudaError_t long_col(const float* qkv, const float* qemb, const float* kemb_t,
                     const float* vemb, const float* aff, const float* m,
                     const float* l, const float* dsv, const float* dsve,
                     const float* delta, float* dqkv, int g, int gp, int L,
                     int S, bool pos, cudaStream_t stream) {
  return col(qkv, qemb, kemb_t, vemb, aff, m, l, dsv, dsve, delta, dqkv, g,
             gp, L, S, pos, stream);
}

cudaError_t long_col(const __nv_bfloat16* qkv, const float* qemb,
                     const float* kemb_t, const float* vemb, const float* aff,
                     const float* m, const float* l, const float* dsv,
                     const float* dsve, const float* delta,
                     __nv_bfloat16* dqkv, int g, int gp, int L, int S,
                     bool pos, cudaStream_t stream) {
  return col(qkv, qemb, kemb_t, vemb, aff, m, l, dsv, dsve, delta, dqkv, g,
             gp, L, S, pos, stream);
}

}  // namespace wide_long
