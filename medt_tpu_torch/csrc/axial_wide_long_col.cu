// The column pass of the long-span wide backward (csrc/axial_wide_long_bwd.cu,
// whose entry points launch it between the row pass and the finalize), for
// Hopper (sm_90a), in a source of its own so that it compiles beside the
// row pass. What it replaces and the design: csrc/wide_long.cuh.
//
// long_col_kernel: a block of kThreads owns one group, 32 stripes (lane =
// stripe) and RB keys (RT a thread). Per tile of KT queries (a ring of one
// to three cp.async slots) the block stages their q, dsv (and dsve) rows, m,
// l and delta (the row pass's) and the table entries (tile's queries,
// block's keys: [key][channel][query]); each thread rebuilds p_ij and
// dlog_ij for its RT keys and the tile from its k rows (registers; a0 k
// and a4 k once a channel) as sum_c q (a0 k + a2 qemb) + a4 k kemb_t + (a1
// + a3 + a5) and adds
//   dk[c,j] += dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])   (registers)
//   dv[p,j] += p_ij dsv[p,i]
// in query order, its v and dv rows in registers where they take at most
// 64 (regs_v: gp 6-16) and in its own shared-memory columns above; dk and
// dv are written once (bf16 rounded once).

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

// v and dv rows in registers where they take at most 64 (else in the
// thread's shared-memory columns)
__host__ __device__ constexpr bool regs_v(int cm) {
  return col_rows(cm) * 2 * cm <= 32;
}

// shared memory outside the ring: the threads' v and dv columns
template <int CM>
__host__ __device__ int col_fixed(int gp) {
  return regs_v(CM) ? 0 : 2 * gp * col_rows(CM) * kThreads;
}

// a ring slot: q, dsv (and dsve) rows, m, l, delta, the table tile, the
// raw bf16 q rows
template <int CM, class T>
__host__ __device__ int col_slot(int gp, bool pos, bool vec) {
  constexpr int RB = kWarps * col_rows(CM), KT = col_keys(CM);
  const int C = gp / 2;
  return (C + (pos ? 2 : 1) * gp + 3) * KT * kStripes +
         (pos ? RB * (2 * C + gp) * KT : 0) + raw_floats<T>(C, KT, vec);
}

template <int CM, bool EX, bool POS, class T>
__global__ void __launch_bounds__(kThreads, col_blocks(CM))
long_col_kernel(ColArgs<T> b, int nslot, bool vecq, bool vecf) {
  constexpr int RT = col_rows(CM), KT = col_keys(CM), RB = kWarps * RT;
  constexpr bool VR = regs_v(CM);
  constexpr int PR = VR ? 2 * CM : 1;
  extern __shared__ __align__(16) float sm[];
  const wide::Lanes<T>& x = b.x;
  const int L = x.L, S = x.S, C = EX ? CM : x.gp / 2, GP = 2 * C;
  const int NCH = 2 * C + GP;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, rw = w * RT;
  const int s0 = blockIdx.x * kStripes, s = s0 + lane;
  const int jb = blockIdx.y * RB, gi = blockIdx.z;
  constexpr int TS = KT * kStripes;  // floats of a staged row tile
  float* VD = sm;                    // v, then dv: [p][r][thread]
  float* ring = sm + col_fixed<CM>(GP);
  const int qf = C * TS, df = GP * TS, ef = POS ? df : 0;
  const int slot_f = col_slot<CM, T>(GP, POS, vecq);
  const int rawo = slot_f - raw_floats<T>(C, KT, vecq);  // raw q rows' offset
  const size_t DVO = (size_t)GP * RT * kThreads;
  float a[6];
#pragma unroll
  for (int kk = 0; kk < 6; ++kk) a[kk] = __ldg(b.aff + gi * 8 + kk);
  const float cst = POS ? a[1] + a[3] + a[5] : a[1];
  float kc[RT][CM], dk[RT][CM], vr[RT][PR], dvr[RT][PR];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int j = jb + rw + r;
    const bool live = j < L && s < S;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      kc[r][c] = c < C && live ? x.k(gi, c, j, s) : 0.f;
      dk[r][c] = 0.f;
    }
    if constexpr (VR) {
#pragma unroll
      for (int p = 0; p < PR; ++p) {
        vr[r][p] = p < GP && live ? x.v(gi, p, j, s) : 0.f;
        dvr[r][p] = 0.f;
      }
    } else {
      for (int p = 0; p < GP; ++p) {
        VD[(p * RT + r) * kThreads + t] = live ? x.v(gi, p, j, s) : 0.f;
        VD[DVO + (p * RT + r) * kThreads + t] = 0.f;
      }
    }
  }
  const int ntile = (L + KT - 1) / KT;
  auto issue = [&](int it) {
    float* base = ring + (it % nslot) * slot_f;
    const int i0 = it * KT;
    stage_rows<KT>(x, base, base + rawo, gi, 0, C, i0, s0, kStripes, vecq, t,
                   kThreads);
    stage_f32<KT>(b.dsv, GP, base + qf, gi, 0, GP, i0, L, S, s0, kStripes,
                  vecf, t, kThreads);
    if constexpr (POS) {
      stage_f32<KT>(b.dsve, GP, base + qf + df, gi, 0, GP, i0, L, S, s0,
                    kStripes, vecf, t, kThreads);
    }
    float* rws = base + qf + df + ef;
    stage_f32<KT>(b.m, 1, rws, gi, 0, 1, i0, L, S, s0, kStripes, vecf, t,
                  kThreads);
    stage_f32<KT>(b.l, 1, rws + TS, gi, 0, 1, i0, L, S, s0, kStripes, vecf,
                  t, kThreads);
    stage_f32<KT>(b.delta, 1, rws + 2 * TS, gi, 0, 1, i0, L, S, s0,
                  kStripes, vecf, t, kThreads);
    if constexpr (POS) {
      stage_tables<KT>(x, rws + 3 * TS, jb, RB, 0, GP, i0, true, t,
                       kThreads);
    }
    flash2::cp_async_commit();
  };
  for (int it = 0; it < max(nslot - 1, 1) && it < ntile; ++it) issue(it);
  for (int it = 0; it < ntile; ++it) {
    if (nslot > 1 && it + nslot - 1 < ntile) issue(it + nslot - 1);
    ring_wait(ring_later(nslot, it, ntile));
    float* slot = ring + (it % nslot) * slot_f;
    convert_rows<KT, T>(slot, slot + rawo, C, kStripes, vecq, t, kThreads);
    __syncthreads();
    const float* Qs = slot;                          // [c][u][lane]
    const float* DSs = Qs + qf;                      // [p][u][lane]
    const float* DEs = DSs + df;                     // [p][u][lane]
    const float* RWs = DEs + ef;                     // m, l, delta
    const float* Ts = RWs + 3 * TS;                  // [r][ch][u]
    const int i0 = it * KT;
    float lg[RT][KT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int u = 0; u < KT; ++u) lg[r][u] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        float qv[KT];
#pragma unroll
        for (int u = 0; u < KT; ++u) qv[u] = Qs[(c * KT + u) * kStripes + lane];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float k0 = kc[r][c] * a[0];
          if constexpr (POS) {
            const float k4 = kc[r][c] * a[4];
            float tq[KT], tk[KT];
            load_row<KT>(Ts + ((rw + r) * NCH + c) * KT, tq);
            load_row<KT>(Ts + ((rw + r) * NCH + C + c) * KT, tk);
#pragma unroll
            for (int u = 0; u < KT; ++u) {
              lg[r][u] = fmaf(qv[u], fmaf(a[2], tq[u], k0), lg[r][u]);
              lg[r][u] = fmaf(k4, tk[u], lg[r][u]);
            }
          } else {
#pragma unroll
            for (int u = 0; u < KT; ++u) lg[r][u] = fmaf(qv[u], k0, lg[r][u]);
          }
        }
      }
    }
    float pr[RT][KT], ds[RT][KT];
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      const bool ok = i0 + u < L && s < S;
      const float mq = RWs[u * kStripes + lane];
      const float ilq = ok ? 1.f / RWs[TS + u * kStripes + lane] : 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        pr[r][u] = ok ? fexp(lg[r][u] + cst - mq) * ilq : 0.f;
        ds[r][u] = 0.f;
      }
    }
    // dsim and dv over the value planes
    auto plane = [&](int p, float* vrow, float* dvrow) {
      float dvq[KT], deq[KT];
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        dvq[u] = DSs[(p * KT + u) * kStripes + lane];
        if constexpr (POS) deq[u] = DEs[(p * KT + u) * kStripes + lane];
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float vv = vrow[r];
        float acc = dvrow[r];
#pragma unroll
        for (int u = 0; u < KT; ++u) {
          ds[r][u] = fmaf(dvq[u], vv, ds[r][u]);
          acc = fmaf(pr[r][u], dvq[u], acc);
        }
        dvrow[r] = acc;
        if constexpr (POS) {
          float tv[KT];
          load_row<KT>(Ts + ((rw + r) * NCH + 2 * C + p) * KT, tv);
#pragma unroll
          for (int u = 0; u < KT; ++u) ds[r][u] = fmaf(deq[u], tv[u], ds[r][u]);
        }
      }
    };
    if constexpr (VR) {
#pragma unroll
      for (int p = 0; p < PR; ++p) {
        if (p < GP) {
          float vrow[RT], dvrow[RT];
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            vrow[r] = vr[r][p];
            dvrow[r] = dvr[r][p];
          }
          plane(p, vrow, dvrow);
#pragma unroll
          for (int r = 0; r < RT; ++r) dvr[r][p] = dvrow[r];
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < GP; ++p) {
        float vrow[RT], dvrow[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          vrow[r] = VD[(p * RT + r) * kThreads + t];
          dvrow[r] = VD[DVO + (p * RT + r) * kThreads + t];
        }
        plane(p, vrow, dvrow);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          VD[DVO + (p * RT + r) * kThreads + t] = dvrow[r];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      const float dq = RWs[2 * TS + u * kStripes + lane];
#pragma unroll
      for (int r = 0; r < RT; ++r) ds[r][u] = pr[r][u] * (ds[r][u] - dq);
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        float qv[KT];
#pragma unroll
        for (int u = 0; u < KT; ++u) qv[u] = Qs[(c * KT + u) * kStripes + lane];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float tk[KT];
          if constexpr (POS) {
            load_row<KT>(Ts + ((rw + r) * NCH + C + c) * KT, tk);
          }
#pragma unroll
          for (int u = 0; u < KT; ++u) {
            float tt = ds[r][u] * a[0] * qv[u];
            if constexpr (POS) tt = fmaf(ds[r][u] * a[4], tk[u], tt);
            dk[r][c] += tt;
          }
        }
      }
    }
    __syncthreads();  // the slot's reads are done
    if (nslot == 1 && it + 1 < ntile) issue(it + 1);
  }
  if (s >= S) return;
  const size_t LS = (size_t)L * S;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int j = jb + rw + r;
    if (j >= L) continue;
    T* out = b.dqkv + (size_t)gi * 2 * GP * LS + (size_t)j * S + s;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) out[(C + c) * LS] = from_f32<T>(dk[r][c]);
    }
    if constexpr (VR) {
#pragma unroll
      for (int p = 0; p < PR; ++p) {
        if (p < GP) out[(GP + p) * LS] = from_f32<T>(dvr[r][p]);
      }
    } else {
      for (int p = 0; p < GP; ++p) {
        out[(GP + p) * LS] =
            from_f32<T>(VD[DVO + (p * RT + r) * kThreads + t]);
      }
    }
  }
}

template <int CM, bool EX, bool POS, class T>
cudaError_t launch(const ColArgs<T>& b, int g, cudaStream_t stream) {
  constexpr int RB = kWarps * col_rows(CM);
  const wide::Lanes<T>& x = b.x;
  const long long fixed = col_fixed<CM>(x.gp);
  bool vecq = x.S % flash2::kChunk<T> == 0 && flash2::aligned16(x.qkv);
  auto slots_fitting = [&] {
    return pick_slots(fixed, col_slot<CM, T>(x.gp, POS, vecq),
                      col_blocks(CM));
  };
  int nslot = slots_fitting();
  if (nslot == 0 && raw_floats<T>(1, 1, vecq) > 0) {  // bf16 by loads
    vecq = false;
    nslot = slots_fitting();
  }
  if (nslot == 0) return cudaErrorInvalidValue;
  const long long slot = col_slot<CM, T>(x.gp, POS, vecq);
  const size_t smem = (size_t)(fixed + nslot * slot) * sizeof(float);
  auto kernel = long_col_kernel<CM, EX, POS, T>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vecf = x.S % 4 == 0 && flash2::aligned16(b.dsv) &&
                    flash2::aligned16(b.m) && flash2::aligned16(b.l) &&
                    flash2::aligned16(b.delta) &&
                    (!POS || flash2::aligned16(b.dsve));
  kernel<<<dim3(stripe_tiles(x.S), (x.L + RB - 1) / RB, g), kThreads, smem,
           stream>>>(b, nslot, vecq, vecf);
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
  if (pos) {  // exact instances with positions only
    switch (exact_c(gp)) {
      case 6: return launch<6, true, true>(b, g, stream);
      case 12: return launch<12, true, true>(b, g, stream);
      case 16: return launch<16, true, true>(b, g, stream);
      default: break;
    }
  }
  switch (wide::cm_bucket(gp / 2)) {
    case 8: return pos ? launch<8, false, true>(b, g, stream)
                       : launch<8, false, false>(b, g, stream);
    case 16: return pos ? launch<16, false, true>(b, g, stream)
                        : launch<16, false, false>(b, g, stream);
    case 32: return pos ? launch<32, false, true>(b, g, stream)
                        : launch<32, false, false>(b, g, stream);
    default: return pos ? launch<64, false, true>(b, g, stream)
                        : launch<64, false, false>(b, g, stream);
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
