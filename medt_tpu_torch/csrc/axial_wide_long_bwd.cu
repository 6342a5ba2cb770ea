// Backward of the long-span attention at wide group planes (spans up to
// 256, every even gp up to 128 outside 2, 4, 8 and 16), for Hopper
// (sm_90a). What it replaces, its contract and its design:
// csrc/wide_long.cuh. From the forward's saved m, l, sv, sve and the
// upstream dsv, dsve (per group gi, query i, key j, stripe s; c = gp/2):
//   p_ij = exp(logit_ij - m_i) / l_i
//   delta_i = sum_p dsv[p,i] sv[p,i] + dsve[p,i] sve[p,i]
//   dsim_ij = sum_p dsv[p,i] v[p,j] + dsve[p,i] vemb[p,i,j]
//   dlog_ij = p_ij (dsim_ij - delta_i)
//   dq[c,i] = sum_j dlog_ij (a0 k[c,j] + a2 qemb[c,i,j])
//   dk[c,j] = sum_i dlog_ij (a0 q[c,i] + a4 kemb_t[c,i,j])
//   dv[p,j] = sum_i p_ij dsv[p,i]
//   dqemb[c,i,j] = a2 sum dlog_ij q[c,i], dkemb_t[c,i,j] = a4 sum dlog_ij
//   k[c,j], dvemb[p,i,j] = sum p_ij dsve[p,i]  (over every group, stripe)
//   daff (g, 8) = [sum dlog*qk, sum dlog, sum dlog*qr, sum dlog,
//                  sum dlog*kr, sum dlog, 0, 0]
// Three launches, in order on the caller's stream:
//   1. long_row_kernel: a block of kThreads owns RB query rows (RT a
//      thread, lane = stripe) and a fixed slice of the (group, 32-stripe)
//      units (grid axis x: row_slices, each a table partial slot). For
//      each unit it loads the rows' q (registers; with positions also a
//      [row][channel][lane] tile), dsv and dsve (tiles of kPitch-padded
//      lanes), m and 1/l once and writes delta; then it walks the key
//      tiles through a cp.async ring (k rows, every v plane, the rows'
//      table entries), rebuilds each pair's logit (qk, qr, kr), p and dlog
//      in registers and adds dq (registers) and the daff sums; with
//      positions it then stages the tile's dlog and p and a thread per
//      table element (dqemb, dkemb_t, dvemb at the block's rows and the
//      tile's keys) sums its 32 stripes' products and adds them, times a2,
//      a4 or 1, to the block's slot (loaded before the tile's products, by
//      the same thread each unit). At a unit's end dq is written and the
//      block's four daff sums go to the unit's daff slot (warp_sum, then
//      the warps in order);
//   2. long_col_kernel (csrc/axial_wide_long_col.cu, its own source so
//      that the two compile in parallel): dk and dv;
//   3. medt::bwd_finalize: the table gradients from the row_slices slots
//      and daff from its slots, each in a fixed order.
// Every sum has one owner and a fixed order: the same inputs give the same
// bits on every run.

#include "reduce.cuh"
#include "wide_long.cuh"

namespace wide_long {
namespace {

using flash2::from_f32;
using medt::warp_sum;

template <class T>
struct BwdArgs {
  wide::Lanes<T> x;
  const float* aff;
  const float* m;
  const float* l;
  const float* sv;
  const float* sve;
  const float* dsv;
  const float* dsve;
  T* dqkv;
  float* dtables;    // (2gp, L, L): dqemb, dkemb_t, dvemb
  float* delta;      // (g, L, S) scratch
  float* aff_part;   // (slots, g, 4)
  float* tab_part;   // (row_slices, 2gp, L, L), positions
  int g;
};

// shared memory of a row-pass block outside its ring: the q, dsve and dsv
// tiles of its rows, the staged dlog and p, the daff sums of its warps
template <int CM, int RT>
__host__ __device__ int row_fixed(int gp, bool pos) {
  constexpr int RB = kWarps * RT, KT = row_keys(CM);
  const int C = gp / 2;
  return (pos ? align4(RB * C * kPitch) + align4(RB * gp * kPitch) : 0) +
         align4(RB * gp * kPitch) +
         (pos ? align4(2 * RB * KT * kPitch + 1) : 0) + 4 * kWarps;
}

// a ring slot of the row pass: k rows (kPitch lanes), v rows, table tile,
// the raw bf16 rows
template <int CM, int RT, class T>
__host__ __device__ int row_slot(int gp, bool pos, bool vec) {
  constexpr int RB = kWarps * RT, KT = row_keys(CM);
  const int C = gp / 2;
  return align4(C * KT * kPitch) + gp * KT * kStripes +
         (pos ? RB * (2 * C + gp) * KT : 0) + raw_floats<T>(C + gp, KT, vec);
}

template <int CM, bool EX, int RT, bool POS, class T>
__global__ void __launch_bounds__(kThreads, row_blocks(CM))
long_row_kernel(BwdArgs<T> b, int nslot, bool vec) {
  constexpr int KT = row_keys(CM), RB = kWarps * RT;
  // table tiles a thread sums a unit's key tile, at most: RB * (2 ceil(c/2)
  // + c) tiles of KT x 2 elements
  constexpr int MO = (RB * (2 * ((CM + 1) / 2) + CM) + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) float sm[];
  const wide::Lanes<T>& x = b.x;
  const int L = x.L, S = x.S, C = EX ? CM : x.gp / 2, GP = 2 * C;
  const int NCH = 2 * C + GP;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, rw = w * RT;
  const int sx = stripe_tiles(S), units = b.g * sx;
  const int sl = blockIdx.x, ns = gridDim.x;
  const int n0 = (int)((long long)units * sl / ns);
  const int n1 = (int)((long long)units * (sl + 1) / ns);
  const int yt = blockIdx.y, i0 = yt * RB;
  float* Qt = sm;                                           // [r][c][lane]
  float* Et = Qt + (POS ? align4(RB * C * kPitch) : 0);     // [r][p][lane]
  float* DSt = Et + (POS ? align4(RB * GP * kPitch) : 0);   // [r][p][lane]
  float* DP = DSt + align4(RB * GP * kPitch);               // dlog, p
  float* red = DP + (POS ? align4(2 * RB * KT * kPitch + 1) : 0);
  float* ring = red + 4 * kWarps;
  const int PO = RB * KT * kPitch + 1;  // p after dlog (another bank)
  const int kf = align4(C * KT * kPitch), vf = GP * KT * kStripes;
  const int slot_f = row_slot<CM, RT, T>(GP, POS, vec);
  const int rawo = slot_f - raw_floats<T>(C + GP, KT, vec);  // raw rows' offset
  // the table tiles: dqemb (a row, the KT keys, 2 channels), dvemb (a row,
  // the KT keys, 2 planes), dkemb_t (KT rows, a key, 2 channels); each
  // thread's tiles decoded once into (row, key, first channel)
  const int cq = (C + 1) / 2, nq = RB * cq, nv = RB * C;
  const int nall = POS ? nq + nv + RB * cq : 0;
  int pk[MO];
#pragma unroll
  for (int mm = 0; mm < MO; ++mm) {
    const int o = t + mm * kThreads;
    int r = 0, u = 0, c0 = 0;
    if (o < nq) {
      r = o / cq;
      c0 = 2 * (o - r * cq);
    } else if (o < nq + nv) {
      r = (o - nq) / C;
      c0 = 2 * (o - nq - r * C);
    } else if (o < nall) {
      const int o3 = o - nq - nv, rest = o3 / cq;
      c0 = 2 * (o3 - rest * cq);
      u = rest % KT;
      r = rest - u;
    }
    pk[mm] = (r << 16) | (u << 8) | c0;
  }
  // tile mm's element (k, b): its slot index, or -1 past the edges
  auto elem = [&](int mm, int k, int b, int j0) -> long long {
    const int o = t + mm * kThreads;
    const int r = pk[mm] >> 16, u = (pk[mm] >> 8) & 255, c = (pk[mm] & 255) + b;
    int ch, i, j;
    if (o < nq) {
      ch = c < C ? c : -1;
      i = i0 + r;
      j = j0 + k;
    } else if (o < nq + nv) {
      ch = 2 * C + c;
      i = i0 + r;
      j = j0 + k;
    } else {
      ch = c < C ? C + c : -1;
      i = i0 + r + k;
      j = j0 + u;
    }
    if (ch < 0 || i >= L || j >= L) return -1;
    return ((long long)ch * L + i) * L + j;
  };
  const size_t LS = (size_t)L * S, LL = (size_t)L * L;
  float* part = b.tab_part + (size_t)sl * 2 * GP * LL;
  const int ntile = (L + KT - 1) / KT, total = (n1 - n0) * ntile;
  auto issue = [&](int k) {  // the k-th (unit, key tile) of the block
    const int n = n0 + k / ntile, j0 = (k % ntile) * KT;
    const int g = n / sx, s0 = (n - g * sx) * kStripes;
    float* base = ring + (k % nslot) * slot_f;
    stage_rows<KT>(x, base, base + rawo, g, C, C, j0, s0, kPitch, vec, t,
                   kThreads);
    stage_rows<KT>(x, base + kf, base + rawo + raw_floats<T>(C, KT, vec), g, GP,
                   GP, j0, s0, kStripes, vec, t, kThreads);
    if constexpr (POS) {
      stage_tables<KT>(x, base + kf + vf, i0, RB, 0, GP, j0, false, t,
                       kThreads);
    }
    flash2::cp_async_commit();
  };
  float q[RT][CM], dq[RT][CM], mrow[RT], il[RT], dlt[RT], a[6], sums[4];
  float pv[MO][KT][2];
  int gi = 0, s = 0;
  for (int k = 0; k < max(nslot - 1, 1) && k < total; ++k) issue(k);
  for (int k = 0; k < total; ++k) {
    const int kn = k / ntile, it = k - kn * ntile, n = n0 + kn;
    const bool first = kn == 0;
    if (it == 0) {  // a new unit: its rows' data, once
      gi = n / sx;
      s = (n - gi * sx) * kStripes + lane;
#pragma unroll
      for (int kk = 0; kk < 6; ++kk) a[kk] = __ldg(b.aff + gi * 8 + kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) sums[kk] = 0.f;
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + rw + r;
        const bool live = i < L && s < S;
        const size_t row = ((size_t)gi * L + i) * S + s;
        const size_t o = (size_t)gi * GP * LS + (size_t)i * S + s;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          q[r][c] = c < C && live ? x.q(gi, c, i, s) : 0.f;
          dq[r][c] = 0.f;
          if (POS && c < C) Qt[((rw + r) * C + c) * kPitch + lane] = q[r][c];
        }
        mrow[r] = live ? __ldg(b.m + row) : 0.f;
        il[r] = live ? 1.f / __ldg(b.l + row) : 0.f;
        float delta = 0.f;
#pragma unroll 4
        for (int p = 0; p < GP; ++p) {
          const float ds = live ? __ldg(b.dsv + o + p * LS) : 0.f;
          DSt[((rw + r) * GP + p) * kPitch + lane] = ds;
          delta = fmaf(ds, live ? __ldg(b.sv + o + p * LS) : 0.f, delta);
        }
        if constexpr (POS) {
#pragma unroll 4
          for (int p = 0; p < GP; ++p) {
            const float de = live ? __ldg(b.dsve + o + p * LS) : 0.f;
            Et[((rw + r) * GP + p) * kPitch + lane] = de;
            delta = fmaf(de, live ? __ldg(b.sve + o + p * LS) : 0.f, delta);
          }
        }
        if (live) b.delta[row] = delta;
        dlt[r] = delta;
      }
    }
    if (nslot > 1 && k + nslot - 1 < total) issue(k + nslot - 1);
    const int j0 = it * KT;
    if constexpr (POS) {  // the slot's partials of this thread's tiles
#pragma unroll
      for (int mm = 0; mm < MO; ++mm) {
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const long long e = first || t + mm * kThreads >= nall
                                    ? -1 : elem(mm, kk, b, j0);
            pv[mm][kk][b] = e >= 0 ? part[e] : 0.f;
          }
        }
      }
    }
    ring_wait(ring_later(nslot, k, total));
    float* slot = ring + (k % nslot) * slot_f;
    convert_rows<KT, T>(slot, slot + rawo, C, kPitch, vec, t, kThreads);
    convert_rows<KT, T>(slot + kf, slot + rawo + raw_floats<T>(C, KT, vec), GP,
                        kStripes, vec, t, kThreads);
    __syncthreads();
    const float* Ks = slot;                         // [c][u][kPitch]
    const float* Vs = Ks + kf;                      // [p][u][lane]
    const float* Ts = Vs + vf;                      // [r][ch][u]
    float qk[RT][KT], qr[RT][KT], kr[RT][KT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int u = 0; u < KT; ++u) qk[r][u] = qr[r][u] = kr[r][u] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        float kc[KT];
#pragma unroll
        for (int u = 0; u < KT; ++u) kc[u] = Ks[(c * KT + u) * kPitch + lane];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int u = 0; u < KT; ++u) {
            qk[r][u] = fmaf(q[r][c], kc[u], qk[r][u]);
          }
          if constexpr (POS) {
            float tq[KT], tk[KT];
            load_row<KT>(Ts + ((rw + r) * NCH + c) * KT, tq);
            load_row<KT>(Ts + ((rw + r) * NCH + C + c) * KT, tk);
#pragma unroll
            for (int u = 0; u < KT; ++u) {
              qr[r][u] = fmaf(q[r][c], tq[u], qr[r][u]);
              kr[r][u] = fmaf(kc[u], tk[u], kr[r][u]);
            }
          }
        }
      }
    }
    float pr[RT][KT], dl[RT][KT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        float lg = qk[r][u] * a[0] + a[1];
        if constexpr (POS) {
          lg += (qr[r][u] * a[2] + a[3]) + (kr[r][u] * a[4] + a[5]);
        }
        pr[r][u] = j0 + u < L ? fexp(lg - mrow[r]) * il[r] : 0.f;
        dl[r][u] = 0.f;  // dsim first
      }
    }
#pragma unroll
    for (int p = 0; p < GP; ++p) {
      float vv[KT];
#pragma unroll
      for (int u = 0; u < KT; ++u) vv[u] = Vs[(p * KT + u) * kStripes + lane];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const float ds = DSt[((rw + r) * GP + p) * kPitch + lane];
#pragma unroll
        for (int u = 0; u < KT; ++u) dl[r][u] = fmaf(ds, vv[u], dl[r][u]);
        if constexpr (POS) {
          const float de = Et[((rw + r) * GP + p) * kPitch + lane];
          float tv[KT];
          load_row<KT>(Ts + ((rw + r) * NCH + 2 * C + p) * KT, tv);
#pragma unroll
          for (int u = 0; u < KT; ++u) dl[r][u] = fmaf(de, tv[u], dl[r][u]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        dl[r][u] = pr[r][u] * (dl[r][u] - dlt[r]);
        sums[0] = fmaf(dl[r][u], qk[r][u], sums[0]);
        sums[1] += dl[r][u];
        if constexpr (POS) {
          sums[2] = fmaf(dl[r][u], qr[r][u], sums[2]);
          sums[3] = fmaf(dl[r][u], kr[r][u], sums[3]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        float kc[KT];
#pragma unroll
        for (int u = 0; u < KT; ++u) kc[u] = Ks[(c * KT + u) * kPitch + lane];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float tq[KT];
          if constexpr (POS) load_row<KT>(Ts + ((rw + r) * NCH + c) * KT, tq);
#pragma unroll
          for (int u = 0; u < KT; ++u) {
            float tt = dl[r][u] * a[0] * kc[u];
            if constexpr (POS) tt = fmaf(dl[r][u] * a[2], tq[u], tt);
            dq[r][c] += tt;
          }
        }
      }
    }
    if constexpr (POS) {  // the tile's table gradient over the 32 stripes
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int u = 0; u < KT; ++u) {
          DP[((rw + r) * KT + u) * kPitch + lane] = dl[r][u];
          DP[PO + ((rw + r) * KT + u) * kPitch + lane] = pr[r][u];
        }
      }
      __syncthreads();
#pragma unroll
      for (int mm = 0; mm < MO; ++mm) {
        const int o = t + mm * kThreads;
        if (o < nall) {
          const int r = pk[mm] >> 16, u = (pk[mm] >> 8) & 255;
          const int c0 = pk[mm] & 255;
          // KT rows of dlog or p (stride as) against 2 rows of q, dsve or k
          const float* A;
          const float* B0;
          int as, bs;
          float sc;
          if (o < nq) {
            A = DP + r * KT * kPitch;
            as = kPitch;
            B0 = Qt + (r * C + c0) * kPitch;
            bs = c0 + 1 < C ? kPitch : 0;
            sc = a[2];
          } else if (o < nq + nv) {
            A = DP + PO + r * KT * kPitch;
            as = kPitch;
            B0 = Et + (r * GP + c0) * kPitch;
            bs = kPitch;
            sc = 1.f;
          } else {
            A = DP + (r * KT + u) * kPitch;
            as = KT * kPitch;
            B0 = Ks + (c0 * KT + u) * kPitch;
            bs = c0 + 1 < C ? KT * kPitch : 0;
            sc = a[4];
          }
          float acc[KT][2];
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) acc[kk][0] = acc[kk][1] = 0.f;
#pragma unroll 8
          for (int tt = 0; tt < kStripes; ++tt) {
            const float b0 = B0[tt], b1 = B0[bs + tt];
#pragma unroll
            for (int kk = 0; kk < KT; ++kk) {
              const float av = A[kk * as + tt];
              acc[kk][0] = fmaf(av, b0, acc[kk][0]);
              acc[kk][1] = fmaf(av, b1, acc[kk][1]);
            }
          }
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              const long long e = elem(mm, kk, b, j0);
              if (e >= 0) {
                const float v = acc[kk][b] * sc;
                part[e] = first ? v : pv[mm][kk][b] + v;
              }
            }
          }
        }
      }
    }
    if (it == ntile - 1) {  // the unit is done: dq, its daff slot
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const int i = i0 + rw + r;
        if (i < L && s < S) {
          T* out = b.dqkv + (size_t)gi * 2 * GP * LS + (size_t)i * S + s;
#pragma unroll
          for (int c = 0; c < CM; ++c) {
            if (c < C) out[c * LS] = from_f32<T>(dq[r][c]);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float v = warp_sum(sums[kk]);
        if (lane == 0) red[w * 4 + kk] = v;
      }
      __syncthreads();
      if (t < 4) {
        float v = 0.f;
#pragma unroll
        for (int ww = 0; ww < kWarps; ++ww) v += red[ww * 4 + t];
        const size_t slot = (size_t)yt * sx + (n - gi * sx);
        b.aff_part[(slot * b.g + gi) * 4 + t] = v;
      }
    }
    __syncthreads();  // the slot's, the tiles' and the sums' reads are done
    if (nslot == 1 && k + 1 < total) issue(k + 1);
  }
}

// launches 1-2 (the column pass from csrc/axial_wide_long_col.cu) with RT
// query rows a row-pass thread; the row pass's daff slots in *slots
template <int CM, bool EX, int RT, bool POS, class T>
cudaError_t launch_rt(const BwdArgs<T>& b, int nsl, int* slots,
                      cudaStream_t stream) {
  constexpr int RB = kWarps * RT;
  const wide::Lanes<T>& x = b.x;
  const int L = x.L, S = x.S, GP = x.gp;
  const long long fixed = row_fixed<CM, RT>(GP, POS);
  bool vec = S % flash2::kChunk<T> == 0 && flash2::aligned16(x.qkv);
  auto slots_fitting = [&] {
    return pick_slots(fixed, row_slot<CM, RT, T>(GP, POS, vec),
                      row_blocks(CM));
  };
  int nslot = slots_fitting();
  if (nslot == 0 && raw_floats<T>(1, 1, vec) > 0) {  // bf16 by loads
    vec = false;
    nslot = slots_fitting();
  }
  if (nslot == 0) return cudaErrorInvalidValue;
  const long long slot = row_slot<CM, RT, T>(GP, POS, vec);
  const size_t smem = (size_t)(fixed + nslot * slot) * sizeof(float);
  auto row = long_row_kernel<CM, EX, RT, POS, T>;
  cudaError_t err = flash2::allow_smem(row, smem);
  if (err != cudaSuccess) return err;
  const int row_tiles = (L + RB - 1) / RB;
  *slots = row_tiles * stripe_tiles(S);
  row<<<dim3(nsl, row_tiles), kThreads, smem, stream>>>(b, nslot, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return long_col(x.qkv, x.qemb, x.kemb_t, x.vemb, b.aff, b.m, b.l, b.dsv,
                  b.dsve, b.delta, b.dqkv, b.g, GP, L, S, POS, stream);
}

// the row pass's rows a thread by c (row_rows): both counts in bucket 16
template <int CM, bool EX, bool POS, class T>
cudaError_t launch(const BwdArgs<T>& b, int nsl, int* slots,
                   cudaStream_t stream) {
  if constexpr (CM == 16) {
    if (row_rows(b.x.gp / 2) == 1) {
      return launch_rt<CM, EX, 1, POS, T>(b, nsl, slots, stream);
    }
    return launch_rt<CM, EX, 2, POS, T>(b, nsl, slots, stream);
  } else {
    return launch_rt<CM, EX, row_rows(CM), POS, T>(b, nsl, slots, stream);
  }
}

template <int CM, class T>
cudaError_t launch_cm(const BwdArgs<T>& b, bool pos, int nsl, int* slots,
                      cudaStream_t stream) {
  return pos ? launch<CM, false, true>(b, nsl, slots, stream)
             : launch<CM, false, false>(b, nsl, slots, stream);
}

template <class T>
int bwd(const T* qkv, const float* qemb, const float* kemb_t,
        const float* vemb, const float* aff, const float* m, const float* l,
        const float* sv, const float* sve, const float* dsv,
        const float* dsve, T* dqkv, float* dtables, float* daff,
        float* delta, float* aff_part, float* tab_part, int g, int gp, int L,
        int S, int has_pos, int n_aff_part, int n_tab_part,
        void* stream_ptr) {
  const bool pos = has_pos != 0;
  if (!geometry_ok(g, gp, L, S) || n_aff_part != slot_capacity(L, S)) {
    return (int)cudaErrorInvalidValue;
  }
  const int nsl = row_slices(g, gp, L, S);
  if (n_tab_part != (pos ? nsl : 0)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const BwdArgs<T> b{{qkv, qemb, kemb_t, vemb, gp, L, S},
                     aff, m, l, sv, sve, dsv, dsve, dqkv, dtables, delta,
                     aff_part, tab_part, g};
  int slots = 0;
  cudaError_t err;
  if (pos && exact_c(gp) == 6) {  // the row pass's one exact width
    err = launch<6, true, true>(b, nsl, &slots, stream);
  } else {
    switch (wide::cm_bucket(gp / 2)) {
      case 8: err = launch_cm<8>(b, pos, nsl, &slots, stream); break;
      case 16: err = launch_cm<16>(b, pos, nsl, &slots, stream); break;
      case 32: err = launch_cm<32>(b, pos, nsl, &slots, stream); break;
      default: err = launch_cm<64>(b, pos, nsl, &slots, stream); break;
    }
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(tab_part, dtables, pos ? nsl : 0,
                     (size_t)2 * gp * L * L, aff_part, daff, slots, g,
                     has_pos, stream);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wide_long

extern "C" {

// Spans 1..256 (the model routes 65..256 here), every even gp up to 128.
// m, l, sv, sve are the forward's saved outputs; dtables (2gp, L, L) is not
// written without positions; delta holds g * L * S floats; aff_part
// (n_aff_part, g, 4), n_aff_part = L * ceil(S/32) (slot_capacity);
// tab_part (n_tab_part, 2gp, L, L), n_tab_part = row_slices(g, gp, L, S)
// with positions, else 0 (and tab_part unused).
int medt_wide_long_bwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, const float* m, const float* l,
                       const float* sv, const float* sve, const float* dsv,
                       const float* dsve, float* dqkv, float* dtables,
                       float* daff, float* delta, float* aff_part,
                       float* tab_part, int g, int gp, int L, int S,
                       int has_pos, int n_aff_part, int n_tab_part,
                       void* stream) {
  return wide_long::bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv,
                        dsve, dqkv, dtables, daff, delta, aff_part, tab_part,
                        g, gp, L, S, has_pos, n_aff_part, n_tab_part, stream);
}

// The same on bf16 qkv: the table and daff gradients are the float32 entry
// point's on the upcast qkv, dqkv (bf16) its dqkv rounded once.
int medt_wide_long_bwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                            const float* kemb_t, const float* vemb,
                            const float* aff, const float* m, const float* l,
                            const float* sv, const float* sve,
                            const float* dsv, const float* dsve,
                            __nv_bfloat16* dqkv, float* dtables, float* daff,
                            float* delta, float* aff_part, float* tab_part,
                            int g, int gp, int L, int S, int has_pos,
                            int n_aff_part, int n_tab_part, void* stream) {
  return wide_long::bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv,
                        dsve, dqkv, dtables, daff, delta, aff_part, tab_part,
                        g, gp, L, S, has_pos, n_aff_part, n_tab_part, stream);
}

}  // extern "C"
