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
// Four launches, in order on the caller's stream:
//   1. long_row_kernel: a thread per (group, query row, stripe), a block 32
//      stripes x R rows (pick_rows over row_floats); per tile of KT keys
//      the k and v rows and the rows' table entries staged; delta (to the
//      scratch) and the thread's dsv, dsve rows (shared memory) first, dq
//      in registers over the keys, the block's four daff sums into its
//      slot (warp_sum, then its warps in order);
//   2. long_col_kernel (csrc/axial_wide_long_col.cu, its own source so
//      that the two compile in parallel): dk and dv;
//   3. with positions, long_tab_kernel: a block per (query row, kTabKeys
//      keys) and 32, 64 or 128 threads (tab_floats); for each (group,
//      stripe chunk) in turn a thread per stripe forms its p and dlog for
//      the keys and stages them with its q and dsve rows and the keys' k
//      rows, then a thread per table element adds its sum over the chunk's
//      stripes (a2, a4 applied per group); every element of the (2gp, L,
//      L) table gradient is owned by one thread of one block, summed in a
//      fixed order and written once;
//   4. medt::bwd_finalize: daff from the slots, in a fixed order.
// No atomics: the same inputs give the same bits on every run.

#include <limits.h>

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
  int g;
};

// shared memory of a row-pass block of R rows: the k and v tile, the table
// tile, the threads' dsv (and dsve) rows
inline int row_floats(int gp, bool pos, int R) {
  const int C = gp / 2, KT = key_tile(wide::cm_bucket(C));
  return (C + gp) * KT * kStripes + (pos ? (2 * C + gp) * R * KT : 0) +
         (pos ? 2 : 1) * gp * kStripes * R;
}

// the table element of a table-pass output: dqemb (c, jj) first, then
// dkemb_t, then dvemb (p, jj), channel fastest
__device__ __forceinline__ void out_index(int e, int C, int GP, int& ch,
                                          int& jj) {
  const int nq = C * kTabKeys;
  if (e < 2 * nq) {
    const int k = e / nq, r = e % nq;
    jj = r / C;
    ch = k * C + r % C;
  } else {
    const int r = e - 2 * nq;
    jj = r / GP;
    ch = 2 * C + r % GP;
  }
}

// shared memory of a table-pass block of CH threads (one a stripe)
inline int tab_floats(int gp, int CH) {
  const int C = gp / 2;
  return CH * (C + 1) + CH * (gp + 1) + gp * CH + 2 * kTabKeys * CH +
         kTabKeys * CH * (C + 1) + 2 * gp * kTabKeys;
}

template <int CM, bool POS, class T>
__global__ void __launch_bounds__(kStripes * kMaxRows, min_blocks(CM))
long_row_kernel(BwdArgs<T> b) {
  constexpr int KT = key_tile(CM);
  extern __shared__ float sm[];
  __shared__ float red[kMaxRows][4];
  const wide::Lanes<T>& x = b.x;
  const int R = blockDim.y, nt = kStripes * R;
  const int lane = threadIdx.x, y = threadIdx.y, t = y * kStripes + lane;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2;
  const int s0 = blockIdx.x * kStripes, i0 = blockIdx.y * R;
  const int gi = blockIdx.z, s = s0 + lane, i = i0 + y;
  const bool live = s < S && i < L;
  float* Ks = sm;                               // [c][u][lane]
  float* Vs = Ks + C * KT * kStripes;           // [p][u][lane]
  float* Ts = Vs + GP * KT * kStripes;          // [r][ch][u], positions
  float* DS = Ts + (POS ? (2 * C + GP) * R * KT : 0);  // [p][t]
  float* DE = DS + GP * nt;                     // [p][t], positions
  // this row's table tile: qemb, kemb_t, vemb rows at fixed offsets
  const int NCH = 2 * C + GP;
  const float* Tq = Ts + y * NCH * KT;
  const float* Tk = Tq + C * KT;
  const float* Tv = Tk + C * KT;
  float a[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = __ldg(b.aff + gi * 8 + k);
  float q[CM], dq[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    q[c] = live && c < C ? x.q(gi, c, i, s) : 0.f;
    dq[c] = 0.f;
  }
  const size_t LS = (size_t)L * S;
  const size_t row = ((size_t)gi * L + i) * S + s;
  const size_t o = (size_t)gi * GP * LS + (size_t)i * S + s;
  float m = 0.f, inv_l = 0.f, delta = 0.f;
  if (live) {
    m = __ldg(b.m + row);
    inv_l = 1.f / __ldg(b.l + row);
    for (int p = 0; p < GP; ++p) {
      const float ds = __ldg(b.dsv + o + p * LS);
      DS[p * nt + t] = ds;
      delta = fmaf(ds, __ldg(b.sv + o + p * LS), delta);
    }
    if constexpr (POS) {
      for (int p = 0; p < GP; ++p) {
        const float de = __ldg(b.dsve + o + p * LS);
        DE[p * nt + t] = de;
        delta = fmaf(de, __ldg(b.sve + o + p * LS), delta);
      }
    }
    b.delta[row] = delta;
  }
  float sums[4] = {0.f, 0.f, 0.f, 0.f};  // dlog*qk, dlog, dlog*qr, dlog*kr
  for (int j0 = 0; j0 < L; j0 += KT) {
    const int nk = min(KT, L - j0);
    __syncthreads();  // the last tile's reads are done
    stage_qkv<KT>(x, Ks, gi, C, C, j0, nk, s0, t, nt);
    stage_qkv<KT>(x, Vs, gi, GP, GP, j0, nk, s0, t, nt);
    if constexpr (POS) {
      for (int e = t; e < NCH * R * KT; e += nt) {
        const int u = e % KT, ch = (e / KT) % NCH, r = e / (KT * NCH);
        Ts[e] = (i0 + r < L && u < nk) ? table_at(x, ch, i0 + r, j0 + u)
                                       : 0.f;
      }
    }
    __syncthreads();
    if (!live) continue;
    float p[KT], qk[KT], qr[KT], kr[KT], dsim[KT];
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      qk[u] = qr[u] = kr[u] = dsim[u] = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          const float kc = Ks[(c * KT + u) * kStripes + lane];
          qk[u] = fmaf(q[c], kc, qk[u]);
          if constexpr (POS) {
            qr[u] = fmaf(q[c], Tq[c * KT + u], qr[u]);
            kr[u] = fmaf(kc, Tk[c * KT + u], kr[u]);
          }
        }
      }
      float lg = qk[u] * a[0] + a[1];
      if constexpr (POS) lg += (qr[u] * a[2] + a[3]) + (kr[u] * a[4] + a[5]);
      p[u] = u < nk ? expf(lg - m) * inv_l : 0.f;
    }
    for (int pp = 0; pp < GP; ++pp) {
      const float ds = DS[pp * nt + t];
      const float de = POS ? DE[pp * nt + t] : 0.f;
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        dsim[u] = fmaf(ds, Vs[(pp * KT + u) * kStripes + lane], dsim[u]);
        if constexpr (POS) {
          dsim[u] = fmaf(de, Tv[pp * KT + u], dsim[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      const float dl = p[u] * (dsim[u] - delta);
      const float d0 = dl * a[0], d2 = dl * a[2];
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          float tt = d0 * Ks[(c * KT + u) * kStripes + lane];
          if constexpr (POS) tt = fmaf(d2, Tq[c * KT + u], tt);
          dq[c] += tt;
        }
      }
      sums[0] = fmaf(dl, qk[u], sums[0]);
      sums[1] += dl;
      if constexpr (POS) {
        sums[2] = fmaf(dl, qr[u], sums[2]);
        sums[3] = fmaf(dl, kr[u], sums[3]);
      }
    }
  }
  if (live) {
    T* out = b.dqkv + (size_t)gi * 2 * GP * LS + (size_t)i * S + s;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) out[c * LS] = from_f32<T>(dq[c]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float v = warp_sum(sums[k]);
    if (lane == 0) red[y][k] = v;
  }
  __syncthreads();
  if (y == 0 && lane < 4) {
    float v = 0.f;
    for (int r = 0; r < R; ++r) v += red[r][lane];
    const size_t slot = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    b.aff_part[(slot * b.g + gi) * 4 + lane] = v;
  }
}

template <int CM, class T>
__global__ void __launch_bounds__(kStripes * kTabMaxWarps, 2 * min_blocks(CM))
long_tab_kernel(BwdArgs<T> b) {
  constexpr int JT = kTabKeys;
  extern __shared__ float sm[];
  const wide::Lanes<T>& x = b.x;
  const int CH = blockDim.x, tid = threadIdx.x;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2;
  const int i = blockIdx.y, j0 = blockIdx.x * JT, nj = min(JT, L - j0);
  const int QW = C + 1, EW = GP + 1, NO = 2 * GP * JT;
  float* Qs = sm;                 // [t][QW]: q rows
  float* Es = Qs + CH * QW;       // [t][EW]: dsve rows
  float* DSt = Es + CH * EW;      // [p][t]: dsv rows
  float* Ps = DSt + GP * CH;      // [jj][t]
  float* Ds = Ps + JT * CH;       // [jj][t]: dlog
  float* Kt = Ds + JT * CH;       // [jj][t][QW]: k rows
  float* Acc = Kt + JT * CH * QW; // by out_index
  for (int e = tid; e < NO; e += CH) Acc[e] = 0.f;
  const size_t LS = (size_t)L * S;
  const int chunks = (S + CH - 1) / CH, units = b.g * chunks;
  for (int un = 0; un < units; ++un) {
    const int gi = un / chunks, s = (un % chunks) * CH + tid;
    __syncthreads();  // the last unit's sums are done
    if (s < S) {
      float a[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) a[k] = __ldg(b.aff + gi * 8 + k);
      float q[CM];
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        q[c] = c < C ? x.q(gi, c, i, s) : 0.f;
        if (c < C) Qs[tid * QW + c] = q[c];
      }
      const size_t row = ((size_t)gi * L + i) * S + s;
      const size_t o = (size_t)gi * GP * LS + (size_t)i * S + s;
      const float m = __ldg(b.m + row), inv_l = 1.f / __ldg(b.l + row);
      const float delta = b.delta[row];
      for (int p = 0; p < GP; ++p) {
        DSt[p * CH + tid] = __ldg(b.dsv + o + p * LS);
        Es[tid * EW + p] = __ldg(b.dsve + o + p * LS);
      }
      for (int jj = 0; jj < JT; ++jj) {
        float* kt = Kt + (jj * CH + tid) * QW;
        if (jj >= nj) {
          Ps[jj * CH + tid] = Ds[jj * CH + tid] = 0.f;
          for (int c = 0; c < C; ++c) kt[c] = 0.f;
          continue;
        }
        const int j = j0 + jj;
        // k's and v's rows and the table entries by pointers that step a
        // channel at a time
        const T* kp = x.qkv + (((size_t)gi * 2 * GP + C) * L + j) * S + s;
        const T* vp = kp + (size_t)C * LS;
        const float* tq = x.qemb + (size_t)i * L + j;
        const float* tk = x.kemb_t + (size_t)i * L + j;
        const float* tv = x.vemb + (size_t)i * L + j;
        const size_t LL = (size_t)L * L;
        float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
        for (int c = 0; c < CM; ++c) {
          if (c < C) {
            const float kv = wide::ld(kp);
            kt[c] = kv;
            qk = fmaf(q[c], kv, qk);
            qr = fmaf(q[c], __ldg(tq), qr);
            kr = fmaf(kv, __ldg(tk), kr);
            kp += LS;
            tq += LL;
            tk += LL;
          }
        }
        const float lg = qk * a[0] + a[1] + (qr * a[2] + a[3]) +
                         (kr * a[4] + a[5]);
        const float p = expf(lg - m) * inv_l;
        float d = 0.f;
        for (int pp = 0; pp < GP; ++pp) {
          d = fmaf(DSt[pp * CH + tid], wide::ld(vp), d);
          d = fmaf(Es[tid * EW + pp], __ldg(tv), d);
          vp += LS;
          tv += LL;
        }
        Ps[jj * CH + tid] = p;
        Ds[jj * CH + tid] = p * (d - delta);
      }
    } else {  // past the last stripe: adds nothing
      for (int c = 0; c < C; ++c) Qs[tid * QW + c] = 0.f;
      for (int p = 0; p < GP; ++p) Es[tid * EW + p] = 0.f;
      for (int jj = 0; jj < JT; ++jj) {
        Ps[jj * CH + tid] = Ds[jj * CH + tid] = 0.f;
        for (int c = 0; c < C; ++c) Kt[(jj * CH + tid) * QW + c] = 0.f;
      }
    }
    __syncthreads();
    const float a2 = __ldg(b.aff + gi * 8 + 2), a4 = __ldg(b.aff + gi * 8 + 4);
    // outputs kind by kind (dqemb, dkemb_t, dvemb), channel fastest, so a
    // warp's lanes mostly share a kind and a key and read consecutive
    // channels
    for (int e = tid; e < NO; e += CH) {
      int ch, jj;
      out_index(e, C, GP, ch, jj);
      if (jj >= nj) continue;
      const float* w = (ch < 2 * C ? Ds : Ps) + jj * CH;
      const float* col = ch < C ? Qs + ch
                         : ch < 2 * C ? Kt + jj * CH * QW + (ch - C)
                                      : Es + (ch - 2 * C);
      const int stride = ch < 2 * C ? QW : EW;
      float v0 = 0.f, v1 = 0.f;
      int tt = 0;
      for (; tt + 1 < CH; tt += 2) {
        v0 = fmaf(w[tt], col[tt * stride], v0);
        v1 = fmaf(w[tt + 1], col[(tt + 1) * stride], v1);
      }
      float v = v0 + v1;
      if (ch < C) {
        v *= a2;
      } else if (ch < 2 * C) {
        v *= a4;
      }
      Acc[e] += v;
    }
  }
  __syncthreads();
  for (int e = tid; e < NO; e += CH) {
    int ch, jj;
    out_index(e, C, GP, ch, jj);
    if (jj < nj) b.dtables[((size_t)ch * L + i) * L + j0 + jj] = Acc[e];
  }
}

// launches 1-3 (the column pass from csrc/axial_wide_long_col.cu); the
// row pass's slots in *slots
template <int CM, bool POS, class T>
cudaError_t launch(const BwdArgs<T>& b, int* slots, cudaStream_t stream) {
  const wide::Lanes<T>& x = b.x;
  const int L = x.L, S = x.S, GP = x.gp;
  const int sx = (S + kStripes - 1) / kStripes;
  const int Rr = pick_rows([&](int r) { return row_floats(GP, POS, r); });
  if (Rr == 0) return cudaErrorInvalidValue;
  const size_t smem_r = (size_t)row_floats(GP, POS, Rr) * sizeof(float);
  auto row = long_row_kernel<CM, POS, T>;
  // the opt-in covers the block's static daff sums too
  cudaError_t err =
      flash2::allow_smem(row, smem_r + sizeof(float) * kMaxRows * 4);
  if (err != cudaSuccess) return err;
  *slots = ((L + Rr - 1) / Rr) * sx;
  row<<<dim3(sx, (L + Rr - 1) / Rr, b.g), dim3(kStripes, Rr), smem_r,
        stream>>>(b);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = long_col(x.qkv, x.qemb, x.kemb_t, x.vemb, b.aff, b.m, b.l, b.dsv,
                 b.dsve, b.delta, b.dqkv, b.g, GP, L, S, POS, stream);
  if (err != cudaSuccess || !POS) return err;
  const int nw = pick_rows([&](int r) {
    return r <= kTabMaxWarps ? tab_floats(GP, r * kStripes) : INT_MAX / 4;
  });
  if (nw == 0) return cudaErrorInvalidValue;
  const size_t smem_t = (size_t)tab_floats(GP, nw * kStripes) * sizeof(float);
  auto tab = long_tab_kernel<CM, T>;
  err = flash2::allow_smem(tab, smem_t);
  if (err != cudaSuccess) return err;
  tab<<<dim3((L + kTabKeys - 1) / kTabKeys, L), nw * kStripes, smem_t,
        stream>>>(b);
  return cudaGetLastError();
}

template <int CM, class T>
cudaError_t launch_cm(const BwdArgs<T>& b, bool pos, int* slots,
                      cudaStream_t stream) {
  return pos ? launch<CM, true>(b, slots, stream)
             : launch<CM, false>(b, slots, stream);
}

template <class T>
int bwd(const T* qkv, const float* qemb, const float* kemb_t,
        const float* vemb, const float* aff, const float* m, const float* l,
        const float* sv, const float* sve, const float* dsv,
        const float* dsve, T* dqkv, float* dtables, float* daff,
        float* delta, float* aff_part, int g, int gp, int L, int S,
        int has_pos, int n_aff_part, void* stream_ptr) {
  if (!geometry_ok(g, gp, L, S) || n_aff_part != slot_capacity(L, S)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool pos = has_pos != 0;
  const BwdArgs<T> b{{qkv, qemb, kemb_t, vemb, gp, L, S},
                     aff, m, l, sv, sve, dsv, dsve, dqkv, dtables, delta,
                     aff_part, g};
  int slots = 0;
  cudaError_t err;
  switch (wide::cm_bucket(gp / 2)) {
    case 8: err = launch_cm<8>(b, pos, &slots, stream); break;
    case 16: err = launch_cm<16>(b, pos, &slots, stream); break;
    case 32: err = launch_cm<32>(b, pos, &slots, stream); break;
    default: err = launch_cm<64>(b, pos, &slots, stream); break;
  }
  if (err != cudaSuccess) return (int)err;
  medt::bwd_finalize(nullptr, nullptr, 0, 0, aff_part, daff, slots, g,
                     has_pos, stream);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wide_long

extern "C" {

// Spans 1..256 (the model routes 65..256 here), every even gp up to 128.
// m, l, sv, sve are the forward's saved outputs; dtables (2gp, L, L) is not
// written without positions; delta holds g * L * S floats; aff_part
// (n_aff_part, g, 4), n_aff_part = L * ceil(S/32) (slot_capacity).
int medt_wide_long_bwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, const float* m, const float* l,
                       const float* sv, const float* sve, const float* dsv,
                       const float* dsve, float* dqkv, float* dtables,
                       float* daff, float* delta, float* aff_part, int g,
                       int gp, int L, int S, int has_pos, int n_aff_part,
                       void* stream) {
  return wide_long::bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv,
                        dsve, dqkv, dtables, daff, delta, aff_part, g, gp, L,
                        S, has_pos, n_aff_part, stream);
}

// The same on bf16 qkv: the table and daff gradients are the float32 entry
// point's on the upcast qkv, dqkv (bf16) its dqkv rounded once.
int medt_wide_long_bwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                            const float* kemb_t, const float* vemb,
                            const float* aff, const float* m, const float* l,
                            const float* sv, const float* sve,
                            const float* dsv, const float* dsve,
                            __nv_bfloat16* dqkv, float* dtables, float* daff,
                            float* delta, float* aff_part, int g, int gp,
                            int L, int S, int has_pos, int n_aff_part,
                            void* stream) {
  return wide_long::bwd(qkv, qemb, kemb_t, vemb, aff, m, l, sv, sve, dsv,
                        dsve, dqkv, dtables, daff, delta, aff_part, g, gp, L,
                        S, has_pos, n_aff_part, stream);
}

}  // extern "C"
