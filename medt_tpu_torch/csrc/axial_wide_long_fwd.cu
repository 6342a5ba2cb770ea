// Forward of the long-span attention at wide group planes (spans up to 256,
// every even gp up to 128 outside 2, 4, 8 and 16), for Hopper (sm_90a).
// What it replaces, its contract and its design: csrc/wide_long.cuh.
//
// long_fwd_kernel: a block of kThreads owns one group, 32 stripes (lane =
// stripe), RB query rows (RT a thread) and one chunk of at most
// fwd_planes(CM) value planes (grid axis y: row tile x chunk). Per tile of
// KT keys (a ring of one to three cp.async slots) the block stages the
// keys' k rows and its chunk's v rows of its 32 stripes and, with
// positions, its rows' qemb, kemb_t and (chunk) vemb entries
// ([row][channel][key]); each
// thread forms the tile's RT x KT logits from its q rows (registers), the
// staged k (a0 k and a4 k once a key, shared by the rows) and 16-byte
// table broadcasts as sum_c q (a0 k + a2 qemb) + a4 k kemb_t + (a1 + a3 +
// a5), takes the tile's max, rescales its accumulators and l once and adds
// the tile's weighted v and vemb terms in key order. Its sv and sve
// accumulators stay in registers. At the end each is divided by l; the
// first chunk's blocks write m and l.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry points return the launch's CUDA error.

#include "wide_long.cuh"

namespace wide_long {
namespace {

template <int CM, bool EX, bool POS, class T>
__global__ void __launch_bounds__(kThreads, fwd_blocks(CM))
long_fwd_kernel(wide::Lanes<T> x, const float* __restrict__ aff,
                float* __restrict__ sv, float* __restrict__ sve,
                float* __restrict__ m_out, float* __restrict__ l_out, int pc,
                int nchunk, int nslot, bool vec) {
  constexpr int RT = fwd_rows(CM), KT = fwd_keys(CM), PM = fwd_planes(CM);
  constexpr int RB = kWarps * RT;
  extern __shared__ __align__(16) float sm[];
  const int L = x.L, S = x.S, C = EX ? CM : x.gp / 2, GP = 2 * C;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int s0 = blockIdx.x * kStripes, s = s0 + lane;
  const int rt = blockIdx.y / nchunk, ck = blockIdx.y - rt * nchunk;
  const int i0 = rt * RB, rw = w * RT;  // the block's first row; the warp's
  const int pv0 = ck * pc;
  const int np = EX && PM >= 2 * CM ? 2 * CM : min(pc, GP - pv0);
  const int gi = blockIdx.z;
  const int nch = 2 * C + np;
  const int kf = C * KT * kStripes, vf = np * KT * kStripes;
  const int tf = POS ? RB * nch * KT : 0;
  const int slot_f = kf + vf + tf + raw_floats<T>(C + np, KT, vec);
  float a[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = __ldg(aff + gi * 8 + k);
  const float cst = POS ? a[1] + a[3] + a[5] : a[1];
  float q[RT][CM];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int i = i0 + rw + r;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      q[r][c] = c < C && i < L && s < S ? x.q(gi, c, i, s) : 0.f;
    }
  }
  float acc[RT][PM], ace[RT][POS ? PM : 1];
  float mr[RT], lr[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    mr[r] = -3.0e38f;
    lr[r] = 0.f;
#pragma unroll
    for (int p = 0; p < PM; ++p) {
      acc[r][p] = 0.f;
      if constexpr (POS) ace[r][p] = 0.f;
    }
  }
  const int ntile = (L + KT - 1) / KT;
  auto issue = [&](int it) {
    float* base = sm + (it % nslot) * slot_f;
    const int j0 = it * KT;
    float* raw = base + kf + vf + tf;
    stage_rows<KT>(x, base, raw, gi, C, C, j0, s0, kStripes, vec, t,
                   kThreads);
    stage_rows<KT>(x, base + kf, raw + raw_floats<T>(C, KT, vec), gi, GP + pv0,
                   np, j0, s0, kStripes, vec, t, kThreads);
    if constexpr (POS) {
      stage_tables<KT>(x, base + kf + vf, i0, RB, pv0, np, j0, false, t,
                       kThreads);
    }
    flash2::cp_async_commit();
  };
  for (int it = 0; it < max(nslot - 1, 1) && it < ntile; ++it) issue(it);
  for (int it = 0; it < ntile; ++it) {
    if (nslot > 1 && it + nslot - 1 < ntile) issue(it + nslot - 1);
    ring_wait(ring_later(nslot, it, ntile));
    float* slot = sm + (it % nslot) * slot_f;
    float* raw = slot + kf + vf + tf;
    convert_rows<KT, T>(slot, raw, C, kStripes, vec, t, kThreads);
    convert_rows<KT, T>(slot + kf, raw + raw_floats<T>(C, KT, vec), np,
                        kStripes, vec, t, kThreads);
    __syncthreads();
    const float* Ks = slot;
    const float* Vs = Ks + kf;
    const float* Ts = Vs + vf;
    const int j0 = it * KT;
    float wv[RT][KT];
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int u = 0; u < KT; ++u) wv[r][u] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        float k0[KT], k4[KT];
#pragma unroll
        for (int u = 0; u < KT; ++u) {
          const float kc = Ks[(c * KT + u) * kStripes + lane];
          k0[u] = kc * a[0];
          k4[u] = kc * a[4];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          if constexpr (POS) {
            float tq[KT], tk[KT];
            load_row<KT>(Ts + ((rw + r) * nch + c) * KT, tq);
            load_row<KT>(Ts + ((rw + r) * nch + C + c) * KT, tk);
#pragma unroll
            for (int u = 0; u < KT; ++u) {
              wv[r][u] = fmaf(q[r][c], fmaf(a[2], tq[u], k0[u]), wv[r][u]);
              wv[r][u] = fmaf(k4[u], tk[u], wv[r][u]);
            }
          } else {
#pragma unroll
            for (int u = 0; u < KT; ++u) {
              wv[r][u] = fmaf(q[r][c], k0[u], wv[r][u]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mt = mr[r];
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        wv[r][u] = j0 + u < L ? wv[r][u] + cst : -3.0e38f;
        mt = fmaxf(mt, wv[r][u]);
      }
      const float scale = fexp(mr[r] - mt);
      mr[r] = mt;
      float lt = 0.f;
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        wv[r][u] = j0 + u < L ? fexp(wv[r][u] - mt) : 0.f;
        lt += wv[r][u];
      }
      lr[r] = fmaf(lr[r], scale, lt);
#pragma unroll
      for (int p = 0; p < PM; ++p) {
        if (p < np) {
          acc[r][p] *= scale;
          if constexpr (POS) ace[r][p] *= scale;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < PM; ++p) {
      if (p < np) {
        float vv[KT];
#pragma unroll
        for (int u = 0; u < KT; ++u) {
          vv[u] = Vs[(p * KT + u) * kStripes + lane];
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int u = 0; u < KT; ++u) {
            acc[r][p] = fmaf(wv[r][u], vv[u], acc[r][p]);
          }
          if constexpr (POS) {
            float tv[KT];
            load_row<KT>(Ts + ((rw + r) * nch + 2 * C + p) * KT, tv);
#pragma unroll
            for (int u = 0; u < KT; ++u) {
              ace[r][p] = fmaf(wv[r][u], tv[u], ace[r][p]);
            }
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
    const int i = i0 + rw + r;
    if (i >= L) continue;
    const float inv_l = 1.f / lr[r];
    const size_t o = ((size_t)gi * GP + pv0) * LS + (size_t)i * S + s;
#pragma unroll
    for (int p = 0; p < PM; ++p) {
      if (p < np) {
        sv[o + p * LS] = acc[r][p] * inv_l;
        if constexpr (POS) sve[o + p * LS] = ace[r][p] * inv_l;
      }
    }
    if (ck == 0) {
      m_out[((size_t)gi * L + i) * S + s] = mr[r];
      l_out[((size_t)gi * L + i) * S + s] = lr[r];
    }
  }
}

template <int CM, bool EX, bool POS, class T>
cudaError_t launch(const wide::Lanes<T>& x, const float* aff, float* sv,
                   float* sve, float* m, float* l, int g,
                   cudaStream_t stream) {
  constexpr int RT = fwd_rows(CM), KT = fwd_keys(CM), PM = fwd_planes(CM);
  constexpr int RB = kWarps * RT;
  const int C = x.gp / 2, nchunk = (x.gp + PM - 1) / PM;
  const int pc = (x.gp + nchunk - 1) / nchunk;
  bool vec = x.S % flash2::kChunk<T> == 0 && flash2::aligned16(x.qkv);
  auto slot_floats = [&] {
    return (long long)(C + pc) * KT * kStripes +
           (POS ? (long long)RB * (2 * C + pc) * KT : 0) +
           raw_floats<T>(C + pc, KT, vec);
  };
  int nslot = pick_slots(0, slot_floats(), fwd_blocks(CM));
  if (nslot == 0 && raw_floats<T>(1, KT, vec) > 0) {  // bf16 by loads
    vec = false;
    nslot = pick_slots(0, slot_floats(), fwd_blocks(CM));
  }
  if (nslot == 0) return cudaErrorInvalidValue;
  const long long slot = slot_floats();
  const size_t smem = (size_t)nslot * slot * sizeof(float);
  auto kernel = long_fwd_kernel<CM, EX, POS, T>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(stripe_tiles(x.S), ((x.L + RB - 1) / RB) * nchunk, g);
  kernel<<<grid, kThreads, smem, stream>>>(x, aff, sv, sve, m, l, pc, nchunk,
                                           nslot, vec);
  return cudaGetLastError();
}

template <int CM, class T>
cudaError_t launch_cm(const wide::Lanes<T>& x, const float* aff, float* sv,
                      float* sve, float* m, float* l, int g, bool pos,
                      cudaStream_t stream) {
  return pos ? launch<CM, false, true>(x, aff, sv, sve, m, l, g, stream)
             : launch<CM, false, false>(x, aff, sv, sve, m, l, g, stream);
}

template <class T>
int fwd(const T* qkv, const float* qemb, const float* kemb_t,
        const float* vemb, const float* aff, float* sv, float* sve, float* m,
        float* l, int g, int gp, int L, int S, int has_pos, void* stream_ptr) {
  if (!geometry_ok(g, gp, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool pos = has_pos != 0;
  const wide::Lanes<T> x{qkv, qemb, kemb_t, vemb, gp, L, S};
  cudaError_t err;
  if (pos && exact_c(gp) == 6) {  // the exact instances take positions only
    err = launch<6, true, true>(x, aff, sv, sve, m, l, g, stream);
  } else if (pos && exact_c(gp) == 12) {
    err = launch<12, true, true>(x, aff, sv, sve, m, l, g, stream);
  } else if (pos && exact_c(gp) == 16) {
    err = launch<16, true, true>(x, aff, sv, sve, m, l, g, stream);
  } else {
    switch (wide::cm_bucket(gp / 2)) {
      case 8:
        err = launch_cm<8>(x, aff, sv, sve, m, l, g, pos, stream);
        break;
      case 16:
        err = launch_cm<16>(x, aff, sv, sve, m, l, g, pos, stream);
        break;
      case 32:
        err = launch_cm<32>(x, aff, sv, sve, m, l, g, pos, stream);
        break;
      default:
        err = launch_cm<64>(x, aff, sv, sve, m, l, g, pos, stream);
        break;
    }
  }
  return (int)err;
}

}  // namespace
}  // namespace wide_long

extern "C" {

// Spans 1..256 (the model routes 65..256 here), every even gp up to 128;
// sve is not written when has_pos == 0; m and l are (g, L, S) each.
int medt_wide_long_fwd(const float* qkv, const float* qemb,
                       const float* kemb_t, const float* vemb,
                       const float* aff, float* sv, float* sve, float* m,
                       float* l, int g, int gp, int L, int S, int has_pos,
                       void* stream) {
  return wide_long::fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp,
                        L, S, has_pos, stream);
}

// The same on bf16 qkv: sv, sve, m and l (float32) are the float32 entry
// point's on the upcast qkv, bit for bit.
int medt_wide_long_fwd_bf16(const __nv_bfloat16* qkv, const float* qemb,
                            const float* kemb_t, const float* vemb,
                            const float* aff, float* sv, float* sve, float* m,
                            float* l, int g, int gp, int L, int S,
                            int has_pos, void* stream) {
  return wide_long::fwd(qkv, qemb, kemb_t, vemb, aff, sv, sve, m, l, g, gp,
                        L, S, has_pos, stream);
}

}  // extern "C"
