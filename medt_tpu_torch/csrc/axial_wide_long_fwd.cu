// Forward of the long-span attention at wide group planes (spans up to 256,
// every even gp up to 128 outside 2, 4, 8 and 16), for Hopper (sm_90a).
// What it replaces, its contract and its design: csrc/wide_long.cuh.
//
// A thread owns one (group, query row, stripe); a block 32 stripes and R
// query rows (fwd_floats, pick_rows). Per tile of KT keys the block stages
// the keys' k and v rows of its 32 stripes and its rows' table entries;
// each thread then forms the tile's logits from its q row (registers) and
// the staged k and tables, takes the tile's max, rescales its sv and sve
// accumulators (shared memory) and l once, and adds the tile's weighted v
// and vemb terms in key order. At the end each accumulator is divided by
// l; m and l are written for the backward.
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise; the entry points return the launch's CUDA error.

#include "wide_long.cuh"

namespace wide_long {
namespace {

// shared memory of a forward block of R rows: the k and v tile, the table
// tile, the sv (and sve) accumulators
inline int fwd_floats(int gp, bool pos, int R) {
  const int C = gp / 2, KT = key_tile(wide::cm_bucket(C));
  return (C + gp) * KT * kStripes + (pos ? (2 * C + gp) * R * KT : 0) +
         (pos ? 2 : 1) * gp * kStripes * R;
}

template <int CM, bool POS, class T>
__global__ void __launch_bounds__(kStripes * kMaxRows, min_blocks(CM))
long_fwd_kernel(wide::Lanes<T> x, const float* __restrict__ aff,
                float* __restrict__ sv, float* __restrict__ sve,
                float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int KT = key_tile(CM);
  extern __shared__ float sm[];
  const int R = blockDim.y, nt = kStripes * R;
  const int lane = threadIdx.x, y = threadIdx.y, t = y * kStripes + lane;
  const int L = x.L, S = x.S, GP = x.gp, C = GP / 2;
  const int s0 = blockIdx.x * kStripes, i0 = blockIdx.y * R;
  const int gi = blockIdx.z, s = s0 + lane, i = i0 + y;
  const bool live = s < S && i < L;
  float* Ks = sm;                               // [c][u][lane]
  float* Vs = Ks + C * KT * kStripes;           // [p][u][lane]
  float* Ts = Vs + GP * KT * kStripes;          // [r][ch][u], positions
  float* Acc = Ts + (POS ? (2 * C + GP) * R * KT : 0);  // [ch][t]
  // this row's table tile: qemb, kemb_t, vemb rows at fixed offsets
  const int NCH = 2 * C + GP;
  const float* Tq = Ts + y * NCH * KT;
  const float* Tk = Tq + C * KT;
  const float* Tv = Tk + C * KT;
  float a[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) a[k] = __ldg(aff + gi * 8 + k);
  float q[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) q[c] = live && c < C ? x.q(gi, c, i, s) : 0.f;
  for (int p = 0; p < (POS ? 2 : 1) * GP; ++p) Acc[p * nt + t] = 0.f;
  float m = -3.0e38f, l = 0.f;
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
    float w[KT];
    float mt = m;
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      float qk = 0.f, qr = 0.f, kr = 0.f;
#pragma unroll
      for (int c = 0; c < CM; ++c) {
        if (c < C) {
          const float kc = Ks[(c * KT + u) * kStripes + lane];
          qk = fmaf(q[c], kc, qk);
          if constexpr (POS) {
            qr = fmaf(q[c], Tq[c * KT + u], qr);
            kr = fmaf(kc, Tk[c * KT + u], kr);
          }
        }
      }
      float lg = qk * a[0] + a[1];
      if constexpr (POS) lg += (qr * a[2] + a[3]) + (kr * a[4] + a[5]);
      w[u] = u < nk ? lg : -3.0e38f;
      mt = fmaxf(mt, w[u]);
    }
    const float scale = expf(m - mt);
    m = mt;
    float lt = 0.f;
#pragma unroll
    for (int u = 0; u < KT; ++u) {
      w[u] = u < nk ? expf(w[u] - m) : 0.f;
      lt += w[u];
    }
    l = fmaf(l, scale, lt);
    for (int p = 0; p < GP; ++p) {
      float av = Acc[p * nt + t] * scale;
#pragma unroll
      for (int u = 0; u < KT; ++u) {
        av = fmaf(w[u], Vs[(p * KT + u) * kStripes + lane], av);
      }
      Acc[p * nt + t] = av;
      if constexpr (POS) {
        float ae = Acc[(GP + p) * nt + t] * scale;
#pragma unroll
        for (int u = 0; u < KT; ++u) {
          ae = fmaf(w[u], Tv[p * KT + u], ae);
        }
        Acc[(GP + p) * nt + t] = ae;
      }
    }
  }
  if (!live) return;
  const float inv_l = 1.f / l;
  const size_t LS = (size_t)L * S;
  const size_t o = (size_t)gi * GP * LS + (size_t)i * S + s;
  for (int p = 0; p < GP; ++p) {
    sv[o + p * LS] = Acc[p * nt + t] * inv_l;
    if constexpr (POS) sve[o + p * LS] = Acc[(GP + p) * nt + t] * inv_l;
  }
  m_out[((size_t)gi * L + i) * S + s] = m;
  l_out[((size_t)gi * L + i) * S + s] = l;
}

template <int CM, bool POS, class T>
cudaError_t launch(const wide::Lanes<T>& x, const float* aff, float* sv,
                   float* sve, float* m, float* l, int g,
                   cudaStream_t stream) {
  const int R = pick_rows([&](int r) { return fwd_floats(x.gp, POS, r); });
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = (size_t)fwd_floats(x.gp, POS, R) * sizeof(float);
  auto kernel = long_fwd_kernel<CM, POS, T>;
  const cudaError_t err = flash2::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((x.S + kStripes - 1) / kStripes, (x.L + R - 1) / R, g);
  kernel<<<grid, dim3(kStripes, R), smem, stream>>>(x, aff, sv, sve, m, l);
  return cudaGetLastError();
}

template <int CM, class T>
cudaError_t launch_cm(const wide::Lanes<T>& x, const float* aff, float* sv,
                      float* sve, float* m, float* l, int g, bool pos,
                      cudaStream_t stream) {
  return pos ? launch<CM, true>(x, aff, sv, sve, m, l, g, stream)
             : launch<CM, false>(x, aff, sv, sve, m, l, g, stream);
}

template <class T>
int fwd(const T* qkv, const float* qemb, const float* kemb_t,
        const float* vemb, const float* aff, float* sv, float* sve, float* m,
        float* l, int g, int gp, int L, int S, int has_pos, void* stream_ptr) {
  if (!geometry_ok(g, gp, L, S)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool pos = has_pos != 0;
  const wide::Lanes<T> x{qkv, qemb, kemb_t, vemb, gp, L, S};
  switch (wide::cm_bucket(gp / 2)) {
    case 8: return (int)launch_cm<8>(x, aff, sv, sve, m, l, g, pos, stream);
    case 16: return (int)launch_cm<16>(x, aff, sv, sve, m, l, g, pos, stream);
    case 32: return (int)launch_cm<32>(x, aff, sv, sve, m, l, g, pos, stream);
    default: return (int)launch_cm<64>(x, aff, sv, sve, m, l, g, pos, stream);
  }
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
