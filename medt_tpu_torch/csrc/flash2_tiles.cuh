// Tile staging shared by the tiled flash and flash2 forward
// (csrc/tiled_fwd.cuh) and backward (csrc/tiled_bwd.cuh), the lanes
// backward (csrc/axial_lanes_bwd.cu) and the moments backward
// (csrc/moments.cu).
//
// A block copies the tiles it is about to compute on from device memory into
// shared memory with cp.async, into a ring of kStages slots, so the next key
// (or query) block is in flight while this one is computed. Every tile is a
// box of (A, B, X) floats whose X run is contiguous in device memory (the
// stripe axis of qkv-shaped tensors, the key axis of the (i, j) tables);
// elements past the valid edge of B or X are zero-filled by the copy itself.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace flash2 {
namespace {

constexpr int kStages = 2;                 // cp.async ring depth
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage the box (A, B, X): element (a, b, x) comes from
// src[a * sa + b * sb + x] and lands at dst[(a * B + b) * XP + x] (XP = X
// unless the caller pads the rows against bank conflicts); it is zero where
// b >= vb or x >= vx. X and XP are multiples of 4. With vec the copies are
// 16 bytes (the caller guarantees 16-byte aligned runs and vx % 4 == 0, so a
// chunk is all valid or all past the edge), else 4 bytes each. NT threads
// share the work; tid is this thread's index among them.
template <int A, int B, int X, int NT, int XP = X>
__device__ __forceinline__ void stage(float* dst, const float* src, size_t sa,
                                      size_t sb, int vb, int vx, bool vec,
                                      int tid) {
  static_assert(X % 4 == 0 && XP % 4 == 0 && XP >= X,
                "runs of whole 16-byte chunks");
  if (vec) {
    constexpr int X4 = X / 4, N = A * B * X4;
#pragma unroll 4
    for (int e = tid; e < N; e += NT) {
      const int x = (e % X4) * 4, ab = e / X4, b = ab % B, a = ab / B;
      const bool ok = b < vb && x < vx;
      cp_async16(dst + ab * XP + x, ok ? src + a * sa + b * sb + x : src,
                 ok);
    }
  } else {
    constexpr int N = A * B * X;
#pragma unroll 4
    for (int e = tid; e < N; e += NT) {
      const int x = e % X, ab = e / X, b = ab % B, a = ab / B;
      const bool ok = b < vb && x < vx;
      cp_async4(dst + ab * XP + x, ok ? src + a * sa + b * sb + x : src, ok);
    }
  }
}

// Stage nb runs of X floats, nb known only at run time: run b comes from
// src[b * sb + x] and lands at dst[b * X + x], zero where x >= vx. Copies
// as in stage(): 16 bytes with vec (aligned runs, vx % 4 == 0), else 4.
template <int X, int NT>
__device__ __forceinline__ void stage_runs(float* dst, const float* src,
                                           size_t sb, int nb, int vx,
                                           bool vec, int tid) {
  static_assert(X % 4 == 0, "runs of whole 16-byte chunks");
  if (vec) {
    constexpr int X4 = X / 4;
    const int n = nb * X4;
#pragma unroll 4
    for (int e = tid; e < n; e += NT) {
      const int x = (e % X4) * 4, b = e / X4;
      const bool ok = x < vx;
      cp_async16(dst + b * X + x, ok ? src + b * sb + x : src, ok);
    }
  } else {
    const int n = nb * X;
#pragma unroll 4
    for (int e = tid; e < n; e += NT) {
      const int x = e % X, b = e / X;
      const bool ok = x < vx;
      cp_async4(dst + b * X + x, ok ? src + b * sb + x : src, ok);
    }
  }
}

// 2^x as one MUFU.EX2 (about 2 ulp, as exp2f; results under 2^-126 flush
// to 0, which no softmax weight beside its row max needs). exp2f without
// fast math adds a range test and two multiplies around it.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// n consecutive floats of shared memory into registers, as 16-byte loads
// where n allows (p is 16-byte aligned when n % 4 == 0).
template <int N>
__device__ __forceinline__ void lds(float (&out)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      out[k] = v.x;
      out[k + 1] = v.y;
      out[k + 2] = v.z;
      out[k + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = p[k];
  }
}

}  // namespace
}  // namespace flash2
