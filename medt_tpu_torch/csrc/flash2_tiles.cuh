// Tile staging shared by the tiled flash and flash2 forward
// (csrc/tiled_fwd.cuh) and backward (csrc/tiled_bwd.cuh), the lanes
// backward (csrc/axial_lanes_bwd.cu) and the moments backward
// (csrc/moments.cu).
//
// A block copies the tiles it is about to compute on from device memory into
// shared memory with cp.async, into a ring of kStages slots, so the next key
// (or query) block is in flight while this one is computed. Every tile is a
// box of (A, B, X) elements whose X run is contiguous in device memory (the
// stripe axis of qkv-shaped tensors, the key axis of the (i, j) tables);
// elements past the valid edge of B or X are zero-filled by the copy itself.
//
// The elements are float, or bf16 for the qkv operand of the bf16 entry
// points: a kernel templated on qkv's element type T stages raw T (a
// 16-byte copy holds kChunk<T> elements, 4 floats or 8 bf16) and converts
// each value to float where it reads it (to_f32), which is exact, so its
// arithmetic is the float32 kernel's on the upcast input.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace flash2 {
namespace {

constexpr int kStages = 2;                 // cp.async ring depth
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// elements of T per 16-byte copy
template <class T>
constexpr int kChunk = 16 / (int)sizeof(T);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a float result stored as T: bf16 rounds to nearest even, once
template <class T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
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

// One element: a 4-byte cp.async for a float; a 2-byte bf16 is below
// cp.async's least size and is copied by the thread (zero when !valid),
// which the caller's cp_async_wait and __syncthreads order like the rest.
template <class T>
__device__ __forceinline__ void copy_elem(T* dst, const T* src, bool valid) {
  if constexpr (sizeof(T) == 4) {
    cp_async4(dst, src, valid);
  } else {
    *dst = valid ? *src : from_f32<T>(0.f);
  }
}

// Stage the box (A, B, X) of T (float or bf16): element (a, b, x) comes
// from src[a * sa + b * sb + x] and lands at dst[(a * B + b) * XP + x] (XP =
// X unless the caller pads the rows against bank conflicts); it is zero
// where b >= vb or x >= vx. X and XP are multiples of kChunk<T>. With vec
// the copies are 16 bytes (the caller guarantees 16-byte aligned runs and
// vx % kChunk<T> == 0, so a chunk is all valid or all past the edge), else
// one element each (copy_elem). NT threads share the work; tid is this
// thread's index among them.
template <int A, int B, int X, int NT, int XP = X, class T>
__device__ __forceinline__ void stage(T* dst, const T* src, size_t sa,
                                      size_t sb, int vb, int vx, bool vec,
                                      int tid) {
  constexpr int V = kChunk<T>;
  static_assert(X % V == 0 && XP % V == 0 && XP >= X,
                "runs of whole 16-byte chunks");
  if (vec) {
    constexpr int XV = X / V, N = A * B * XV;
#pragma unroll 4
    for (int e = tid; e < N; e += NT) {
      const int x = (e % XV) * V, ab = e / XV, b = ab % B, a = ab / B;
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
      copy_elem(dst + ab * XP + x, ok ? src + a * sa + b * sb + x : src, ok);
    }
  }
}

// Stage nb runs of X elements of T, nb known only at run time: run b comes
// from src[b * sb + x] and lands at dst[b * X + x], zero where x >= vx.
// Copies as in stage(): 16 bytes with vec (aligned runs, vx % kChunk<T> ==
// 0), else one element each.
template <int X, int NT, class T>
__device__ __forceinline__ void stage_runs(T* dst, const T* src, size_t sb,
                                           int nb, int vx, bool vec,
                                           int tid) {
  constexpr int V = kChunk<T>;
  static_assert(X % V == 0, "runs of whole 16-byte chunks");
  if (vec) {
    constexpr int XV = X / V;
    const int n = nb * XV;
#pragma unroll 4
    for (int e = tid; e < n; e += NT) {
      const int x = (e % XV) * V, b = e / XV;
      const bool ok = x < vx;
      cp_async16(dst + b * X + x, ok ? src + b * sb + x : src, ok);
    }
  } else {
    const int n = nb * X;
#pragma unroll 4
    for (int e = tid; e < n; e += NT) {
      const int x = e % X, b = e / X;
      const bool ok = x < vx;
      copy_elem(dst + b * X + x, ok ? src + b * sb + x : src, ok);
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

// n consecutive bf16 of shared memory into registers as floats, as 8-byte
// loads where n allows (p is 8-byte aligned when n % 4 == 0).
template <int N>
__device__ __forceinline__ void lds(float (&out)[N], const __nv_bfloat16* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p + k);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&v.y));
      out[k] = lo.x;
      out[k + 1] = lo.y;
      out[k + 2] = hi.x;
      out[k + 3] = hi.y;
    }
  } else if constexpr (N == 2) {
    const float2 v =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = v.x;
    out[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) out[k] = to_f32(p[k]);
  }
}

}  // namespace
}  // namespace flash2
