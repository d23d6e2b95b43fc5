// Shared device helpers for the hand-written Hopper kernels.
//
// Conversions between bf16 and float go through the intrinsics only
// (__bfloat162float / __float2bfloat16), so the sources also compile
// under -D__CUDA_NO_BFLOAT16_CONVERSIONS__.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptk {

// dtype codes shared with the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// Load VEC consecutive elements starting at p into fp32 registers. When
// the VEC elements span whole 16-byte (or one 8-byte) words, the load is
// vectorised; the caller guarantees p is aligned to that width.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      const uint4 u = reinterpret_cast<const uint4*>(p)[c];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < kPer; ++k) out[c * kPer + k] = to_float(e[k]);
    }
  } else if constexpr (kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_float(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = to_float(p[k]);
  }
}

// Store VEC fp32 values as T; vectorised under the same rule as load_vec.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&in)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c) {
      uint4 u;
      T* e = reinterpret_cast<T*>(&u);
#pragma unroll
      for (int k = 0; k < kPer; ++k) e[k] = from_float<T>(in[c * kPer + k]);
      reinterpret_cast<uint4*>(p)[c] = u;
    }
  } else if constexpr (kBytes == 8) {
    uint2 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int k = 0; k < VEC; ++k) e[k] = from_float<T>(in[k]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = from_float<T>(in[k]);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block (blockDim.x a multiple of 32, at most 1024):
// a shuffle reduction in each warp, then one across the warps' partial
// sums in shared memory. Every thread gets the total.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float partial[32];
  __shared__ float total;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float s = lane < nwarps ? partial[lane] : 0.f;
    s = warp_sum(s);
    if (lane == 0) total = s;
  }
  __syncthreads();
  return total;
}

}  // namespace ptk

// Error text for a code returned by an entry point (each library
// exports its own copy; they are loaded privately).
extern "C" const char* ptk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
