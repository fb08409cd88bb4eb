// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define HETU_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Round once from fp32 to the storage type (round-to-nearest-even, as
// torch's .to(bfloat16) does).
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Grid size for a grid-stride loop over n items.
inline unsigned grid_for(long long n, int threads, long long cap = 65535) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}
