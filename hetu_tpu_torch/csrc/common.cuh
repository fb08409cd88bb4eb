// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <initializer_list>

#define HETU_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Round once from fp32 to the storage type (round-to-nearest-even, as
// torch's .to(bfloat16) and .to(float16) do; past fp16's largest finite
// value, 65504, the rounding gives inf, as torch's does).
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// N values of T moved as one access of N * sizeof(T) bytes: 16 in a
// kernel's vector arm (8 bf16 or fp16, 4 fp32), one element in its scalar
// arm.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Whether every pointer starts on a 16-byte boundary.
inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<unsigned long long>(p) % 16) return false;
  return true;
}

// Blocks of `threads` that the current device keeps resident at once:
// one wave of `kernel` over every SM.
template <typename K>
int wave_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Grid size for a grid-stride loop over n items.
inline unsigned grid_for(long long n, int threads, long long cap = 65535) {
  long long blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned>(blocks < cap ? blocks : cap);
}
