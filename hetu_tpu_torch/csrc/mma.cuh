// Tensor-core helpers shared by the port's 16-bit kernels (sm_90a):
// ldmatrix from shared memory and mma.sync.m16n8k16 with bf16 or fp16
// operands and fp32 accumulators.  An accumulator c[e] of a 16 x 8 tile
// holds row g + 8 (e >> 1) and column 2 tig + (e & 1), g = lane >> 2,
// tig = lane & 3.  ldmatrix moves 16-bit words whatever they hold, so
// one load serves both types; `mma16<T>` picks the product's operand
// type, so one kernel body serves both arms.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <type_traits>

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_f16(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a b with operands of the 16-bit type T (bf16 or fp16).
template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  static_assert(std::is_same<T, __nv_bfloat16>::value ||
                    std::is_same<T, __half>::value,
                "mma16 takes bf16 or fp16 operands");
  if constexpr (std::is_same<T, __half>::value) mma_f16(c, a, b0, b1);
  else mma_bf16(c, a, b0, b1);
}

// Two fp32 values rounded once to T (round-to-nearest-even), lo in the
// low half of the word: an mma operand register.
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// The two 16-bit values of a word of T, widened exactly to fp32.
template <typename T>
__device__ __forceinline__ float2 unpack16x2(uint32_t w) {
  if constexpr (std::is_same<T, __half>::value)
    return __half22float2(*reinterpret_cast<const __half2*>(&w));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
