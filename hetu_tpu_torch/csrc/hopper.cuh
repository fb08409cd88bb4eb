// Hopper building blocks for the port's 16-bit kernels (sm_90a):
// mbarriers, cp.async copies that arrive on an mbarrier, the 128-byte
// swizzled shared-memory tile layout and its wgmma descriptors, and
// wgmma.mma_async in the three shapes the flash kernels issue, with bf16
// or fp16 operands.  Plain PTX, no CUTLASS.
//
// The tile layout.  A [64 rows][D] 16-bit operand (bf16 or fp16: the
// layout and the descriptors depend on the element's size alone) is
// stored as D / 64 sub-tiles of [64][64] (8 KB each, 1024-byte aligned);
// row r of a sub-tile is 128 bytes, and its 16-byte chunk c lies at chunk
// c ^ (r % 8) (CU_TENSOR_MAP_SWIZZLE_128B's pattern, so wgmma reads it
// without bank conflicts).  The same bytes serve two operand roles:
//   * K-major (contracted over D: Q, K in S = Q K^T): a k16 step is 32
//     bytes into each row of one sub-tile; 8-row groups 1024 bytes apart;
//   * MN-major (contracted over the rows: V in P V): a k16 step is 16
//     rows (2048 bytes) down; 8-row groups 1024 bytes apart, the next 64
//     columns one sub-tile (8192 bytes) on.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include <cstdint>
#include <type_traits>

namespace hopper {

constexpr int SUB_TILE_BYTES = 64 * 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) of a swizzled [64][D] tile, c a multiple
// of 8 (one 16-byte chunk).
__device__ __forceinline__ uint32_t swizzled(int r, int c) {
  return (c >> 6) * SUB_TILE_BYTES + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4);
}

// wgmma descriptor of a 128-byte-swizzled operand at shared address
// `addr`: leading / stride byte offsets, layout type 1 (128B swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major, contracted over D: step `ks` (16 columns) of a tile at `tile`.
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int ks) {
  return desc_sw128(tile + (ks >> 2) * SUB_TILE_BYTES + (ks & 3) * 32, 16,
                    1024);
}
// MN-major, contracted over the rows: step `ks` (16 rows).
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int ks) {
  return desc_sw128(tile + ks * 2048, SUB_TILE_BYTES, 1024);
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- cp.async
// 16 bytes global -> shared; zeros where !pred (nothing is read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 16 : 0) : "memory");
}
// 4 bytes global -> shared; zero where !pred.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(pred ? 4 : 0) : "memory");
}
// Arrive on `bar` once this thread's cp.asyncs so far have landed (counts
// one arrival of the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// cp.async writes through the generic proxy and wgmma reads through the
// async proxy: a reader fences between the barrier wait and its wgmma.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -------------------------------------------------- warpgroup scheduling
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
// A barrier over the 128 threads of one warpgroup (ids 1.. ; 0 is
// __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// -------------------------------------------------------------- wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// An accumulator d[n8][e] of a 64 x N product holds, in warp w of the
// warpgroup, row 16 w + g + 8 (e >> 1) and column 8 n8 + 2 tig + (e & 1)
// (g = lane >> 2, tig = lane & 3): mma.sync's layout, a warp a 16-row slab.

// The three products in each 16-bit operand type: the same instruction
// shapes, fragment layouts and descriptors for bf16 and fp16 (TY is the
// PTX operand type, "bf16" or "f16"; `wgmma_ss_n64_bf16`,
// `wgmma_ss_n64_f16` ...), and a template over the element type that
// picks one (`wgmma_ss_n64<T>` ...).
#define HOPPER_WGMMA_SS_N64(SUFFIX, TY)                                     \
  __device__ __forceinline__ void wgmma_ss_n64_##SUFFIX(                    \
      float(&d)[8][4], uint64_t desc_a, uint64_t desc_b, int accumulate) {  \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
        "%28, %29, %30, %31}, "                                             \
        "%32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),       \
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),       \
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),       \
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),       \
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),       \
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),       \
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),       \
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])        \
        : "l"(desc_a), "l"(desc_b), "r"(accumulate));                       \
  }

#define HOPPER_WGMMA_RS_N64(SUFFIX, TY)                                     \
  __device__ __forceinline__ void wgmma_rs_n64_##SUFFIX(                    \
      float(&d)[8][4], const unsigned(&a)[4], uint64_t desc_b) {            \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "         \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
        "%28, %29, %30, %31}, "                                             \
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),       \
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),       \
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),       \
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),       \
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),       \
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),       \
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),       \
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])        \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)); \
  }

#define HOPPER_WGMMA_RS_N128(SUFFIX, TY)                                    \
  __device__ __forceinline__ void wgmma_rs_n128_##SUFFIX(                   \
      float(&d)[16][4], const unsigned(&a)[4], uint64_t desc_b) {           \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "        \
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "  \
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "  \
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "  \
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "               \
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),       \
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),       \
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),       \
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),       \
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),       \
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),       \
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),       \
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),       \
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),       \
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),       \
          "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),   \
          "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),   \
          "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),   \
          "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),   \
          "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),   \
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])    \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1)); \
  }

// d (64 x 64, fp32) = A . B^T, or += where `accumulate`: A [64][16] and
// B [64][16] both K-major in shared memory (descriptors).
HOPPER_WGMMA_SS_N64(bf16, "bf16")
HOPPER_WGMMA_SS_N64(f16, "f16")
// d (64 x 64, fp32) += A . B: A [64][16] in registers (the mma.sync
// A-fragment layout, a warp's 16 rows), B [16][64] MN-major in shared
// memory (descriptor, transposed).
HOPPER_WGMMA_RS_N64(bf16, "bf16")
HOPPER_WGMMA_RS_N64(f16, "f16")
// d (64 x 128, fp32) += A . B: as above with B [16][128].
HOPPER_WGMMA_RS_N128(bf16, "bf16")
HOPPER_WGMMA_RS_N128(f16, "f16")

#undef HOPPER_WGMMA_SS_N64
#undef HOPPER_WGMMA_RS_N64
#undef HOPPER_WGMMA_RS_N128

template <typename T>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4],
                                             uint64_t desc_a,
                                             uint64_t desc_b,
                                             int accumulate) {
  if constexpr (std::is_same_v<T, __half>)
    wgmma_ss_n64_f16(d, desc_a, desc_b, accumulate);
  else
    wgmma_ss_n64_bf16(d, desc_a, desc_b, accumulate);
}
template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                             const unsigned (&a)[4],
                                             uint64_t desc_b) {
  if constexpr (std::is_same_v<T, __half>)
    wgmma_rs_n64_f16(d, a, desc_b);
  else
    wgmma_rs_n64_bf16(d, a, desc_b);
}
template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[16][4],
                                              const unsigned (&a)[4],
                                              uint64_t desc_b) {
  if constexpr (std::is_same_v<T, __half>)
    wgmma_rs_n128_f16(d, a, desc_b);
  else
    wgmma_rs_n128_bf16(d, a, desc_b);
}

}  // namespace hopper
