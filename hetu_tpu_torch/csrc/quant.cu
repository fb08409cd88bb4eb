// Blockwise absmax quantize of a flat buffer (deterministic rounding):
//   x [nb * bs] fp32 or bf16 -> q int8 [nb, bs], scales fp32 [nb]
//   scale = max(|x_block|) / qmax, floored at 1e-12
//   q     = clip(round-half-to-even(x / scale), -qmax, qmax)
// with qmax 127 (int8) or 7 (the int4 grid, still one value a byte).
//
// Replaces hetu_tpu/ops/pallas/quant.py `_quant_kernel` /
// `quantize_blockwise_pallas` (arithmetic: comm/compress.py
// `quantize_blockwise`).  Bound on an H100 by bytes: one read of x and
// one write of the payload and scales, a max, a division and a rounding
// an element.  Design: one warp a block (the KV pages' block is a head
// vector of 128), the block's values held in registers between the
// absmax and the quantize, so x is read from device memory once; bf16
// input is widened in registers, which gives the values the reference's
// astype(f32) gives without an fp32 copy of the buffer.  The scale and
// x / scale are true IEEE divisions (__fdiv_rn, never a reciprocal) and
// the rounding is rintf (round-half-to-even), so the payload is
// bit-identical to the plain PyTorch version.  Block sizes 32, 64, 128
// and 256 only (a block held in one warp's registers).
#include <stdint.h>

#include "common.cuh"

constexpr int QB_THREADS = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quantize_one(float x, float scale,
                                               float qmax) {
  const float y = rintf(__fdiv_rn(x, scale));
  return static_cast<int8_t>(fminf(fmaxf(y, -qmax), qmax));
}

// VPL values a lane, element lane + 32 * i of the block (coalesced).
template <typename T, int VPL>
__global__ void __launch_bounds__(QB_THREADS)
    quantize_regs_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                         float* __restrict__ scales, long long nb,
                         float qmax) {
  constexpr int BS = 32 * VPL;
  const int lane = threadIdx.x & 31;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x)
                          >> 5;
  for (long long b = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       b < nb; b += warps) {
    const T* xb = x + b * BS;
    float v[VPL];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      v[i] = to_f32(xb[lane + 32 * i]);
      amax = fmaxf(amax, fabsf(v[i]));
    }
    const float scale = fmaxf(__fdiv_rn(warp_max(amax), qmax), 1e-12f);
    int8_t* qb = q + b * BS;
#pragma unroll
    for (int i = 0; i < VPL; ++i) qb[lane + 32 * i] = quantize_one(v[i], scale,
                                                                  qmax);
    if (lane == 0) scales[b] = scale;
  }
}

template <typename T>
static int launch(const void* x, void* q, void* scales, long long nb, int bs,
                  float qmax, void* stream) {
  if (nb < 0 || !(qmax == 127.0f || qmax == 7.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  // a warp a block, QB_THREADS / 32 blocks a thread block, a few waves
  const unsigned grid = grid_for(nb * 32, QB_THREADS, 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st_ = static_cast<float*>(scales);
#define QB_REGS(V)                                                        \
  quantize_regs_kernel<T, V><<<grid, QB_THREADS, 0, st>>>(xt, qt, st_, nb, \
                                                          qmax)
  if (bs == 32) QB_REGS(1);
  else if (bs == 64) QB_REGS(2);
  else if (bs == 128) QB_REGS(4);
  else if (bs == 256) QB_REGS(8);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef QB_REGS
  return static_cast<int>(cudaGetLastError());
}

HETU_EXPORT int hetu_quantize_blockwise_f32(const void* x, void* q,
                                            void* scales, long long nb,
                                            int bs, float qmax,
                                            void* stream) {
  return launch<float>(x, q, scales, nb, bs, qmax, stream);
}

HETU_EXPORT int hetu_quantize_blockwise_bf16(const void* x, void* q,
                                             void* scales, long long nb,
                                             int bs, float qmax,
                                             void* stream) {
  return launch<__nv_bfloat16>(x, q, scales, nb, bs, qmax, stream);
}
