// Blockwise absmax quantize and dequantize of a flat buffer.
//
// Quantize (deterministic rounding):
//   x [nb * bs] fp32, bf16 or fp16 -> q int8 [nb, bs], scales fp32 [nb]
//   scale = max(|x_block|) / qmax, floored at 1e-12
//   q     = clip(round-half-to-even(x / scale), -qmax, qmax)
// with qmax 127 (int8) or 7 (the int4 grid, still one value a byte).
//
// Replaces hetu_tpu/ops/pallas/quant.py `_quant_kernel` /
// `quantize_blockwise_pallas` (arithmetic: comm/compress.py
// `quantize_blockwise`).  Bound on an H100 by bytes: one read of x and
// one write of the payload and scales, a max, a division and a rounding
// an element.  Design: the head-vector body of quant.cuh, a block of bs
// values held by a group of bs * sizeof(T) / 16 lanes (16 for bf16 or
// fp16 at block 128, 8 at 64), one 16-byte load a lane and chunk, the
// absmax by xor shuffles inside the group (16-bit values widened exactly
// first), the payload stored packed (8 bytes a lane from a 16-bit
// chunk), one lane of the group storing the scale;
// over a grid that covers the buffer, a buffer of more than a wave of
// blocks takes four a group at a time, their loads issued before any is
// quantized (a smaller one one, so that a decode-sized buffer keeps its
// launch latency).  The payload is bit-identical to the plain PyTorch
// version: the scale is a true IEEE division and x / scale is rounded
// half to even as rintf(__fdiv_rn) rounds it (quant.cuh
// `quantize_lane`).  Block sizes 32, 64, 128 and 256 only.  The serving
// path writes its KV pages through kv_write.cu, on the same body; this
// flat form quantizes the draft model's matrices.
//
// Dequantize:
//   q int8 [nb, bs], scales fp32 [nb] -> y [nb * bs], y = float(q) * scale
// in fp32, or rounded once to bf16 or fp16 (round-to-nearest-even, the
// bits of fp32-then-.to(torch.bfloat16 / torch.float16); past fp16's
// largest finite value the rounding gives inf, as the cast does).
//
// Replaces hetu_tpu/ops/pallas/quant.py `_dequant_kernel` /
// `dequantize_blockwise_pallas` (arithmetic: comm/compress.py
// `dequantize_blockwise`).  Bound by bytes: 1 + 4 / bs bytes read and 4
// (bf16, fp16: 2) written an element, one multiply.  The reference
// writes fp32 and its callers cast; the 16-bit arms round the same fp32
// product once, so a caller that wants bf16 or fp16 writes half the
// bytes and makes no second pass.  Design: one thread per
// 16 payload bytes, one 16-byte load, its row's scale read once (the
// threads of a row share the address, one broadcast load), 16-byte
// stores, staged through shared memory a warp at a time so that each
// store instruction writes 512 contiguous bytes.  A group of 16 that
// straddles a row end (bs not a multiple of 16), the buffer's last
// partial group, or a payload pointer off 16-byte alignment (a view into
// a padded flat buffer) takes the byte-wise path, a row a byte.  Any
// bs >= 1.
#include <stdint.h>

#include "common.cuh"
#include "quant.cuh"

constexpr int QB_THREADS = 256;  // the dequantize's block
constexpr int QZ_THREADS = 128;  // the quantize's
// groups a lane holds at once in a buffer wider than a wave of threads
// (132 SMs x 2,048)
constexpr int QZ_UNROLL = 4;
constexpr long long QZ_WAVE_THREADS = 132LL * 2048;

// A warp's step takes UNROLL runs of 32 / LANES consecutive blocks of
// the buffer (a group each), all loads issued before any block is
// stored; the loop is warp-uniform (a group past nb holds zeros and
// stores nothing), so every lane reaches the group's shuffles.
template <typename T, int LANES, int CH, int UNROLL>
__global__ void __launch_bounds__(QZ_THREADS)
    quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scales, long long nb, int bs,
                    float qmax) {
  constexpr int PER_WARP = 32 / LANES;
  constexpr int SPAN = PER_WARP * UNROLL;  // blocks a warp's step
  const int lane = threadIdx.x & 31;
  const int l = lane % LANES;
  const int chunks = bs * static_cast<int>(sizeof(T)) / 16;
  const long long warps = (static_cast<long long>(gridDim.x) * blockDim.x)
                          >> 5;
  for (long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 5;
       w * SPAN < nb; w += warps) {
    HeadVec<T, LANES, CH> hv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = w * SPAN + u * PER_WARP + lane / LANES;
      hv[u].load(x + (b < nb ? b : 0) * bs, l, chunks, b < nb);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long b = w * SPAN + u * PER_WARP + lane / LANES;
      const HeadScale h =
          head_scale(group_max<LANES>(hv[u].lane_absmax()), qmax);
      if (b < nb) {
        store_int8(hv[u], q + b * bs, l, chunks, h);
        if (l == 0) scales[b] = h.scale;
      }
    }
  }
}

// One launch over nb blocks, a group of LANES lanes each: a buffer with
// more groups than a wave of threads holds takes QZ_UNROLL a group at a
// time, a smaller one one.
template <typename T, int LANES, int CH>
static void run_quantize(const T* x, int8_t* q, float* scales, long long nb,
                         int bs, float qmax, cudaStream_t st) {
  if (nb * LANES > QZ_WAVE_THREADS) {
    constexpr int span = 32 / LANES * QZ_UNROLL;
    quantize_kernel<T, LANES, CH, QZ_UNROLL>
        <<<grid_for((nb + span - 1) / span * 32, QZ_THREADS, 1 << 20),
           QZ_THREADS, 0, st>>>(x, q, scales, nb, bs, qmax);
  } else {
    constexpr int span = 32 / LANES;
    quantize_kernel<T, LANES, CH, 1>
        <<<grid_for((nb + span - 1) / span * 32, QZ_THREADS, 1 << 20),
           QZ_THREADS, 0, st>>>(x, q, scales, nb, bs, qmax);
  }
}

template <typename T>
static int launch(const void* x, void* q, void* scales, long long nb, int bs,
                  float qmax, void* stream) {
  if (nb < 0 || !(qmax == 127.0f || qmax == 7.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bs != 32 && bs != 64 && bs != 128 && bs != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const int chunks = bs * static_cast<int>(sizeof(T)) / 16;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scales);
  if (chunks <= 4) run_quantize<T, 4, 1>(xt, qt, sc, nb, bs, qmax, st);
  else if (chunks == 8) run_quantize<T, 8, 1>(xt, qt, sc, nb, bs, qmax, st);
  else if (chunks == 16) run_quantize<T, 16, 1>(xt, qt, sc, nb, bs, qmax, st);
  else if (chunks == 32) run_quantize<T, 32, 1>(xt, qt, sc, nb, bs, qmax, st);
  else run_quantize<T, 32, 2>(xt, qt, sc, nb, bs, qmax, st);
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

HETU_EXPORT int hetu_quantize_blockwise_f16(const void* x, void* q,
                                            void* scales, long long nb,
                                            int bs, float qmax,
                                            void* stream) {
  return launch<__half>(x, q, scales, nb, bs, qmax, stream);
}

// ----------------------------------------------------------- dequantize
// 16 dequantized values packed for 16-byte stores: W = sizeof(T) words
// (fp32: 4 words of 4 values; bf16 or fp16: 2 words of 8, rounded once
// each).
template <typename T>
struct DqPack;

template <>
struct DqPack<float> {
  static constexpr int W = 4;
  static __device__ __forceinline__ void pack(const float* v, uint4* o) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = make_uint4(__float_as_uint(v[4 * i]),
                        __float_as_uint(v[4 * i + 1]),
                        __float_as_uint(v[4 * i + 2]),
                        __float_as_uint(v[4 * i + 3]));
  }
};

template <>
struct DqPack<__nv_bfloat16> {
  static constexpr int W = 2;
  static __device__ __forceinline__ void pack(const float* v, uint4* o) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo =
            __bfloat16_as_ushort(__float2bfloat16(v[8 * i + 2 * j]));
        const uint32_t hi =
            __bfloat16_as_ushort(__float2bfloat16(v[8 * i + 2 * j + 1]));
        w[j] = lo | (hi << 16);
      }
      o[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

template <>
struct DqPack<__half> {
  static constexpr int W = 2;
  static __device__ __forceinline__ void pack(const float* v, uint4* o) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo =
            __half_as_ushort(__float2half_rn(v[8 * i + 2 * j]));
        const uint32_t hi =
            __half_as_ushort(__float2half_rn(v[8 * i + 2 * j + 1]));
        w[j] = lo | (hi << 16);
      }
      o[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
};

// One 16-byte payload load -> 16 values, byte i of the little-endian
// words sign-extended and times the row's scale.
__device__ __forceinline__ void dequant16(const int8_t* q, float s,
                                          float* v) {
  const int4 raw = *reinterpret_cast<const int4*>(q);
  const uint32_t w[4] = {static_cast<uint32_t>(raw.x),
                         static_cast<uint32_t>(raw.y),
                         static_cast<uint32_t>(raw.z),
                         static_cast<uint32_t>(raw.w)};
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int b = static_cast<int>(w[i >> 2] << (24 - 8 * (i & 3))) >> 24;
    v[i] = __fmul_rn(static_cast<float>(b), s);
  }
}

constexpr int DQ_WARPS = QB_THREADS / 32;

// Lane l of a warp covers group g = base + l, elements [16 g, 16 g + 16)
// of the flat buffer.  When all 32 groups take the vector path, the warp
// stages its 512 values in shared memory and stores them as contiguous
// 512-byte runs (a lane's own 16-byte stores would land 32 or 64 bytes
// apart); otherwise (the buffer's last warp, rows off the 16-byte grid,
// an unaligned payload) each lane writes its group byte by byte.
template <typename T, bool ALIGNED>
__global__ void __launch_bounds__(QB_THREADS)
    dequantize_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scales,
                      T* __restrict__ y, long long n, int bs) {
  constexpr int W = DqPack<T>::W;
  __shared__ uint4 stage[DQ_WARPS][32 * W];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long groups = (n + 15) >> 4;
  const long long step = static_cast<long long>(gridDim.x) * DQ_WARPS * 32;
  for (long long base =
           (static_cast<long long>(blockIdx.x) * DQ_WARPS + warp) * 32;
       base < groups; base += step) {
    const long long g = base + lane;
    const long long e0 = g << 4;
    const long long row = e0 / bs;
    const bool vec = ALIGNED && e0 + 16 <= n && e0 + 16 <= (row + 1) * bs;
    if (__all_sync(0xffffffffu, vec)) {
      float v[16];
      dequant16(q + e0, scales[row], v);
      DqPack<T>::pack(v, &stage[warp][lane * W]);
      __syncwarp();
      uint4* out = reinterpret_cast<uint4*>(y + (base << 4));
#pragma unroll
      for (int i = 0; i < W; ++i)
        out[i * 32 + lane] = stage[warp][i * 32 + lane];
      __syncwarp();
    } else if (g < groups) {
      const long long e1 = e0 + 16 < n ? e0 + 16 : n;
      for (long long e = e0; e < e1; ++e)
        y[e] = from_f32<T>(
            __fmul_rn(static_cast<float>(q[e]), scales[e / bs]));
    }
  }
}

template <typename T>
static int launch_dequant(const void* q, const void* scales, void* y,
                          long long nb, int bs, void* stream) {
  if (nb < 0 || bs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const long long n = nb * bs;
  const unsigned grid = grid_for((n + 15) >> 4, QB_THREADS, 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scales);
  T* yt = static_cast<T*>(y);
  // the 16-byte path needs the payload's base on a 16-byte boundary (the
  // output is a fresh allocation, 256-byte aligned)
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0)
    dequantize_kernel<T, true><<<grid, QB_THREADS, 0, st>>>(qt, sc, yt, n, bs);
  else
    dequantize_kernel<T, false><<<grid, QB_THREADS, 0, st>>>(qt, sc, yt, n,
                                                             bs);
  return static_cast<int>(cudaGetLastError());
}

HETU_EXPORT int hetu_dequantize_blockwise_f32(const void* q,
                                              const void* scales, void* y,
                                              long long nb, int bs,
                                              void* stream) {
  return launch_dequant<float>(q, scales, y, nb, bs, stream);
}

HETU_EXPORT int hetu_dequantize_blockwise_bf16(const void* q,
                                               const void* scales, void* y,
                                               long long nb, int bs,
                                               void* stream) {
  return launch_dequant<__nv_bfloat16>(q, scales, y, nb, bs, stream);
}

HETU_EXPORT int hetu_dequantize_blockwise_f16(const void* q,
                                              const void* scales, void* y,
                                              long long nb, int bs,
                                              void* stream) {
  return launch_dequant<__half>(q, scales, y, nb, bs, stream);
}
