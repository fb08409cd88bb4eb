// Absmax quantize of one head vector (or one flat block) held by a group
// of lanes: the body of the flat blockwise quantize (quant.cu) and of the
// fused KV page write (kv_write.cu).
//
// A vector of D values of T is `chunks` = D * sizeof(T) / 16 chunks of
// 16 bytes.  A group of LANES lanes of one warp holds it (LANES a power
// of two, 32 / LANES groups a warp): lane l loads chunks l, l + LANES,
// ... (CH of them, one 16-byte load each; lanes past `chunks` load
// nothing and hold zeros).  bf16 or fp16 at hd 128 is 16 chunks: 16
// lanes, one load a lane; hd 64 is 8; fp32 at hd 128 is 32.
//
// The arithmetic keeps the plain PyTorch version's bits
// (ops/cuda/quant.py `quantize_blockwise_plain`, the reference's
// comm/compress.py `quantize_blockwise` with deterministic rounding):
//   scale = max(__fdiv_rn(amax, qmax), 1e-12)
//   q     = clip(rintf(__fdiv_rn(x, scale)), -qmax, qmax)
// true IEEE divisions and round-half-to-even; bf16 and fp16 input is
// widened exactly, so a 16-bit vector's bits and scale are those of its
// fp32 widening.  `quantize_lane` gets q's bits from a multiply by the
// scale's reciprocal, falling back to the division where a product lies
// near a rounding boundary (its note says why that is exact).  The
// absmax is taken by xor shuffles inside the group, so every lane of the
// warp must call `group_max` (a group with nothing to do holds zeros and
// stores nothing).
//
// The payload leaves as one packed store a chunk: int8 one byte a value
// (8 bytes from a bf16 chunk, 4 from fp32) or the int4 pages' nibbles
// (even index in the low nibble, value + 8: 4 bytes from a bf16 chunk,
// 2 from fp32); the caller's lane 0 of the group stores the scale.
#pragma once

#include <stdint.h>

#include <type_traits>

#include "common.cuh"

template <typename T, int LANES, int CH>
struct HeadVec {
  static constexpr int VPC = 16 / static_cast<int>(sizeof(T));  // a chunk
  uint4 raw[CH];

  // Chunk c of this lane: chunk c * LANES + l of the vector at x.
  __device__ __forceinline__ void load(const T* x, int l, int chunks,
                                       bool live) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = c * LANES + l;
      raw[c] = live && k < chunks
                   ? __ldg(reinterpret_cast<const uint4*>(x) + k)
                   : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Value j (0 <= j < VPC) of chunk c, widened to fp32 exactly.
  __device__ __forceinline__ float value(int c, int j) const {
    const uint32_t w[4] = {raw[c].x, raw[c].y, raw[c].z, raw[c].w};
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[j]);
    } else if constexpr (std::is_same<T, __half>::value) {
      const uint32_t word = w[j >> 1];
      return __half2float(__ushort_as_half(
          static_cast<unsigned short>((j & 1) ? word >> 16 : word)));
    } else {  // bf16: the high half of an fp32
      const uint32_t word = w[j >> 1];
      return __uint_as_float((j & 1) ? (word & 0xffff0000u) : (word << 16));
    }
  }

  __device__ __forceinline__ float lane_absmax() const {
    float m = 0.0f;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < VPC; ++j) m = fmaxf(m, fabsf(value(c, j)));
    return m;
  }
};

// The max over a group of LANES lanes (every lane of the warp calls it).
template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A head vector's scale, its reciprocal (within 2 ulp: the quantize's
// bound allows it) and qmax.
struct HeadScale {
  float scale, inv, qmax;
};

__device__ __forceinline__ HeadScale head_scale(float amax, float qmax) {
  const float scale = fmaxf(__fdiv_rn(amax, qmax), 1e-12f);
  return {scale, __fdividef(1.0f, scale), qmax};
}

// 1.5 * 2^23: v + RND_MAGIC rounds |v| < 2^22 to an integer, ties to even
// (rintf's rounding), and leaves it in the low bits: the low byte of
// the sum's bits is the integer's two's-complement byte.  The int4 pages
// add 8 more (an even offset: the same roundings), so that byte is the
// stored nibble, value + 8.
constexpr float RND_MAGIC = 12582912.0f;

// A lane's values of a head vector quantized: bits[c][j] holds value j of
// chunk c in its low byte (int8: the payload byte; int4: the nibble,
// magic RND_MAGIC + 8).  The bits of rintf(__fdiv_rn(x, scale)), with
// the division and the rounding on the full-rate pipes: y = x * inv is
// within 4 * 2^-24 * |x / scale| < 3.1e-5 of the quotient fl(x / scale)
// (inv within 2 ulp of 1 / scale; |x| <= amax, so |x / scale| <=
// qmax(1 + 2^-24) < 128), and rint
// changes only across a half-integer, so where every y of the lane lies
// more than 2e-4 from one the product's rounding is the quotient's; a
// lane with a y nearer one takes the true divisions (about one lane in
// 300 on random data).  The same bound keeps every value inside
// [-qmax, qmax]: the reference's clip never moves a finite input.  The
// division's MUFU reciprocal, rintf and the float-to-int conversion run
// at an eighth of the FMA rate, three a value where each value was
// divided.
template <typename T, int LANES, int CH>
__device__ __forceinline__ void quantize_lane(
    const HeadVec<T, LANES, CH>& hv, const HeadScale& h, float magic,
    uint32_t (&bits)[CH][HeadVec<T, LANES, CH>::VPC]) {
  constexpr int VPC = HeadVec<T, LANES, CH>::VPC;
  bool near = false;
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int j = 0; j < VPC; ++j) {
      const float y = __fmul_rn(hv.value(c, j), h.inv);
      const float t = __fadd_rn(y, magic);
      near |= !(fabsf(__fadd_rn(y, -__fadd_rn(t, -magic))) < 0.4998f);
      bits[c][j] = __float_as_uint(t);
    }
  if (near) {
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < VPC; ++j)
        bits[c][j] = __float_as_uint(__fadd_rn(
            rintf(__fdiv_rn(hv.value(c, j), h.scale)), magic));
  }
}

// The low bytes of four words, in order, in one word.
__device__ __forceinline__ uint32_t low_bytes(uint32_t b0, uint32_t b1,
                                              uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410);
}

// int8 payload, one value a byte: chunk k of the row at q, VPC bytes.
template <typename T, int LANES, int CH>
__device__ __forceinline__ void store_int8(const HeadVec<T, LANES, CH>& hv,
                                           int8_t* q, int l, int chunks,
                                           const HeadScale& h) {
  constexpr int VPC = HeadVec<T, LANES, CH>::VPC;
  uint32_t b[CH][VPC];
  quantize_lane(hv, h, RND_MAGIC, b);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = c * LANES + l;
    if (k >= chunks) continue;
    const uint32_t w0 = low_bytes(b[c][0], b[c][1], b[c][2], b[c][3]);
    if constexpr (VPC == 8)
      reinterpret_cast<uint2*>(q)[k] =
          make_uint2(w0, low_bytes(b[c][4], b[c][5], b[c][6], b[c][7]));
    else
      reinterpret_cast<uint32_t*>(q)[k] = w0;
  }
}

// int4 payload (qmax 7): value + 8 in a nibble, the even index low.
template <typename T, int LANES, int CH>
__device__ __forceinline__ void store_int4(const HeadVec<T, LANES, CH>& hv,
                                           uint8_t* q, int l, int chunks,
                                           const HeadScale& h) {
  constexpr int VPC = HeadVec<T, LANES, CH>::VPC;
  uint32_t b[CH][VPC];
  quantize_lane(hv, h, RND_MAGIC + 8.0f, b);
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = c * LANES + l;
    if (k >= chunks) continue;
    // nibbles of the even values, and of the odd ones, a byte each
    if constexpr (VPC == 8) {
      const uint32_t even = low_bytes(b[c][0], b[c][2], b[c][4], b[c][6]);
      const uint32_t odd = low_bytes(b[c][1], b[c][3], b[c][5], b[c][7]);
      reinterpret_cast<uint32_t*>(q)[k] = even | (odd << 4);
    } else {
      const uint32_t even = __byte_perm(b[c][0], b[c][2], 0x0040);
      const uint32_t odd = __byte_perm(b[c][1], b[c][3], 0x0040);
      reinterpret_cast<uint16_t*>(q)[k] =
          static_cast<uint16_t>(even | (odd << 4));
    }
  }
}
