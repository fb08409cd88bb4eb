// Fused sampling epilogue: last-layer hidden rows x the LM head ->
// temperature / top-k / top-p filtering -> a Gumbel-argmax draw, one
// token a row.
//
// Replaces hetu_tpu/ops/pallas/sample.py `_sample_kernel` /
// `fused_sample` (with `hash_uniform`, `gumbel`, `_sort_key`,
// `_kth_largest_key`, `_nucleus_key`).  The contract is the TPU
// kernel's: hidden [R, H] + head w [H, V] + key words [R, 2] (the raw
// data of fold_in(key(seed), position)) + temperatures, top-ks and
// top-ps -> tokens [R] int32; temperature 0 rows take the first-index
// argmax of the unfiltered logits.
//
// The TPU kernel keeps a row's whole vocabulary in VMEM; a block on
// this card cannot (one fp32 row of 128256 is 513 KB against 227 KB of
// shared memory), so the work is two kernels:
//  (a) the product: fp32 logits [R, V] into a scratch buffer (20 MB at
//      R = 40, which stays in the 50 MB L2).  A block owns a strip of
//      128 vocabulary columns for up to 64 rows and walks the hidden
//      dim, staging both tiles in shared memory with 16-byte loads, so
//      the 1.05 GB Llama-3-8B head is read from device memory once;
//      bound by those bytes (0.314 ms at 3.35 TB/s).  bf16 operands
//      multiply on the tensor cores (`lm_head_mma_kernel`, mma.sync,
//      fp32 accumulators: 42 GFLOP at R = 40 is 0.04 ms at the bf16
//      peak, so the head's bytes set the time); fp32 operands, or rows
//      that are not 16-byte runs, on fp32 FMAs (`lm_head_kernel`).
//  (b) `sample_kernel`, filter and draw: a thread-block cluster of
//      SB_CLUSTER = 8 blocks (1024 threads each) a row, over the logits
//      in L2.  Each block reads its eighth of the row once, keeps its
//      keys (below) in shared memory, and every later pass runs there;
//      the blocks combine partial results through distributed shared
//      memory, in rank order.  A first pass takes the greedy
//      first-index argmax and the max of the temperature-scaled row
//      (true division, as the reference).  Top-k finds the EXACT k-th
//      largest value as the TPU kernel's bisection does, over the same
//      monotone uint32 image of the fp32 values, by a radix select
//      instead: four levels of a 256-bin histogram (integer counts, so
//      the result does not depend on the order of the atomics).  The
//      nucleus threshold is the TPU kernel's 32-step bisection over the
//      same image, summing exp(x - max) (computed once, held beside the
//      keys) over the kept keys above the midpoint.  The nucleus
//      renormalizes over exactly k entries, as the sorted reference
//      (and the plain version) does, where the TPU kernel counts every
//      copy of the k-th value.  Sums are block reductions in a fixed
//      order, then the cluster's in rank order, so every block takes
//      the same branches and a row draws the same token on every run.
//      A row is limited to 8 x SB_MAX_CHUNK = 212,992 entries (shared
//      memory).  The draw adds Gumbel noise from the reference's
//      counter hash (murmur finalizer, bit-exact in uint32) and takes the
//      first-index argmax over the kept keys, which is the argmax of the
//      masked row (masked entries sit at -1e30 and win only where their
//      noise is +inf, which the hash alone decides).  Exact shortcuts:
//      temperature-0 rows stop after the argmax, top-k = 0 (or >= V) and
//      top-p outside (0, 1) skip their filters.
// Kernel (b) alone is also the sampler wherever the logits already exist
// (the decode step, the first token).
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma.cuh"

namespace cg = cooperative_groups;

// ------------------------------------------------------------ (a) product
constexpr int LM_THREADS = 256;
constexpr int LM_BN = 128;  // vocabulary columns a block
constexpr int LM_RT = 64;   // rows a block
constexpr int LM_BK = 32;   // hidden dims a step

// A 16-byte load's values as fp32, by shifts (a pointer to the loaded
// vector would send it through local memory).
__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[4]) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(uint4 raw, float (&v)[8]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16: the high half of an fp32
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
}

template <typename T>
__global__ void __launch_bounds__(LM_THREADS)
    lm_head_kernel(const T* __restrict__ hidden, const T* __restrict__ w,
                   float* __restrict__ logits, int R, int H, int V,
                   long long w_sk, long long w_sn, bool vec) {
  __shared__ float hs[LM_RT][LM_BK];
  __shared__ __align__(16) float ws[LM_BK][LM_BN];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ty = tid >> 5;  // a warp: rows ty, ty + 8, ...
  const long long n0 = static_cast<long long>(blockIdx.x) * LM_BN;
  const int r0 = blockIdx.y * LM_RT;
  const int rows = min(LM_RT, R - r0);
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  constexpr int E = 16 / sizeof(T);  // values a 16-byte load
  for (int k0 = 0; k0 < H; k0 += LM_BK) {
    // E consecutive values a thread: one 16-byte load where the run lies
    // inside the matrix and `vec` (unit column stride, rows on 16-byte
    // boundaries), else one value at a time
    for (int e = tid; e < LM_RT * LM_BK / E; e += LM_THREADS) {
      const int r = e / (LM_BK / E), kk = (e - r * (LM_BK / E)) * E;
      const T* src = hidden + static_cast<long long>(r0 + r) * H + k0 + kk;
      float v[E];
      if (r >= rows) {
#pragma unroll
        for (int i = 0; i < E; ++i) v[i] = 0.0f;
      } else if (vec && k0 + kk + E <= H) {
        unpack16(__ldg(reinterpret_cast<const uint4*>(src)), v);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) v[i] = k0 + kk + i < H ? to_f32(src[i]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) hs[r][kk + i] = v[i];
    }
    for (int e = tid; e < LM_BK * LM_BN / E; e += LM_THREADS) {
      const int kk = e / (LM_BN / E), n = (e - kk * (LM_BN / E)) * E;
      float v[E];
      if (k0 + kk >= H) {
#pragma unroll
        for (int i = 0; i < E; ++i) v[i] = 0.0f;
      } else if (vec && n0 + n + E <= V) {
        unpack16(__ldg(reinterpret_cast<const uint4*>(
                     w + (k0 + kk) * w_sk + n0 + n)), v);
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i)
          v[i] = n0 + n + i < V ? to_f32(w[(k0 + kk) * w_sk + (n0 + n + i) * w_sn])
                                : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) ws[kk][n + i] = v[i];
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < LM_BK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][lane * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (ty + 8 * i < rows) {  // the same for the whole warp
          const float a = hs[ty + 8 * i][kk];
          acc[i][0] += a * b.x;
          acc[i][1] += a * b.y;
          acc[i][2] += a * b.z;
          acc[i][3] += a * b.w;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i;
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long n = n0 + lane * 4 + j;
        if (n < V) logits[static_cast<long long>(r0 + r) * V + n] = acc[i][j];
      }
    }
  }
}

// The bf16 product on the tensor cores (mma.sync.m16n8k16, fp32
// accumulators): a block of 4 warps owns a strip of LMM_BN = 128
// columns for up to 16 MT rows, a warp 32 of the columns for all of
// them.  Each stage of LMM_BK = 64 hidden dims is staged in shared
// memory with 16-byte loads (rows padded by 16 bytes, so an ldmatrix's
// 8 rows fall in 8 bank groups), and the next stage's loads are issued
// into registers before this stage's products, so the head streams
// while the tensor cores work.  Needs H and V multiples of 8 and
// 16-byte aligned rows (`lm_head_kernel` takes the rest).
constexpr int LMM_THREADS = 128;
constexpr int LMM_BN = 128;
constexpr int LMM_BK = 64;
constexpr int LMM_LDA = LMM_BK + 8;
constexpr int LMM_LDB = LMM_BN + 8;

template <int MT>
__global__ void __launch_bounds__(LMM_THREADS)
    lm_head_mma_kernel(const bf16* __restrict__ hidden,
                       const bf16* __restrict__ w,
                       float* __restrict__ logits, int R, int H, int V) {
  constexpr int ROWS = 16 * MT;
  constexpr int A_LOADS = ROWS * (LMM_BK / 8) / LMM_THREADS;  // = MT
  constexpr int B_LOADS = LMM_BK * (LMM_BN / 8) / LMM_THREADS;  // = 8
  __shared__ __align__(16) bf16 As[ROWS * LMM_LDA];
  __shared__ __align__(16) bf16 Bs[LMM_BK * LMM_LDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * LMM_BN;
  const int r0 = blockIdx.y * ROWS;
  uint4 ra[A_LOADS], rb[B_LOADS];

  // load stage k0 into registers: zero past the matrix
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int c = tid + i * LMM_THREADS;
      const int r = c / (LMM_BK / 8), k = k0 + (c % (LMM_BK / 8)) * 8;
      ra[i] = (r0 + r < R && k < H)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        hidden + static_cast<long long>(r0 + r) * H + k))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * LMM_THREADS;
      const int k = k0 + c / (LMM_BN / 8), n = n0 + (c % (LMM_BN / 8)) * 8;
      rb[i] = (k < H && n < V)
                  ? __ldg(reinterpret_cast<const uint4*>(
                        w + static_cast<long long>(k) * V + n))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int c = tid + i * LMM_THREADS;
      *reinterpret_cast<uint4*>(As + (c / (LMM_BK / 8)) * LMM_LDA +
                                (c % (LMM_BK / 8)) * 8) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * LMM_THREADS;
      *reinterpret_cast<uint4*>(Bs + (c / (LMM_BN / 8)) * LMM_LDB +
                                (c % (LMM_BN / 8)) * 8) = rb[i];
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.0f;
  // A fragments: rows 0-15 of a tile, columns k .. k+7 then k+8 .. k+15;
  // B (contracted over its rows, so transposed): rows k .. k+15 of
  // columns n .. n+7, then n+8 .. n+15
  const bf16* a_ptr = As + (lane & 15) * LMM_LDA + (lane >> 4) * 8;
  const bf16* b_ptr = Bs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LMM_LDB +
                      (lane >> 4) * 8 + warp * 32;

  load(0);
  for (int k0 = 0; k0 < H; k0 += LMM_BK) {
    __syncthreads();  // the last stage's products have read As / Bs
    store();
    __syncthreads();
    if (k0 + LMM_BK < H) load(k0 + LMM_BK);
#pragma unroll
    for (int ks = 0; ks < LMM_BK / 16; ++ks) {
      unsigned b[2][4];
      ldmatrix_x4_trans(b[0], b_ptr + 16 * ks * LMM_LDB);
      ldmatrix_x4_trans(b[1], b_ptr + 16 * ks * LMM_LDB + 16);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        unsigned a[4];
        ldmatrix_x4(a, a_ptr + 16 * m * LMM_LDA + 16 * ks);
        mma_bf16(acc[m][0], a, b[0][0], b[0][1]);
        mma_bf16(acc[m][1], a, b[0][2], b[0][3]);
        mma_bf16(acc[m][2], a, b[1][0], b[1][1]);
        mma_bf16(acc[m][3], a, b[1][2], b[1][3]);
      }
    }
  }
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * m + g + 8 * h;
        const int n = n0 + warp * 32 + 8 * t + 2 * tig;  // n + 1 < V: V % 8 == 0
        if (r < R && n < V)
          *reinterpret_cast<float2*>(logits + static_cast<long long>(r) * V +
                                     n) =
              make_float2(acc[m][t][2 * h], acc[m][t][2 * h + 1]);
      }
}

// ------------------------------------------------- (b) filter and draw
constexpr int SB_THREADS = 1024;
constexpr int SB_WARPS = SB_THREADS / 32;
constexpr int SB_CLUSTER = 8;        // blocks a row: one thread-block cluster
constexpr int SB_MAX_CHUNK = 26624;  // values a block holds: V <= 212,992

// f32 -> uint32, strictly monotone over the values (+0.0 first, so -0.0
// and +0.0 map to one key)
__device__ __forceinline__ uint32_t sort_key(float x) {
  const uint32_t b = __float_as_uint(__fadd_rn(x, 0.0f));
  return (b & 0x80000000u) ? ~b : (b ^ 0x80000000u);
}

// Inverse of sort_key (x + 0.0: -0.0 comes back as +0.0, which no sum,
// exp or comparison here tells apart)
__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// The reference's counter hash (lane 0), its 24 high bits
__device__ __forceinline__ uint32_t hash_bits(uint32_t w0, uint32_t w1,
                                              uint32_t idx) {
  uint32_t x = w0 ^ (idx * 0x9E3779B1u);
  x += w1;
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >> 8;
}

// ... as a uniform in (0, 1], as the reference rounds it: the top value
// 0xFFFFFF gives 1 - 2^-25, which rounds to 1.0 (Gumbel noise +inf)
__device__ __forceinline__ float hash_uniform(uint32_t w0, uint32_t w1,
                                              uint32_t idx) {
  return __fadd_rn(
      __fmul_rn(static_cast<float>(hash_bits(w0, w1, idx)), 1.0f / 16777216.0f),
      0.5f / 16777216.0f);
}

__device__ __forceinline__ float gumbel(uint32_t w0, uint32_t w1,
                                        uint32_t idx) {
  return -logf(-logf(hash_uniform(w0, w1, idx)));
}

struct ArgMax {
  float v;
  int i;
};

// first index among equal maxima (jnp.argmax's rule)
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// What a block offers a cluster reduction; the other blocks of the
// cluster read it from this block's shared memory.
struct Part {
  ArgMax am;
  float f;
  uint32_t lo, hi;
  unsigned hist[256];
};

struct Scratch {
  ArgMax am[SB_WARPS];
  float f[SB_WARPS];
  unsigned u[SB_WARPS];
  unsigned hist[256];  // the cluster's histogram of one radix level
  int sel, cum;
  // Two parts, used in turn: a block writes part p again only two
  // reductions later, after a cluster barrier that every block reaches
  // only once it has read part p of the reduction before.
  Part part[2];
};

// Block reductions in a fixed order (warp shuffles, then warp 0): the
// result is broadcast to every thread.
__device__ ArgMax block_argmax(ArgMax a, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(0xffffffffu, a.v, o),
             __shfl_xor_sync(0xffffffffu, a.i, o)};
    a = better(a, b);
  }
  __syncthreads();
  if (lane == 0) sc.am[warp] = a;
  __syncthreads();
  a = sc.am[lane < SB_WARPS ? lane : 0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(0xffffffffu, a.v, o),
             __shfl_xor_sync(0xffffffffu, a.i, o)};
    a = better(a, b);
  }
  return a;
}

__device__ float block_sum(float v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (lane == 0) sc.f[warp] = v;
  __syncthreads();
  v = lane < SB_WARPS ? sc.f[lane] : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ float block_max(float v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if (lane == 0) sc.f[warp] = v;
  __syncthreads();
  v = sc.f[lane < SB_WARPS ? lane : 0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ uint32_t block_umin_umax(uint32_t v, bool is_max, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t b = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? max(v, b) : min(v, b);
  }
  __syncthreads();
  if (lane == 0) sc.u[warp] = v;
  __syncthreads();
  v = sc.u[lane < SB_WARPS ? lane : 0];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint32_t b = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? max(v, b) : min(v, b);
  }
  return v;
}

// Cluster reductions: each block's result goes to its next part, then
// every thread of every block combines the parts in rank order, so all
// blocks hold the same bits and take the same branches.
struct Cluster {
  cg::cluster_group cl;
  Scratch& sc;
  int seq;

  __device__ Part& mine() { return sc.part[seq & 1]; }
  __device__ const Part& of(Part& p, int rank) {
    return *cl.map_shared_rank(&p, rank);
  }

  __device__ ArgMax argmax(ArgMax a) {
    a = block_argmax(a, sc);
    Part& p = mine();
    ++seq;
    if (threadIdx.x == 0) p.am = a;
    cl.sync();
    a = of(p, 0).am;
    for (int rk = 1; rk < SB_CLUSTER; ++rk) a = better(a, of(p, rk).am);
    return a;
  }

  __device__ float sum(float v) {
    v = block_sum(v, sc);
    Part& p = mine();
    ++seq;
    if (threadIdx.x == 0) p.f = v;
    cl.sync();
    v = of(p, 0).f;
    for (int rk = 1; rk < SB_CLUSTER; ++rk) v += of(p, rk).f;
    return v;
  }

  __device__ float max(float v) {
    v = block_max(v, sc);
    Part& p = mine();
    ++seq;
    if (threadIdx.x == 0) p.f = v;
    cl.sync();
    v = of(p, 0).f;
    for (int rk = 1; rk < SB_CLUSTER; ++rk) v = fmaxf(v, of(p, rk).f);
    return v;
  }

  __device__ void minmax(uint32_t& lo, uint32_t& hi) {
    lo = block_umin_umax(lo, false, sc);
    hi = block_umin_umax(hi, true, sc);
    Part& p = mine();
    ++seq;
    if (threadIdx.x == 0) {
      p.lo = lo;
      p.hi = hi;
    }
    cl.sync();
    lo = of(p, 0).lo;
    hi = of(p, 0).hi;
    for (int rk = 1; rk < SB_CLUSTER; ++rk) {
      lo = ::min(lo, of(p, rk).lo);
      hi = ::max(hi, of(p, rk).hi);
    }
  }
};

// Radix select over the cluster's keys: the key of the k-th largest
// scaled value (duplicates counted as the sort counts them) and how
// many keys lie above it.  Four levels of a 256-bin histogram of
// integer counts (the order of the atomics cannot change them); a
// warp's lanes that fall in one bin add once (match.any).
__device__ uint32_t kth_largest_key(const uint32_t* keys, int n, int k,
                                    int* n_above, Cluster& c) {
  Scratch& sc = c.sc;
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0, mask = 0;
  int above = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    Part& p = c.mine();
    ++c.seq;
    if (tid < 256) p.hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += SB_THREADS) {
      const int j = base + tid;
      int bin = -1;
      if (j < n) {
        const uint32_t key = keys[j];
        if ((key & mask) == prefix) bin = static_cast<int>((key >> shift) & 255u);
      }
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&p.hist[bin], static_cast<unsigned>(__popc(peers)));
    }
    c.cl.sync();
    if (tid < 256) {
      unsigned t = 0;
      for (int rk = 0; rk < SB_CLUSTER; ++rk) t += c.of(p, rk).hist[tid];
      sc.hist[tid] = t;
    }
    __syncthreads();
    if (tid < 32) {  // warp 0: lane l owns bins 255 - 8l .. 248 - 8l
      unsigned cnt[8], tot = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cnt[j] = sc.hist[255 - (8 * lane + j)];
        tot += cnt[j];
      }
      unsigned pre = tot;  // inclusive scan over lanes, then exclusive
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned b = __shfl_up_sync(0xffffffffu, pre, o);
        if (lane >= o) pre += b;
      }
      unsigned cum = pre - tot;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cum < static_cast<unsigned>(k) &&
            cum + cnt[j] >= static_cast<unsigned>(k)) {
          sc.sel = 255 - (8 * lane + j);
          sc.cum = static_cast<int>(cum);
        }
        cum += cnt[j];
      }
    }
    __syncthreads();
    const int sel = sc.sel, cum = sc.cum;
    k -= cum;
    above += cum;
    prefix |= static_cast<uint32_t>(sel) << shift;
    mask |= 255u << shift;
    __syncthreads();  // sc.hist / sc.sel are rewritten next level
  }
  *n_above = above;
  return prefix;
}

// One row a cluster of SB_CLUSTER blocks: block `rank` holds columns
// rank * chunk .. + chunk of the row in shared memory (keys and, for
// the nucleus, exp(x - max)), so the logits are read once and every
// later pass runs over shared memory on SB_CLUSTER SMs.
template <typename T>
__global__ void __cluster_dims__(SB_CLUSTER, 1, 1) __launch_bounds__(SB_THREADS)
    sample_kernel(const T* __restrict__ logits, long long row_stride, int V,
                  const uint32_t* __restrict__ words,
                  const float* __restrict__ temps,
                  const int* __restrict__ top_ks,
                  const float* __restrict__ top_ps, int* __restrict__ out) {
  __shared__ Scratch sc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk = (V + SB_CLUSTER - 1) / SB_CLUSTER;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);    // [chunk]
  float* es = reinterpret_cast<float*>(keys + chunk);         // [chunk]
  Cluster c{cg::this_cluster(), sc, 0};
  const int rank = static_cast<int>(c.cl.block_rank());
  const int r = blockIdx.x / SB_CLUSTER;
  const int i0 = rank * chunk;
  const int n = ::max(0, ::min(V, i0 + chunk) - i0);
  const int tid = threadIdx.x;
  const float temp = temps[r];
  const bool sampled = temp > 0.0f;
  const float t_div = sampled ? temp : 1.0f;
  const T* lg = logits + r * row_stride + i0;

  // 1. greedy argmax of the raw logits; the scaled row's keys (true
  //    division, as the reference) and its max
  ArgMax best{-INFINITY, V};
  float mx = -INFINITY;
  for (int j = tid; j < n; j += SB_THREADS) {
    const float x = to_f32(lg[j]);
    if (x > best.v) best = ArgMax{x, i0 + j};
    if (sampled) {
      const float y = __fdiv_rn(x, t_div);
      keys[j] = sort_key(y);
      mx = fmaxf(mx, y);
    }
  }
  best = c.argmax(best);
  if (!sampled) {
    if (rank == 0 && tid == 0) out[r] = best.i;
    c.cl.sync();  // no block leaves while another reads its part
    return;
  }
  mx = c.max(mx);

  // 2. top-k: the k-th largest key (all kept when k is 0 or >= V)
  const int k_in = top_ks[r];
  const int k_eff = k_in > 0 ? ::min(k_in, V) : V;
  const bool topk = k_eff < V;
  uint32_t kth = 0;
  int n_above = 0;
  if (topk) kth = kth_largest_key(keys, n, k_eff, &n_above, c);

  // 3. nucleus: the smallest key t whose kept mass strictly above it
  //    falls below top_p of the kept mass (bisection, as the reference).
  //    The mass renormalizes over exactly k_eff entries, as the sorted
  //    reference does: copies of the k-th value past rank k_eff stay in
  //    the draw but not in the total.  Once lo == hi the reference's
  //    remaining steps leave hi as it is, so the loop stops there.
  const float top_p = top_ps[r];
  uint32_t thr = kth;
  if (top_p > 0.0f && top_p < 1.0f) {
    float z = 0.0f;
    uint32_t lo = 0xffffffffu, hi = 0u;
    for (int j = tid; j < n; j += SB_THREADS) {
      const uint32_t key = keys[j];
      float e = 0.0f;
      if (key >= kth) {
        e = expf(key_value(key) - mx);
        if (!topk || key > kth) z += e;
        lo = ::min(lo, key);
        hi = ::max(hi, key);
      }
      es[j] = e;
    }
    z = c.sum(z);
    if (topk) z += static_cast<float>(k_eff - n_above) *
                   expf(key_value(kth) - mx);
    c.minmax(lo, hi);
    for (int it = 0; it < 32 && lo < hi; ++it) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      float s_gt = 0.0f;
      for (int j = tid; j < n; j += SB_THREADS)
        if (keys[j] > mid) s_gt += es[j];
      s_gt = c.sum(s_gt);
      if (__fdiv_rn(s_gt, z) < top_p) {
        hi = mid;
      } else {
        lo = mid + 1u;
      }
    }
    thr = hi;
  }

  // 4. the draw: first-index argmax of scaled + Gumbel over kept keys.
  //    A filtered entry sits at -1e30 in the reference's row, and
  //    -1e30 + g rounds back to -1e30 unless g is +inf: then it is +inf
  //    and wins the reference's argmax like any other +inf.  Only the
  //    hash decides that, so that test reads no logits.
  const uint32_t w0 = words[2 * r], w1 = words[2 * r + 1];
  ArgMax pick{-INFINITY, V};
  for (int j = tid; j < n; j += SB_THREADS) {
    const uint32_t i = static_cast<uint32_t>(i0 + j);
    const uint32_t key = keys[j];
    if (key >= thr)
      pick = better(pick, ArgMax{__fadd_rn(key_value(key), gumbel(w0, w1, i)),
                                 static_cast<int>(i)});
    if (hash_bits(w0, w1, i) == 0xFFFFFFu)
      pick = better(pick, ArgMax{INFINITY, static_cast<int>(i)});
  }
  pick = c.argmax(pick);
  if (rank == 0 && tid == 0) out[r] = pick.i;
  c.cl.sync();  // no block leaves while another reads its part
}

// a block's chunk of the row: its keys and exp(x - max)
static size_t sample_smem_bytes(int V) {
  const size_t chunk = (static_cast<size_t>(V) + SB_CLUSTER - 1) / SB_CLUSTER;
  return chunk * (sizeof(uint32_t) + sizeof(float));
}

template <typename T>
static int launch_sample(const void* logits, long long row_stride, int R,
                         int V, const void* words, const void* temps,
                         const void* top_ks, const void* top_ps, void* out,
                         void* stream) {
  if (R < 0 || R > (1 << 27) || V < 1 ||
      (V + SB_CLUSTER - 1) / SB_CLUSTER > SB_MAX_CHUNK || row_stride < V)
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  const size_t smem = sample_smem_bytes(V);
  const cudaError_t err = cudaFuncSetAttribute(
      sample_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // R clusters of SB_CLUSTER blocks (the kernel's __cluster_dims__)
  sample_kernel<T><<<R * SB_CLUSTER, SB_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), row_stride, V,
      static_cast<const uint32_t*>(words), static_cast<const float*>(temps),
      static_cast<const int*>(top_ks), static_cast<const float*>(top_ps),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch_lm_head(const void* hidden, const void* w, void* logits,
                          int R, int H, int V, long long w_sk, long long w_sn,
                          void* stream) {
  if (R < 0 || H < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  dim3 grid((V + LM_BN - 1) / LM_BN, (R + LM_RT - 1) / LM_RT);
  // 16-byte runs: unit column stride, every row on a 16-byte boundary
  constexpr int E = 16 / sizeof(T);
  const bool vec = w_sn == 1 && w_sk % E == 0 && H % E == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(hidden) % 16 == 0;
  if constexpr (sizeof(T) == 2) {
    if (vec && w_sk == V && V % 8 == 0) {
      // up to 64 rows a block: the fewest 16-row tiles that hold them
      const int mt = R >= 64 ? 4 : (R + 15) / 16;
      dim3 g2((V + LMM_BN - 1) / LMM_BN, (R + 16 * mt - 1) / (16 * mt));
      const bf16* h = static_cast<const bf16*>(hidden);
      const bf16* wb = static_cast<const bf16*>(w);
      float* out = static_cast<float*>(logits);
      cudaStream_t st = static_cast<cudaStream_t>(stream);
      if (mt == 1) lm_head_mma_kernel<1><<<g2, LMM_THREADS, 0, st>>>(h, wb, out, R, H, V);
      else if (mt == 2) lm_head_mma_kernel<2><<<g2, LMM_THREADS, 0, st>>>(h, wb, out, R, H, V);
      else if (mt == 3) lm_head_mma_kernel<3><<<g2, LMM_THREADS, 0, st>>>(h, wb, out, R, H, V);
      else lm_head_mma_kernel<4><<<g2, LMM_THREADS, 0, st>>>(h, wb, out, R, H, V);
      return static_cast<int>(cudaGetLastError());
    }
  }
  lm_head_kernel<T><<<grid, LM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(hidden), static_cast<const T*>(w),
      static_cast<float*>(logits), R, H, V, w_sk, w_sn, vec);
  return static_cast<int>(cudaGetLastError());
}

HETU_EXPORT int hetu_sample_f32(const void* logits, long long row_stride,
                                int R, int V, const void* words,
                                const void* temps, const void* top_ks,
                                const void* top_ps, void* out, void* stream) {
  return launch_sample<float>(logits, row_stride, R, V, words, temps, top_ks,
                              top_ps, out, stream);
}

HETU_EXPORT int hetu_sample_bf16(const void* logits, long long row_stride,
                                 int R, int V, const void* words,
                                 const void* temps, const void* top_ks,
                                 const void* top_ps, void* out, void* stream) {
  return launch_sample<__nv_bfloat16>(logits, row_stride, R, V, words, temps,
                                      top_ks, top_ps, out, stream);
}

HETU_EXPORT int hetu_lm_head_f32(const void* hidden, const void* w,
                                 void* logits, int R, int H, int V,
                                 long long w_sk, long long w_sn,
                                 void* stream) {
  return launch_lm_head<float>(hidden, w, logits, R, H, V, w_sk, w_sn, stream);
}

HETU_EXPORT int hetu_lm_head_bf16(const void* hidden, const void* w,
                                  void* logits, int R, int H, int V,
                                  long long w_sk, long long w_sn,
                                  void* stream) {
  return launch_lm_head<__nv_bfloat16>(hidden, w, logits, R, H, V, w_sk, w_sn,
                                       stream);
}
