// Fused sampling epilogue: last-layer hidden rows x the LM head ->
// temperature / top-k / top-p filtering -> a Gumbel-argmax draw, one
// token a row.
//
// Replaces hetu_tpu/ops/pallas/sample.py `_sample_kernel` /
// `fused_sample` (with `hash_uniform`, `gumbel`, `_sort_key`,
// `_kth_largest_key` :122, `_nucleus_key` :138).  The contract is the
// TPU kernel's: hidden [R, H] + head w [H, V] + key words [R, 2] (the
// raw data of fold_in(key(seed), position)) + temperatures, top-ks and
// top-ps -> tokens [R] int32; temperature 0 rows take the first-index
// argmax of the unfiltered logits.
//
// The TPU kernel keeps a row's whole vocabulary in VMEM; a block on
// this card cannot (one fp32 row of 128256 is 513 KB against 227 KB of
// shared memory), so the work is two kernels:
//  (a) the product: fp32 logits [R, V] into a scratch buffer (20 MB at
//      R = 40, which stays in the 50 MB L2).  40 rows make 40 FLOP a
//      head byte against the card's ridge of 295, so the head's bytes
//      bound it (the 1.05 GB Llama-3-8B head: 0.314 ms at 3.35 TB/s;
//      GPT-2-large's tied 129 MB table: 0.038 ms).  A block owns a strip
//      of vocabulary columns for up to 64 rows, so the head is read from
//      device memory once, and streams it through a ring of 16-byte
//      `cp.async` copies in shared memory (zero-filled past V and past
//      H), so the next stages of the head are in flight while the tensor
//      cores (mma.sync.m16n8k16, 16-bit in, fp32 accumulators) work on the
//      current one.  One kernel serves both layouts of a 16-bit head
//      and both 16-bit types (bf16 and fp16 operands, fp32 logits, as the
//      reference's `_sample_kernel` accumulates)
//      (`lm_head_mma_kernel<T, MT, KMAJOR>`, tiles in `LmmTile`):
//        * N-major, rows of [H, V] (an untied head): a stage is 128
//          hidden rows of 256 columns, read by ldmatrix.trans;
//        * K-major, the transposed view of a [V, H] table (a tied head,
//          `wte.t()`): a stage is 128 table rows of 128 hidden dims,
//          whole 16-byte runs of each row, read by ldmatrix without
//          .trans, the layout mma.sync's B operand takes as it is.
//      The ragged edge of V is masked per element, so V needs no
//      alignment.  fp32 operands, and strides that neither layout covers,
//      run on fp32 FMAs (`lm_head_kernel`); the wrapper picks the route
//      from dtype, strides and alignment and the launch refuses a route
//      whose preconditions fail.
//  (b) `sample_kernel`, filter and draw: a thread-block cluster of
//      SB_CLUSTER = 8 blocks (1024 threads each) a row, over the logits
//      in L2.  Each block reads its eighth of the row once (16-byte
//      loads), keeps its keys (below) in shared memory, and every later
//      pass runs there; the blocks combine partial results through
//      distributed shared memory in rank order, read by one thread a
//      block and broadcast through its own shared memory.  A round (a
//      block reduction, a cluster barrier, the combine) costs ~1.5-4 us,
//      so the design counts rounds: greedy rows take one (the first-index
//      argmax); sampled rows work on the monotone uint32 image of the
//      temperature-scaled values (true division, as the reference).
//      Top-k finds the EXACT k-th largest value as the TPU kernel's
//      bisection does, by a radix select instead: four levels of a
//      256-bin histogram of integer counts (native shared-memory atomics,
//      so the order cannot change them); its first round also takes the
//      row's max.  The nucleus threshold is the TPU kernel's 32-step
//      bisection's answer: the smallest key t whose kept mass strictly
//      above it, S(t), gives fdiv(S(t), z) < top_p, S a sum of
//      exp(x - max) in a fixed order (a thread's entries in index order,
//      the block's warp trees, the cluster's ranks in order).  That
//      predicate is monotone in t and changes only at present keys, so
//      its answer is the smallest present key c where it holds.  A radix
//      select over MASS proposes c in four rounds (a 256-bin histogram a
//      level, exp(x - max) in fixed-point units added by integer atomics,
//      walked from the top to the bin where the mass above first falls
//      below top_p z; its first level rides on the pass that sums z);
//      one more round confirms it with the exact predicate at c and at
//      the next present key below c (the sum over keys >= c is the sum
//      over keys above that key, term for term) and, in the same pass,
//      draws with c as the threshold.  Where the histogram's rounding
//      misplaced c, the confirmation steps to the neighbour, and after
//      SB_STEPS steps the bisection runs over the bracket left, so the
//      threshold, and every token, is the bisection's bit for bit.  The
//      nucleus renormalizes over exactly k entries, as the sorted
//      reference (and the plain version) does, where the TPU kernel
//      counts every copy of the k-th value.  exp(x - max) is recomputed
//      where a pass needs it, not held: the keys alone fill a block's
//      shared memory, so two blocks can share an SM.  The kernel has two
//      builds (`launch_sample`): one block an SM for rows that fit in
//      one wave of clusters, two (registers capped at 32) for more rows,
//      twice the clusters a wave.  A row is limited to 8 x SB_MAX_CHUNK =
//      212,992 entries.  The draw adds Gumbel noise from the reference's
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

constexpr unsigned FULL = 0xffffffffu;

// The dynamic shared memory a block of `kernel` may take on the current
// device: the opt-in maximum less its static shared memory, set once a
// device (`cache` is per kernel).  -1 on failure.
template <typename K>
static int dyn_smem_limit(K kernel, int* cache) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (cache[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    if (cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncGetAttributes(&attr, kernel) != cudaSuccess)
      return -1;
    const int limit = optin - static_cast<int>(attr.sharedSizeBytes);
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             limit) != cudaSuccess)
      return -1;
    cache[dev] = limit;
  }
  return cache[dev];
}

// ------------------------------------------------------------ (a) product
constexpr int LM_THREADS = 256;
constexpr int LM_BN = 128;  // vocabulary columns a block
constexpr int LM_RT = 64;   // rows a block
constexpr int LM_BK = 32;   // hidden dims a step

// The launch's route, as the wrapper names it (ops/cuda/sample.py).
enum LmRoute { LM_N_MAJOR = 0, LM_K_MAJOR = 1, LM_FMA = 2 };

// A 16-byte load's values of T as fp32, exactly, from the loaded words
// (a pointer to the loaded vector would send it through local memory).
template <typename T>
__device__ __forceinline__ void unpack16(uint4 raw,
                                         float (&v)[16 / sizeof(T)]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(w[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = unpack16x2<T>(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
}

// fp32 FMAs: fp32 operands, and 16-bit heads whose strides neither
// layout of the tensor-core kernel covers.
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
        unpack16<T>(__ldg(reinterpret_cast<const uint4*>(src)), v);
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
        unpack16<T>(__ldg(reinterpret_cast<const uint4*>(
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

// The 16-bit product (bf16 or fp16 operands of type T, one body for
// both: `mma16<T>`) on the tensor cores: a block owns a strip of BN
// columns for up to 16 MT rows, a warp 32 of the columns for all of
// them.  Stages of BK hidden dims stream through a ring of STAGES slots
// in shared memory by 16-byte cp.async copies (each thread's copies a
// commit group; rows padded by 16 bytes, so an ldmatrix's 8 rows fall in
// 8 bank groups).  Needs H a multiple of 8, hidden and the head on
// 16-byte boundaries, and the head's row stride (w_ld) a multiple of 8:
// N-major rows of w [H, V] with unit column stride, or K-major rows of
// the [V, H] table whose transposed view w is.  The tiles of each layout
// are the fastest of a sweep on the H100 (tools_sample_bench.py times
// the chosen ones): N-major strips of 256 columns, 128-dim stages, two
// slots (170 KB, a block an SM, 8 warps: 512-byte runs of each head
// row); K-major strips of 128 table rows, 128-dim stages (256-byte runs
// of each row), three slots.
template <bool KMAJOR>
struct LmmTile {
  static constexpr int BN = KMAJOR ? 128 : 256;
  static constexpr int BK = 128;
  static constexpr int STAGES = KMAJOR ? 3 : 2;
  static constexpr int THREADS = BN;  // a warp a 32-column slice
  static constexpr int LDA = BK + 8;  // A: a row per hidden row
  static constexpr int LDB = KMAJOR ? BK + 8   // a row per table row
                                    : BN + 8;  // a row per hidden dim
};

template <int MT, bool KMAJOR>
struct LmmSmem {  // in 16-bit elements
  using Tl = LmmTile<KMAJOR>;
  static constexpr int A = 16 * MT * Tl::LDA;
  static constexpr int B = KMAJOR ? Tl::BN * Tl::LDB : Tl::BK * Tl::LDB;
  static constexpr int STAGE = A + B;
  static constexpr int BYTES = Tl::STAGES * STAGE * 2;
  static_assert(BYTES + 1024 <= 228 * 1024, "ring too large");
};

// 16 bytes global -> shared, of which the first `bytes` are read and the
// rest zero-filled (0: nothing is read; `src` must still be a valid
// address).
__device__ __forceinline__ void cp_async16(const void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

template <typename T, int MT, bool KMAJOR>
__global__ void __launch_bounds__(LmmTile<KMAJOR>::THREADS)
    lm_head_mma_kernel(const T* __restrict__ hidden,
                       const T* __restrict__ w,
                       float* __restrict__ logits, int R, int H, int V,
                       long long w_ld) {
  using L = LmmSmem<MT, KMAJOR>;
  using Tl = LmmTile<KMAJOR>;
  constexpr int LMM_BN = Tl::BN, LMM_BK = Tl::BK, LMM_STAGES = Tl::STAGES;
  constexpr int LMM_THREADS = Tl::THREADS, LMM_LDA = Tl::LDA;
  constexpr int LMM_LDK = Tl::LDB, LMM_LDN = Tl::LDB;
  extern __shared__ __align__(16) unsigned char lmm_raw[];
  T* smem = reinterpret_cast<T*>(lmm_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // blockIdx.x walks the row blocks of one strip, so the blocks that
  // read a strip of the head run together and share it through L2
  const int r0 = blockIdx.x * 16 * MT;
  const int n0 = blockIdx.y * LMM_BN;
  const int KT = (H + LMM_BK - 1) / LMM_BK;

  // stage kt into ring slot `slot`: zeros past R, H and V
  auto load = [&](int slot, int kt) {
    T* As = smem + slot * L::STAGE;
    T* Bs = As + L::A;
    const int k0 = kt * LMM_BK;
    constexpr int KC = LMM_BK / 8, NC = LMM_BN / 8;  // chunks a row
#pragma unroll
    for (int c = tid; c < 16 * MT * KC; c += LMM_THREADS) {  // 16 MT rows
      const int r = c / KC, k = k0 + (c % KC) * 8;
      const bool ok = r0 + r < R && k < H;
      cp_async16(As + r * LMM_LDA + (c % KC) * 8,
                 ok ? hidden + static_cast<long long>(r0 + r) * H + k : hidden,
                 ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < LMM_BK * NC / LMM_THREADS; ++i) {
      const int c = tid + i * LMM_THREADS;
      if constexpr (KMAJOR) {  // LMM_BN table rows of LMM_BK dims
        const int n = c / KC, k = (c % KC) * 8;
        const bool ok = n0 + n < V && k0 + k < H;
        cp_async16(Bs + n * LMM_LDK + k,
                   ok ? w + static_cast<long long>(n0 + n) * w_ld + k0 + k : w,
                   ok ? 16 : 0);
      } else {  // LMM_BK hidden rows of LMM_BN columns, ragged at V
        const int k = c / NC, nc = (c % NC) * 8;
        const int left = V - (n0 + nc);
        const int bytes = (k0 + k < H && left > 0) ? 2 * min(left, 8) : 0;
        cp_async16(Bs + k * LMM_LDN + nc,
                   bytes ? w + static_cast<long long>(k0 + k) * w_ld + n0 + nc
                         : w,
                   bytes);
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][t][e] = 0.0f;
  // A fragments: rows 0-15 of a tile, columns k .. k+7 then k+8 .. k+15.
  // B fragments of columns n .. n+7, then n+8 .. n+15, each over k ..
  // k+7 and k+8 .. k+15: K-major rows are columns (ldmatrix as stored),
  // N-major rows are hidden dims (ldmatrix.trans).
  const int a_off = (lane & 15) * LMM_LDA + (lane >> 4) * 8;
  const int b_off =
      KMAJOR ? (warp * 32 + (lane & 7) + ((lane >> 4) << 3)) * LMM_LDK +
                   ((lane >> 3) & 1) * 8
             : (((lane >> 3) & 1) * 8 + (lane & 7)) * LMM_LDN +
                   (lane >> 4) * 8 + warp * 32;

#pragma unroll
  for (int s = 0; s < LMM_STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<LMM_STAGES - 2>();  // stage kt has landed (this thread's)
    __syncthreads();  // ... every thread's; and slot kt - 1 is read
    if (kt + LMM_STAGES - 1 < KT)
      load((kt + LMM_STAGES - 1) % LMM_STAGES, kt + LMM_STAGES - 1);
    cp_async_commit();
    const T* As = smem + (kt % LMM_STAGES) * L::STAGE;
    const T* Bs = As + L::A;
#pragma unroll
    for (int ks = 0; ks < LMM_BK / 16; ++ks) {
      unsigned b[2][4];
      if constexpr (KMAJOR) {
        ldmatrix_x4(b[0], Bs + b_off + 16 * ks);
        ldmatrix_x4(b[1], Bs + b_off + 16 * LMM_LDK + 16 * ks);
      } else {
        ldmatrix_x4_trans(b[0], Bs + b_off + 16 * ks * LMM_LDN);
        ldmatrix_x4_trans(b[1], Bs + b_off + 16 * ks * LMM_LDN + 16);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        unsigned a[4];
        ldmatrix_x4(a, As + a_off + 16 * m * LMM_LDA + 16 * ks);
        mma16<T>(acc[m][0], a, b[0][0], b[0][1]);
        mma16<T>(acc[m][1], a, b[0][2], b[0][3]);
        mma16<T>(acc[m][2], a, b[1][0], b[1][1]);
        mma16<T>(acc[m][3], a, b[1][2], b[1][3]);
      }
    }
  }
  // each element masked at R and V; pairs stored as one 8-byte store
  // where a row of V fp32 keeps them on 8-byte boundaries (V even)
  const int g = lane >> 2, tig = lane & 3;
  const bool pairs = (V & 1) == 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 16 * m + g + 8 * h;
        const int n = n0 + warp * 32 + 8 * t + 2 * tig;
        if (r >= R || n >= V) continue;
        float* o = logits + static_cast<long long>(r) * V + n;
        if (pairs) {
          *reinterpret_cast<float2*>(o) =
              make_float2(acc[m][t][2 * h], acc[m][t][2 * h + 1]);
        } else {
          o[0] = acc[m][t][2 * h];
          if (n + 1 < V) o[1] = acc[m][t][2 * h + 1];
        }
      }
}

// ------------------------------------------------- (b) filter and draw
constexpr int SB_THREADS = 1024;
constexpr int SB_WARPS = SB_THREADS / 32;
constexpr int SB_CLUSTER = 8;        // blocks a row: one thread-block cluster
constexpr int SB_MAX_CHUNK = 26624;  // values a block holds: V <= 212,992
constexpr int SB_BINS = 256;         // a radix level: 8 bits of the key
constexpr int SB_STEPS = 3;          // confirmations before the bisection
static_assert(SB_WARPS == 32, "a block reduction's second level is one warp");
static_assert(SB_MAX_CHUNK <= 32 * SB_THREADS, "a thread's entries: 32 bits");

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

// The scalars of a cluster reduction.
struct Vals {
  ArgMax am;
  float f, f2;
  uint32_t lo, hi;
};

// What a block offers a cluster reduction; the other blocks of the
// cluster read it from this block's shared memory.
struct Part {
  Vals v;
  unsigned hist[SB_BINS];  // a level's key counts (top-k) or mass units
};

struct Scratch {
  ArgMax am[SB_WARPS];
  float f[SB_WARPS], f2[SB_WARPS];
  unsigned u[SB_WARPS], u2[SB_WARPS];
  union {  // the cluster's histogram of one radix level
    unsigned hist[SB_BINS];
    float mass[SB_BINS];
  };
  int sel, cum;
  float above;
  Vals bc;  // a cluster reduction's result, for every thread of the block
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
    ArgMax b{__shfl_xor_sync(FULL, a.v, o), __shfl_xor_sync(FULL, a.i, o)};
    a = better(a, b);
  }
  __syncthreads();
  if (lane == 0) sc.am[warp] = a;
  __syncthreads();
  a = sc.am[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    ArgMax b{__shfl_xor_sync(FULL, a.v, o), __shfl_xor_sync(FULL, a.i, o)};
    a = better(a, b);
  }
  return a;
}

__device__ float block_sum(float v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  __syncthreads();
  if (lane == 0) sc.f[warp] = v;
  __syncthreads();
  v = sc.f[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ float block_max(float v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  __syncthreads();
  if (lane == 0) sc.f[warp] = v;
  __syncthreads();
  v = sc.f[lane];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Two sums (each in block_sum's order), a max, a min and an argmax
// (block_argmax's), in one pair of barriers.
__device__ void block_vals(Vals& v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const auto tree = [&]() {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.f += __shfl_xor_sync(FULL, v.f, o);
      v.f2 += __shfl_xor_sync(FULL, v.f2, o);
      v.hi = max(v.hi, __shfl_xor_sync(FULL, v.hi, o));
      v.lo = min(v.lo, __shfl_xor_sync(FULL, v.lo, o));
      v.am = better(v.am, ArgMax{__shfl_xor_sync(FULL, v.am.v, o),
                                 __shfl_xor_sync(FULL, v.am.i, o)});
    }
  };
  tree();
  __syncthreads();
  if (lane == 0) {
    sc.f[warp] = v.f;
    sc.f2[warp] = v.f2;
    sc.u[warp] = v.hi;
    sc.u2[warp] = v.lo;
    sc.am[warp] = v.am;
  }
  __syncthreads();
  v.f = sc.f[lane];
  v.f2 = sc.f2[lane];
  v.hi = sc.u[lane];
  v.lo = sc.u2[lane];
  v.am = sc.am[lane];
  tree();
}

// Folds a rank's values into the running ones: every field.
struct FoldAll {
  __device__ void operator()(Vals& x, const Vals& y) const {
    x.f += y.f;
    x.f2 += y.f2;
    x.hi = max(x.hi, y.hi);
    x.lo = min(x.lo, y.lo);
    x.am = better(x.am, y.am);
  }
};

// Cluster reductions: each block's result goes to its next part; after
// the cluster barrier thread 0 combines the parts in rank order and
// broadcasts the result through this block's shared memory, so all
// blocks hold the same bits and take the same branches (one reader a
// block: 8 remote loads a reduction, not 8 a thread).
struct Cluster {
  cg::cluster_group cl;
  Scratch& sc;
  int seq;

  __device__ Part& mine() { return sc.part[seq & 1]; }
  __device__ const Part& of(Part& p, int rank) {
    return *cl.map_shared_rank(&p, rank);
  }

  // The barrier, then `op` folds ranks 1.. into rank 0's values.
  template <typename Op>
  __device__ Vals combine(Part& p, Op op) {
    cl.sync();
    if (threadIdx.x == 0) {
      Vals a = of(p, 0).v;
      for (int rk = 1; rk < SB_CLUSTER; ++rk) op(a, of(p, rk).v);
      sc.bc = a;
    }
    __syncthreads();
    return sc.bc;
  }
  // This block's values into its next part, then `combine`.
  template <typename Op>
  __device__ Vals reduce(const Vals& mine_v, Op op) {
    Part& p = mine();
    ++seq;
    if (threadIdx.x == 0) p.v = mine_v;
    return combine(p, op);
  }

  __device__ ArgMax argmax(ArgMax a) {
    Vals v{};
    v.am = block_argmax(a, sc);
    return reduce(v, [](Vals& x, const Vals& y) { x.am = better(x.am, y.am); })
        .am;
  }

  __device__ float sum(float f) {
    Vals v{};
    v.f = block_sum(f, sc);
    return reduce(v, [](Vals& x, const Vals& y) { x.f += y.f; }).f;
  }

  __device__ float max(float f) {
    Vals v{};
    v.f = block_max(f, sc);
    return reduce(v, [](Vals& x, const Vals& y) { x.f = fmaxf(x.f, y.f); })
        .f;
  }

  // `sum`'s two sums (each bit for bit what `sum` gives), a max, a min
  // and `argmax`'s argmax, in one round.
  __device__ Vals all(Vals v) {
    block_vals(v, sc);
    return reduce(v, FoldAll{});
  }
};

// Radix select over the cluster's keys: the key of the k-th largest
// scaled value (duplicates counted as the sort counts them) and how
// many keys lie above it.  Four levels of a 256-bin histogram of
// integer counts (the order of the atomics cannot change them), each
// lane its own native shared-memory atomic.
// With `mx` (a block's max, else null) the first level's round also
// takes the cluster's max into *mx.
__device__ uint32_t kth_largest_key(const uint32_t* keys, int n, int k,
                                    int* n_above, Cluster& c, float* mx) {
  Scratch& sc = c.sc;
  const int tid = threadIdx.x, lane = tid & 31;
  uint32_t prefix = 0, mask = 0;
  int above = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    Part& p = c.mine();
    ++c.seq;
    if (tid < SB_BINS) p.hist[tid] = 0;
    if (mx && shift == 24) {
      const float m = block_max(*mx, sc);  // its barriers: the zeroed bins
      if (tid == 0) p.v.f = m;
    } else {
      __syncthreads();
    }
    for (int j = tid; j < n; j += SB_THREADS) {
      const uint32_t key = keys[j];
      if ((key & mask) == prefix) atomicAdd(&p.hist[(key >> shift) & 255u], 1u);
    }
    c.cl.sync();
    if (tid < SB_BINS) {
      unsigned t = 0;
      for (int rk = 0; rk < SB_CLUSTER; ++rk) t += c.of(p, rk).hist[tid];
      sc.hist[tid] = t;
    }
    if (mx && shift == 24 && tid == SB_BINS) {  // a thread outside the bins
      float m = c.of(p, 0).v.f;
      for (int rk = 1; rk < SB_CLUSTER; ++rk) m = fmaxf(m, c.of(p, rk).v.f);
      sc.bc.f = m;
    }
    __syncthreads();
    if (mx && shift == 24) *mx = sc.bc.f;
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
        const unsigned b = __shfl_up_sync(FULL, pre, o);
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

// The nucleus's mass bins are integers: exp(x - max) <= 1 in units of
// 2^-S, S chosen so that no bin of a block can pass 2^31 (`mass_shift`),
// added into the block's part by native shared-memory integer atomics
// (a float atomicAdd on shared memory is a compare-and-swap loop), each
// lane its own, so the sums are exact whatever the order.  An entry
// below half a unit adds nothing and is skipped (the kernel's `cut`: keys
// more than (S + 1.5) ln 2 below the max, 12.8 nats at Llama-3's
// vocabulary), so a level's atomics touch only the entries that matter.
__device__ __forceinline__ void hist_add(unsigned* hist, int bin, unsigned u) {
  if (u) atomicAdd(hist + bin, u);
}

// S for chunks of `chunk` entries: 2^b >= chunk gives S = 31 - b (every
// block of the cluster the same).
__device__ __forceinline__ int mass_shift(int chunk) {
  return 31 - (32 - __clz(::max(chunk, 2) - 1));
}

// This block's next part for a level's bins: zeroed here for the first
// level, by the gather before it for the others (`mass_gather`).
__device__ Part& mass_part(Cluster& c, bool first) {
  Part& p = c.mine();
  ++c.seq;
  if (first) {
    if (threadIdx.x < SB_BINS) p.hist[threadIdx.x] = 0u;
    __syncthreads();
  }
  return p;
}

// After the cluster barrier: the cluster's bin masses (in `unit`s) into
// sc.mass, for `mass_select` after a block barrier.
__device__ void mass_gather(Cluster& c, Part& p, float unit) {
  const int tid = threadIdx.x;
  if (tid < SB_BINS) {
    unsigned long long m = 0;
    for (int rk = 0; rk < SB_CLUSTER; ++rk) m += c.of(p, rk).hist[tid];
    c.sc.mass[tid] = static_cast<float>(m) * unit;
    // the next reduction's part, zeroed for a next level: its last
    // readers passed the cluster barrier before this one's
    c.mine().hist[tid] = 0u;
  }
}

// Warp 0 walks the gathered bin masses from the top for the lowest bin
// holding mass whose mass strictly above (plus `above`, the mass above
// this level's prefix) is below `target`.  Sets sc.sel (-1: none) and
// sc.above, the mass above that bin.
__device__ void mass_select(Scratch& sc, float above, float target) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {  // lane l owns bins 255 - 8l .. 248 - 8l
    float m[8], tot = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m[j] = sc.mass[255 - (8 * lane + j)];
      tot += m[j];
    }
    float pre = tot;  // inclusive scan over lanes
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float b = __shfl_up_sync(FULL, pre, o);
      if (lane >= o) pre += b;
    }
    float cum = above + (pre - tot);
    int best = -1;
    float best_above = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (m[j] > 0.0f && cum < target) {
        best = 255 - (8 * lane + j);
        best_above = cum;
      }
      cum += m[j];
    }
    const unsigned has = __ballot_sync(FULL, best >= 0);
    if (has == 0u) {
      if (lane == 0) sc.sel = -1;
    } else if (lane == 31 - __clz(has)) {  // the lowest bin: the last lane
      sc.sel = best;
      sc.above = best_above;
    }
  }
  __syncthreads();
}

// f(j, key) for this thread's entries j = tid + SB_THREADS i whose key
// `take` holds, in ascending j (so a thread's sums keep their order): the
// entries are marked first by cheap tests, then the lanes of a warp run
// f together over their marks, so a body that few entries need (an exp,
// a Gumbel draw) costs a warp its busiest lane's count, not a pass.
template <typename P, typename F>
__device__ __forceinline__ void for_taken(const uint32_t* keys, int n, P take,
                                          F f) {
  unsigned marks = 0u;
  for (int i = 0, j = threadIdx.x; j < n; ++i, j += SB_THREADS)
    if (take(keys[j])) marks |= 1u << i;
  while (marks) {
    const int j = threadIdx.x + (__ffs(marks) - 1) * SB_THREADS;
    marks &= marks - 1u;
    f(j, keys[j]);
  }
}

// f(j, value) for j = 0 .. n-1 of a block's chunk of the row, each
// thread its values in ascending order: 16-byte loads where the chunk
// allows (a scalar head up to the first 16-byte boundary, a scalar tail).
template <typename T, typename F>
__device__ __forceinline__ void for_each_value(const T* lg, int n, F f) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int head = ::min(
      n, static_cast<int>(((16 - (reinterpret_cast<uintptr_t>(lg) & 15)) & 15) /
                          sizeof(T)));
  for (int j = tid; j < head; j += SB_THREADS) f(j, to_f32(lg[j]));
  const int nv = (n - head) / E;
  const uint4* vec = reinterpret_cast<const uint4*>(lg + head);
  for (int i = tid; i < nv; i += SB_THREADS) {
    float x[E];
    unpack16<T>(__ldg(vec + i), x);
#pragma unroll
    for (int e = 0; e < E; ++e) f(head + i * E + e, x[e]);
  }
  for (int j = head + nv * E + tid; j < n; j += SB_THREADS) f(j, to_f32(lg[j]));
}

// One row a cluster of SB_CLUSTER blocks: block `rank` holds columns
// rank * chunk .. + chunk of the row in shared memory (their keys), so
// the logits are read once and every later pass runs over shared memory
// on SB_CLUSTER SMs.
template <typename T, int MINB>
__global__ void __cluster_dims__(SB_CLUSTER, 1, 1)
    __launch_bounds__(SB_THREADS, MINB)
    sample_kernel(const T* __restrict__ logits, long long row_stride, int V,
                  const uint32_t* __restrict__ words,
                  const float* __restrict__ temps,
                  const int* __restrict__ top_ks,
                  const float* __restrict__ top_ps, int* __restrict__ out) {
  __shared__ Scratch sc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chunk = (V + SB_CLUSTER - 1) / SB_CLUSTER;
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);  // [chunk]
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

  // 1. greedy rows: the first-index argmax of the raw logits.  Sampled
  //    rows: the scaled row's keys (true division, as the reference) and
  //    its max.  A thread takes its values in ascending order, so the
  //    first of equal maxima stays.
  if (!sampled) {
    ArgMax best{-INFINITY, V};
    for_each_value(lg, n, [&](int j, float x) {
      if (x > best.v) best = ArgMax{x, i0 + j};
    });
    best = c.argmax(best);
    if (rank == 0 && tid == 0) out[r] = best.i;
    c.cl.sync();  // no block leaves while another reads its part
    return;
  }
  float mx = -INFINITY;
  for_each_value(lg, n, [&](int j, float x) {
    const float y = __fdiv_rn(x, t_div);
    keys[j] = sort_key(y);
    mx = fmaxf(mx, y);
  });
  const float top_p = top_ps[r];
  const bool p_on = top_p > 0.0f && top_p < 1.0f;

  // The draw: first-index argmax of scaled + Gumbel over the keys kept
  // by threshold t (any order: `better` keeps the first index).  A
  // filtered entry sits at -1e30 in the reference's row, and -1e30 + g
  // rounds back to -1e30 unless g is +inf: then it is +inf and wins the
  // reference's argmax like any other +inf.  Only the hash decides that,
  // so that test reads no logits.
  const uint32_t w0 = words[2 * r], w1 = words[2 * r + 1];
  const auto noisy = [&](ArgMax& a, int j, uint32_t key) {  // a kept entry
    const uint32_t i = static_cast<uint32_t>(i0 + j);
    a = better(a, ArgMax{__fadd_rn(key_value(key), gumbel(w0, w1, i)),
                         static_cast<int>(i)});
  };
  const auto infinite = [&](ArgMax& a, int j) {  // any entry
    const uint32_t i = static_cast<uint32_t>(i0 + j);
    if (hash_bits(w0, w1, i) == 0xFFFFFFu)
      a = better(a, ArgMax{INFINITY, static_cast<int>(i)});
  };
  ArgMax pick{-INFINITY, V};
  bool drawn = false;

  // 2. top-k: the k-th largest key (all kept when k is 0 or >= V)
  //    The nucleus needs the row's max: top-k's first round takes it,
  //    else a round of its own.
  const int k_in = top_ks[r];
  const int k_eff = k_in > 0 ? ::min(k_in, V) : V;
  const bool topk = k_eff < V;
  uint32_t kth = 0;
  int n_above = 0;
  if (topk) {
    kth = kth_largest_key(keys, n, k_eff, &n_above, c, p_on ? &mx : nullptr);
  } else if (p_on) {
    mx = c.max(mx);  // its barriers also publish the keys
  } else {
    __syncthreads();  // the keys are written
  }

  // 3. nucleus: the smallest present kept key t whose kept mass strictly
  //    above it falls below top_p of the kept mass, as the reference's
  //    bisection decides it.  The mass renormalizes over exactly k_eff
  //    entries, as the sorted reference does: copies of the k-th value
  //    past rank k_eff stay in the draw but not in the total.
  uint32_t thr = kth;
  if (p_on) {
    // exp(x - max) of a kept key, the reference's value, recomputed where
    // a pass needs it rather than held beside the keys (half the shared
    // memory, so two blocks share an SM where the chunk allows)
    const auto ev = [mx](uint32_t key) { return expf(key_value(key) - mx); };
    const int shift_u = mass_shift(chunk);
    const float scale = ldexpf(1.0f, shift_u), unit = ldexpf(1.0f, -shift_u);
    // keys below `cut` hold less than half a unit of mass: no level adds
    // them, and the later levels skip them before any exp
    const uint32_t cut = sort_key(mx - (static_cast<float>(shift_u) + 1.5f) *
                                           0.69314718f);
    // the radix starts at the first byte where the keys that can add mass,
    // [max(kth, cut), the row's max], differ (a top-k row's few keys
    // often share their first byte: one level fewer)
    const uint32_t low = ::max(kth, cut), top = sort_key(mx);
    int shift0 = 24;
    while (shift0 > 0 && (low >> shift0) == (top >> shift0)) shift0 -= 8;
    const uint32_t mask0 = shift0 == 24 ? 0u : ~0u << (shift0 + 8);
    // the first level rides on the pass that computes the kept total z
    // and the kept keys' range [lo, hi]
    float z = 0.0f;
    uint32_t lo = 0xffffffffu, hi = 0u;
    Part& p = mass_part(c, true);
    for (int j = tid; j < n; j += SB_THREADS) {
      const uint32_t key = keys[j];
      if (key >= kth) {
        const float e = ev(key);
        if (!topk || key > kth) z += e;
        lo = ::min(lo, key);
        hi = ::max(hi, key);
        if (key >= cut)  // then key >= low: its bytes above shift0 are top's
          hist_add(p.hist, static_cast<int>((key >> shift0) & 255u),
                   __float2uint_rn(__fmul_rn(e, scale)));
      }
    }
    Vals v{ArgMax{-INFINITY, V}, z, 0.0f, lo, hi};
    block_vals(v, sc);  // its barriers: the bins
    if (tid == 0) p.v = v;
    // one gather for the totals and the bins: `combine` without its own
    c.cl.sync();        // barriers, so `sum`'s rank-order total, bit for bit
    if (tid == SB_BINS) {  // a thread outside the bins
      Vals a = c.of(p, 0).v;
      for (int rk = 1; rk < SB_CLUSTER; ++rk) FoldAll{}(a, c.of(p, rk).v);
      sc.bc = a;
    }
    mass_gather(c, p, unit);
    __syncthreads();
    z = sc.bc.f;
    hi = sc.bc.hi;
    lo = sc.bc.lo;
    if (topk) z += static_cast<float>(k_eff - n_above) *
                   expf(key_value(kth) - mx);
    // propose: the radix select over mass
    const float target = __fmul_rn(top_p, z);
    mass_select(sc, 0.0f, target);
    uint32_t prefix = top & mask0, mask = mask0;
    bool lost = false;
    for (int shift = shift0;; shift -= 8) {
      // (the next walk rewrites them after a cluster barrier, which every
      // thread reaches after reading them)
      const int sel = sc.sel;
      const float above = sc.above;
      if (sel < 0) {  // rounding left no bin: propose the top key
        lost = true;
        break;
      }
      prefix |= static_cast<uint32_t>(sel) << shift;
      mask |= 255u << shift;
      if (shift == 0) break;
      Part& q = mass_part(c, false);
      for (int j = tid; j < n; j += SB_THREADS) {
        const uint32_t key = keys[j];
        if ((key & mask) == prefix && key >= kth && key >= cut)
          hist_add(q.hist, static_cast<int>((key >> (shift - 8)) & 255u),
                   __float2uint_rn(__fmul_rn(ev(key), scale)));
      }
      c.cl.sync();  // its block barrier: the bins
      mass_gather(c, q, unit);
      __syncthreads();
      mass_select(sc, above, target);
    }
    // confirm with the bisection's predicate P(t) = fdiv(S(t), z) <
    // top_p, S(t) the fixed-order sum of exp(x - max) over keys > t.  The answer
    // c* lies in [lo, hi] (P(hi) holds: S = 0).  At a candidate c one
    // pass gives S(c), S over keys >= c (= S at the next present kept key
    // below c, term for term: no kept key lies between), that key and
    // the next present kept key above c.
    //    The first pass also draws with c as the threshold (step 4's
    //    work), kept where c is confirmed at once: one round less.
    uint32_t cand = lost ? hi : prefix;
    for (int step = 0; step < SB_STEPS && lo < hi; ++step) {
      // f, f2: S over keys > c and >= c; hi: that key + 1 (0: none); lo:
      // the next key above c
      Vals x{ArgMax{-INFINITY, V}, 0.0f, 0.0f, 0xffffffffu, 0u};
      for (int j = tid; j < n; j += SB_THREADS) {
        const uint32_t key = keys[j];
        if (key >= kth) {
          if (key < cand) x.hi = ::max(x.hi, key + 1u);
          if (key > cand) x.lo = ::min(x.lo, key);
        }
        if (step == 0) infinite(x.am, j);
      }
      for_taken(keys, n, [cand](uint32_t key) { return key >= cand; },
                [&](int j, uint32_t key) {  // kept: cand >= lo >= kth
                  const float e = ev(key);
                  if (key > cand) x.f += e;
                  x.f2 += e;
                  if (step == 0) noisy(x.am, j, key);
                });
      x = c.all(x);
      if (__fdiv_rn(x.f, z) < top_p) {
        hi = cand;
        if (x.hi == 0u || !(__fdiv_rn(x.f2, z) < top_p)) {
          lo = cand;  // P fails just below c: c is the answer
          if (step == 0) {
            pick = x.am;
            drawn = true;
          }
          break;
        }
        hi = x.hi - 1u;  // P holds at the key below too
        cand = hi;
      } else {
        lo = x.lo;  // c* lies above c
        cand = x.lo;
      }
    }
    // where rounding misplaced the candidate by more than SB_STEPS keys,
    // the reference's bisection over what is left of [lo, hi]
    while (lo < hi) {
      const uint32_t mid = lo + ((hi - lo) >> 1);
      float s_gt = 0.0f;
      for_taken(keys, n, [mid](uint32_t key) { return key > mid; },
                [&](int, uint32_t key) { s_gt += ev(key); });
      s_gt = c.sum(s_gt);
      if (__fdiv_rn(s_gt, z) < top_p) {
        hi = mid;
      } else {
        lo = mid + 1u;
      }
    }
    thr = hi;
  }

  // 4. the draw (where the nucleus's first confirmation did not draw)
  if (!drawn) {
    for (int j = tid; j < n; j += SB_THREADS) {
      const uint32_t key = keys[j];
      if (key >= thr) noisy(pick, j, key);
      infinite(pick, j);
    }
    pick = c.argmax(pick);
  }
  if (rank == 0 && tid == 0) out[r] = pick.i;
  c.cl.sync();  // no block leaves while another reads its part
}

// A block's shared memory: the keys of its chunk of the row, with the
// attribute set once a device.  -1 where the chunk does not fit.
template <typename T, int MINB>
static long long sample_smem(int V) {
  static int cache[64];
  const int limit = dyn_smem_limit(sample_kernel<T, MINB>, cache);
  const long long bytes =
      (static_cast<long long>(V) + SB_CLUSTER - 1) / SB_CLUSTER *
      static_cast<long long>(sizeof(uint32_t));
  return limit < 0 || bytes > limit ? -1 : bytes;
}

// Clusters of the draw kernel the current device runs at once for rows
// of V entries (its waves: rows over this), or minus a cudaError_t.
template <typename T, int MINB>
static int active_clusters(int V) {
  const long long smem = sample_smem<T, MINB>(V);
  if (smem < 0) return -static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(SB_CLUSTER * 1024);
  cfg.blockDim = dim3(SB_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &clusters, sample_kernel<T, MINB>, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// Two builds of the kernel, the same arithmetic: MINB = 1 keeps its
// registers (63) and one block an SM at any V; MINB = 2 caps them at 32
// (a few spilled) so two blocks share an SM and twice the clusters run
// at once.  Rows that fit in one wave of the first take it, more rows
// the second.  The first's wave, once a device:
template <typename T>
static int one_wave() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return -static_cast<int>(cudaErrorInvalidValue);
  if (cache[dev] == 0) {
    const int n = active_clusters<T, 1>(SB_CLUSTER * SB_MAX_CHUNK);
    if (n <= 0) return n;
    cache[dev] = n;
  }
  return cache[dev];
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
  const int wave = one_wave<T>();
  if (wave <= 0) return wave < 0 ? -wave : static_cast<int>(cudaErrorInvalidValue);
  const bool wide = R > wave;
  const long long smem = wide ? sample_smem<T, 2>(V) : sample_smem<T, 1>(V);
  if (smem < 0) return static_cast<int>(cudaErrorInvalidValue);
  // R clusters of SB_CLUSTER blocks (the kernel's __cluster_dims__)
  auto kernel = wide ? sample_kernel<T, 2> : sample_kernel<T, 1>;
  kernel<<<R * SB_CLUSTER, SB_THREADS, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), row_stride, V,
      static_cast<const uint32_t*>(words), static_cast<const float*>(temps),
      static_cast<const int*>(top_ks), static_cast<const float*>(top_ps),
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MT, bool KMAJOR>
static cudaError_t launch_lm_head_mma(const T* hidden, const T* w,
                                      float* logits, int R, int H, int V,
                                      long long w_ld, cudaStream_t stream) {
  using L = LmmSmem<MT, KMAJOR>;
  static int cache[64];
  const int limit = dyn_smem_limit(lm_head_mma_kernel<T, MT, KMAJOR>, cache);
  if (limit < L::BYTES) return cudaErrorInvalidValue;
  using Tl = LmmTile<KMAJOR>;
  const dim3 grid((R + 16 * MT - 1) / (16 * MT), (V + Tl::BN - 1) / Tl::BN);
  lm_head_mma_kernel<T, MT, KMAJOR><<<grid, Tl::THREADS, L::BYTES, stream>>>(
      hidden, w, logits, R, H, V, w_ld);
  return cudaGetLastError();
}

template <typename T, bool KMAJOR>
static cudaError_t launch_lm_head_tc(const T* hidden, const T* w,
                                     float* logits, int R, int H, int V,
                                     long long w_ld, cudaStream_t stream) {
  // up to 64 rows a block: the fewest 16-row tiles that hold them
  const int mt = R >= 64 ? 4 : (R + 15) / 16;
  switch (mt) {
    case 1: return launch_lm_head_mma<T, 1, KMAJOR>(hidden, w, logits, R, H, V, w_ld, stream);
    case 2: return launch_lm_head_mma<T, 2, KMAJOR>(hidden, w, logits, R, H, V, w_ld, stream);
    case 3: return launch_lm_head_mma<T, 3, KMAJOR>(hidden, w, logits, R, H, V, w_ld, stream);
    default: return launch_lm_head_mma<T, 4, KMAJOR>(hidden, w, logits, R, H, V, w_ld, stream);
  }
}

template <typename T>
static int launch_lm_head(const void* hidden, const void* w, void* logits,
                          int R, int H, int V, long long w_sk, long long w_sn,
                          int route, void* stream) {
  if (R < 0 || H < 1 || V < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == LM_N_MAJOR || route == LM_K_MAJOR) {
    // the tensor-core kernel's preconditions; a route that misses one is
    // refused, never run on another arm
    const bool kmajor = route == LM_K_MAJOR;
    const long long ld = kmajor ? w_sn : w_sk;
    if constexpr (sizeof(T) != 2) {
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (H % 8 || ld % 8 || (kmajor ? w_sk : w_sn) != 1 ||
          !aligned16({hidden, w}) || (V + 127) / 128 > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
      const T* h = static_cast<const T*>(hidden);
      const T* wb = static_cast<const T*>(w);
      float* o = static_cast<float*>(logits);
      return static_cast<int>(
          kmajor ? launch_lm_head_tc<T, true>(h, wb, o, R, H, V, ld, st)
                 : launch_lm_head_tc<T, false>(h, wb, o, R, H, V, ld, st));
    }
  }
  if (route != LM_FMA) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((V + LM_BN - 1) / LM_BN, (R + LM_RT - 1) / LM_RT);
  // 16-byte runs: unit column stride, every row on a 16-byte boundary
  constexpr int E = 16 / sizeof(T);
  const bool vec = w_sn == 1 && w_sk % E == 0 && H % E == 0 &&
                   aligned16({hidden, w});
  lm_head_kernel<T><<<grid, LM_THREADS, 0, st>>>(
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

// The clusters a wave holds for R rows of V entries: the build the
// launch takes for them.
HETU_EXPORT int hetu_sample_clusters_f32(int R, int V) {
  const int one = one_wave<float>();
  return one < 0 || R <= one ? one : active_clusters<float, 2>(V);
}

HETU_EXPORT int hetu_sample_clusters_bf16(int R, int V) {
  const int one = one_wave<__nv_bfloat16>();
  return one < 0 || R <= one ? one : active_clusters<__nv_bfloat16, 2>(V);
}

HETU_EXPORT int hetu_sample_f16(const void* logits, long long row_stride,
                                int R, int V, const void* words,
                                const void* temps, const void* top_ks,
                                const void* top_ps, void* out, void* stream) {
  return launch_sample<__half>(logits, row_stride, R, V, words, temps, top_ks,
                               top_ps, out, stream);
}

HETU_EXPORT int hetu_sample_clusters_f16(int R, int V) {
  const int one = one_wave<__half>();
  return one < 0 || R <= one ? one : active_clusters<__half, 2>(V);
}

HETU_EXPORT int hetu_lm_head_f32(const void* hidden, const void* w,
                                 void* logits, int R, int H, int V,
                                 long long w_sk, long long w_sn, int route,
                                 void* stream) {
  return launch_lm_head<float>(hidden, w, logits, R, H, V, w_sk, w_sn, route,
                               stream);
}

HETU_EXPORT int hetu_lm_head_bf16(const void* hidden, const void* w,
                                  void* logits, int R, int H, int V,
                                  long long w_sk, long long w_sn, int route,
                                  void* stream) {
  return launch_lm_head<__nv_bfloat16>(hidden, w, logits, R, H, V, w_sk, w_sn,
                                       route, stream);
}

HETU_EXPORT int hetu_lm_head_f16(const void* hidden, const void* w,
                                 void* logits, int R, int H, int V,
                                 long long w_sk, long long w_sn, int route,
                                 void* stream) {
  return launch_lm_head<__half>(hidden, w, logits, R, H, V, w_sk, w_sn, route,
                                stream);
}
