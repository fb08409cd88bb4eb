// Paged-attention decode: one query token per slot attends directly over
// the serving KV pool through the slot's page table (gather-free decode).
//
// Replaces hetu_tpu/ops/pallas/paged_attention.py `_kernel` and
// `paged_attention` (exact pages, quant="none").
//   q        [S, nq, hd]           one token per slot
//   k/v pool [P, page_size, n_kv, hd], page 0 = the null page
//   table    [S, max_pages] int32  page ids
//   positions[S] int32             slot s sees global keys 0..positions[s]
//   out      [S, nq, hd]           in q's dtype
// Scores in fp32, scale applied after the dot, online softmax across
// tiles, l == 0 -> 1.
//
// Bound on an H100 by bytes: every live K/V element is read once for
// 4 * group flops, far below the card's flops-per-byte balance.
// Design (simple and right first): one block per (slot, kv head) holds
// the kv head's `group` q rows in shared memory, so each K/V row is
// read ONCE for all of them (the GQA grouping, no repeated heads).  The
// block walks only the slot's live keys, positions[s] + 1 of them, in
// tiles of PA_TILE = 32 keys.  Per tile it first resolves each key's
// row offset through the page table, then all threads copy the tile's
// K and V rows into shared memory at once with 16-byte loads (rows must
// start on 16-byte boundaries: hd * sizeof(T) % 16 == 0 and aligned
// pools, which every Llama head dim and torch allocation give), so the
// tile costs one round trip to device memory instead of one dependent
// page-id + row load per key.  K is kept in fp32 with
// rows padded by one word, so the scores step — one thread per (q row,
// key), a plain dot product over the head dim — reads shared memory
// without bank conflicts and needs no cross-lane reduction.  The
// online-softmax update takes a warp per q row (a lane per key), P.V a
// thread per head dim.  The q-head group size is a template parameter
// (1, 2, 4, 8 or 16; a group in between runs the next size up), so the
// per-row loops unroll without predication.  Keys past positions[s]
// are never loaded: freed and null pages hold stale bytes, and
// multiplying a masked probability by them (0 * NaN) would poison the
// output.
//
// Known limit: one block per (slot, kv head) puts a deep slot's whole
// key range on one SM (S * n_kv = 64 blocks at the Llama-3-8B serving
// shape); splitting keys across blocks is the next step.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

constexpr int PA_THREADS = 128;
constexpr int PA_WARPS = PA_THREADS / 32;
constexpr int PA_TILE = 32;        // keys staged per pass: one per lane
constexpr int PA_MAX_GROUP = 16;   // q heads per kv head
constexpr int PA_MAX_D = 2;        // head dims per thread: hd <= 256
constexpr float PA_NEG = -1e30f;

// Shared memory, in bytes, for one block: the V tile in the pool's
// type, the tile's row offsets, the padded fp32 K tile, then the fp32
// q rows, probabilities and softmax state.
template <typename T>
static size_t pa_smem_bytes(int G, int hd) {
  return sizeof(T) * PA_TILE * static_cast<size_t>(hd) +
         sizeof(long long) * PA_TILE +
         sizeof(float) * (PA_TILE * static_cast<size_t>(hd + 1) +
                          static_cast<size_t>(G) * hd +
                          static_cast<size_t>(G) * PA_TILE + 3 * G);
}

template <typename T, int G>
__global__ void __launch_bounds__(PA_THREADS)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pool,
                           const T* __restrict__ v_pool,
                           const int* __restrict__ table,
                           const int* __restrict__ positions,
                           T* __restrict__ out, int n_kv, int group, int hd,
                           int ps, int mp, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* v_s = reinterpret_cast<T*>(smem_raw);                 // [PA_TILE][hd]
  long long* off_s = reinterpret_cast<long long*>(v_s + PA_TILE * hd);
  float* k_s = reinterpret_cast<float*>(off_s + PA_TILE);  // [PA_TILE][hd+1]
  const int k_stride = hd + 1;
  float* q_s = k_s + PA_TILE * k_stride;                   // [G][hd]
  float* p_s = q_s + G * hd;                               // [G][PA_TILE]
  float* corr_s = p_s + G * PA_TILE;                       // [G]
  float* l_s = corr_s + G;                                 // [G]
  float* m_s = l_s + G;                                    // [G]

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = n_kv * group;
  // keys at global positions 0..positions[s], never past the table
  const int n_keys = min(positions[s] + 1, mp * ps);
  const int* trow = table + static_cast<long long>(s) * mp;

  // q rows past `group` (a group between two template sizes) stay zero
  const T* qh = q + (static_cast<long long>(s) * nq + h * group) * hd;
  for (int i = tid; i < G * hd; i += PA_THREADS)
    q_s[i] = i < group * hd ? to_f32(qh[i]) : 0.0f;
  if (tid < G) {
    m_s[tid] = PA_NEG;
    l_s[tid] = 0.0f;
  }
  float acc[G][PA_MAX_D];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < PA_MAX_D; ++j) acc[g][j] = 0.0f;
  __syncthreads();  // q_s, m_s, l_s are read by every thread

  for (int t0 = 0; t0 < n_keys; t0 += PA_TILE) {
    const int nt = min(PA_TILE, n_keys - t0);

    // 0. stage the tile: row offsets through the page table, then every
    //    thread copies K and V rows with independent 16-byte loads
    if (tid < nt) {
      const int kp = t0 + tid;
      const long long page = trow[kp / ps];
      off_s[tid] = ((page * ps + kp % ps) * n_kv + h) *
                   static_cast<long long>(hd);
    }
    __syncthreads();
    constexpr int E = 16 / sizeof(T);  // elements per 16-byte load
    const int per_row = hd / E;
    for (int c = tid; c < nt * per_row; c += PA_THREADS) {
      const int j = c / per_row;
      const int e = (c - j * per_row) * E;
      const uint4 kraw =
          *reinterpret_cast<const uint4*>(k_pool + off_s[j] + e);
      *reinterpret_cast<uint4*>(v_s + j * hd + e) =
          *reinterpret_cast<const uint4*>(v_pool + off_s[j] + e);
      const T* kv = reinterpret_cast<const T*>(&kraw);
#pragma unroll
      for (int i = 0; i < E; ++i) k_s[j * k_stride + e + i] = to_f32(kv[i]);
    }
    __syncthreads();

    // 1. scores: thread (warp g, lane j) takes q row g against key j
    for (int g = warp; g < G; g += PA_WARPS) {
      if (lane < nt) {
        const float* kr = k_s + lane * k_stride;
        const float* qr = q_s + g * hd;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
        int d = 0;
        for (; d + 4 <= hd; d += 4) {
          a0 += qr[d] * kr[d];
          a1 += qr[d + 1] * kr[d + 1];
          a2 += qr[d + 2] * kr[d + 2];
          a3 += qr[d + 3] * kr[d + 3];
        }
        for (; d < hd; ++d) a0 += qr[d] * kr[d];
        p_s[g * PA_TILE + lane] = ((a0 + a1) + (a2 + a3)) * scale;
      }
    }
    __syncthreads();

    // 2. online softmax: warp w takes q rows w, w + PA_WARPS, ...; a lane
    //    per key
    for (int g = warp; g < G; g += PA_WARPS) {
      const float x = lane < nt ? p_s[g * PA_TILE + lane] : PA_NEG;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = lane < nt ? expf(x - m_new) : 0.0f;
      if (lane < nt) p_s[g * PA_TILE + lane] = p;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr_s[g] = c;
        l_s[g] = l_s[g] * c + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 3. acc = acc * corr + P . V for this thread's head dims
#pragma unroll
    for (int jd = 0; jd < PA_MAX_D; ++jd) {
      const int d = tid + jd * PA_THREADS;
      if (d < hd) {
        float a[G];
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] = acc[g][jd] * corr_s[g];
        for (int j = 0; j < nt; ++j) {
          const float vv = to_f32(v_s[j * hd + d]);
#pragma unroll
          for (int g = 0; g < G; ++g) a[g] += p_s[g * PA_TILE + j] * vv;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][jd] = a[g];
      }
    }
    __syncthreads();  // the next tile rewrites off_s, k_s, v_s, p_s, corr_s
  }

  T* oh = out + (static_cast<long long>(s) * nq + h * group) * hd;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < group) {
      const float l = l_s[g];
      const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
#pragma unroll
      for (int jd = 0; jd < PA_MAX_D; ++jd) {
        const int d = tid + jd * PA_THREADS;
        if (d < hd) oh[g * hd + d] = from_f32<T>(acc[g][jd] * inv);
      }
    }
  }
}

template <typename T, int G>
static int launch_as(const void* q, const void* k_pool, const void* v_pool,
                     const void* table, const void* positions, void* out,
                     int S, int n_kv, int group, int hd, int ps, int mp,
                     float scale, void* stream) {
  const size_t smem = pa_smem_bytes<T>(G, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(S, n_kv);
  paged_attention_kernel<T, G><<<grid, PA_THREADS, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(positions), static_cast<T*>(out), n_kv, group,
      hd, ps, mp, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* table, const void* positions, void* out, int S,
                  int n_kv, int group, int hd, int ps, int mp, float scale,
                  void* stream) {
  // 16-byte loads need every row to start on a 16-byte boundary
  if (group < 1 || group > PA_MAX_GROUP || hd < 1 ||
      hd > PA_MAX_D * PA_THREADS || ps < 1 || mp < 1 ||
      (hd * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
#define PA_LAUNCH(G)                                                     \
  return launch_as<T, G>(q, k_pool, v_pool, table, positions, out, S, n_kv, \
                         group, hd, ps, mp, scale, stream)
  if (group <= 1) PA_LAUNCH(1);
  if (group <= 2) PA_LAUNCH(2);
  if (group <= 4) PA_LAUNCH(4);
  if (group <= 8) PA_LAUNCH(8);
  PA_LAUNCH(16);
#undef PA_LAUNCH
}

HETU_EXPORT int hetu_paged_attention_f32(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* table,
                                         const void* positions, void* out,
                                         int S, int n_kv, int group, int hd,
                                         int ps, int mp, float scale,
                                         void* stream) {
  return launch<float>(q, k_pool, v_pool, table, positions, out, S, n_kv,
                       group, hd, ps, mp, scale, stream);
}

HETU_EXPORT int hetu_paged_attention_bf16(const void* q, const void* k_pool,
                                          const void* v_pool,
                                          const void* table,
                                          const void* positions, void* out,
                                          int S, int n_kv, int group, int hd,
                                          int ps, int mp, float scale,
                                          void* stream) {
  return launch<__nv_bfloat16>(q, k_pool, v_pool, table, positions, out, S,
                               n_kv, group, hd, ps, mp, scale, stream);
}
