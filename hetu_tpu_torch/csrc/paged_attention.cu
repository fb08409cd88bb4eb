// Paged attention over the serving KV pool through each slot's page
// table (gather-free): the decode step (one query token a slot) and the
// speculative verify step (C = k + 1 query tokens a slot), over exact,
// int8 or int4 pages.
//
// Replaces hetu_tpu/ops/pallas/paged_attention.py `_kernel` /
// `paged_attention` (decode) and `_verify_kernel` / `paged_verify`
// (verify), with the quantized page modes of `_load_page`.
//   q         [S, C, nq, hd]        C query tokens a slot (decode: C = 1)
//   k/v pool  [P, page_size, n_kv, hd_p], page 0 = the null page;
//             exact: q's type, hd_p = hd; int8: int8, hd_p = hd;
//             int4: uint8, hd_p = hd / 2, two nibbles a byte (even index
//             in the LOW nibble, value + 8)
//   k/v scale [P, page_size, n_kv] fp32 (quantized pages only): one
//             absmax scale a head vector
//   table     [S, max_pages] int32  page ids
//   positions [S] int32             query c of slot s sits at
//                                   positions[s] + c and sees global
//                                   keys 0..positions[s] + c
//   out       [S, C, nq, hd]        in q's type
// Scores in fp32, scale applied after the dot, online softmax across
// tiles, l == 0 -> 1.
//
// Bound on an H100 by bytes: every live K/V row is read once for
// 4 * C * group flops, far below the card's flops-per-byte balance, and
// quantized pages move 1 (int8) or 1/2 (int4) byte a value plus a
// 4-byte scale a row.  Design (simple and right first): one block per
// (slot, kv head) holds the kv head's C * group query rows (every query
// token's q heads of that group) in shared memory, so each live K/V row
// is read ONCE for all of them.  The block walks only the keys the
// slot's last query can see, positions[s] + C of them (a page whose
// first key lies past positions[s] + C - 1 is never touched), in tiles
// of PA_TILE = 32 keys.  Per tile it resolves each key's row through
// the page table, then all threads copy the tile's K and V rows with
// independent 16-byte loads (rows must start on 16-byte boundaries:
// 16-byte rows and aligned pools), dequantizing int8 / int4 payloads in
// registers (k * scale, (nibble - 8) * scale, in fp32, as the plain
// version does) on the way into shared memory, so device memory sees
// only the payload and the scales.  K is kept in fp32 with rows padded
// by one word, so the scores step — one thread per (query row, key), a
// plain dot product over the head dim — reads shared memory without
// bank conflicts.  Query row r (token c = r / group) masks keys past
// positions[s] + c; the online-softmax update takes a warp per row (a
// lane per key), P.V a thread per head dim.  The row count is a
// template parameter (1, 2, 4, 8, 16, 24 or 32; a count in between runs
// the next size up), so the per-row loops unroll without predication,
// and so is C > 1: the decode instantiation (C = 1) reads its group's
// q rows as one run, masks nothing inside the live range and keeps no
// per-row limits, so the verify step's token arithmetic costs it
// nothing (through a runtime C it cost the exact decode arm about 9%).
// Keys past positions[s] + C - 1 are never loaded: freed and null pages
// hold stale bytes, and multiplying a masked probability by them
// (0 * NaN) would poison the output.
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
constexpr int PA_MAX_ROWS = 32;    // query rows (C * group) a block
constexpr int PA_MAX_D = 2;        // head dims per thread: hd <= 256
constexpr float PA_NEG = -1e30f;

enum PageMode { PA_EXACT = 0, PA_INT8 = 1, PA_INT4 = 2 };

// What a page row holds in each mode, and how the V tile is staged (the
// pool's type for exact pages, dequantized fp32 otherwise).
template <typename T, int MODE>
struct Page;
template <typename T>
struct Page<T, PA_EXACT> {
  using P = T;
  using VS = T;
};
template <typename T>
struct Page<T, PA_INT8> {
  using P = int8_t;
  using VS = float;
};
template <typename T>
struct Page<T, PA_INT4> {
  using P = uint8_t;
  using VS = float;
};

// Shared memory, in bytes, for one block: the V tile, the tile's row
// indices and scales, the padded fp32 K tile, then the fp32 q rows,
// probabilities, softmax state and each row's last visible key.
template <typename T, int MODE>
static size_t pa_smem_bytes(int rows, int hd) {
  using VS = typename Page<T, MODE>::VS;
  return sizeof(VS) * PA_TILE * static_cast<size_t>(hd) +
         sizeof(long long) * PA_TILE +
         sizeof(float) * (2 * PA_TILE + PA_TILE * static_cast<size_t>(hd + 1) +
                          static_cast<size_t>(rows) * hd +
                          static_cast<size_t>(rows) * PA_TILE + 3 * rows) +
         sizeof(int) * rows;
}

template <typename T, int MODE, int ROWS, bool VERIFY>
__global__ void __launch_bounds__(PA_THREADS)
    paged_attention_kernel(const T* __restrict__ q,
                           const void* __restrict__ k_pool,
                           const void* __restrict__ v_pool,
                           const float* __restrict__ k_scale,
                           const float* __restrict__ v_scale,
                           const int* __restrict__ table,
                           const int* __restrict__ positions,
                           T* __restrict__ out, int C, int n_kv, int group,
                           int hd, int ps, int mp, float scale) {
  using VS = typename Page<T, MODE>::VS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  VS* v_s = reinterpret_cast<VS*>(smem_raw);               // [PA_TILE][hd]
  long long* row_s = reinterpret_cast<long long*>(v_s + PA_TILE * hd);
  float* ksc_s = reinterpret_cast<float*>(row_s + PA_TILE);  // [PA_TILE]
  float* vsc_s = ksc_s + PA_TILE;                            // [PA_TILE]
  float* k_s = vsc_s + PA_TILE;                          // [PA_TILE][hd+1]
  const int k_stride = hd + 1;
  float* q_s = k_s + PA_TILE * k_stride;                   // [ROWS][hd]
  float* p_s = q_s + ROWS * hd;                            // [ROWS][PA_TILE]
  float* corr_s = p_s + ROWS * PA_TILE;                    // [ROWS]
  float* l_s = corr_s + ROWS;                              // [ROWS]
  float* m_s = l_s + ROWS;                                 // [ROWS]
  int* lim_s = reinterpret_cast<int*>(m_s + ROWS);         // [ROWS]

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nq = n_kv * group;
  if constexpr (!VERIFY) C = 1;
  const int pos = positions[s];
  // keys at global positions 0..pos + C - 1, never past the table
  const int n_keys = min(pos + C, mp * ps);
  const int* trow = table + static_cast<long long>(s) * mp;

  // query row r = c * group + g: token c, q head h * group + g; rows
  // past C * group (a count between two template sizes) stay zero
  if constexpr (VERIFY) {
    const int rows = C * group;
    for (int i = tid; i < ROWS * hd; i += PA_THREADS) {
      const int r = i / hd, d = i - r * hd;
      float v = 0.0f;
      if (r < rows) {
        const int c = r / group, g = r - c * group;
        v = to_f32(q[((static_cast<long long>(s) * C + c) * nq + h * group +
                      g) * hd + d]);
      }
      q_s[i] = v;
    }
    if (tid < ROWS) lim_s[tid] = pos + min(tid / group, C - 1);
  } else {  // the group's q rows are one run of group * hd values
    const T* qh = q + (static_cast<long long>(s) * nq + h * group) * hd;
    for (int i = tid; i < ROWS * hd; i += PA_THREADS)
      q_s[i] = i < group * hd ? to_f32(qh[i]) : 0.0f;
  }
  if (tid < ROWS) {
    m_s[tid] = PA_NEG;
    l_s[tid] = 0.0f;
  }
  float acc[ROWS][PA_MAX_D];
#pragma unroll
  for (int g = 0; g < ROWS; ++g)
#pragma unroll
    for (int j = 0; j < PA_MAX_D; ++j) acc[g][j] = 0.0f;
  __syncthreads();  // q_s, m_s, l_s, lim_s are read by every thread

  for (int t0 = 0; t0 < n_keys; t0 += PA_TILE) {
    const int nt = min(PA_TILE, n_keys - t0);

    // 0. stage the tile: row indices (and scales) through the page
    //    table, then every thread copies K and V rows with independent
    //    16-byte loads.  Exact rows go in as loaded (V) or widened to
    //    fp32 (K); quantized ones are dequantized in registers, their
    //    values taken out of the load's four words by shifts.
    if (tid < nt) {
      const int kp = t0 + tid;
      const long long page = trow[kp / ps];
      const long long row = (page * ps + kp % ps) * n_kv + h;
      row_s[tid] = row;
      if (MODE != PA_EXACT) {
        ksc_s[tid] = k_scale[row];
        vsc_s[tid] = v_scale[row];
      }
    }
    __syncthreads();
    if constexpr (MODE == PA_EXACT) {
      constexpr int E = 16 / sizeof(T);  // values a 16-byte load
      const T* kt = static_cast<const T*>(k_pool);
      const T* vt = static_cast<const T*>(v_pool);
      const int per = hd / E;
      for (int c = tid; c < nt * per; c += PA_THREADS) {
        const int j = c / per;
        const int e = (c - j * per) * E;
        const long long off = row_s[j] * hd + e;
        const uint4 kraw = *reinterpret_cast<const uint4*>(kt + off);
        *reinterpret_cast<uint4*>(v_s + j * hd + e) =
            *reinterpret_cast<const uint4*>(vt + off);
        const T* kv = reinterpret_cast<const T*>(&kraw);
#pragma unroll
        for (int i = 0; i < E; ++i) k_s[j * k_stride + e + i] = to_f32(kv[i]);
      }
    } else {
      const uint4* kb = static_cast<const uint4*>(k_pool);
      const uint4* vb = static_cast<const uint4*>(v_pool);
      // 16-byte loads a payload row: hd bytes (int8) or hd / 2 (int4)
      const int per_row = (MODE == PA_INT4 ? hd / 2 : hd) / 16;
      for (int c = tid; c < nt * per_row; c += PA_THREADS) {
        const int j = c / per_row;
        const int chunk = c - j * per_row;
        const long long at = row_s[j] * per_row + chunk;  // 16-byte units
        const uint4 kraw = __ldg(kb + at);
        const uint4 vraw = __ldg(vb + at);
        float* kr = k_s + j * k_stride;
        VS* vr = v_s + j * hd;
        const uint32_t kw[4] = {kraw.x, kraw.y, kraw.z, kraw.w};
        const uint32_t vw[4] = {vraw.x, vraw.y, vraw.z, vraw.w};
        const float ks = ksc_s[j], vs = vsc_s[j];
        if constexpr (MODE == PA_INT8) {  // byte b of word i: value 4i + b
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const int e = chunk * 16 + 4 * i + b;
              kr[e] = static_cast<float>(
                          static_cast<int>(kw[i] << (24 - 8 * b)) >> 24) * ks;
              vr[e] = static_cast<float>(
                          static_cast<int>(vw[i] << (24 - 8 * b)) >> 24) * vs;
            }
        } else {  // nibble n of word i: value 8i + n (low nibble first)
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const int e = chunk * 32 + 8 * i + n;
              kr[e] = static_cast<float>(
                          static_cast<int>((kw[i] >> (4 * n)) & 0xFu) - 8) * ks;
              vr[e] = static_cast<float>(
                          static_cast<int>((vw[i] >> (4 * n)) & 0xFu) - 8) * vs;
            }
        }
      }
    }
    __syncthreads();

    // 1. scores: thread (warp w, lane j) takes rows w, w + PA_WARPS, ...
    //    against key j
    for (int g = warp; g < ROWS; g += PA_WARPS) {
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

    // 2. online softmax: warp w takes rows w, w + PA_WARPS, ...; a lane
    //    per key; keys past the row's position are masked (the decode
    //    row sees every staged key)
    for (int g = warp; g < ROWS; g += PA_WARPS) {
      bool seen = lane < nt;
      if constexpr (VERIFY) seen = seen && t0 + lane <= lim_s[g];
      const float x = seen ? p_s[g * PA_TILE + lane] : PA_NEG;
      float mx = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p = seen ? expf(x - m_new) : 0.0f;
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
        float a[ROWS];
#pragma unroll
        for (int g = 0; g < ROWS; ++g) a[g] = acc[g][jd] * corr_s[g];
        for (int j = 0; j < nt; ++j) {
          const float vv = to_f32(v_s[j * hd + d]);
#pragma unroll
          for (int g = 0; g < ROWS; ++g) a[g] += p_s[g * PA_TILE + j] * vv;
        }
#pragma unroll
        for (int g = 0; g < ROWS; ++g) acc[g][jd] = a[g];
      }
    }
    __syncthreads();  // the next tile rewrites row_s, k_s, v_s, p_s, corr_s
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < C * group) {
      const int c = VERIFY ? r / group : 0, g = r - c * group;
      T* orow = out + ((static_cast<long long>(s) * C + c) * nq + h * group +
                       g) * hd;
      const float l = l_s[r];
      const float inv = 1.0f / (l == 0.0f ? 1.0f : l);
#pragma unroll
      for (int jd = 0; jd < PA_MAX_D; ++jd) {
        const int d = tid + jd * PA_THREADS;
        if (d < hd) orow[d] = from_f32<T>(acc[r][jd] * inv);
      }
    }
  }
}

template <typename T, int MODE, int ROWS, bool VERIFY>
static int launch_as(const void* q, const void* k_pool, const void* v_pool,
                     const void* k_scale, const void* v_scale,
                     const void* table, const void* positions, void* out,
                     int S, int C, int n_kv, int group, int hd, int ps,
                     int mp, float scale, void* stream) {
  const size_t smem = pa_smem_bytes<T, MODE>(ROWS, hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, MODE, ROWS, VERIFY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(S, n_kv);
  paged_attention_kernel<T, MODE, ROWS, VERIFY>
      <<<grid, PA_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), k_pool, v_pool,
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(table), static_cast<const int*>(positions),
      static_cast<T*>(out), C, n_kv, group, hd, ps, mp, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale, const void* table,
                  const void* positions, void* out, int S, int C, int n_kv,
                  int group, int hd, int ps, int mp, float scale,
                  void* stream) {
  using P = typename Page<T, MODE>::P;
  const int hd_p = MODE == PA_INT4 ? hd / 2 : hd;
  const int rows = C * group;
  // 16-byte loads need every page row to start on a 16-byte boundary
  if (C < 1 || group < 1 || rows > PA_MAX_ROWS || hd < 1 ||
      hd > PA_MAX_D * PA_THREADS || (MODE == PA_INT4 && hd % 2) || ps < 1 ||
      mp < 1 || (hd_p * sizeof(P)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0 ||
      (MODE != PA_EXACT && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
#define PA_LAUNCH(R, V)                                                      \
  return launch_as<T, MODE, R, V>(q, k_pool, v_pool, k_scale, v_scale,      \
                                  table, positions, out, S, C, n_kv, group, \
                                  hd, ps, mp, scale, stream)
  if (C == 1) {  // decode: rows = group
    if (rows <= 1) PA_LAUNCH(1, false);
    if (rows <= 2) PA_LAUNCH(2, false);
    if (rows <= 4) PA_LAUNCH(4, false);
    if (rows <= 8) PA_LAUNCH(8, false);
    if (rows <= 16) PA_LAUNCH(16, false);
    PA_LAUNCH(32, false);
  }
  if (rows <= 2) PA_LAUNCH(2, true);
  if (rows <= 4) PA_LAUNCH(4, true);
  if (rows <= 8) PA_LAUNCH(8, true);
  if (rows <= 16) PA_LAUNCH(16, true);
  if (rows <= 24) PA_LAUNCH(24, true);
  PA_LAUNCH(32, true);
#undef PA_LAUNCH
}

// One symbol a (q type, page mode); the decode step passes C = 1.
HETU_EXPORT int hetu_paged_attention_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* positions, void* out,
    int S, int C, int n_kv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  return launch<float, PA_EXACT>(q, k_pool, v_pool, k_scale, v_scale, table,
                          positions, out, S, C, n_kv, group, hd, ps, mp,
                          scale, stream);
}

HETU_EXPORT int hetu_paged_attention_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* positions, void* out,
    int S, int C, int n_kv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  return launch<__nv_bfloat16, PA_EXACT>(q, k_pool, v_pool, k_scale, v_scale, table,
                          positions, out, S, C, n_kv, group, hd, ps, mp,
                          scale, stream);
}

HETU_EXPORT int hetu_paged_attention_int8_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* positions, void* out,
    int S, int C, int n_kv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  return launch<float, PA_INT8>(q, k_pool, v_pool, k_scale, v_scale, table,
                          positions, out, S, C, n_kv, group, hd, ps, mp,
                          scale, stream);
}

HETU_EXPORT int hetu_paged_attention_int8_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* positions, void* out,
    int S, int C, int n_kv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  return launch<__nv_bfloat16, PA_INT8>(q, k_pool, v_pool, k_scale, v_scale, table,
                          positions, out, S, C, n_kv, group, hd, ps, mp,
                          scale, stream);
}

HETU_EXPORT int hetu_paged_attention_int4_f32(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* positions, void* out,
    int S, int C, int n_kv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  return launch<float, PA_INT4>(q, k_pool, v_pool, k_scale, v_scale, table,
                          positions, out, S, C, n_kv, group, hd, ps, mp,
                          scale, stream);
}

HETU_EXPORT int hetu_paged_attention_int4_bf16(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* table, const void* positions, void* out,
    int S, int C, int n_kv, int group, int hd, int ps, int mp, float scale,
    void* stream) {
  return launch<__nv_bfloat16, PA_INT4>(q, k_pool, v_pool, k_scale, v_scale, table,
                          positions, out, S, C, n_kv, group, hd, ps, mp,
                          scale, stream);
}
