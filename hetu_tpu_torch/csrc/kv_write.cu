// The fused KV page write: a token block's K and V (decode, verify) or a
// prefill's K and V scratch (all layers) written into the serving pool's
// pages, quantized on the way where the pages are int8 or int4.
//
// Replaces the page writes over hetu_tpu/ops/pallas/quant.py
// `_quant_kernel` / `quantize_blockwise_pallas` (the int8 pages'
// quantize) in hetu_tpu/serving/kv_pool.py `write_token`, `write_tokens`
// and `write_pages` (`quantize_heads`; int4 by ops/quantization.py
// `quantize_int4`): for each head vector x [hd] and its slot (page, offset)
//   exact pages:  pool[page, offset, h] = x cast to the pool's type
//   int8 / int4:  pool[page, offset, h], scale[page, offset, h] =
//                 the head vector's absmax quantize (quant.cuh)
//
// K and V are fp32, bf16 or fp16 (`in_dtype`: 0, 1, 2); exact pages are
// of any of the three types (`mode`: KvMode).  Two entries, neither of
// which reads a host value (a CUDA graph can capture them):
//   * write_kv_tokens — one layer, a token block [S, C, n_kv, hd] of K and
//     of V (C = 1 decode, k + 1 verify) in one launch.  Token i of slot s
//     sits at positions[s] + i and goes to page table[s, (pos) / ps] at
//     offset pos % ps; a position past the slot's table row goes to the
//     null page 0, as the reference's `write_tokens` redirects it (rows
//     that are not decoding point there already).  K and V are read in
//     place through their strides (RoPE's contiguous K, V and GPT's K as
//     views of the fused QKV projection): no copy is made.
//   * write_kv_pages — a prefill's scratch ks / vs [L, M, n_kv, hd] (views
//     of the dense cache [L, 1, M, n_kv, hd]) into the pages of a page row
//     [mp] (M = mp * ps), all layers, K and V, in one launch; null entries
//     (the prefix cache's shared pages, the unused tail) are skipped, so
//     only the real pages' rows are read or written.
//
// Bound on an H100 by bytes: each head vector read once and its payload
// and scale written once, a max, a division and a rounding a value.
// Design: the head-vector body of quant.cuh, hd * sizeof(T) / 16 lanes a
// vector, one 16-byte load a lane (hd 128 bf16: 16 lanes, two vectors a
// warp), the payload stored packed.  The token write walks its 2 S C n_kv
// vectors, a warp's groups on one token's consecutive heads, so the
// loads and the stores of a page row are contiguous.  The page write's
// grid is (tiles a page, row entries, K and V of each layer): a block of
// KV_THREADS (128 beat 64, 256 and 512 on the H100 at the prefill shapes)
// writes one tile of one page, KV_UNROLL vectors a lane, their loads
// issued before any is stored, so enough bytes are in flight to reach
// the memory's rate, and a null entry's blocks read one entry of the
// row and end.  Its index arithmetic is a division a thread: integer
// division costs as much as a value's quantize.  Exact pages of the
// input's type are a 16-byte copy; a cast to another type rounds once
// from the exact fp32 widening (round-to-nearest-even).  int8 / int4
// pages of 16-bit K and V quantize that widening: bits and scales of
// fp32 input of the same values.  Writes into the null page from several rows
// (inactive rows, positions past a row) land in no defined order, as the
// scatter they replace: page 0 is never read.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "quant.cuh"

constexpr int KV_THREADS = 128;
constexpr int KV_UNROLL = 4;
// the page write's grid: row entries and 2 x layers each at most 65,535
constexpr int KV_MAX_ENTRIES = 65535;

// Exact pages: the values cast once to the pool's type TO (the bits
// themselves where TO is T).
template <typename TO, typename T, int LANES, int CH>
__device__ __forceinline__ void store_exact(const HeadVec<T, LANES, CH>& hv,
                                            TO* y, int l, int chunks) {
  constexpr int VPC = HeadVec<T, LANES, CH>::VPC;
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int k = c * LANES + l;
    if (k >= chunks) continue;
    if constexpr (std::is_same<TO, T>::value) {
      reinterpret_cast<uint4*>(y)[k] = hv.raw[c];
    } else {
      Vec<TO, VPC> o;
#pragma unroll
      for (int j = 0; j < VPC; ++j) o.v[j] = from_f32<TO>(hv.value(c, j));
      if constexpr (sizeof(o) == 32) {  // 16-bit -> fp32: two 16-byte stores
        uint4* d = reinterpret_cast<uint4*>(y + k * VPC);
        d[0] = reinterpret_cast<const uint4*>(&o)[0];
        d[1] = reinterpret_cast<const uint4*>(&o)[1];
      } else {
        reinterpret_cast<Vec<TO, VPC>*>(y)[k] = o;
      }
    }
  }
}

// What a page write stores: exact pages of fp32, bf16 or fp16, or int8 /
// int4 payloads with one fp32 scale a head vector.
enum KvMode : int { KV_EXACT_F32 = 0, KV_EXACT_BF16 = 1, KV_EXACT_F16 = 2,
                    KV_INT8 = 8, KV_INT4 = 4 };

// The element type of a mode's exact pages.
template <int MODE>
using ExactType = typename std::conditional<
    MODE == KV_EXACT_F32, float,
    typename std::conditional<MODE == KV_EXACT_BF16, __nv_bfloat16,
                              __half>::type>::type;

// Store one head vector into row `row` of a page array (payload row
// widths: hd values exact, hd bytes int8, hd / 2 bytes int4) and, for a
// quantized pool, its scale.  Every lane of the warp calls it; `live`
// says whether this lane's group has a vector.
template <int MODE, typename T, int LANES, int CH>
__device__ __forceinline__ void store_head(const HeadVec<T, LANES, CH>& hv,
                                           void* pool, float* scales,
                                           long long row, int hd, int l,
                                           int chunks, bool live) {
  if constexpr (MODE == KV_EXACT_F32 || MODE == KV_EXACT_BF16 ||
                MODE == KV_EXACT_F16) {
    using TO = ExactType<MODE>;
    if (live) store_exact<TO>(hv, static_cast<TO*>(pool) + row * hd, l,
                              chunks);
  } else {
    const HeadScale h = head_scale(group_max<LANES>(hv.lane_absmax()),
                                   MODE == KV_INT8 ? 127.0f : 7.0f);
    if (!live) return;
    if constexpr (MODE == KV_INT8)
      store_int8(hv, static_cast<int8_t*>(pool) + row * hd, l, chunks, h);
    else
      store_int4(hv, static_cast<uint8_t*>(pool) + row * (hd / 2), l, chunks,
                 h);
    if (l == 0) scales[row] = h.scale;
  }
}

struct TokenWrite {
  const void* k;
  const void* v;
  void* k_pool;  // one layer's [P, ps, n_kv, hd'] payload
  void* v_pool;
  float* k_scale;  // [P, ps, n_kv], or null for exact pages
  float* v_scale;
  const int* table;      // [S, mp]
  const int* positions;  // [S]
  int S, C, n_kv, hd, ps, mp;
  long long k_ss, k_sc, k_sh, v_ss, v_sc, v_sh;  // element strides
};

// Vector t of the 2 S C n_kv (fewer than 2^31, the wrapper checks) is
// head t % n_kv of token (s, c) of K (t < S C n_kv) or V.
template <typename T, int MODE, int LANES, int CH>
__global__ void __launch_bounds__(KV_THREADS)
    write_kv_tokens_kernel(const TokenWrite w) {
  constexpr int PER_WARP = 32 / LANES;
  const int lane = threadIdx.x & 31;
  const int l = lane % LANES;
  const int chunks = w.hd * static_cast<int>(sizeof(T)) / 16;
  const int per_kv = w.S * w.C * w.n_kv;
  const int warps = gridDim.x * blockDim.x >> 5;
  for (int wi = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       wi * PER_WARP < 2 * per_kv; wi += warps) {
    const int t = wi * PER_WARP + lane / LANES;
    const bool live = t < 2 * per_kv;
    const bool is_v = t >= per_kv;
    const T* src = nullptr;
    long long row = 0;
    if (live) {
      const int r = (is_v ? t - per_kv : t) / w.n_kv;
      const int h = t % w.n_kv;
      const int c = r % w.C;
      const int s = r / w.C;
      const int pos = w.positions[s] + c;
      const int pidx = pos / w.ps;
      const long long page = pidx < w.mp ? w.table[s * w.mp + pidx] : 0;
      row = (page * w.ps + pos % w.ps) * w.n_kv + h;
      src = is_v ? static_cast<const T*>(w.v) + s * w.v_ss + c * w.v_sc +
                       h * w.v_sh
                 : static_cast<const T*>(w.k) + s * w.k_ss + c * w.k_sc +
                       h * w.k_sh;
    }
    HeadVec<T, LANES, CH> hv;
    hv.load(src, l, chunks, live);
    store_head<MODE>(hv, is_v ? w.v_pool : w.k_pool,
                     is_v ? w.v_scale : w.k_scale, row, w.hd, l, chunks,
                     live);
  }
}

struct PageWrite {
  const void* k;  // [L, M, n_kv, hd] through its strides
  const void* v;
  void* k_pool;  // [L, P, ps, n_kv, hd']
  void* v_pool;
  float* k_scale;  // [L, P, ps, n_kv], or null for exact pages
  float* v_scale;
  const int* row;  // [mp] page ids, 0 = null
  int L, P, mp, ps, n_kv, hd;
  long long k_sl, k_sm, k_sh, v_sl, v_sm, v_sh;  // element strides
};

// grid (tiles a page, row entries, 2 L): block (x, j, z) writes tile x of
// entry j's page of layer z % L, K for z < L and V beyond.
template <typename T, int MODE, int LANES, int CH>
__global__ void __launch_bounds__(KV_THREADS)
    write_kv_pages_kernel(const PageWrite w) {
  constexpr int PER_WARP = 32 / LANES;
  constexpr int STEP = KV_THREADS / 32 * PER_WARP;  // vectors a pass
  const int j = blockIdx.y;
  const long long page = w.row[j];
  if (page == 0) return;  // a null entry: the block writes nothing
  const int lane = threadIdx.x & 31;
  const int l = lane % LANES;
  const int chunks = w.hd * static_cast<int>(sizeof(T)) / 16;
  const int nv = w.ps * w.n_kv;  // head vectors a page holds
  const bool is_v = static_cast<int>(blockIdx.z) >= w.L;
  const int layer = is_v ? blockIdx.z - w.L : blockIdx.z;
  const long long sm = is_v ? w.v_sm : w.k_sm;
  const long long sh = is_v ? w.v_sh : w.k_sh;
  const T* x = static_cast<const T*>(is_v ? w.v : w.k) +
               layer * (is_v ? w.v_sl : w.k_sl) +
               static_cast<long long>(j) * w.ps * sm;
  const long long rows_l = static_cast<long long>(w.P) * nv;  // a layer's
  const int hd_p = MODE == KV_INT4 ? w.hd / 2 : w.hd;
  char* pool = static_cast<char*>(is_v ? w.v_pool : w.k_pool) +
               layer * rows_l * hd_p *
                   static_cast<long long>(MODE == KV_EXACT_F32 ? 4
                                          : MODE == KV_EXACT_BF16 ||
                                                  MODE == KV_EXACT_F16
                                              ? 2
                                              : 1);
  float* scales = is_v ? w.v_scale : w.k_scale;
  if (scales != nullptr) scales += layer * rows_l;
  // this thread's vectors: v0, v0 + STEP, ...; (position, head) of each
  // by steps, one division a thread
  const int v0 = blockIdx.x * STEP * KV_UNROLL + (threadIdx.x >> 5) *
                 PER_WARP + lane / LANES;
  int p = v0 / w.n_kv, h = v0 % w.n_kv;
  const int dp = STEP / w.n_kv, dh = STEP % w.n_kv;
  HeadVec<T, LANES, CH> hv[KV_UNROLL];
#pragma unroll
  for (int u = 0; u < KV_UNROLL; ++u) {
    const bool live = v0 + u * STEP < nv;
    hv[u].load(live ? x + p * sm + h * sh : x, l, chunks, live);
    p += dp;
    h += dh;
    if (h >= w.n_kv) {
      h -= w.n_kv;
      ++p;
    }
  }
#pragma unroll
  for (int u = 0; u < KV_UNROLL; ++u) {
    const int vi = v0 + u * STEP;
    store_head<MODE>(hv[u], pool, scales, page * nv + vi, w.hd, l, chunks,
                     vi < nv);
  }
}

// The mode's instantiations by the lanes a head vector takes: chunks of
// 16 bytes up to 4, 8, 16 or 32 (one load a lane), or 64 (fp32 at hd 256,
// two).
template <typename T, int MODE, typename Launch>
static int by_lanes(int chunks, Launch go) {
  if (chunks <= 4) return go.template run<T, MODE, 4, 1>();
  if (chunks <= 8) return go.template run<T, MODE, 8, 1>();
  if (chunks <= 16) return go.template run<T, MODE, 16, 1>();
  if (chunks <= 32) return go.template run<T, MODE, 32, 1>();
  if (chunks <= 64) return go.template run<T, MODE, 32, 2>();
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename Launch>
static int by_mode(int mode, int chunks, Launch go) {
  switch (mode) {
    case KV_EXACT_F32: return by_lanes<T, KV_EXACT_F32>(chunks, go);
    case KV_EXACT_BF16: return by_lanes<T, KV_EXACT_BF16>(chunks, go);
    case KV_EXACT_F16: return by_lanes<T, KV_EXACT_F16>(chunks, go);
    case KV_INT8: return by_lanes<T, KV_INT8>(chunks, go);
    case KV_INT4: return by_lanes<T, KV_INT4>(chunks, go);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The input's type by its code (KvIn) and the head vector's 16-byte
// chunks.
enum KvIn : int { KV_IN_F32 = 0, KV_IN_BF16 = 1, KV_IN_F16 = 2 };

template <typename Launch>
static int dispatch(int in_dtype, int mode, int hd, Launch go) {
  if (hd < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dtype) {
    case KV_IN_F32:
      if (hd % 4) return static_cast<int>(cudaErrorInvalidValue);
      return by_mode<float>(mode, hd / 4, go);
    case KV_IN_BF16:
      if (hd % 8) return static_cast<int>(cudaErrorInvalidValue);
      return by_mode<__nv_bfloat16>(mode, hd / 8, go);
    case KV_IN_F16:
      if (hd % 8) return static_cast<int>(cudaErrorInvalidValue);
      return by_mode<__half>(mode, hd / 8, go);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

struct TokenLaunch {
  TokenWrite w;
  cudaStream_t st;
  template <typename T, int MODE, int LANES, int CH>
  int run() const {
    const long long vectors = 2LL * w.S * w.C * w.n_kv;
    const long long threads = (vectors + 32 / LANES - 1) / (32 / LANES) * 32;
    write_kv_tokens_kernel<T, MODE, LANES, CH>
        <<<grid_for(threads, KV_THREADS, 1 << 16), KV_THREADS, 0, st>>>(w);
    return static_cast<int>(cudaGetLastError());
  }
};

struct PageLaunch {
  PageWrite w;
  cudaStream_t st;
  template <typename T, int MODE, int LANES, int CH>
  int run() const {
    constexpr int tile = KV_THREADS / LANES * KV_UNROLL;
    const dim3 grid((w.ps * w.n_kv + tile - 1) / tile, w.mp, 2 * w.L);
    write_kv_pages_kernel<T, MODE, LANES, CH><<<grid, KV_THREADS, 0, st>>>(w);
    return static_cast<int>(cudaGetLastError());
  }
};

HETU_EXPORT int hetu_write_kv_tokens(
    const void* k, const void* v, void* k_pool, void* v_pool, void* k_scale,
    void* v_scale, const void* table, const void* positions, int S, int C,
    int n_kv, int hd, int ps, int mp, long long k_ss, long long k_sc,
    long long k_sh, long long v_ss, long long v_sc, long long v_sh,
    int in_dtype, int mode, void* stream) {
  if (S < 0 || C < 1 || n_kv < 1 || ps < 1 || mp < 1 ||
      2LL * S * C * n_kv >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  TokenWrite w{k, v, k_pool, v_pool, static_cast<float*>(k_scale),
               static_cast<float*>(v_scale), static_cast<const int*>(table),
               static_cast<const int*>(positions), S, C, n_kv, hd, ps, mp,
               k_ss, k_sc, k_sh, v_ss, v_sc, v_sh};
  return dispatch(in_dtype, mode, hd,
                  TokenLaunch{w, static_cast<cudaStream_t>(stream)});
}

HETU_EXPORT int hetu_write_kv_pages(
    const void* k, const void* v, void* k_pool, void* v_pool, void* k_scale,
    void* v_scale, const void* row, int L, int P, int mp, int ps, int n_kv,
    int hd, long long k_sl, long long k_sm, long long k_sh, long long v_sl,
    long long v_sm, long long v_sh, int in_dtype, int mode, void* stream) {
  if (L < 0 || P < 1 || mp < 0 || ps < 1 || n_kv < 1 || mp > KV_MAX_ENTRIES ||
      2 * L > KV_MAX_ENTRIES)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L == 0 || mp == 0) return 0;
  PageWrite w{k, v, k_pool, v_pool, static_cast<float*>(k_scale),
              static_cast<float*>(v_scale), static_cast<const int*>(row), L,
              P, mp, ps, n_kv, hd, k_sl, k_sm, k_sh, v_sl, v_sm, v_sh};
  return dispatch(in_dtype, mode, hd,
                  PageLaunch{w, static_cast<cudaStream_t>(stream)});
}
