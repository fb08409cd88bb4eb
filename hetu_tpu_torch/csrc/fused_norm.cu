// Fused residual-add + RMSNorm / LayerNorm, forward and backward, over
// [rows, hidden].
//
// Replaces hetu_tpu/ops/pallas/fused_norm.py: `_fwd_kernel` / `_call_fwd`
// and `_bwd_kernel` / `_call_bwd` (the custom VJP of
// `fused_residual_rmsnorm` and `fused_residual_layernorm`), both arms.
//
//   RMS forward:  s = x + h (fp32);  y = s * rsqrt(mean(s^2) + eps) * w
//   LN forward:   s = x + h (fp32);  mu = mean(s);
//                 var = mean((s - mu)^2)  (two passes over the row held
//                 in registers: E[s^2] - mu^2 cancels badly);
//                 y = (s - mu) * rsqrt(var + eps) * w (+ b)
//             y is computed from the UNROUNDED fp32 s, as the Pallas
//             kernel does; y and s are each rounded once to x's dtype.
//   RMS backward: from the saved, already rounded s:
//             inv = rsqrt(mean(s^2) + eps); xhat = s * inv; g = dy * w
//             dx = inv * (g - xhat * mean(g * xhat)) + dr,
//             mean(g * xhat) taken as inv * sum(g * s) / n
//             dw = sum over rows of dy * xhat
//   LN backward:  mu and inv from s as in the forward; c = s - mu;
//             xhat = c * inv; g = dy * w
//             dx = inv * (g - mean(g) - xhat * mean(g * xhat)) + dr,
//             mean(g * xhat) taken as inv * sum(g * c) / n (not from
//             sum(g * s) - mu * sum(g), which cancels where |mu| >> sigma)
//             dw = sum over rows of dy * xhat;  db = sum over rows of dy
//             (db only with a bias: a null db pointer is the scale-only
//             arm, as a null b is in the forward)
//
// Bound on an H100 by bytes: a handful of flops per element against 8
// bytes per bf16 element, forward (x, h in; y, s out) and backward (s,
// dy, dr in; dx out).  Design for Hopper, one row layout for all four
// kernels: a row is cut into 16-byte chunks (8 bf16 or fp16, 4 fp32
// values);
// the blockDim.x threads of a row (a multiple of a warp) hold VPT chunks
// each, chunk c = threadIdx.x + j * blockDim.x, so neighbouring threads
// move neighbouring 16-byte vectors of every stream and chunks past the
// row are masked; a block holds blockDim.y rows (several where rows are
// narrow).  The launch plan (VPT, threads a row, rows a block, grid and
// arm) is `launch_plan` in ops/cuda/fused_norm.py; `check_plan` here
// refuses one the kernels cannot run.  All loads of a row are issued
// before its first reduction.  Each reduction is one round: a warp
// butterfly and, for a row wider than a warp, ONE barrier over shared
// slots that belong to that round and to the row's parity, so no
// trailing barrier guards their reuse.  RMS forward: one round (sum
// s^2); RMS backward: one (sum s^2, sum g s); LN forward: two (sum s,
// then the centred sum c^2); LN backward: two ((sum s, sum g), then
// (sum c^2, sum g c)).  The scalar arm (a width or a base off 16 bytes)
// is the same kernel with element-wise loads and stores of the same
// chunks, so it gives the vector arm's bits.
//
// The backward's dw (and db) is a sum over all rows; summing it across
// blocks would take atomics, which make it depend on the order blocks
// finish.  Instead its grid is one wave, every block resident at once
// (kBlocksPerSm blocks an SM, which __launch_bounds__ guarantees fit),
// each block as many rows as kMaxThreads allows: a block takes the row
// groups blockIdx.x, + gridDim.x, ..., keeps the next group's s, dy
// and dr in flight in a shared-memory ring (cp.async) while it reduces
// the current one, sums dy * xhat (and dy) in registers, folds its row
// slots together in slot order and writes ONE partial row; the wrapper
// sums the partials with one torch.sum, in a fixed order.  On an H100
// this beat a last-block pass inside the kernel (one SM reading every
// partial row), more blocks an SM (more partial rows to sum) and
// registers as the prefetch buffer (PERF.md, PR 11).  _rn intrinsics
// keep the compiler from contracting into FMAs.
#include <atomic>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// Threads a block at most; the plan never asks for more.  A block of
// this many always fits an SM, two of them where a thread holds one
// chunk a row (kBlocksPerSm: 128 and 64 registers a thread).
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
template <int VPT>
constexpr int kBlocksPerSm = VPT == 1 ? 2 : 1;
// Row groups in the backward's load ring: the one being reduced and
// the next, in flight.
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;

// The instantiations a launch plan may pick: VPT 1, 2, ... kMaxVpt<T>
// (powers of two), each in a vector and a scalar arm.  Mirrored by
// ops/cuda/fused_norm.py `INSTANCES`.
template <typename T>
constexpr int kMaxVpt = 4;
template <>
constexpr int kMaxVpt<__nv_bfloat16> = 2;
template <>
constexpr int kMaxVpt<__half> = 2;

// Values in a 16-byte chunk.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

template <typename T>
using Chunk = Vec<T, kVec<T>>;

// First column of this thread's j-th chunk.
template <typename T>
__device__ __forceinline__ int chunk_col(int j) {
  return (threadIdx.x + j * blockDim.x) * kVec<T>;
}

// Whether value e of the chunk at `col` lies in the row: the vector arm
// masks whole chunks (its rows are whole chunks), the scalar arm values.
template <bool SCALAR>
__device__ __forceinline__ bool in_row(int col, int e, int hidden) {
  return (SCALAR ? col + e : col) < hidden;
}

// The chunk at `col` of `row`, zeros past the row or for a row past the
// last (`live` false).
template <typename T, bool SCALAR>
__device__ __forceinline__ Chunk<T> load_chunk(const T* row, int col,
                                               int hidden, bool live) {
  Chunk<T> v;
  if constexpr (!SCALAR) {
    if (live && col < hidden)
      return *reinterpret_cast<const Chunk<T>*>(row + col);
  }
#pragma unroll
  for (int e = 0; e < kVec<T>; ++e)
    v.v[e] = SCALAR && live && col + e < hidden ? row[col + e]
                                                : from_f32<T>(0.0f);
  return v;
}

template <typename T, bool SCALAR>
__device__ __forceinline__ void store_chunk(T* row, int col, int hidden,
                                            bool live, const Chunk<T>& v) {
  if (!live) return;
  if constexpr (!SCALAR) {
    if (col < hidden) *reinterpret_cast<Chunk<T>*>(row + col) = v;
  } else {
#pragma unroll
    for (int e = 0; e < kVec<T>; ++e)
      if (col + e < hidden) row[col + e] = v.v[e];
  }
}

// N fp32 values from `col` (w, b), zeros past the row: float4 accesses
// in the vector arm.
template <int N, bool SCALAR>
__device__ __forceinline__ void load_f32(const float* p, int col, int hidden,
                                         float (&out)[N]) {
  if constexpr (!SCALAR) {
    if (col < hidden) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q) {
        const float4 f = reinterpret_cast<const float4*>(p + col)[q];
        out[4 * q] = f.x;
        out[4 * q + 1] = f.y;
        out[4 * q + 2] = f.z;
        out[4 * q + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    out[e] = SCALAR && col + e < hidden ? p[col + e] : 0.0f;
}

template <int N, bool SCALAR>
__device__ __forceinline__ void store_f32(float* p, int col, int hidden,
                                          const float (&v)[N]) {
  if constexpr (!SCALAR) {
    if (col < hidden) {
#pragma unroll
      for (int q = 0; q < N / 4; ++q)
        reinterpret_cast<float4*>(p + col)[q] =
            make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e)
      if (col + e < hidden) p[col + e] = v[e];
  }
}

// Sums each of v[0, N) over the threads of this thread's row; every
// thread of the row gets the same bits (the butterfly's two lanes of a
// pair add the same two values; the warps' partials are added in warp
// order).  A row of one warp takes no barrier, a wider one takes ONE:
// `slots` holds N * kMaxWarps floats that no other reduction in flight
// uses (a round and a parity of its own).
template <int N>
__device__ __forceinline__ void row_sums(float (&v)[N], float* slots) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      v[i] = __fadd_rn(v[i], __shfl_xor_sync(0xffffffffu, v[i], o));
  }
  const int warps = blockDim.x >> 5;
  if (warps == 1) return;
  const int warp = (threadIdx.y * blockDim.x + threadIdx.x) >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) slots[i * kMaxWarps + warp] = v[i];
  }
  __syncthreads();
  const int first = threadIdx.y * warps;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float* row = slots + i * kMaxWarps + first;
    float t = row[0];
#pragma unroll
    for (int k = 1; k < kMaxWarps; ++k)
      if (k < warps) t = __fadd_rn(t, row[k]);
    v[i] = t;
  }
}

__device__ __forceinline__ float rsqrt_rn(float mean_sq, float eps) {
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(mean_sq, eps)));
}

template <typename T, int VPT, bool SCALAR>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm<VPT>)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                   const float* __restrict__ w, T* __restrict__ y,
                   T* __restrict__ s_out, long long rows, int hidden,
                   float eps) {
  constexpr int V = kVec<T>;
  __shared__ float red[2][kMaxWarps];
  const float n = static_cast<float>(hidden);
  float wv[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j)
    load_f32<V, SCALAR>(w, chunk_col<T>(j), hidden, wv[j]);
  int parity = 0;
  for (long long g = blockIdx.x; g * blockDim.y < rows;
       g += gridDim.x, parity ^= 1) {
    const long long row = g * blockDim.y + threadIdx.y;
    const bool live = row < rows;
    const long long base = row * hidden;
    Chunk<T> xv[VPT], hv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      xv[j] = load_chunk<T, SCALAR>(x + base, chunk_col<T>(j), hidden, live);
      hv[j] = load_chunk<T, SCALAR>(h + base, chunk_col<T>(j), hidden, live);
    }
    float sv[VPT][V], sq[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sv[j][e] = __fadd_rn(to_f32(xv[j].v[e]), to_f32(hv[j].v[e]));
        sq[0] = __fadd_rn(sq[0], __fmul_rn(sv[j][e], sv[j][e]));
      }
    }
    row_sums(sq, red[parity]);
    const float inv = rsqrt_rn(__fdiv_rn(sq[0], n), eps);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      Chunk<T> yv, so;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        yv.v[e] = from_f32<T>(__fmul_rn(__fmul_rn(sv[j][e], inv), wv[j][e]));
        so.v[e] = from_f32<T>(sv[j][e]);
      }
      store_chunk<T, SCALAR>(y + base, chunk_col<T>(j), hidden, live, yv);
      store_chunk<T, SCALAR>(s_out + base, chunk_col<T>(j), hidden, live, so);
    }
  }
}

template <typename T, int VPT, bool SCALAR>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm<VPT>)
layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                     const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y,
                     T* __restrict__ s_out, long long rows, int hidden,
                     float eps) {
  constexpr int V = kVec<T>;
  __shared__ float red[2][2][kMaxWarps];
  const float n = static_cast<float>(hidden);
  float wv[VPT][V], bv[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    load_f32<V, SCALAR>(w, chunk_col<T>(j), hidden, wv[j]);
    if (b != nullptr) load_f32<V, SCALAR>(b, chunk_col<T>(j), hidden, bv[j]);
  }
  int parity = 0;
  for (long long g = blockIdx.x; g * blockDim.y < rows;
       g += gridDim.x, parity ^= 1) {
    const long long row = g * blockDim.y + threadIdx.y;
    const bool live = row < rows;
    const long long base = row * hidden;
    Chunk<T> xv[VPT], hv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      xv[j] = load_chunk<T, SCALAR>(x + base, chunk_col<T>(j), hidden, live);
      hv[j] = load_chunk<T, SCALAR>(h + base, chunk_col<T>(j), hidden, live);
    }
    float sv[VPT][V], sum[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        sv[j][e] = __fadd_rn(to_f32(xv[j].v[e]), to_f32(hv[j].v[e]));
        sum[0] = __fadd_rn(sum[0], sv[j][e]);
      }
    }
    row_sums(sum, red[parity][0]);
    const float mu = __fdiv_rn(sum[0], n);
    float sq[1] = {0.0f};
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (in_row<SCALAR>(chunk_col<T>(j), e, hidden)) {
          const float c = __fsub_rn(sv[j][e], mu);
          sq[0] = __fadd_rn(sq[0], __fmul_rn(c, c));
        }
      }
    }
    row_sums(sq, red[parity][1]);
    const float inv = rsqrt_rn(__fdiv_rn(sq[0], n), eps);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      Chunk<T> yv, so;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float v = __fmul_rn(__fmul_rn(__fsub_rn(sv[j][e], mu), inv),
                            wv[j][e]);
        if (b != nullptr) v = __fadd_rn(v, bv[j][e]);
        yv.v[e] = from_f32<T>(v);
        so.v[e] = from_f32<T>(sv[j][e]);
      }
      store_chunk<T, SCALAR>(y + base, chunk_col<T>(j), hidden, live, yv);
      store_chunk<T, SCALAR>(s_out + base, chunk_col<T>(j), hidden, live, so);
    }
  }
}

// One row's s, dy and dr as stored.
template <typename T, int VPT>
struct GradRow {
  Chunk<T> s[VPT], dy[VPT], dr[VPT];
};

// The backward's load ring in shared memory: kStages row groups of s,
// dy and dr, one 16-byte slot a chunk a thread.  Each thread copies and
// reads only its own slots, so cp.async groups alone order them: no
// barrier, and no register holds a row in flight.  The scalar arm fills
// its slots with element-wise loads (zeros past the row, as the vector
// arm's copies zero-fill).
template <typename T, int VPT, bool SCALAR>
struct Ring {
  Chunk<T>* base;
  int threads, tid;

  __device__ __forceinline__ Chunk<T>* slot(int stage, int stream,
                                            int j) const {
    return base + ((stage * 3 + stream) * VPT + j) * threads + tid;
  }

  // The copies of `row` (zeros for a row past the last) into `stage`,
  // committed as one group.
  __device__ __forceinline__ void issue(int stage, const T* s, const T* dy,
                                        const T* dr, long long row,
                                        long long rows, int hidden) const {
    const bool live = row < rows;
    const long long at = live ? row * hidden : 0;
    const T* src[3] = {s + at, dy + at, dr + at};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int col = chunk_col<T>(j);
        if constexpr (SCALAR) {
          *slot(stage, k, j) = load_chunk<T, true>(src[k], col, hidden, live);
        } else {
          const bool in = live && col < hidden;
          hopper::cp_async16(hopper::smem_u32(slot(stage, k, j)),
                             src[k] + (in ? col : 0), in);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  // Waits for the older group in flight, then reads `stage`.
  __device__ __forceinline__ GradRow<T, VPT> take(int stage) const {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
    GradRow<T, VPT> g;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      g.s[j] = *slot(stage, 0, j);
      g.dy[j] = *slot(stage, 1, j);
      g.dr[j] = *slot(stage, 2, j);
    }
    return g;
  }
};

extern __shared__ __align__(16) unsigned char ring_smem[];

// The ring of this thread over the block's dynamic shared memory, its
// first kStages - 1 row groups in flight.
template <typename T, int VPT, bool SCALAR>
__device__ __forceinline__ Ring<T, VPT, SCALAR> start_ring(
    const T* s, const T* dy, const T* dr, long long rows, int hidden) {
  const int threads = blockDim.x * blockDim.y;
  Ring<T, VPT, SCALAR> r{reinterpret_cast<Chunk<T>*>(ring_smem), threads,
                         static_cast<int>(threadIdx.y * blockDim.x +
                                          threadIdx.x)};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  const long long row =
      static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  for (int k = 0; k + 1 < kStages; ++k)
    r.issue(k, s, dy, dr, row + k * stride, rows, hidden);
  return r;
}

// Writes the block's partial row of `sum` (VPT chunks a thread): the
// row slots' sums added in slot order through shared memory (the
// drained ring), then slot 0 stores them.
template <typename T, int VPT, bool SCALAR>
__device__ __forceinline__ void store_partial(float (&sum)[VPT][kVec<T>],
                                              float* part, int hidden) {
  float* fold = reinterpret_cast<float*>(ring_smem);
  for (int y = 1; y < static_cast<int>(blockDim.y); ++y) {
    __syncthreads();
    if (static_cast<int>(threadIdx.y) == y) {
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        store_f32<kVec<T>, SCALAR>(fold, chunk_col<T>(j), hidden, sum[j]);
    }
    __syncthreads();
    if (threadIdx.y == 0) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        float v[kVec<T>];
        load_f32<kVec<T>, SCALAR>(fold, chunk_col<T>(j), hidden, v);
#pragma unroll
        for (int e = 0; e < kVec<T>; ++e) sum[j][e] = __fadd_rn(sum[j][e], v[e]);
      }
    }
  }
  if (threadIdx.y == 0) {
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      store_f32<kVec<T>, SCALAR>(part, chunk_col<T>(j), hidden, sum[j]);
  }
}

template <typename T, int VPT, bool SCALAR>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm<VPT>)
rmsnorm_bwd_kernel(const T* __restrict__ s, const float* __restrict__ w,
                   const T* __restrict__ dy, const T* __restrict__ dr,
                   T* __restrict__ dx, float* __restrict__ dw_part,
                   long long rows, int hidden, float eps) {
  constexpr int V = kVec<T>;
  __shared__ float red[2][2 * kMaxWarps];
  const float n = static_cast<float>(hidden);
  float wv[VPT][V], dw[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    load_f32<V, SCALAR>(w, chunk_col<T>(j), hidden, wv[j]);
#pragma unroll
    for (int e = 0; e < V; ++e) dw[j][e] = 0.0f;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  const auto ring = start_ring<T, VPT, SCALAR>(s, dy, dr, rows, hidden);
  int parity = 0, stage = 0;
  for (long long g = blockIdx.x; g * blockDim.y < rows;
       g += gridDim.x, parity ^= 1, stage = (stage + 1) % kStages) {
    const long long row = g * blockDim.y + threadIdx.y;
    // the next group goes out before this row's reductions
    ring.issue((stage + kStages - 1) % kStages, s, dy, dr,
               row + (kStages - 1) * stride, rows, hidden);
    const GradRow<T, VPT> cur = ring.take(stage);
    float sums[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float sf = to_f32(cur.s[j].v[e]);
        const float g_ = __fmul_rn(to_f32(cur.dy[j].v[e]), wv[j][e]);
        sums[0] = __fadd_rn(sums[0], __fmul_rn(sf, sf));
        sums[1] = __fadd_rn(sums[1], __fmul_rn(g_, sf));
      }
    }
    row_sums(sums, red[parity]);
    const float inv = rsqrt_rn(__fdiv_rn(sums[0], n), eps);
    const float mean_gx = __fdiv_rn(__fmul_rn(inv, sums[1]), n);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      Chunk<T> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float dyf = to_f32(cur.dy[j].v[e]);
        const float xhat = __fmul_rn(to_f32(cur.s[j].v[e]), inv);
        const float d = __fmul_rn(
            inv, __fsub_rn(__fmul_rn(dyf, wv[j][e]),
                           __fmul_rn(xhat, mean_gx)));
        o.v[e] = from_f32<T>(__fadd_rn(d, to_f32(cur.dr[j].v[e])));
        dw[j][e] = __fadd_rn(dw[j][e], __fmul_rn(dyf, xhat));
      }
      store_chunk<T, SCALAR>(dx + row * hidden, chunk_col<T>(j), hidden,
                             row < rows, o);
    }
  }
  hopper::cp_async_wait_all();
  store_partial<T, VPT, SCALAR>(
      dw, dw_part + static_cast<long long>(blockIdx.x) * hidden, hidden);
}

template <typename T, int VPT, bool SCALAR>
__global__ void __launch_bounds__(kMaxThreads, kBlocksPerSm<VPT>)
layernorm_bwd_kernel(const T* __restrict__ s, const float* __restrict__ w,
                     const T* __restrict__ dy, const T* __restrict__ dr,
                     T* __restrict__ dx, float* __restrict__ dw_part,
                     float* __restrict__ db_part, long long rows, int hidden,
                     float eps) {
  constexpr int V = kVec<T>;
  __shared__ float red[2][2][2 * kMaxWarps];
  const float n = static_cast<float>(hidden);
  float wv[VPT][V], dw[VPT][V], db[VPT][V];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    load_f32<V, SCALAR>(w, chunk_col<T>(j), hidden, wv[j]);
#pragma unroll
    for (int e = 0; e < V; ++e) dw[j][e] = db[j][e] = 0.0f;
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  const auto ring = start_ring<T, VPT, SCALAR>(s, dy, dr, rows, hidden);
  int parity = 0, stage = 0;
  for (long long g = blockIdx.x; g * blockDim.y < rows;
       g += gridDim.x, parity ^= 1, stage = (stage + 1) % kStages) {
    const long long row = g * blockDim.y + threadIdx.y;
    // the next group goes out before this row's reductions
    ring.issue((stage + kStages - 1) % kStages, s, dy, dr,
               row + (kStages - 1) * stride, rows, hidden);
    const GradRow<T, VPT> cur = ring.take(stage);
    float r0[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        r0[0] = __fadd_rn(r0[0], to_f32(cur.s[j].v[e]));
        r0[1] = __fadd_rn(r0[1],
                          __fmul_rn(to_f32(cur.dy[j].v[e]), wv[j][e]));
      }
    }
    row_sums(r0, red[parity][0]);
    const float mu = __fdiv_rn(r0[0], n);
    const float mean_g = __fdiv_rn(r0[1], n);
    // c = s - mu, 0 past the row (its dy, so its g, is 0 there too)
    float c[VPT][V], r1[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        c[j][e] = in_row<SCALAR>(chunk_col<T>(j), e, hidden)
                      ? __fsub_rn(to_f32(cur.s[j].v[e]), mu)
                      : 0.0f;
        const float g_ = __fmul_rn(to_f32(cur.dy[j].v[e]), wv[j][e]);
        r1[0] = __fadd_rn(r1[0], __fmul_rn(c[j][e], c[j][e]));
        r1[1] = __fadd_rn(r1[1], __fmul_rn(g_, c[j][e]));
      }
    }
    row_sums(r1, red[parity][1]);
    const float inv = rsqrt_rn(__fdiv_rn(r1[0], n), eps);
    const float mean_gx = __fdiv_rn(__fmul_rn(inv, r1[1]), n);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      Chunk<T> o;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float dyf = to_f32(cur.dy[j].v[e]);
        const float xhat = __fmul_rn(c[j][e], inv);
        const float d = __fmul_rn(
            inv, __fsub_rn(__fsub_rn(__fmul_rn(dyf, wv[j][e]), mean_g),
                           __fmul_rn(xhat, mean_gx)));
        o.v[e] = from_f32<T>(__fadd_rn(d, to_f32(cur.dr[j].v[e])));
        dw[j][e] = __fadd_rn(dw[j][e], __fmul_rn(dyf, xhat));
        db[j][e] = __fadd_rn(db[j][e], dyf);
      }
      store_chunk<T, SCALAR>(dx + row * hidden, chunk_col<T>(j), hidden,
                             row < rows, o);
    }
  }
  hopper::cp_async_wait_all();
  const long long part = static_cast<long long>(blockIdx.x) * hidden;
  store_partial<T, VPT, SCALAR>(dw, dw_part + part, hidden);
  if (db_part != nullptr)
    store_partial<T, VPT, SCALAR>(db, db_part + part, hidden);
}

// A launch plan, as ops/cuda/fused_norm.py `launch_plan` picks it.
struct Plan {
  int vpt, threads, block_rows, grid, scalar;
};

// Bytes of the backward's ring under `p` (it holds the fold of the row
// slots' partial sums after: hidden floats <= the ring's bytes / 12).
template <typename T>
int ring_bytes(const Plan& p) {
  return 3 * kStages * p.vpt * p.threads * p.block_rows *
         static_cast<int>(sizeof(Chunk<T>));
}

// 0 where the kernels can run `p` over [rows, hidden] with these
// pointers, else the error the wrapper raises.
template <typename T>
int check_plan(const Plan& p, long long rows, int hidden,
               std::initializer_list<const void*> ptrs) {
  const bool vpt_ok = (p.vpt == 1 || p.vpt == 2 || p.vpt == 4) &&
                      p.vpt <= kMaxVpt<T>;
  if (!vpt_ok || rows < 1 || hidden < 1 || p.threads < 32 ||
      p.threads % 32 || p.block_rows < 1 ||
      p.threads * p.block_rows > kMaxThreads || p.grid < 1 ||
      static_cast<long long>(p.threads) * p.vpt * kVec<T> < hidden)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!p.scalar && (hidden % kVec<T> || !aligned16(ptrs)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  return 0;
}

// The largest ring a plan can ask for: kMaxThreads threads of
// kMaxVpt<float> chunks.
constexpr int kRingBytes = 3 * kStages * kMaxThreads * 4 * 16;

// Lets `KERNEL` take a ring of up to kRingBytes, once an instantiation
// and a device: the driver call stays off the per-launch path.
template <auto KERNEL>
cudaError_t allow_ring() {
  static std::atomic<bool> allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(KERNEL,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRingBytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    allowed[dev].store(true, std::memory_order_release);
  return err;
}

// Calls launch(VPT, SCALAR) with the plan's instantiation as
// std::integral_constant / std::bool_constant arguments.
template <typename T, typename Launch>
int dispatch(const Plan& p, Launch&& launch) {
  using One = std::integral_constant<int, 1>;
  using Two = std::integral_constant<int, 2>;
  using Four = std::integral_constant<int, 4>;
  switch (p.vpt * 2 + (p.scalar ? 1 : 0)) {
    case 2: launch(One{}, std::false_type{}); break;
    case 3: launch(One{}, std::true_type{}); break;
    case 4: launch(Two{}, std::false_type{}); break;
    case 5: launch(Two{}, std::true_type{}); break;
    default:
      if constexpr (kMaxVpt<T> >= 4) {
        if (p.vpt == 4) {
          if (p.scalar) launch(Four{}, std::true_type{});
          else launch(Four{}, std::false_type{});
          break;
        }
      }
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

#define NORM_KERNEL(kernel) \
  kernel<T, decltype(vpt)::value, decltype(scalar)::value> \
      <<<p.grid, dim3(p.threads, p.block_rows), 0, st>>>
// the backward: its ring in dynamic shared memory
#define NORM_BWD_KERNEL(kernel)                                          \
  constexpr auto k = kernel<T, decltype(vpt)::value,                     \
                            decltype(scalar)::value>;                    \
  if (allow_ring<k>() != cudaSuccess) return;                            \
  k<<<p.grid, dim3(p.threads, p.block_rows), ring_bytes<T>(p), st>>>

template <typename T>
int launch_fwd(const void* x, const void* h, const void* w, void* y,
               void* s, long long rows, int hidden, float eps, const Plan& p,
               void* stream) {
  if (int err = check_plan<T>(p, rows, hidden, {x, h, w, y, s})) return err;
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch<T>(p, [&](auto vpt, auto scalar) {
    NORM_KERNEL(rmsnorm_fwd_kernel)(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<const float*>(w), static_cast<T*>(y),
        static_cast<T*>(s), rows, hidden, eps);
  });
}

template <typename T>
int launch_ln_fwd(const void* x, const void* h, const void* w, const void* b,
                  void* y, void* s, long long rows, int hidden, float eps,
                  const Plan& p, void* stream) {
  if (int err = check_plan<T>(p, rows, hidden,
                              {x, h, w, b ? b : w, y, s}))
    return err;
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch<T>(p, [&](auto vpt, auto scalar) {
    NORM_KERNEL(layernorm_fwd_kernel)(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<T*>(y), static_cast<T*>(s), rows, hidden, eps);
  });
}

template <typename T>
int launch_bwd(const void* s, const void* w, const void* dy, const void* dr,
               void* dx, void* dw_part, long long rows, int hidden,
               float eps, const Plan& p, void* stream) {
  if (int err = check_plan<T>(p, rows, hidden,
                                  {s, w, dy, dr, dx, dw_part}))
    return err;
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch<T>(p, [&](auto vpt, auto scalar) {
    NORM_BWD_KERNEL(rmsnorm_bwd_kernel)(
        static_cast<const T*>(s), static_cast<const float*>(w),
        static_cast<const T*>(dy), static_cast<const T*>(dr),
        static_cast<T*>(dx), static_cast<float*>(dw_part), rows, hidden,
        eps);
  });
}

template <typename T>
int launch_ln_bwd(const void* s, const void* w, const void* dy,
                  const void* dr, void* dx, void* dw_part, void* db_part,
                  long long rows, int hidden, float eps, const Plan& p,
                  void* stream) {
  if (int err = check_plan<T>(p, rows, hidden,
                                  {s, w, dy, dr, dx, dw_part,
                                   db_part ? db_part : dw_part}))
    return err;
  auto st = static_cast<cudaStream_t>(stream);
  return dispatch<T>(p, [&](auto vpt, auto scalar) {
    NORM_BWD_KERNEL(layernorm_bwd_kernel)(
        static_cast<const T*>(s), static_cast<const float*>(w),
        static_cast<const T*>(dy), static_cast<const T*>(dr),
        static_cast<T*>(dx), static_cast<float*>(dw_part),
        static_cast<float*>(db_part), rows, hidden, eps);
  });
}

#undef NORM_KERNEL
#undef NORM_BWD_KERNEL

}  // namespace

// Every entry point takes the plan as five ints (vpt, threads a row,
// rows a block, grid, scalar arm), then the stream.
#define HETU_PLAN Plan{vpt, threads, block_rows, grid, scalar}, stream

HETU_EXPORT int hetu_rmsnorm_fwd_f32(const void* x, const void* h,
                                     const void* w, void* y, void* s,
                                     long long rows, int hidden, float eps,
                                     int vpt, int threads, int block_rows,
                                     int grid, int scalar, void* stream) {
  return launch_fwd<float>(x, h, w, y, s, rows, hidden, eps, HETU_PLAN);
}

HETU_EXPORT int hetu_rmsnorm_fwd_bf16(const void* x, const void* h,
                                      const void* w, void* y, void* s,
                                      long long rows, int hidden, float eps,
                                      int vpt, int threads, int block_rows,
                                      int grid, int scalar, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, h, w, y, s, rows, hidden, eps,
                                   HETU_PLAN);
}

HETU_EXPORT int hetu_rmsnorm_fwd_f16(const void* x, const void* h,
                                     const void* w, void* y, void* s,
                                     long long rows, int hidden, float eps,
                                     int vpt, int threads, int block_rows,
                                     int grid, int scalar, void* stream) {
  return launch_fwd<__half>(x, h, w, y, s, rows, hidden, eps, HETU_PLAN);
}

HETU_EXPORT int hetu_rmsnorm_bwd_f32(const void* s, const void* w,
                                     const void* dy, const void* dr,
                                     void* dx, void* dw_part, long long rows,
                                     int hidden, float eps, int vpt,
                                     int threads, int block_rows, int grid,
                                     int scalar, void* stream) {
  return launch_bwd<float>(s, w, dy, dr, dx, dw_part, rows, hidden, eps,
                           HETU_PLAN);
}

HETU_EXPORT int hetu_rmsnorm_bwd_bf16(const void* s, const void* w,
                                      const void* dy, const void* dr,
                                      void* dx, void* dw_part, long long rows,
                                      int hidden, float eps, int vpt,
                                      int threads, int block_rows, int grid,
                                      int scalar, void* stream) {
  return launch_bwd<__nv_bfloat16>(s, w, dy, dr, dx, dw_part, rows, hidden,
                                   eps, HETU_PLAN);
}

HETU_EXPORT int hetu_rmsnorm_bwd_f16(const void* s, const void* w,
                                     const void* dy, const void* dr,
                                     void* dx, void* dw_part, long long rows,
                                     int hidden, float eps, int vpt,
                                     int threads, int block_rows, int grid,
                                     int scalar, void* stream) {
  return launch_bwd<__half>(s, w, dy, dr, dx, dw_part, rows, hidden, eps,
                            HETU_PLAN);
}

HETU_EXPORT int hetu_layernorm_fwd_f32(const void* x, const void* h,
                                       const void* w, const void* b, void* y,
                                       void* s, long long rows, int hidden,
                                       float eps, int vpt, int threads,
                                       int block_rows, int grid, int scalar,
                                       void* stream) {
  return launch_ln_fwd<float>(x, h, w, b, y, s, rows, hidden, eps,
                              HETU_PLAN);
}

HETU_EXPORT int hetu_layernorm_fwd_bf16(const void* x, const void* h,
                                        const void* w, const void* b, void* y,
                                        void* s, long long rows, int hidden,
                                        float eps, int vpt, int threads,
                                        int block_rows, int grid, int scalar,
                                        void* stream) {
  return launch_ln_fwd<__nv_bfloat16>(x, h, w, b, y, s, rows, hidden, eps,
                                      HETU_PLAN);
}

HETU_EXPORT int hetu_layernorm_fwd_f16(const void* x, const void* h,
                                       const void* w, const void* b, void* y,
                                       void* s, long long rows, int hidden,
                                       float eps, int vpt, int threads,
                                       int block_rows, int grid, int scalar,
                                       void* stream) {
  return launch_ln_fwd<__half>(x, h, w, b, y, s, rows, hidden, eps, HETU_PLAN);
}

HETU_EXPORT int hetu_layernorm_bwd_f32(const void* s, const void* w,
                                       const void* dy, const void* dr,
                                       void* dx, void* dw_part, void* db_part,
                                       long long rows, int hidden, float eps,
                                       int vpt, int threads, int block_rows,
                                       int grid, int scalar, void* stream) {
  return launch_ln_bwd<float>(s, w, dy, dr, dx, dw_part, db_part, rows,
                              hidden, eps, HETU_PLAN);
}

HETU_EXPORT int hetu_layernorm_bwd_bf16(const void* s, const void* w,
                                        const void* dy, const void* dr,
                                        void* dx, void* dw_part,
                                        void* db_part, long long rows,
                                        int hidden, float eps, int vpt,
                                        int threads, int block_rows, int grid,
                                        int scalar, void* stream) {
  return launch_ln_bwd<__nv_bfloat16>(s, w, dy, dr, dx, dw_part, db_part,
                                      rows, hidden, eps, HETU_PLAN);
}

HETU_EXPORT int hetu_layernorm_bwd_f16(const void* s, const void* w,
                                       const void* dy, const void* dr,
                                       void* dx, void* dw_part,
                                       void* db_part, long long rows,
                                       int hidden, float eps, int vpt,
                                       int threads, int block_rows, int grid,
                                       int scalar, void* stream) {
  return launch_ln_bwd<__half>(s, w, dy, dr, dx, dw_part, db_part, rows,
                               hidden, eps, HETU_PLAN);
}

#undef HETU_PLAN
