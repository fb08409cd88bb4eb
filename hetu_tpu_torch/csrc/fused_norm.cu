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
//             dx = inv * (g - xhat * mean(g * xhat)) + dr
//             dw = sum over rows of dy * xhat
//   LN backward:  inv and mu from s as in the forward;
//             xhat = (s - mu) * inv; g = dy * w
//             dx = inv * (g - mean(g) - xhat * mean(g * xhat)) + dr
//             dw = sum over rows of dy * xhat;  db = sum over rows of dy
//             (db only with a bias: a null db pointer is the scale-only
//             arm, as a null b is in the forward)
//
// Bound on an H100 by bytes: a handful of flops per element against 8
// bytes per bf16 element, forward (x, h in; y, s out) and backward (s,
// dy, dr in; dx out).  Design: one block of 256 threads per row,
// each thread holding VPT values of the row in registers (columns
// tid, tid + 256, ... so neighbouring threads touch neighbouring
// addresses; columns past `hidden` are masked, so any width up to
// 256 * 32 runs), so a row is read once and written once; the row sums are
// one warp-shuffle + shared-memory reduction.  The backward's dw (and
// db) is a sum over all rows; summing it across blocks would take
// atomics, which make it depend on the order blocks finish.  Instead,
// like the Pallas kernel, each block writes its own partial row, from
// a fixed set of rows (row = block, block + grid, ...), and the wrapper
// sums the [grid, hidden] partials with one torch.sum, as the JAX code
// sums its per-block partials outside Pallas.  _rn intrinsics keep the
// compiler from contracting into FMAs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sum of `v` over the block; every thread gets the result.  `red` holds
// kWarps floats; the trailing barrier lets the caller reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  __syncthreads();
  return t;
}

// Sums of `a` and `b` over the block in one round of barriers; every
// thread gets both.  `red` holds 2 * kWarps floats.
__device__ __forceinline__ float2 block_sum2(float a, float b, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[warp] = a;
    red[kWarps + warp] = b;
  }
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    t.x += red[i];
    t.y += red[kWarps + i];
  }
  __syncthreads();
  return t;
}

__device__ __forceinline__ float inv_rms(float sum_sq, int hidden,
                                         float eps) {
  const float var = __fdiv_rn(sum_sq, static_cast<float>(hidden));
  return __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps)));
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                   const float* __restrict__ w, T* __restrict__ y,
                   T* __restrict__ s_out, long long rows, int hidden,
                   float eps) {
  __shared__ float red[kWarps];
  float wv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = j * kThreads + threadIdx.x;
    wv[j] = col < hidden ? w[col] : 0.0f;
  }
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * hidden;
    float sv[VPT];
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      sv[j] = col < hidden
                  ? __fadd_rn(to_f32(x[base + col]), to_f32(h[base + col]))
                  : 0.0f;
      sq = __fadd_rn(sq, __fmul_rn(sv[j], sv[j]));
    }
    const float inv = inv_rms(block_sum(sq, red), hidden, eps);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      if (col < hidden) {
        y[base + col] = from_f32<T>(__fmul_rn(__fmul_rn(sv[j], inv), wv[j]));
        s_out[base + col] = from_f32<T>(sv[j]);
      }
    }
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_kernel(const T* __restrict__ s, const float* __restrict__ w,
                   const T* __restrict__ dy, const T* __restrict__ dr,
                   T* __restrict__ dx, float* __restrict__ dw_part,
                   long long rows, int hidden, float eps) {
  __shared__ float red[kWarps];
  float wv[VPT], dw[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = j * kThreads + threadIdx.x;
    wv[j] = col < hidden ? w[col] : 0.0f;
    dw[j] = 0.0f;
  }
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * hidden;
    float sv[VPT], gv[VPT], dyv[VPT];
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      const bool in = col < hidden;
      sv[j] = in ? to_f32(s[base + col]) : 0.0f;
      dyv[j] = in ? to_f32(dy[base + col]) : 0.0f;
      gv[j] = __fmul_rn(dyv[j], wv[j]);
      sq = __fadd_rn(sq, __fmul_rn(sv[j], sv[j]));
    }
    const float inv = inv_rms(block_sum(sq, red), hidden, eps);
    float gx = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      sv[j] = __fmul_rn(sv[j], inv);                       // xhat
      gx = __fadd_rn(gx, __fmul_rn(gv[j], sv[j]));
    }
    const float mean_gx =
        __fdiv_rn(block_sum(gx, red), static_cast<float>(hidden));
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      if (col < hidden) {
        const float d = __fmul_rn(
            inv, __fsub_rn(gv[j], __fmul_rn(sv[j], mean_gx)));
        dx[base + col] = from_f32<T>(__fadd_rn(d, to_f32(dr[base + col])));
        dw[j] = __fadd_rn(dw[j], __fmul_rn(dyv[j], sv[j]));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = j * kThreads + threadIdx.x;
    if (col < hidden) dw_part[static_cast<long long>(blockIdx.x) * hidden +
                              col] = dw[j];
  }
}

// The LayerNorm row statistics of the VPT values each thread holds
// (columns past `hidden` hold 0 and are masked out of the variance):
// mu = mean(s), then inv = rsqrt(mean((s - mu)^2) + eps) from the
// centred values, a second pass over the registers.
template <int VPT>
__device__ __forceinline__ float2 ln_stats(const float (&sv)[VPT],
                                           int hidden, float eps,
                                           float* red) {
  float sum = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) sum = __fadd_rn(sum, sv[j]);
  const float n = static_cast<float>(hidden);
  const float mu = __fdiv_rn(block_sum(sum, red), n);
  float sq = 0.0f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (j * kThreads + static_cast<int>(threadIdx.x) < hidden) {
      const float c = __fsub_rn(sv[j], mu);
      sq = __fadd_rn(sq, __fmul_rn(c, c));
    }
  }
  const float var = __fdiv_rn(block_sum(sq, red), n);
  return make_float2(mu, __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, eps))));
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
layernorm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ h,
                     const float* __restrict__ w,
                     const float* __restrict__ b, T* __restrict__ y,
                     T* __restrict__ s_out, long long rows, int hidden,
                     float eps) {
  __shared__ float red[kWarps];
  float wv[VPT], bv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = j * kThreads + threadIdx.x;
    wv[j] = col < hidden ? w[col] : 0.0f;
    bv[j] = (b != nullptr && col < hidden) ? b[col] : 0.0f;
  }
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * hidden;
    float sv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      sv[j] = col < hidden
                  ? __fadd_rn(to_f32(x[base + col]), to_f32(h[base + col]))
                  : 0.0f;
    }
    const float2 st = ln_stats(sv, hidden, eps, red);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      if (col < hidden) {
        float v = __fmul_rn(__fmul_rn(__fsub_rn(sv[j], st.x), st.y), wv[j]);
        if (b != nullptr) v = __fadd_rn(v, bv[j]);
        y[base + col] = from_f32<T>(v);
        s_out[base + col] = from_f32<T>(sv[j]);
      }
    }
  }
}

template <typename T, int VPT>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_kernel(const T* __restrict__ s, const float* __restrict__ w,
                     const T* __restrict__ dy, const T* __restrict__ dr,
                     T* __restrict__ dx, float* __restrict__ dw_part,
                     float* __restrict__ db_part, long long rows, int hidden,
                     float eps) {
  __shared__ float red[2 * kWarps];
  float wv[VPT], dw[VPT], db[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = j * kThreads + threadIdx.x;
    wv[j] = col < hidden ? w[col] : 0.0f;
    dw[j] = db[j] = 0.0f;
  }
  const float n = static_cast<float>(hidden);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const long long base = row * hidden;
    // dr too is loaded before the row's reductions, so its latency
    // hides behind them (loaded after, it cost 0.108 -> 0.079 ms at
    // [8192, 1280] bf16 on an H100)
    float sv[VPT], dyv[VPT], drv[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      const bool in = col < hidden;
      sv[j] = in ? to_f32(s[base + col]) : 0.0f;
      dyv[j] = in ? to_f32(dy[base + col]) : 0.0f;
      drv[j] = in ? to_f32(dr[base + col]) : 0.0f;
    }
    const float2 st = ln_stats(sv, hidden, eps, red);
    float gs = 0.0f, gx = 0.0f;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      // xhat, 0 in the masked tail (its dy, so its g, is 0 there too)
      sv[j] = j * kThreads + static_cast<int>(threadIdx.x) < hidden
                  ? __fmul_rn(__fsub_rn(sv[j], st.x), st.y)
                  : 0.0f;
      const float g = __fmul_rn(dyv[j], wv[j]);
      gs = __fadd_rn(gs, g);
      gx = __fadd_rn(gx, __fmul_rn(g, sv[j]));
    }
    const float2 sums = block_sum2(gs, gx, red);
    const float mean_g = __fdiv_rn(sums.x, n);
    const float mean_gx = __fdiv_rn(sums.y, n);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const int col = j * kThreads + threadIdx.x;
      if (col < hidden) {
        const float g = __fmul_rn(dyv[j], wv[j]);
        const float d = __fmul_rn(
            st.y, __fsub_rn(__fsub_rn(g, mean_g), __fmul_rn(sv[j], mean_gx)));
        dx[base + col] = from_f32<T>(__fadd_rn(d, drv[j]));
        dw[j] = __fadd_rn(dw[j], __fmul_rn(dyv[j], sv[j]));
        db[j] = __fadd_rn(db[j], dyv[j]);
      }
    }
  }
  const long long part = static_cast<long long>(blockIdx.x) * hidden;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int col = j * kThreads + threadIdx.x;
    if (col < hidden) {
      dw_part[part + col] = dw[j];
      if (db_part != nullptr) db_part[part + col] = db[j];
    }
  }
}

// Values per thread for a row of `hidden`: the smallest power of two
// with 256 * VPT >= hidden, 0 past the largest instantiation.
int vpt_for(int hidden) {
  for (int v = 1; v <= 32; v <<= 1)
    if (kThreads * v >= hidden) return v;
  return 0;
}

template <typename T>
int launch_fwd(const void* x, const void* h, const void* w, void* y,
               void* s, long long rows, int hidden, float eps,
               void* stream) {
  const dim3 grid(grid_for(rows, 1, 65535));
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<const float*>(w), static_cast<T*>(y),
        static_cast<T*>(s), rows, hidden, eps);
  };
  switch (vpt_for(hidden)) {
    case 1: args(rmsnorm_fwd_kernel<T, 1>); break;
    case 2: args(rmsnorm_fwd_kernel<T, 2>); break;
    case 4: args(rmsnorm_fwd_kernel<T, 4>); break;
    case 8: args(rmsnorm_fwd_kernel<T, 8>); break;
    case 16: args(rmsnorm_fwd_kernel<T, 16>); break;
    case 32: args(rmsnorm_fwd_kernel<T, 32>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* s, const void* w, const void* dy, const void* dr,
               void* dx, void* dw_part, long long rows, int hidden, int grid,
               float eps, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(s), static_cast<const float*>(w),
        static_cast<const T*>(dy), static_cast<const T*>(dr),
        static_cast<T*>(dx), static_cast<float*>(dw_part), rows, hidden,
        eps);
  };
  switch (vpt_for(hidden)) {
    case 1: args(rmsnorm_bwd_kernel<T, 1>); break;
    case 2: args(rmsnorm_bwd_kernel<T, 2>); break;
    case 4: args(rmsnorm_bwd_kernel<T, 4>); break;
    case 8: args(rmsnorm_bwd_kernel<T, 8>); break;
    case 16: args(rmsnorm_bwd_kernel<T, 16>); break;
    case 32: args(rmsnorm_bwd_kernel<T, 32>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_fwd(const void* x, const void* h, const void* w, const void* b,
                  void* y, void* s, long long rows, int hidden, float eps,
                  void* stream) {
  const dim3 grid(grid_for(rows, 1, 65535));
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(h),
        static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<T*>(y), static_cast<T*>(s), rows, hidden, eps);
  };
  switch (vpt_for(hidden)) {
    case 1: args(layernorm_fwd_kernel<T, 1>); break;
    case 2: args(layernorm_fwd_kernel<T, 2>); break;
    case 4: args(layernorm_fwd_kernel<T, 4>); break;
    case 8: args(layernorm_fwd_kernel<T, 8>); break;
    case 16: args(layernorm_fwd_kernel<T, 16>); break;
    case 32: args(layernorm_fwd_kernel<T, 32>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ln_bwd(const void* s, const void* w, const void* dy,
                  const void* dr, void* dx, void* dw_part, void* db_part,
                  long long rows, int hidden, int grid, float eps,
                  void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(s), static_cast<const float*>(w),
        static_cast<const T*>(dy), static_cast<const T*>(dr),
        static_cast<T*>(dx), static_cast<float*>(dw_part),
        static_cast<float*>(db_part), rows, hidden, eps);
  };
  switch (vpt_for(hidden)) {
    case 1: args(layernorm_bwd_kernel<T, 1>); break;
    case 2: args(layernorm_bwd_kernel<T, 2>); break;
    case 4: args(layernorm_bwd_kernel<T, 4>); break;
    case 8: args(layernorm_bwd_kernel<T, 8>); break;
    case 16: args(layernorm_bwd_kernel<T, 16>); break;
    case 32: args(layernorm_bwd_kernel<T, 32>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

HETU_EXPORT int hetu_rmsnorm_fwd_f32(const void* x, const void* h,
                                     const void* w, void* y, void* s,
                                     long long rows, int hidden, float eps,
                                     void* stream) {
  return launch_fwd<float>(x, h, w, y, s, rows, hidden, eps, stream);
}

HETU_EXPORT int hetu_rmsnorm_fwd_bf16(const void* x, const void* h,
                                      const void* w, void* y, void* s,
                                      long long rows, int hidden, float eps,
                                      void* stream) {
  return launch_fwd<__nv_bfloat16>(x, h, w, y, s, rows, hidden, eps, stream);
}

HETU_EXPORT int hetu_rmsnorm_bwd_f32(const void* s, const void* w,
                                     const void* dy, const void* dr,
                                     void* dx, void* dw_part, long long rows,
                                     int hidden, int grid, float eps,
                                     void* stream) {
  return launch_bwd<float>(s, w, dy, dr, dx, dw_part, rows, hidden, grid,
                           eps, stream);
}

HETU_EXPORT int hetu_rmsnorm_bwd_bf16(const void* s, const void* w,
                                      const void* dy, const void* dr,
                                      void* dx, void* dw_part, long long rows,
                                      int hidden, int grid, float eps,
                                      void* stream) {
  return launch_bwd<__nv_bfloat16>(s, w, dy, dr, dx, dw_part, rows, hidden,
                                   grid, eps, stream);
}

HETU_EXPORT int hetu_layernorm_fwd_f32(const void* x, const void* h,
                                       const void* w, const void* b, void* y,
                                       void* s, long long rows, int hidden,
                                       float eps, void* stream) {
  return launch_ln_fwd<float>(x, h, w, b, y, s, rows, hidden, eps, stream);
}

HETU_EXPORT int hetu_layernorm_fwd_bf16(const void* x, const void* h,
                                        const void* w, const void* b, void* y,
                                        void* s, long long rows, int hidden,
                                        float eps, void* stream) {
  return launch_ln_fwd<__nv_bfloat16>(x, h, w, b, y, s, rows, hidden, eps,
                                      stream);
}

HETU_EXPORT int hetu_layernorm_bwd_f32(const void* s, const void* w,
                                       const void* dy, const void* dr,
                                       void* dx, void* dw_part, void* db_part,
                                       long long rows, int hidden, int grid,
                                       float eps, void* stream) {
  return launch_ln_bwd<float>(s, w, dy, dr, dx, dw_part, db_part, rows,
                              hidden, grid, eps, stream);
}

HETU_EXPORT int hetu_layernorm_bwd_bf16(const void* s, const void* w,
                                        const void* dy, const void* dr,
                                        void* dx, void* dw_part,
                                        void* db_part, long long rows,
                                        int hidden, int grid, float eps,
                                        void* stream) {
  return launch_ln_bwd<__nv_bfloat16>(s, w, dy, dr, dx, dw_part, db_part,
                                      rows, hidden, grid, eps, stream);
}
