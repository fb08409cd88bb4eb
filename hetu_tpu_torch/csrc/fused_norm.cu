// Fused residual-add + RMSNorm, forward and backward, over [rows, hidden].
//
// Replaces hetu_tpu/ops/pallas/fused_norm.py, the RMS variant of
// `_fwd_kernel` / `_call_fwd` and `_bwd_kernel` / `_call_bwd` (the
// custom VJP of `fused_residual_rmsnorm`).
//
//   forward:  s = x + h (fp32);  y = s * rsqrt(mean(s^2) + eps) * w
//             y is computed from the UNROUNDED fp32 s, as the Pallas
//             kernel does; y and s are each rounded once to x's dtype.
//   backward: from the saved, already rounded s:
//             inv = rsqrt(mean(s^2) + eps); xhat = s * inv; g = dy * w
//             dx = inv * (g - xhat * mean(g * xhat)) + dr
//             dw = sum over rows of dy * xhat
//
// Bound on an H100 by bytes: a handful of flops per element against 6
// (forward: x, h in; y, s out) or 8 (backward: s, dy, dr in; dx out)
// bytes per bf16 element.  Design: one block of 256 threads per row,
// each thread holding VPT values of the row in registers (columns
// tid, tid + 256, ... so neighbouring threads touch neighbouring
// addresses), so a row is read once and written once; the row sums are
// one warp-shuffle + shared-memory reduction.  The backward's dw is a
// sum over all rows; summing it across blocks would take atomics, which
// make dw depend on the order blocks finish.  Instead, like the Pallas
// kernel, each block writes its own partial row of dw, from a fixed
// set of rows (row = block, block + grid, ...), and the wrapper sums
// the [grid, hidden] partials with one torch.sum, as the JAX code sums
// its per-block partials outside Pallas.  _rn intrinsics keep the
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
