// Fused SwiGLU forward: y = silu(gate) * up over [tokens, inner].
//
// Replaces hetu_tpu/ops/pallas/swiglu.py `_fwd_kernel` / `_swiglu` /
// `fused_swiglu` (forward).  Bound on an H100 by bytes: two reads and
// one write per element at ~5 flops, far below the card's
// flops-per-byte balance.  Design: one pass, fp32 math, one rounding
// to the storage type, so the [tokens, inner] product never touches
// device memory in fp32; gate and up are read through their row
// strides, so the model's strided views of the fused gate/up
// projection need no copy.  Explicit _rn intrinsics keep the compiler
// from contracting into FMAs, matching the plain PyTorch version's
// rounding order.
#include "common.cuh"

template <typename T>
__global__ void swiglu_fwd_kernel(const T* __restrict__ gate,
                                  const T* __restrict__ up,
                                  T* __restrict__ out, long long tokens,
                                  long long inner, long long g_stride,
                                  long long u_stride) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < tokens; row += gridDim.y) {
    const T* g = gate + row * g_stride;
    const T* u = up + row * u_stride;
    T* y = out + row * inner;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < inner; i += step) {
      const float gv = to_f32(g[i]);
      const float uv = to_f32(u[i]);
      const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-gv)));
      y[i] = from_f32<T>(__fmul_rn(__fmul_rn(gv, sig), uv));
    }
  }
}

template <typename T>
static int launch(const void* gate, const void* up, void* out,
                  long long tokens, long long inner, long long g_stride,
                  long long u_stride, void* stream) {
  constexpr int threads = 256;
  dim3 grid(grid_for(inner, threads, 1024), grid_for(tokens, 1, 65535));
  swiglu_fwd_kernel<T><<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<T*>(out), tokens, inner, g_stride, u_stride);
  return static_cast<int>(cudaGetLastError());
}

HETU_EXPORT int hetu_swiglu_fwd_f32(const void* gate, const void* up,
                                    void* out, long long tokens,
                                    long long inner, long long g_stride,
                                    long long u_stride, void* stream) {
  return launch<float>(gate, up, out, tokens, inner, g_stride, u_stride,
                       stream);
}

HETU_EXPORT int hetu_swiglu_fwd_bf16(const void* gate, const void* up,
                                     void* out, long long tokens,
                                     long long inner, long long g_stride,
                                     long long u_stride, void* stream) {
  return launch<__nv_bfloat16>(gate, up, out, tokens, inner, g_stride,
                               u_stride, stream);
}
