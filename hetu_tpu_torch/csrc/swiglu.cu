// Fused SwiGLU over [tokens, inner], forward and backward:
//   forward:  y = silu(gate) * up
//   backward: dgate = dy * up * sig * (1 + gate * (1 - sig)),
//             dup = dy * gate * sig,           sig = sigmoid(gate)
//
// Replaces hetu_tpu/ops/pallas/swiglu.py `_fwd_kernel` / `_swiglu`
// (forward) and `_bwd_kernel` / `_swiglu_bwd` (backward).  Bound on an
// H100 by bytes: forward two reads and one write per element, backward
// three reads and two writes, at ~5-12 flops, far below the card's
// flops-per-byte balance.  Design: one pass, fp32 math, one rounding
// to the storage type, so no fp32 intermediate touches device memory;
// every operand is addressed through its own row stride, so the model's
// strided gate/up halves of the fused [tokens, 2, inner] projection are
// read in place, and the backward writes dgate and dup straight into
// the two halves of ONE [tokens, 2, inner] gradient buffer (no concat).
// Explicit _rn intrinsics keep the compiler from contracting into FMAs,
// matching the plain PyTorch version's rounding order.
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

// Backward from the saved (gate, up): sigmoid is recomputed, not kept.
template <typename T>
__global__ void swiglu_bwd_kernel(const T* __restrict__ gate,
                                  const T* __restrict__ up,
                                  const T* __restrict__ dy,
                                  T* __restrict__ dgate, T* __restrict__ dup,
                                  long long tokens, long long inner,
                                  long long g_stride, long long u_stride,
                                  long long dy_stride, long long dg_stride,
                                  long long du_stride) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < tokens; row += gridDim.y) {
    const T* g = gate + row * g_stride;
    const T* u = up + row * u_stride;
    const T* d = dy + row * dy_stride;
    T* dg = dgate + row * dg_stride;
    T* du = dup + row * du_stride;
    for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         i < inner; i += step) {
      const float gv = to_f32(g[i]);
      const float uv = to_f32(u[i]);
      const float dv = to_f32(d[i]);
      const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-gv)));
      const float slope =
          __fadd_rn(1.0f, __fmul_rn(gv, __fsub_rn(1.0f, sig)));
      dg[i] = from_f32<T>(__fmul_rn(__fmul_rn(__fmul_rn(dv, uv), sig),
                                    slope));
      du[i] = from_f32<T>(__fmul_rn(__fmul_rn(dv, gv), sig));
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

template <typename T>
static int launch_bwd(const void* gate, const void* up, const void* dy,
                      void* dgate, void* dup, long long tokens,
                      long long inner, long long g_stride, long long u_stride,
                      long long dy_stride, long long dg_stride,
                      long long du_stride, void* stream) {
  constexpr int threads = 256;
  dim3 grid(grid_for(inner, threads, 1024), grid_for(tokens, 1, 65535));
  swiglu_bwd_kernel<T><<<grid, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gate), static_cast<const T*>(up),
      static_cast<const T*>(dy), static_cast<T*>(dgate),
      static_cast<T*>(dup), tokens, inner, g_stride, u_stride, dy_stride,
      dg_stride, du_stride);
  return static_cast<int>(cudaGetLastError());
}

HETU_EXPORT int hetu_swiglu_bwd_f32(const void* gate, const void* up,
                                    const void* dy, void* dgate, void* dup,
                                    long long tokens, long long inner,
                                    long long g_stride, long long u_stride,
                                    long long dy_stride, long long dg_stride,
                                    long long du_stride, void* stream) {
  return launch_bwd<float>(gate, up, dy, dgate, dup, tokens, inner,
                           g_stride, u_stride, dy_stride, dg_stride,
                           du_stride, stream);
}

HETU_EXPORT int hetu_swiglu_bwd_bf16(const void* gate, const void* up,
                                     const void* dy, void* dgate, void* dup,
                                     long long tokens, long long inner,
                                     long long g_stride, long long u_stride,
                                     long long dy_stride, long long dg_stride,
                                     long long du_stride, void* stream) {
  return launch_bwd<__nv_bfloat16>(gate, up, dy, dgate, dup, tokens, inner,
                                   g_stride, u_stride, dy_stride, dg_stride,
                                   du_stride, stream);
}
