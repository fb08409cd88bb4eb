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
//
// The forward streams: HBM3 needs ~20 KB of loads in flight an SM to
// reach its rate, and one 2-byte element a thread keeps ~8 KB.  So a
// flat grid of at most one wave (every SM full) strides over (token,
// vector column) in 16-byte vectors of gate, up and out (8 bf16 or
// fp16, 4 fp32 each).  Up to a few waves of vectors (a serving call's sizes),
// a thread takes one vector at a time in blocks of 256, with few
// registers and so the most threads an SM; a larger call (a training
// step's) takes two vectors a thread, one grid apart, both loaded
// before any math, in blocks of 64.  The index math is 32-bit where
// the sizes fit.  Rows
// whose width is not a multiple of the vector, or whose bases or
// strides are off a 16-byte boundary, take the scalar arm: the same
// kernel on one-element vectors, the same instructions per element, so
// both arms give the same bits.
#include "common.cuh"


__device__ __forceinline__ float silu_times(float gv, float uv) {
  const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-gv)));
  return __fmul_rn(__fmul_rn(gv, sig), uv);
}

// Vector f of the flat index covers out[row, col .. col + VEC); a
// thread takes UNROLL vectors a grid apart at a time.  I is int where
// every offset fits, else long long.
template <typename T, int VEC, typename I, int THREADS, int UNROLL>
__global__ void __launch_bounds__(THREADS)
    swiglu_fwd_kernel(const T* __restrict__ gate, const T* __restrict__ up,
                      T* __restrict__ out, I vectors, I row_vectors,
                      I inner, I g_stride, I u_stride) {
  using V = Vec<T, VEC>;
  const I grid_threads = static_cast<I>(gridDim.x) * THREADS;
  for (I base = static_cast<I>(blockIdx.x) * THREADS +
                static_cast<I>(threadIdx.x);
       base < vectors; base += grid_threads * UNROLL) {
    V g[UNROLL], u[UNROLL];
    I o[UNROLL];
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const I f = base + j * grid_threads;
      if (f < vectors) {
        const I row = f / row_vectors;
        const I col = (f - row * row_vectors) * VEC;
        g[j] = *reinterpret_cast<const V*>(gate + row * g_stride + col);
        u[j] = *reinterpret_cast<const V*>(up + row * u_stride + col);
        o[j] = row * inner + col;
      }
    }
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      if (base + j * grid_threads < vectors) {
        V y;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          y.v[e] = from_f32<T>(silu_times(to_f32(g[j].v[e]),
                                          to_f32(u[j].v[e])));
        *reinterpret_cast<V*>(out + o[j]) = y;
      }
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

template <typename T, int VEC, typename I, int THREADS, int UNROLL>
static int launch_shape(const void* gate, const void* up, void* out,
                        long long vectors, long long inner,
                        long long g_stride, long long u_stride, int wave,
                        cudaStream_t stream) {
  const unsigned grid =
      grid_for(vectors, THREADS, wave < 65535 ? wave : 65535);
  swiglu_fwd_kernel<T, VEC, I, THREADS, UNROLL>
      <<<grid, THREADS, 0, stream>>>(
          static_cast<const T*>(gate), static_cast<const T*>(up),
          static_cast<T*>(out), static_cast<I>(vectors),
          static_cast<I>(inner / VEC), static_cast<I>(inner),
          static_cast<I>(g_stride), static_cast<I>(u_stride));
  return static_cast<int>(cudaGetLastError());
}

// Up to SMALL_WAVES waves of one vector a thread: blocks of 256, one
// vector at a time; beyond: blocks of 64, two vectors at a time.
constexpr long long SMALL_WAVES = 4;

template <typename T, int VEC, typename I>
static int launch_arm(const void* gate, const void* up, void* out,
                      long long tokens, long long inner, long long g_stride,
                      long long u_stride, cudaStream_t stream) {
  static const int small_wave =
      wave_blocks(swiglu_fwd_kernel<T, VEC, I, 256, 1>, 256);
  static const int large_wave =
      wave_blocks(swiglu_fwd_kernel<T, VEC, I, 64, 2>, 64);
  const long long vectors = tokens * (inner / VEC);
  if (vectors <= SMALL_WAVES * small_wave * 256)
    return launch_shape<T, VEC, I, 256, 1>(gate, up, out, vectors, inner,
                                           g_stride, u_stride, small_wave,
                                           stream);
  return launch_shape<T, VEC, I, 64, 2>(gate, up, out, vectors, inner,
                                        g_stride, u_stride, large_wave,
                                        stream);
}

// The arm: 16-byte vectors where every row base lies on a 16-byte
// boundary, else one element a vector; 32-bit indices where every
// offset fits, with room for the flat index to run one grid stride
// (at most 65535 x 256) past the end.
template <typename T, int VEC>
static int launch_fits(const void* gate, const void* up, void* out,
                       long long tokens, long long inner, long long g_stride,
                       long long u_stride, cudaStream_t stream) {
  const long long reach =
      (tokens - 1) * (g_stride > u_stride ? g_stride : u_stride) + inner;
  if (reach < (1LL << 31) && tokens * inner < (1LL << 31) - (1LL << 26))
    return launch_arm<T, VEC, int>(gate, up, out, tokens, inner, g_stride,
                                   u_stride, stream);
  return launch_arm<T, VEC, long long>(gate, up, out, tokens, inner,
                                       g_stride, u_stride, stream);
}

template <typename T>
static int launch(const void* gate, const void* up, void* out,
                  long long tokens, long long inner, long long g_stride,
                  long long u_stride, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long B = sizeof(T);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = inner % VEC == 0 && aligned16({gate, up, out}) &&
                   (tokens == 1 || ((g_stride * B) % 16 == 0 &&
                                    (u_stride * B) % 16 == 0));
  if (vec)
    return launch_fits<T, VEC>(gate, up, out, tokens, inner, g_stride,
                               u_stride, s);
  return launch_fits<T, 1>(gate, up, out, tokens, inner, g_stride, u_stride,
                           s);
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

HETU_EXPORT int hetu_swiglu_fwd_f16(const void* gate, const void* up,
                                    void* out, long long tokens,
                                    long long inner, long long g_stride,
                                    long long u_stride, void* stream) {
  return launch<__half>(gate, up, out, tokens, inner, g_stride, u_stride,
                        stream);
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

HETU_EXPORT int hetu_swiglu_bwd_f16(const void* gate, const void* up,
                                    const void* dy, void* dgate, void* dup,
                                    long long tokens, long long inner,
                                    long long g_stride, long long u_stride,
                                    long long dy_stride, long long dg_stride,
                                    long long du_stride, void* stream) {
  return launch_bwd<__half>(gate, up, dy, dgate, dup, tokens, inner,
                            g_stride, u_stride, dy_stride, dg_stride,
                            du_stride, stream);
}
