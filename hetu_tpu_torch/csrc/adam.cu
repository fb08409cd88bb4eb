// Fused AdamW update of one parameter leaf, in place.
//
// Replaces hetu_tpu/ops/pallas/adam.py `_adam_kernel` / `adam_update`:
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g^2
//   p' = p - lr * ((m' / c1) / (sqrt(v' / c2) + eps) + wd * p)
// in fp32 (p fp32 or bf16, rounded once; g, m, v fp32).  lr and the
// bias corrections c1 = 1 - b1^step, c2 = 1 - b2^step arrive by value,
// computed on the host in fp32 as the JAX optimizer computes them in
// its graph; the decay sits inside the bracket on every leaf, as in
// the reference (not torch's decoupled p *= 1 - lr * wd).
//
// Bound on an H100 by bytes: 28 bytes per fp32 element (p, m, v read
// and written, g read) against ~15 flops.  Design: one elementwise
// grid-stride pass that reads p, g, m and v once and writes p, m and v
// IN PLACE: where the JAX package donates its old buffers to the
// jitted step, the port updates the tensors it owns, so no second copy
// of the optimizer state is ever allocated.  _rn intrinsics keep the
// compiler from contracting into FMAs, matching the plain PyTorch
// version's rounding order.
#include "common.cuh"

template <typename P>
__global__ void adam_kernel(P* __restrict__ p, const float* __restrict__ g,
                            float* __restrict__ m, float* __restrict__ v,
                            long long n, float b1, float one_minus_b1,
                            float b2, float one_minus_b2, float lr, float c1,
                            float c2, float eps, float wd) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const float gv = g[i];
    const float mv = __fadd_rn(__fmul_rn(b1, m[i]),
                               __fmul_rn(one_minus_b1, gv));
    const float vv = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(one_minus_b2, __fmul_rn(gv, gv)));
    const float mhat = __fdiv_rn(mv, c1);
    const float vhat = __fdiv_rn(vv, c2);
    const float pf = to_f32(p[i]);
    const float upd = __fadd_rn(
        __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), eps)), __fmul_rn(wd, pf));
    p[i] = from_f32<P>(__fsub_rn(pf, __fmul_rn(lr, upd)));
    m[i] = mv;
    v[i] = vv;
  }
}

template <typename P>
static int launch(void* p, const void* g, void* m, void* v, long long n,
                  float b1, float one_minus_b1, float b2, float one_minus_b2,
                  float lr, float c1, float c2, float eps, float wd,
                  void* stream) {
  constexpr int threads = 256;
  adam_kernel<P><<<grid_for(n, threads, 132 * 16), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<P*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, b1, one_minus_b1,
      b2, one_minus_b2, lr, c1, c2, eps, wd);
  return static_cast<int>(cudaGetLastError());
}

HETU_EXPORT int hetu_adam_f32(void* p, const void* g, void* m, void* v,
                              long long n, float b1, float one_minus_b1,
                              float b2, float one_minus_b2, float lr,
                              float c1, float c2, float eps, float wd,
                              void* stream) {
  return launch<float>(p, g, m, v, n, b1, one_minus_b1, b2, one_minus_b2, lr,
                       c1, c2, eps, wd, stream);
}

HETU_EXPORT int hetu_adam_bf16(void* p, const void* g, void* m, void* v,
                               long long n, float b1, float one_minus_b1,
                               float b2, float one_minus_b2, float lr,
                               float c1, float c2, float eps, float wd,
                               void* stream) {
  return launch<__nv_bfloat16>(p, g, m, v, n, b1, one_minus_b1, b2,
                               one_minus_b2, lr, c1, c2, eps, wd, stream);
}
