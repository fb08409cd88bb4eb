// Fused rotary embedding: RoPE applied to q AND k in one launch.
//
// Replaces hetu_tpu/ops/pallas/rotary.py `_kernel` / `_apply` /
// `fused_rotary_qk`, forward and backward (`_rotary_bwd`).  q [rows, nq,
// hd] and k [rows, nk, hd] (rows = batch * seq) rotate by the
// pre-gathered fp32 tables cos_t / sin_t [rows, hd/2] with the
// half-split rotation
//   out[i]      = x[i] * cos - x[i + hd/2] * sin
//   out[i+hd/2] = x[i + hd/2] * cos + x[i] * sin
// in fp32, rounded once.  The rotation is orthogonal, so its backward
// is the same kernel rotating the cotangents by -theta: `sin_sign` is
// +1 forward and -1 backward and multiplies each sin value (exactly),
// so the backward needs no negated copy of the table.  Bound on an H100
// by bytes (each element is read and written once, six flops per
// pair).  Design: one thread per
// (row, head, pair), a grid-stride loop over q's and k's pairs in one
// launch, so the tables are read once per pair and neither tensor
// makes an extra round trip.  _rn intrinsics keep the plain PyTorch
// version's rounding order.
#include "common.cuh"

template <typename T>
__global__ void rotary_qk_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_t,
                                 T* __restrict__ q_out, T* __restrict__ k_out,
                                 long long rows, int nq, int nk, int d2,
                                 float sin_sign) {
  const long long per_row = static_cast<long long>(nq + nk) * d2;
  const long long total = rows * per_row;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
       idx < total; idx += step) {
    const long long row = idx / per_row;
    const int rem = static_cast<int>(idx - row * per_row);
    const int head = rem / d2;
    const int i = rem - head * d2;
    const float c = cos_t[row * d2 + i];
    const float s = sin_sign * sin_t[row * d2 + i];
    const T* src;
    T* dst;
    if (head < nq) {
      const long long base = (row * nq + head) * 2LL * d2;
      src = q + base;
      dst = q_out + base;
    } else {
      const long long base = (row * nk + (head - nq)) * 2LL * d2;
      src = k + base;
      dst = k_out + base;
    }
    const float x1 = to_f32(src[i]);
    const float x2 = to_f32(src[i + d2]);
    dst[i] = from_f32<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
    dst[i + d2] = from_f32<T>(__fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s)));
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* cos_t,
                  const void* sin_t, void* q_out, void* k_out, long long rows,
                  int nq, int nk, int d2, float sin_sign, void* stream) {
  constexpr int threads = 256;
  const long long total = rows * static_cast<long long>(nq + nk) * d2;
  rotary_qk_kernel<T><<<grid_for(total, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      static_cast<T*>(q_out), static_cast<T*>(k_out), rows, nq, nk, d2,
      sin_sign);
  return static_cast<int>(cudaGetLastError());
}

HETU_EXPORT int hetu_rotary_qk_f32(const void* q, const void* k,
                                   const void* cos_t, const void* sin_t,
                                   void* q_out, void* k_out, long long rows,
                                   int nq, int nk, int d2, float sin_sign,
                                   void* stream) {
  return launch<float>(q, k, cos_t, sin_t, q_out, k_out, rows, nq, nk, d2,
                       sin_sign, stream);
}

HETU_EXPORT int hetu_rotary_qk_bf16(const void* q, const void* k,
                                    const void* cos_t, const void* sin_t,
                                    void* q_out, void* k_out, long long rows,
                                    int nq, int nk, int d2, float sin_sign,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, cos_t, sin_t, q_out, k_out, rows, nq,
                               nk, d2, sin_sign, stream);
}
