// Fused AdamW update of a list of parameter leaves, in place, in one
// launch.
//
// Replaces hetu_tpu/ops/pallas/adam.py `_adam_kernel` / `adam_update`:
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g^2
//   p' = p - lr * ((m' / c1) / (sqrt(v' / c2) + eps) + wd * p)
// in fp32 (p fp32, bf16 or fp16, rounded once to nearest even, an fp16
// p past 65,504 to inf as astype(float16) does; g, m, v fp32).  lr and
// the bias corrections c1 = 1 - b1^step, c2 = 1 - b2^step arrive by value,
// computed on the host in fp32 as the JAX optimizer computes them in
// its graph; the decay sits inside the bracket on every leaf, as in
// the reference (not torch's decoupled p *= 1 - lr * wd).
//
// Bound on an H100 by bytes: 28 bytes per fp32 element (p, m, v read
// and written, g read) against ~15 flops.  Design:
//   * one launch takes a table of leaves (`AdamTable`, a
//     __grid_constant__ parameter of up to 32,764 bytes, CUDA 12.1+): the
//     TPU kernel is called once per leaf, and a model's hundreds of small
//     biases and gains would each cost a launch;
//   * the leaves are cut into chunks of ADAM_CHUNK elements; the host
//     writes each leaf's first chunk into the table (a prefix of chunk
//     counts), and a block finds a chunk's leaf by a binary search over
//     it; the grid holds as many blocks as the SMs keep resident at once,
//     and each block strides over the chunks;
//   * g, m and v (and an fp32 p) move as 16-byte float4 accesses, a bf16
//     or fp16 p as 4 x 16 bits (8 bytes), ADAM_UNROLL vectors in flight
//     a thread; a leaf whose pointers are not 16-byte aligned (a view)
//     and the tail of a leaf whose length is not a multiple of 4 take a
//     scalar path in the same kernel;
//   * it reads p, g, m and v once and writes p, m and v IN PLACE: where
//     the JAX package donates its old buffers to the jitted step, the
//     port updates the tensors it owns, so no second copy of the
//     optimizer state is ever allocated;
//   * `skip`, when set, points at an int on the device: nonzero makes the
//     launch write nothing (the dynamic loss scale's non-finite step, as
//     the reference's where(finite, new, old) keeps p, m and v), so the
//     host never reads the flag to decide whether to launch.
// _rn intrinsics keep the compiler from contracting into FMAs, matching
// the plain PyTorch version's rounding order.
#include "common.cuh"

using bf16 = __nv_bfloat16;

// The table's sizes; mirrored by ops/cuda/adam.py.
constexpr int ADAM_MAX_LEAVES = 512;
constexpr int ADAM_CHUNK = 16384;
constexpr int ADAM_THREADS = 256;
constexpr int ADAM_UNROLL = 4;

// One leaf: p (fp32, bf16 or fp16), g, m, v of n elements each.
// `aligned`: p, g, m and v all start on a 16-byte boundary (the vector
// path).
struct AdamLeaf {
  void* p;
  const float* g;
  float* m;
  float* v;
  long long n;
  int aligned;
  int pad;
};

// One launch's arguments; mirrored field for field by the ctypes
// Structure in ops/cuda/adam.py.  Leaf i owns chunks chunk_start[i] ..
// chunk_start[i + 1] - 1; chunk_start[leaves] is the launch's total.
struct AdamTable {
  float b1, one_minus_b1, b2, one_minus_b2, lr, c1, c2, eps, wd;
  int leaves;
  const int* skip;  // nullptr, or nonzero on the device: write nothing
  int chunk_start[ADAM_MAX_LEAVES + 1];
  AdamLeaf leaf[ADAM_MAX_LEAVES];
};
static_assert(sizeof(AdamTable) <= 32764, "kernel parameters past 32,764 B");

namespace {

struct Hyper {
  float b1, omb1, b2, omb2, lr, c1, c2, eps, wd;
};

__device__ __forceinline__ float adam_step(float pf, float gv, float& m,
                                           float& v, const Hyper& h) {
  const float mv = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gv));
  const float vv = __fadd_rn(__fmul_rn(h.b2, v),
                             __fmul_rn(h.omb2, __fmul_rn(gv, gv)));
  const float mhat = __fdiv_rn(mv, h.c1);
  const float vhat = __fdiv_rn(vv, h.c2);
  const float upd = __fadd_rn(
      __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)), __fmul_rn(h.wd, pf));
  m = mv;
  v = vv;
  return __fsub_rn(pf, __fmul_rn(h.lr, upd));
}

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
__device__ __forceinline__ void load4(const __half* p, float (&x)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&v.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&v.y));
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&x)[4]) {
  // round to nearest even, as __float2bfloat16 and torch's .to() do
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}
__device__ __forceinline__ void store4(__half* p, const float (&x)[4]) {
  // round to nearest even (inf past 65,504), as __float2half_rn, torch's
  // .to() and astype(float16) do
  const __half2 lo = __floats2half2_rn(x[0], x[1]);
  const __half2 hi = __floats2half2_rn(x[2], x[3]);
  uint2 v;
  v.x = *reinterpret_cast<const unsigned*>(&lo);
  v.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = v;
}

template <typename P>
__global__ void __launch_bounds__(ADAM_THREADS)
adam_multi_kernel(const __grid_constant__ AdamTable t) {
  if (t.skip != nullptr && *t.skip != 0) return;
  const Hyper h{t.b1, t.one_minus_b1, t.b2, t.one_minus_b2, t.lr,
                t.c1, t.c2, t.eps, t.wd};
  const int chunks = t.chunk_start[t.leaves];
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    // the chunk's leaf: the last i with chunk_start[i] <= c
    int lo = 0, hi = t.leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
    }
    const AdamLeaf& leaf = t.leaf[lo];
    P* p = static_cast<P*>(leaf.p);
    const float* g = leaf.g;
    float* m = leaf.m;
    float* v = leaf.v;
    const long long c0 =
        static_cast<long long>(c - t.chunk_start[lo]) * ADAM_CHUNK;
    const long long c1 = min(c0 + ADAM_CHUNK, leaf.n);
    long long scalar_from = c0;
    if (leaf.aligned) {
      // vectors c0 / 4 .. c1 / 4 - 1 (c0 is a multiple of 4)
      const long long v_end = c1 >> 2;
      for (long long base = (c0 >> 2) + threadIdx.x; base < v_end;
           base += ADAM_THREADS * ADAM_UNROLL) {
        float pv[ADAM_UNROLL][4], gv[ADAM_UNROLL][4], mv[ADAM_UNROLL][4],
            vv[ADAM_UNROLL][4];
#pragma unroll
        for (int u = 0; u < ADAM_UNROLL; ++u) {
          const long long j = base + u * ADAM_THREADS, i = j << 2;
          if (j < v_end) {
            load4(g + i, gv[u]);
            load4(m + i, mv[u]);
            load4(v + i, vv[u]);
            load4(p + i, pv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < ADAM_UNROLL; ++u) {
          const long long j = base + u * ADAM_THREADS, i = j << 2;
          if (j < v_end) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              pv[u][e] = adam_step(pv[u][e], gv[u][e], mv[u][e], vv[u][e], h);
            store4(p + i, pv[u]);
            store4(m + i, mv[u]);
            store4(v + i, vv[u]);
          }
        }
      }
      scalar_from = v_end << 2;
    }
    // an unaligned leaf, or the last (n % 4) elements of an aligned one
    for (long long i = scalar_from + threadIdx.x; i < c1; i += ADAM_THREADS) {
      float mi = m[i], vi = v[i];
      p[i] = from_f32<P>(adam_step(to_f32(p[i]), g[i], mi, vi, h));
      m[i] = mi;
      v[i] = vi;
    }
  }
}

// Blocks of the kernel that the card keeps resident at once: the grid
// fills the SMs and no more (each block strides over the chunks).
template <typename P>
int resident_blocks() {
  static const int blocks = wave_blocks(adam_multi_kernel<P>, ADAM_THREADS);
  return blocks;
}

template <typename P>
int launch(const AdamTable* t, void* stream) {
  const int chunks = t->chunk_start[t->leaves];
  if (t->leaves < 1 || t->leaves > ADAM_MAX_LEAVES || chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = min(chunks, resident_blocks<P>());
  adam_multi_kernel<P><<<grid, ADAM_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(*t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

HETU_EXPORT int hetu_adam_multi_f32(const AdamTable* t, void* stream) {
  return launch<float>(t, stream);
}

HETU_EXPORT int hetu_adam_multi_bf16(const AdamTable* t, void* stream) {
  return launch<bf16>(t, stream);
}

HETU_EXPORT int hetu_adam_multi_f16(const AdamTable* t, void* stream) {
  return launch<__half>(t, stream);
}
