// Fused rotary embedding: RoPE applied to q AND k in one launch.
//
// Replaces hetu_tpu/ops/pallas/rotary.py `_kernel` / `_apply` /
// `fused_rotary_qk`, forward and backward (`_rotary_bwd`).  q (nq heads)
// and k (nk heads) of b x s token rows rotate by the pre-gathered fp32
// tables cos_t / sin_t [b * s, hd/2] with the half-split rotation
//   out[i]      = x[i] * cos - x[i + hd/2] * sin
//   out[i+hd/2] = x[i + hd/2] * cos + x[i] * sin
// in fp32, rounded once.  The rotation is orthogonal, so its backward
// is the same kernel rotating the cotangents by -theta: `sin_sign` is
// +1 forward and -1 backward and multiplies each sin value (exactly),
// so the backward needs no negated copy of the table.  _rn intrinsics
// keep the plain PyTorch version's rounding order.
//
// Bound on an H100 by bytes (each element is read and written once, six
// flops per pair).  Design:
//   * q and k are read in place through their strides: q as [b, s,
//     n_kv, group, hd] (q head h at (h / group, h % group): the grouped
//     slice of the fused QKV projection, or group 1 for a plain [b, s,
//     nq, hd]), k as [b, s, nk, hd]; the head dim has unit stride.  The
//     outputs are contiguous [b, s, nq, hd] and [b, s, nk, hd];
//   * a block takes a token row at a time (grid-stride over rows) and
//     one slice of its heads: grid.y slices of ~64 threads, so that a
//     decode step's few rows still spread over the SMs and a training
//     step's thousands pack them evenly.  A thread owns VEC pairs (a
//     column chunk) of one head; its head's place in q or k and its
//     offsets are worked out once, not per element, and are 32-bit
//     where every one fits.  A row's cos and sin come from device
//     memory once: the slices' other reads of them hit in L1 / L2;
//   * each thread moves 16-byte vectors: x[i : i+VEC] and x[i+hd/2 :
//     i+hd/2+VEC] in, the same two out (VEC = 8 bf16 or fp16, 4 fp32
//     pairs).  A half head dim that is not a multiple of VEC, or a
//     base or stride off a 16-byte boundary, takes the scalar arm: the
//     same kernel on one pair a chunk, the same instructions per
//     element, so both arms give the same bits.
#include "common.cuh"

// A block's threads: at least this many, a whole number of heads.
constexpr int ROT_THREADS = 64;

// The shapes and element strides a launch reads; I is int where every
// offset fits, else long long.
template <typename I>
struct RotaryShape {
  int seq, nq, nk, group, d2;
  I q_sb, q_ss, q_sh, q_sg;  // q: batch, seq, kv head, group
  I k_sb, k_ss, k_sh;        // k: batch, seq, head
  float sin_sign;
};

template <typename T, int VEC, typename I>
__global__ void rotary_qk_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const float* __restrict__ cos_t,
                                 const float* __restrict__ sin_t,
                                 T* __restrict__ q_out, T* __restrict__ k_out,
                                 int rows, const RotaryShape<I> sh) {
  using V = Vec<T, VEC>;
  constexpr int FV = VEC < 4 ? VEC : 4;  // fp32 table values an access
  using F = Vec<float, FV>;
  const int d2 = sh.d2, hd = 2 * d2;
  const int chunks = d2 / VEC;
  const int hp = blockDim.x / chunks;  // heads a block (blockDim = hp chunks)
  const int slot = threadIdx.x / chunks;
  const int i = (threadIdx.x - slot * chunks) * VEC;
  const int h = blockIdx.y * hp + slot;
  if (h >= sh.nq + sh.nk) return;
  // the thread's head in each row: q head h at (h / group, h % group) of
  // the grouped view, else k head h - nq
  const bool is_q = h < sh.nq;
  const I src_off = is_q ? (h / sh.group) * sh.q_sh + (h % sh.group) * sh.q_sg
                         : (h - sh.nq) * sh.k_sh;
  const I sb = is_q ? sh.q_sb : sh.k_sb, ss = is_q ? sh.q_ss : sh.k_ss;
  const T* base = is_q ? q : k;
  T* out = is_q ? q_out : k_out;
  const I out_row = static_cast<I>(is_q ? sh.nq : sh.nk) * hd;
  const I out_off = (is_q ? h : h - sh.nq) * hd + i;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const int bi = r / sh.seq, si = r - bi * sh.seq;
    const T* src = base + (bi * sb + si * ss + src_off + i);
    T* dst = out + (r * out_row + out_off);
    const I t = static_cast<I>(r) * d2 + i;
    const V x1 = *reinterpret_cast<const V*>(src);
    const V x2 = *reinterpret_cast<const V*>(src + d2);
    float c[VEC], s[VEC];
#pragma unroll
    for (int j = 0; j < VEC / FV; ++j) {
      const F cv = *reinterpret_cast<const F*>(cos_t + t + j * FV);
      const F sv = *reinterpret_cast<const F*>(sin_t + t + j * FV);
#pragma unroll
      for (int e = 0; e < FV; ++e) {
        c[j * FV + e] = cv.v[e];
        s[j * FV + e] = sh.sin_sign * sv.v[e];
      }
    }
    V y1, y2;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float a = to_f32(x1.v[e]), b = to_f32(x2.v[e]);
      y1.v[e] = from_f32<T>(__fsub_rn(__fmul_rn(a, c[e]),
                                      __fmul_rn(b, s[e])));
      y2.v[e] = from_f32<T>(__fadd_rn(__fmul_rn(b, c[e]),
                                      __fmul_rn(a, s[e])));
    }
    *reinterpret_cast<V*>(dst) = y1;
    *reinterpret_cast<V*>(dst + d2) = y2;
  }
}

// The launch's arguments as the host holds them.
struct RotaryCall {
  const void *q, *k, *cos_t, *sin_t;
  void *q_out, *k_out;
  int rows;
  RotaryShape<long long> sh;
};

template <typename T, int VEC, typename I>
static int launch_arm(const RotaryCall& a, cudaStream_t stream) {
  const RotaryShape<long long>& w = a.sh;
  const int chunks = w.d2 / VEC, nh = w.nq + w.nk;
  if (chunks > 1024) return static_cast<int>(cudaErrorInvalidValue);
  // small blocks: the slices of a row's heads fill the SMs even for a
  // decode step's few rows, and pack them evenly for a training step's
  // thousands; a thread rotates one head of each row it visits
  const int min_heads = (ROT_THREADS + chunks - 1) / chunks;
  const int slices = (nh + min_heads - 1) / min_heads;
  const int hp = (nh + slices - 1) / slices;
  const RotaryShape<I> sh{w.seq, w.nq, w.nk, w.group, w.d2,
                          static_cast<I>(w.q_sb), static_cast<I>(w.q_ss),
                          static_cast<I>(w.q_sh), static_cast<I>(w.q_sg),
                          static_cast<I>(w.k_sb), static_cast<I>(w.k_ss),
                          static_cast<I>(w.k_sh), w.sin_sign};
  const dim3 grid(grid_for(a.rows, 1, 1LL << 30), slices);
  rotary_qk_kernel<T, VEC, I><<<grid, hp * chunks, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const float*>(a.cos_t), static_cast<const float*>(a.sin_t),
      static_cast<T*>(a.q_out), static_cast<T*>(a.k_out), a.rows, sh);
  return static_cast<int>(cudaGetLastError());
}

// 32-bit offsets where the farthest element of q, k and the outputs
// lies within 2^31 of its base.
template <typename T, int VEC>
static int launch_fits(const RotaryCall& a, long long batch,
                       cudaStream_t stream) {
  const RotaryShape<long long>& w = a.sh;
  const long long hd = 2LL * w.d2, rows = a.rows;
  const long long reach_q = (batch - 1) * w.q_sb + (w.seq - 1) * w.q_ss +
                            (w.nq / w.group - 1) * w.q_sh +
                            (w.group - 1) * w.q_sg + hd;
  const long long reach_k = (batch - 1) * w.k_sb + (w.seq - 1) * w.k_ss +
                            (w.nk - 1) * w.k_sh + hd;
  const long long outs = rows * (w.nq > w.nk ? w.nq : w.nk) * hd;
  const long long most =
      reach_q > reach_k ? (reach_q > outs ? reach_q : outs)
                        : (reach_k > outs ? reach_k : outs);
  if (most < (1LL << 31)) return launch_arm<T, VEC, int>(a, stream);
  return launch_arm<T, VEC, long long>(a, stream);
}

template <typename T>
static int launch(const void* q, const void* k, const void* cos_t,
                  const void* sin_t, void* q_out, void* k_out, long long batch,
                  long long seq, int nq, int nk, int group, int d2,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long q_sg, long long k_sb, long long k_ss,
                  long long k_sh, float sin_sign, void* stream) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr long long B = sizeof(T);
  if (batch * seq == 0 || batch * seq >= (1LL << 31) || group < 1 ||
      nq % group || q_sb < 0 || q_ss < 0 || q_sh < 0 || q_sg < 0 ||
      k_sb < 0 || k_ss < 0 || k_sh < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const RotaryCall a{q, k, cos_t, sin_t, q_out, k_out,
                     static_cast<int>(batch * seq),
                     {static_cast<int>(seq), nq, nk, group, d2, q_sb, q_ss,
                      q_sh, q_sg, k_sb, k_ss, k_sh, sin_sign}};
  bool vec = d2 % VEC == 0 && aligned16({q, k, cos_t, sin_t, q_out, k_out});
  for (long long st : {q_sb, q_ss, q_sh, q_sg, k_sb, k_ss, k_sh})
    vec = vec && (st * B) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_fits<T, VEC>(a, batch, s);
  return launch_fits<T, 1>(a, batch, s);
}

HETU_EXPORT int hetu_rotary_qk_f32(
    const void* q, const void* k, const void* cos_t, const void* sin_t,
    void* q_out, void* k_out, long long batch, long long seq, int nq, int nk,
    int group, int d2, long long q_sb, long long q_ss, long long q_sh,
    long long q_sg, long long k_sb, long long k_ss, long long k_sh,
    float sin_sign, void* stream) {
  return launch<float>(q, k, cos_t, sin_t, q_out, k_out, batch, seq, nq, nk,
                       group, d2, q_sb, q_ss, q_sh, q_sg, k_sb, k_ss, k_sh,
                       sin_sign, stream);
}

HETU_EXPORT int hetu_rotary_qk_bf16(
    const void* q, const void* k, const void* cos_t, const void* sin_t,
    void* q_out, void* k_out, long long batch, long long seq, int nq, int nk,
    int group, int d2, long long q_sb, long long q_ss, long long q_sh,
    long long q_sg, long long k_sb, long long k_ss, long long k_sh,
    float sin_sign, void* stream) {
  return launch<__nv_bfloat16>(q, k, cos_t, sin_t, q_out, k_out, batch, seq,
                               nq, nk, group, d2, q_sb, q_ss, q_sh, q_sg,
                               k_sb, k_ss, k_sh, sin_sign, stream);
}

HETU_EXPORT int hetu_rotary_qk_f16(
    const void* q, const void* k, const void* cos_t, const void* sin_t,
    void* q_out, void* k_out, long long batch, long long seq, int nq, int nk,
    int group, int d2, long long q_sb, long long q_ss, long long q_sh,
    long long q_sg, long long k_sb, long long k_ss, long long k_sh,
    float sin_sign, void* stream) {
  return launch<__half>(q, k, cos_t, sin_t, q_out, k_out, batch, seq, nq, nk,
                        group, d2, q_sb, q_ss, q_sh, q_sg, k_sb, k_ss, k_sh,
                        sin_sign, stream);
}
