// Flash attention, forward and backward, for one card.
//
// Replaces hetu_tpu/ops/pallas/flash_attention.py: `_fwd_kernel` / `_fwd`
// (forward, o and lse), `_bwd_dq_kernel` and `_bwd_dkv_kernel` / `_bwd`
// (backward).  Three kernels:
//
//   flash_fwd_kernel      a block owns one 64-row q tile of one (batch,
//                         q head) and walks that row's live k tiles itself,
//                         carrying the running max m, the sum l and the
//                         output accumulator in registers (the Pallas grid's
//                         sequential third axis and its VMEM scratch);
//   flash_bwd_dq_kernel   the same walk, recomputing S and dP from the saved
//                         lse and delta = rowsum(do * o), accumulating dq;
//   flash_bwd_dkv_kernel  a block owns one 64-row k tile of one (batch, kv
//                         head) and walks the q tiles of every q head of that
//                         kv head's group, so dk and dv are summed over the
//                         group in registers: no atomics, no per-q-head
//                         buffer, and two runs give the same bits.
//
// What bounds them on an H100: operations.  At the training shape (2 x 32
// heads x 2048 x 128, causal) the forward is 2 products, 68.75 GFLOP, over
// 84 MB of q, k, v, o: about 800 operations a byte, far above the card's
// balance; the dq kernel is 3 products, the dk/dv kernel 4 (both recompute
// S and dP, as the TPU kernels do).  What the design does about it: scores
// never touch device memory (a tile of S, P and dS lives in registers or
// shared memory), the 16-bit arms run on the tensor cores, K and V are read
// through the kv head's stride (no materialised GQA repeat), and dead tiles
// of the block mask are skipped before anything is loaded.
//
// The block mask is semantics, not only a schedule: `live` is the caller's
// [nq][nk] grid in units of (block_q, block_k); a dead API block is never
// computed, whatever its positions and segments say.  The kernels' own
// tile is 64 x 64; an API block holds ceil(block / 64) tiles, the last one
// ragged, so any block size works.  Inside a live tile the mask is by
// explicit global positions (q_pos >= k_pos) and segment ids (equal).  A
// row that sees nothing gives p = 0 (never exp(0) = 1): o = 0, lse = -1e30,
// and zero gradients.
//
// Arithmetic: three arms, the same three kernels in each.
//
// fp32 inputs (first half of this file): every product in fp32 FMAs on
// the CUDA cores, so the card agrees with the plain PyTorch version to
// fp32 rounding (the narrow card-vs-CPU training check rests on this).
// 256 threads as 16 x 16; thread (ty, tx) owns rows 4*ty .. 4*ty+3 and
// columns tx, tx+16, tx+32, tx+48 of a 64 x 64 score tile, and the same
// rows x columns 4*tx .. 4*tx+3 (+64) of a [64, D] accumulator.  Row
// reductions are shuffles over the 16 lanes of a half warp.  Tiles are
// staged with a row stride of D + 4 floats, which keeps the float4 reads
// of both access patterns free of bank conflicts; P and dS pass through
// shared memory once.
//
// bf16 and fp16 inputs (second half): every product runs on the tensor
// cores with fp32 accumulators; the softmax, lse, delta and all sums stay
// fp32, and P and dS are rounded once to the inputs' type as the next
// product's operand (as FlashAttention-2 does; the TPU kernel keeps them
// fp32).  o is rounded once to that type on the way out; dq, dk, dv leave
// in fp32 in every arm.  The two 16-bit arms are one set of kernels,
// templated on the element type T (`__nv_bfloat16` or `__half`): the
// tile layout, the wgmma shapes and descriptors depend on its size alone,
// and only the operand type of the products and the one rounding of P,
// dS and o differ.  In fp16 P lies in [0, 1] and rounds 8x finer than in
// bf16; dS = P (dP - delta) can pass fp16's 65504 under a large loss
// scale, and then rounds to inf, which the trainer's finite check sees,
// as it sees the plain version's inf where dq, dk and dv are cast to
// fp16.
//
// The three 16-bit kernels are built for Hopper (the section "16-bit:
// Hopper" below): a producer warpgroup streams K/V (dk/dv: Q/dO) tiles
// through a ring of shared-memory slots with cp.async and mbarriers,
// consumer warpgroups of 64 rows (three a block in the forward, two in dq
// and dk/dv) run wgmma.mma_async with both operands of S (and dP) in
// shared memory and P / dS as the register operand of the next product,
// a pair of tiles that the causal mask empties is not computed and a full
// one skips the element mask, and the softmax runs in exp2 with the scale
// folded in.

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 64;
constexpr int THREADS = 256;
constexpr int LDP = TILE + 4;  // row stride of a staged P / dS tile

}  // namespace

// One launch's arguments; mirrored field for field by the ctypes
// Structure in ops/cuda/flash_attention.py.  q, k, v, o, dout and the
// gradients are [b, h, s, d] through their strides (in elements; d has
// stride 1); lse and delta are contiguous [b, hq, sq].
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  const void* dout;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  const int* q_pos;
  const int* k_pos;
  const int* q_seg;  // null: no segment mask
  const int* k_seg;
  const unsigned char* live;  // [nq][nk]
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  long long qpos_sb, kpos_sb, qseg_sb, kseg_sb;
  int b, hq, hkv, sq, sk;
  int block_q, block_k, nq, nk;
  int causal;
  float scale;
};

namespace {

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Stage `rows` rows of a [*, D] fp32 operand (row stride `stride`
// elements) into dst [TILE][D + 4]; rows past `rows` are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int rows) {
  constexpr int VEC = D / 4;
  for (int i = threadIdx.x; i < TILE * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) val = load4(src + r * stride + c);
    store4(dst + r * ld<D>() + c, val);
  }
}

// Stage `rows` ints (positions or segment ids); null src or rows past
// `rows` give 0.
__device__ __forceinline__ void stage_ints(int* dst, const int* src,
                                           int rows) {
  if (threadIdx.x < TILE)
    dst[threadIdx.x] = (src != nullptr && threadIdx.x < rows)
                           ? src[threadIdx.x] : 0;
}

// acc[i][j] += sum_d A[4*ty + i][d] * B[tx + 16*j][d]
template <int D>
__device__ __forceinline__ void dot_abt(const float* A, const float* B,
                                        float (&acc)[4][4]) {
  const int tx = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (r0 + i) * ld<D>() + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(B + (tx + 16 * j) * ld<D>() + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
      }
  }
}

// acc[i][4*jj + c] += sum_k P[4*ty + i][k] * B[k][4*tx + 64*jj + c]
template <int D>
__device__ __forceinline__ void dot_pb(const float* P, const float* B,
                                       float (&acc)[4][D / 16]) {
  const int tx = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
#pragma unroll 2
  for (int k = 0; k < TILE; k += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 pv = load4(P + (r0 + i) * LDP + k);
      p[i][0] = pv.x; p[i][1] = pv.y; p[i][2] = pv.z; p[i][3] = pv.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int jj = 0; jj < D / 64; ++jj) {
        const float4 bv = load4(B + (k + u) * ld<D>() + 4 * tx + 64 * jj);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * jj + 0] = fmaf(p[i][u], bv.x, acc[i][4 * jj + 0]);
          acc[i][4 * jj + 1] = fmaf(p[i][u], bv.y, acc[i][4 * jj + 1]);
          acc[i][4 * jj + 2] = fmaf(p[i][u], bv.z, acc[i][4 * jj + 2]);
          acc[i][4 * jj + 3] = fmaf(p[i][u], bv.w, acc[i][4 * jj + 3]);
        }
      }
  }
}

// Reduce over the 16 lanes that share a row group (a half warp).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The kernels' tile `t` along one side: the API block it lies in, its
// first row and how many of its 64 rows exist.
struct TileAt {
  int block, row0, rows;
};
__device__ __forceinline__ TileAt tile_at(int t, int block_size) {
  const int per = (block_size + TILE - 1) / TILE;
  TileAt at;
  at.block = t / per;
  const int sub = t % per;
  at.row0 = at.block * block_size + sub * TILE;
  at.rows = min(TILE, block_size - sub * TILE);
  return at;
}

// Dynamic shared memory, in floats: `tiles` staged [TILE][D + 4] operands,
// `ptiles` [TILE][LDP] score tiles, 4 int rows (positions, segments) and
// 2 float rows (lse, delta).
template <int D>
constexpr size_t smem_bytes(int tiles, int ptiles) {
  return sizeof(float) * (static_cast<size_t>(tiles) * TILE * ld<D>() +
                          static_cast<size_t>(ptiles) * TILE * LDP +
                          6 * TILE);
}

// ------------------------------------------------------------------ forward
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + TILE * ld<D>();
  float* Vs = Ks + TILE * ld<D>();
  float* Ps = Vs + TILE * ld<D>();
  int* qpos = reinterpret_cast<int*>(Ps + TILE * LDP);
  int* qseg = qpos + TILE;
  int* kpos = qseg + TILE;
  int* kseg = kpos + TILE;

  const int tx = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
  // heavy (late, causal) rows first
  const TileAt qt = tile_at(gridDim.x - 1 - blockIdx.x, a.block_q);
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const bool use_seg = a.q_seg != nullptr;
  const int per_k = (a.block_k + TILE - 1) / TILE;

  stage<D>(Qs, static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh +
                      qt.row0 * a.q_ss, a.q_ss, qt.rows);
  stage_ints(qpos, a.q_pos + bi * a.qpos_sb + qt.row0, qt.rows);
  stage_ints(qseg, use_seg ? a.q_seg + bi * a.qseg_sb + qt.row0 : nullptr,
             qt.rows);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  const float* kbase = static_cast<const float*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const float* vbase = static_cast<const float*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  for (int kb = 0; kb < a.nk; ++kb) {
    if (!a.live[qt.block * a.nk + kb]) continue;
    for (int sub = 0; sub < per_k; ++sub) {
      const TileAt kt = tile_at(kb * per_k + sub, a.block_k);
      __syncthreads();  // the last tile's reads are done
      stage<D>(Ks, kbase + kt.row0 * a.k_ss, a.k_ss, kt.rows);
      stage<D>(Vs, vbase + kt.row0 * a.v_ss, a.v_ss, kt.rows);
      stage_ints(kpos, a.k_pos + bi * a.kpos_sb + kt.row0, kt.rows);
      stage_ints(kseg, use_seg ? a.k_seg + bi * a.kseg_sb + kt.row0 : nullptr,
                 kt.rows);
      __syncthreads();

      float s[4][4] = {};
      dot_abt<D>(Qs, Ks, s);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i;
        float m_cur = NEG_INF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          bool ok = col < kt.rows;
          if (a.causal) ok = ok && qpos[row] >= kpos[col];
          if (use_seg) ok = ok && qseg[row] == kseg[col];
          s[i][j] = ok ? s[i][j] * a.scale : NEG_INF;
          m_cur = fmaxf(m_cur, s[i][j]);
        }
        m_cur = half_warp_max(m_cur);
        const float m_new = fmaxf(m[i], m_cur);
        // a row that has seen nothing yet: exp(s - m_new) would be 1;
        // shift the reference point so p underflows to 0
        const float m_exp = m_new <= NEG_INF / 2 ? 0.f : m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[i][j] - m_exp);
          sum += p;
          Ps[row * LDP + tx + 16 * j] = p;
        }
        sum = half_warp_sum(sum);
        const float corr = expf(m[i] - m_new);
        l[i] = l[i] * corr + sum;
        m[i] = m_new;
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[i][c] *= corr;
      }
      __syncthreads();
      dot_pb<D>(Ps, Vs, acc);
    }
  }

  float* obase = static_cast<float*>(a.o) + bi * a.o_sb + h * a.o_sh;
  float* lse = a.lse + (static_cast<long long>(bi) * a.hq + h) * a.sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + i;
    if (row >= qt.rows) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      store4(obase + (qt.row0 + row) * a.o_ss + 4 * tx + 64 * jj,
             make_float4(acc[i][4 * jj] * inv, acc[i][4 * jj + 1] * inv,
                         acc[i][4 * jj + 2] * inv, acc[i][4 * jj + 3] * inv));
    if (tx == 0)
      lse[qt.row0 + row] = l[i] == 0.f ? NEG_INF : m[i] + logf(l_safe);
  }
}

// ------------------------------------------------------------- backward: dq
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE * ld<D>();
  float* Ks = dOs + TILE * ld<D>();
  float* Vs = Ks + TILE * ld<D>();
  float* dSs = Vs + TILE * ld<D>();
  int* qpos = reinterpret_cast<int*>(dSs + TILE * LDP);
  int* qseg = qpos + TILE;
  int* kpos = qseg + TILE;
  int* kseg = kpos + TILE;

  const int tx = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
  const TileAt qt = tile_at(gridDim.x - 1 - blockIdx.x, a.block_q);
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const bool use_seg = a.q_seg != nullptr;
  const int per_k = (a.block_k + TILE - 1) / TILE;

  stage<D>(Qs, static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh +
                      qt.row0 * a.q_ss, a.q_ss, qt.rows);
  stage<D>(dOs, static_cast<const float*>(a.dout) + bi * a.do_sb +
                       h * a.do_sh + qt.row0 * a.do_ss, a.do_ss, qt.rows);
  stage_ints(qpos, a.q_pos + bi * a.qpos_sb + qt.row0, qt.rows);
  stage_ints(qseg, use_seg ? a.q_seg + bi * a.qseg_sb + qt.row0 : nullptr,
             qt.rows);

  const long long stat = (static_cast<long long>(bi) * a.hq + h) * a.sq +
                         qt.row0;
  float lse[4], delta[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = r0 + i < qt.rows;
    const float x = in ? a.lse[stat + r0 + i] : 0.f;
    lse[i] = x <= NEG_INF / 2 ? 0.f : x;  // a row that saw nothing
    delta[i] = in ? a.delta[stat + r0 + i] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  const float* kbase = static_cast<const float*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const float* vbase = static_cast<const float*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  for (int kb = 0; kb < a.nk; ++kb) {
    if (!a.live[qt.block * a.nk + kb]) continue;
    for (int sub = 0; sub < per_k; ++sub) {
      const TileAt kt = tile_at(kb * per_k + sub, a.block_k);
      __syncthreads();
      stage<D>(Ks, kbase + kt.row0 * a.k_ss, a.k_ss, kt.rows);
      stage<D>(Vs, vbase + kt.row0 * a.v_ss, a.v_ss, kt.rows);
      stage_ints(kpos, a.k_pos + bi * a.kpos_sb + kt.row0, kt.rows);
      stage_ints(kseg, use_seg ? a.k_seg + bi * a.kseg_sb + kt.row0 : nullptr,
                 kt.rows);
      __syncthreads();

      float s[4][4] = {}, dp[4][4] = {};
      dot_abt<D>(Qs, Ks, s);
      dot_abt<D>(dOs, Vs, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          bool ok = col < kt.rows;
          if (a.causal) ok = ok && qpos[row] >= kpos[col];
          if (use_seg) ok = ok && qseg[row] == kseg[col];
          const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
          dSs[row * LDP + col] = p * (dp[i][j] - delta[i]);
        }
      }
      __syncthreads();
      dot_pb<D>(dSs, Ks, acc);
    }
  }

  float* dq = a.dq + bi * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + i;
    if (row >= qt.rows) continue;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj)
      store4(dq + (qt.row0 + row) * a.dq_ss + 4 * tx + 64 * jj,
             make_float4(acc[i][4 * jj] * a.scale,
                         acc[i][4 * jj + 1] * a.scale,
                         acc[i][4 * jj + 2] * a.scale,
                         acc[i][4 * jj + 3] * a.scale));
  }
}

// --------------------------------------------------------- backward: dk, dv
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE * ld<D>();
  float* Qs = Vs + TILE * ld<D>();
  float* dOs = Qs + TILE * ld<D>();
  float* Pt = dOs + TILE * ld<D>();   // P transposed: [k row][q column]
  float* dSt = Pt + TILE * LDP;
  int* qpos = reinterpret_cast<int*>(dSt + TILE * LDP);
  int* qseg = qpos + TILE;
  int* kpos = qseg + TILE;
  int* kseg = kpos + TILE;
  float* lse = reinterpret_cast<float*>(kseg + TILE);
  float* delta = lse + TILE;

  const int tx = threadIdx.x & 15, r0 = (threadIdx.x >> 4) * 4;
  // light (late, causal) k tiles last
  const TileAt kt = tile_at(blockIdx.x, a.block_k);
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int group = a.hq / a.hkv;
  const bool use_seg = a.q_seg != nullptr;
  const int per_q = (a.block_q + TILE - 1) / TILE;

  stage<D>(Ks, static_cast<const float*>(a.k) + bi * a.k_sb + hk * a.k_sh +
                      kt.row0 * a.k_ss, a.k_ss, kt.rows);
  stage<D>(Vs, static_cast<const float*>(a.v) + bi * a.v_sb + hk * a.v_sh +
                      kt.row0 * a.v_ss, a.v_ss, kt.rows);
  stage_ints(kpos, a.k_pos + bi * a.kpos_sb + kt.row0, kt.rows);
  stage_ints(kseg, use_seg ? a.k_seg + bi * a.kseg_sb + kt.row0 : nullptr,
             kt.rows);

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* qbase = static_cast<const float*>(a.q) + bi * a.q_sb + h * a.q_sh;
    const float* dobase =
        static_cast<const float*>(a.dout) + bi * a.do_sb + h * a.do_sh;
    const long long stat = (static_cast<long long>(bi) * a.hq + h) * a.sq;
    for (int qb = 0; qb < a.nq; ++qb) {
      if (!a.live[qb * a.nk + kt.block]) continue;
      for (int sub = 0; sub < per_q; ++sub) {
        const TileAt qt = tile_at(qb * per_q + sub, a.block_q);
        __syncthreads();
        stage<D>(Qs, qbase + qt.row0 * a.q_ss, a.q_ss, qt.rows);
        stage<D>(dOs, dobase + qt.row0 * a.do_ss, a.do_ss, qt.rows);
        stage_ints(qpos, a.q_pos + bi * a.qpos_sb + qt.row0, qt.rows);
        stage_ints(qseg,
                   use_seg ? a.q_seg + bi * a.qseg_sb + qt.row0 : nullptr,
                   qt.rows);
        if (threadIdx.x < TILE) {
          const bool in = threadIdx.x < qt.rows;
          const float x = in ? a.lse[stat + qt.row0 + threadIdx.x] : 0.f;
          lse[threadIdx.x] = x <= NEG_INF / 2 ? 0.f : x;
          delta[threadIdx.x] =
              in ? a.delta[stat + qt.row0 + threadIdx.x] : 0.f;
        }
        __syncthreads();

        // st[i][j]: k row r0 + i against q column tx + 16 j
        float st[4][4] = {}, dpt[4][4] = {};
        dot_abt<D>(Ks, Qs, st);
        dot_abt<D>(Vs, dOs, dpt);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int krow = r0 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int qcol = tx + 16 * j;
            bool ok = krow < kt.rows && qcol < qt.rows;
            if (a.causal) ok = ok && qpos[qcol] >= kpos[krow];
            if (use_seg) ok = ok && qseg[qcol] == kseg[krow];
            const float p =
                ok ? expf(st[i][j] * a.scale - lse[qcol]) : 0.f;
            Pt[krow * LDP + qcol] = p;
            dSt[krow * LDP + qcol] = p * (dpt[i][j] - delta[qcol]);
          }
        }
        __syncthreads();
        dot_pb<D>(Pt, dOs, dv);
        dot_pb<D>(dSt, Qs, dk);
      }
    }
  }

  float* dkp = a.dk + bi * a.dk_sb + hk * a.dk_sh;
  float* dvp = a.dv + bi * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + i;
    if (row >= kt.rows) continue;
#pragma unroll
    for (int jj = 0; jj < D / 64; ++jj) {
      store4(dkp + (kt.row0 + row) * a.dk_ss + 4 * tx + 64 * jj,
             make_float4(dk[i][4 * jj] * a.scale, dk[i][4 * jj + 1] * a.scale,
                         dk[i][4 * jj + 2] * a.scale,
                         dk[i][4 * jj + 3] * a.scale));
      store4(dvp + (kt.row0 + row) * a.dv_ss + 4 * tx + 64 * jj,
             make_float4(dv[i][4 * jj], dv[i][4 * jj + 1], dv[i][4 * jj + 2],
                         dv[i][4 * jj + 3]));
    }
  }
}

// ================================================== 16-bit: Hopper
//
// The three 16-bit kernels (T = __nv_bfloat16 or __half) are built for
// Hopper (sm_90a).  Block: NC
// consumer warpgroups (1 or 3 in the forward, 1 or 2 in dq and in
// dk/dv) and one producer warpgroup, the last.  A consumer warpgroup
// owns one 64-row tile of the block's side (q in the forward and dq, k
// in dk/dv; `tile_at`'s mapping, ragged last tile and all), so a block
// of two covers 128 rows.  The producer loads the block's own tiles once
// (Q; Q and dO; K and V) and streams the other side's tiles (K, V and
// their positions in the forward and dq; Q, dO, lse, delta and positions
// in dk/dv) through a ring of STAGES slots in shared memory with
// cp.async 16-byte copies, which write the 128-byte swizzled layout
// (`hopper.cuh`) and zero rows past a tile's end, so nothing past an API
// block is ever read.  Each copy arrives on the slot's `full` mbarrier
// when it lands, and producer warp 0 adds the streamed tile's position
// (and segment) range; every consumer warp arrives on the slot's `empty`
// mbarrier when its products are done, and the producer refills the
// slot.  Consumers stage nothing through their registers.  The ring
// takes as many slots as shared memory holds, up to 8 (4 to 8 here).
//
// The ring carries the streamed tiles that are live for at least one of
// the block's warpgroups; a warpgroup computes only those live for its
// own API block and passes over the others (a tile dead for both is
// never loaded; one dead for this warpgroup is never computed here,
// whatever it holds).
//
// Products, on wgmma.mma_async with fp32 accumulators: S = Q K^T
// (forward, dq), dP = dO V^T (dq), S^T = K Q^T and dP^T = V dO^T (dk/dv)
// take both operands K-major from shared memory; P, dS, P^T and dS^T are
// rounded once to T in registers (`to_fragments`: the accumulators of
// two neighbouring 8-column tiles are exactly one A fragment) and are the
// register A operand of O += P V, dQ += dS K, dV += P^T dO and
// dK += dS^T Q, whose B operand is read MN-major from the same tile.
//
// Tile classes (`tile_classes` in ops/cuda/flash_attention.py is the same
// rule in PyTorch): a (q tile, k tile) pair is dead when its API block
// is; where both tiles have all 64 rows and the mask is causal, empty
// when max(q_pos of the q tile) < min(k_pos of the k tile), full when
// min(q_pos) >= max(k_pos) and segments are off or one segment id covers
// both tiles (not causal: that segment rule alone); else partial.  An
// empty tile is not computed (every p would be 0: the same bits), a full
// one skips the element mask.  The softmax runs in base 2: exp2 of s * scale
// * log2(e) - m (forward) or - lse * log2(e) (dq, dk/dv), with the scale
// folded into one multiply; lse leaves in natural log.
//
// Grid: three consumer warpgroups a block in the forward, two in dq and
// dk/dv, where that grid still has a block for every SM; else one (64
// rows a block, the most blocks) — `consumer_warpgroups` below.  More
// warpgroups a block keep more of them in flight on an SM: measured on
// the card, the time of a tile goes to the softmax's exp2 and
// conversions (the SFU) and to latency, not to the tensor cores.
//
// An accumulator c[nt][e] of a warpgroup's 64 x (8 nt) tile holds, in
// warp w, row 16 w + g + 8 (e >> 1) and column 8 nt + 2 tig + (e & 1),
// g = lane >> 2, tig = lane & 3 (`hopper.cuh`).

// Two fp32 values rounded once (to nearest even) to T and packed in one
// 32-bit word, lo in the low half.
template <typename T>
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  if constexpr (std::is_same_v<T, __half>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const unsigned*>(&v);
  }
}

// A warp's 16 x 64 slab of an accumulator tile, rounded once to T, as the
// register A operand of the next product (k16 slices ks = 0 .. 3).
template <typename T>
__device__ __forceinline__ void to_fragments(const float (&c)[8][4],
                                             unsigned (&p)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    p[ks][0] = pack2<T>(c[2 * ks][0], c[2 * ks][1]);
    p[ks][1] = pack2<T>(c[2 * ks][2], c[2 * ks][3]);
    p[ks][2] = pack2<T>(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    p[ks][3] = pack2<T>(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

// Reduce over the 4 lanes (tig) that share a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

constexpr int WG = 128;       // threads of a warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
// Registers a thread after setmaxnreg, where a block has more than one
// consumer warpgroup: the warpgroups share what the launch gave them.
// The forward's three: 3 x 128 x 152 + 128 x 56 = 512 x 128; dq's two:
// 2 x 128 x 224 + 128 x 56 = 384 x 168 (dq takes 64 registers a thread at
// head dim 128, S and dP 32 each); dk/dv's two: 2 x 128 x 232 + 128 x 40
// = 384 x 168 (240 and 24 at head dim 128, where dk and dv take 128
// registers a thread).
enum Pass { FWD, DQ, DKV };
template <int D, Pass P>
__host__ __device__ constexpr int consumer_regs() {
  return P == FWD ? 152 : P == DQ ? 224 : D == 128 ? 240 : 232;
}
template <int D, Pass P>
__host__ __device__ constexpr int producer_regs() {
  return P != DKV ? 56 : D == 128 ? 24 : 40;
}

template <int D>
__host__ __device__ constexpr int tile_bytes() { return TILE * D * 2; }

// Ring slots of `per_slot` bytes that fit in the 227 KB a block may hold
// beside `fixed` bytes, with 3 KB left for barriers, the tile meta and
// alignment; at most 8.
__host__ __device__ constexpr int ring_slots(int fixed, int per_slot) {
  return (227 * 1024 - 3072 - fixed) / per_slot < 8
             ? (227 * 1024 - 3072 - fixed) / per_slot
             : 8;
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (hopper::smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Producer: `rows` rows of a [*, D] 16-bit operand (row stride `stride`)
// into the swizzled tile at shared address `dst`; rows past `rows` are
// zero.  `tid` is the thread's index in the producer warpgroup: it copies
// one 16-byte column of every STEP-th row, STEP a multiple of 8, so its
// swizzle (row % 8) and its steps through both tensors stay fixed.
template <int D, typename T>
__device__ __forceinline__ void load_tile(uint32_t dst, const T* src,
                                          long long stride, int rows,
                                          int tid) {
  static_assert(sizeof(T) == 2, "the tile layout holds 16-bit elements");
  constexpr int CHUNKS = D / 8, STEP = WG / CHUNKS;
  const int c = (tid % CHUNKS) * 8;
  int r = tid / CHUNKS;
  dst += hopper::swizzled(r, c);
  const T* from = src + r * stride + c;
#pragma unroll 1
  for (; r < TILE; r += STEP) {
    hopper::cp_async16(dst, r < rows ? from : src, r < rows);
    dst += STEP * 128;
    from += STEP * stride;
  }
}
// Producer: word `i` (< 64) of a row of 4-byte values; zero past `rows`.
__device__ __forceinline__ void load_word(uint32_t dst, const void* src,
                                          int i, int rows) {
  hopper::cp_async4(dst + 4 * i,
                    static_cast<const int*>(src) + (i < rows ? i : 0),
                    i < rows);
}

template <typename T, int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 8][4],
                                         const unsigned (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64)
    hopper::wgmma_rs_n64<T>(d, a, desc_b);
  else
    hopper::wgmma_rs_n128<T>(d, a, desc_b);
}

// A ring of STAGES slots: the current slot and the parity of its round.
template <int STAGES>
struct Ring {
  int slot = 0;
  unsigned phase = 0;
  __device__ __forceinline__ void next() {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1u;
    }
  }
};

// A consumer warpgroup's rows: min and max of the positions and of the
// segment ids over its valid rows (the tile classes' inputs), reduced
// over the warpgroup through `red` (16 ints).
struct RowRange {
  int pos_min, pos_max, seg_min, seg_max;
};
__device__ __forceinline__ RowRange warpgroup_range(const int (&pos)[2],
                                                    const int (&seg)[2],
                                                    const bool (&in)[2],
                                                    int* red, int wg) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  int v[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    if (in[hh]) {
      v[0] = min(v[0], pos[hh]);
      v[1] = max(v[1], pos[hh]);
      v[2] = min(v[2], seg[hh]);
      v[3] = max(v[3], seg[hh]);
    }
  v[0] = __reduce_min_sync(0xffffffffu, v[0]);
  v[1] = __reduce_max_sync(0xffffffffu, v[1]);
  v[2] = __reduce_min_sync(0xffffffffu, v[2]);
  v[3] = __reduce_max_sync(0xffffffffu, v[3]);
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[4 * warp + j] = v[j];
  hopper::warpgroup_sync(1 + wg);
  RowRange r{INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    r.pos_min = min(r.pos_min, red[4 * w]);
    r.pos_max = max(r.pos_max, red[4 * w + 1]);
    r.seg_min = min(r.seg_min, red[4 * w + 2]);
    r.seg_max = max(r.seg_max, red[4 * w + 3]);
  }
  return r;
}
// The `sub`-th 64-row tile of API block `block` (`tile_at` without its
// divisions).
__device__ __forceinline__ TileAt sub_tile(int block, int sub,
                                           int block_size) {
  return TileAt{block, block * block_size + sub * TILE,
                min(TILE, block_size - sub * TILE)};
}
// Bit w: API block `i` of the streamed side is live for warpgroup w's
// own API block `own[w]` (-1: the warpgroup has no tile); `live` is read
// at own[w] * own_stride + i * i_stride.  Producer and consumers read the
// same bits, so they walk the same tiles through the ring.
template <int NC>
__device__ __forceinline__ unsigned live_bits(const unsigned char* live,
                                              const int (&own)[NC],
                                              int own_stride, int i_stride,
                                              int i) {
  unsigned f = 0;
#pragma unroll
  for (int w = 0; w < NC; ++w)
    if (own[w] >= 0 && __ldg(live + own[w] * own_stride + i * i_stride))
      f |= 1u << w;
  return f;
}
// Producer warp 0, for a slot whose streamed tile has all 64 rows: min and
// max of its positions (and segment ids, where `seg` is given) into
// `meta`, for the consumers' full-tile rule; then the warp's one plain
// arrival on the slot's `full` barrier, which publishes them.
__device__ __forceinline__ void tile_meta(int4* meta, const int* pos,
                                          const int* seg, uint64_t* bar) {
  const int lane = threadIdx.x & 31;
  const int p0 = pos[lane], p1 = pos[lane + 32];
  int4 m;
  m.x = __reduce_min_sync(0xffffffffu, min(p0, p1));
  m.y = __reduce_max_sync(0xffffffffu, max(p0, p1));
  m.z = m.w = 0;
  if (seg != nullptr) {
    const int s0 = seg[lane], s1 = seg[lane + 32];
    m.z = __reduce_min_sync(0xffffffffu, min(s0, s1));
    m.w = __reduce_max_sync(0xffffffffu, max(s0, s1));
  }
  if (lane == 0) {
    *meta = m;
    hopper::mbar_arrive(bar);
  }
}
// A consumer warp is done with a ring slot.
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(empty);
}

// Producer of the forward and dq: stream the K and V tiles live for any
// of the block's warpgroups (API q blocks `qblock`), with their
// positions, segments and, for a tile of all 64 rows, its position range
// (`tile_meta`), through the ring of the layout L (members k, v, kpos,
// kseg, meta).  The consumers walk the same tiles with the same `Ring`.
template <typename T, typename L, int D, int NC>
__device__ __forceinline__ void stream_kv(const FlashArgs& a,
                                          unsigned char* smem,
                                          uint64_t* full, uint64_t* empty,
                                          const int (&qblock)[NC], int bi,
                                          int hk, int tid) {
  const uint32_t sbase = hopper::smem_u32(smem);
  int4* meta = reinterpret_cast<int4*>(smem + L::meta);
  const bool use_seg = a.q_seg != nullptr;
  const int per_k = (a.block_k + TILE - 1) / TILE;
  const T* kbase = static_cast<const T*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const T* vbase = static_cast<const T*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  Ring<L::STAGES> ring;
  for (int kb = 0; kb < a.nk; ++kb) {
    if (!live_bits(a.live, qblock, a.nk, 1, kb)) continue;
    for (int sub = 0; sub < per_k; ++sub, ring.next()) {
      const TileAt kt = sub_tile(kb, sub, a.block_k);
      const int s = ring.slot;
      hopper::mbar_wait(empty + s, ring.phase ^ 1u);
      if (tid < 32) {
        if (kt.rows == TILE)
          tile_meta(meta + s, a.k_pos + bi * a.kpos_sb + kt.row0,
                    use_seg ? a.k_seg + bi * a.kseg_sb + kt.row0 : nullptr,
                    full + s);
        else if (tid == 0)
          hopper::mbar_arrive(full + s);
      }
      load_tile<D>(sbase + L::k + s * tile_bytes<D>(),
                   kbase + kt.row0 * a.k_ss, a.k_ss, kt.rows, tid);
      load_tile<D>(sbase + L::v + s * tile_bytes<D>(),
                   vbase + kt.row0 * a.v_ss, a.v_ss, kt.rows, tid);
      if (tid < TILE)
        load_word(sbase + L::kpos + s * TILE * 4,
                  a.k_pos + bi * a.kpos_sb + kt.row0, tid, kt.rows);
      else if (use_seg)
        load_word(sbase + L::kseg + s * TILE * 4,
                  a.k_seg + bi * a.kseg_sb + kt.row0, tid - TILE, kt.rows);
      hopper::cp_async_arrive(full + s);
    }
  }
  hopper::cp_async_wait_all();
}

// Shared memory of the forward, in bytes from a 1024-aligned base.
template <int D, int NC>
struct FwdSmem {
  static constexpr int STAGES =
      ring_slots(NC * tile_bytes<D>(), 2 * tile_bytes<D>() + 2 * TILE * 4);
  static constexpr int q = 0;                                 // NC tiles
  static constexpr int k = q + NC * tile_bytes<D>();          // STAGES
  static constexpr int v = k + STAGES * tile_bytes<D>();      // STAGES
  static constexpr int kpos = v + STAGES * tile_bytes<D>();   // [STAGES][64]
  static constexpr int kseg = kpos + STAGES * TILE * 4;
  static constexpr int meta = kseg + STAGES * TILE * 4;       // [STAGES] int4
  static constexpr int bars = meta + STAGES * 16;             // 1 + 2 STAGES
  static constexpr int red = bars + 8 * (1 + 2 * STAGES);     // NC x 16 ints
  static constexpr int bytes = red + NC * 16 * 4 + 1024;      // + alignment
};

template <typename T, int D, int NC>
__global__ void __launch_bounds__(WG * (NC + 1), 1)
flash_fwd_mma_kernel(const FlashArgs a) {
  using L = FwdSmem<D, NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sbase = hopper::smem_u32(smem);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qfull + 1;
  constexpr int STAGES = L::STAGES;
  uint64_t* empty = full + STAGES;
  const int* kpos_s = reinterpret_cast<const int*>(smem + L::kpos);
  const int* kseg_s = reinterpret_cast<const int*>(smem + L::kseg);
  int4* meta = reinterpret_cast<int4*>(smem + L::meta);

  const int wg = threadIdx.x / WG;
  // heavy (late, causal) rows first
  const int cta = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const bool use_seg = a.q_seg != nullptr;
  const int per_k = (a.block_k + TILE - 1) / TILE;
  const int nt_q = a.nq * ((a.block_q + TILE - 1) / TILE);
  int qblock[NC];   // each warpgroup's API q block, -1: no tile
#pragma unroll
  for (int w = 0; w < NC; ++w)
    qblock[w] = cta * NC + w < nt_q ? tile_at(cta * NC + w, a.block_q).block
                                    : -1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, WG);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, WG + 1);   // + producer warp 0's meta
      hopper::mbar_init(empty + s, 4 * NC);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------ producer
    if constexpr (NC > 1)
      hopper::setmaxnreg_dec<producer_regs<D, FWD>()>();
    const int tid = threadIdx.x - NC * WG;
    const T* qbase = static_cast<const T*>(a.q) + bi * a.q_sb + h * a.q_sh;
#pragma unroll
    for (int w = 0; w < NC; ++w)
      if (qblock[w] >= 0) {
        const TileAt qt = tile_at(cta * NC + w, a.block_q);
        load_tile<D>(sbase + L::q + w * tile_bytes<D>(),
                     qbase + qt.row0 * a.q_ss, a.q_ss, qt.rows, tid);
      }
    hopper::cp_async_arrive(qfull);
    stream_kv<T, L, D, NC>(a, smem, full, empty, qblock, bi, hk, tid);
  } else {
    // ------------------------------------------------------ consumers
    if constexpr (NC > 1)
      hopper::setmaxnreg_inc<consumer_regs<D, FWD>()>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tig = lane & 3;
    const bool has = qblock[wg] >= 0;
    const TileAt qt = tile_at(has ? cta * NC + wg : 0, a.block_q);
    // the thread's two rows of the tile: 16 warp + g and + 8
    int qp[2], qs[2];
    bool in[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh;
      in[hh] = has && row < qt.rows;
      qp[hh] = in[hh] ? a.q_pos[bi * a.qpos_sb + qt.row0 + row] : 0;
      qs[hh] = in[hh] && use_seg ? a.q_seg[bi * a.qseg_sb + qt.row0 + row]
                                 : 0;
    }
    const RowRange qr = warpgroup_range(
        qp, qs, in, reinterpret_cast<int*>(smem + L::red) + 16 * wg, wg);
    const bool q_whole = has && qt.rows == TILE;
    const float c2 = a.scale * LOG2E;
    const uint32_t q_tile = sbase + L::q + wg * tile_bytes<D>();

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's
    float o[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

    // O += P V of a tile is issued and left running; the next tile's
    // S = Q K^T queues behind it, and the wait for S also sees P V done,
    // which releases the earlier tile's slot.  Products are issued and
    // awaited on the tile's one path, so they stay asynchronous.
    unsigned p[4][4];
    int pending = -1;   // the slot whose P V is in flight
    hopper::mbar_wait(qfull, 0);
    Ring<STAGES> ring;
    for (int kb = 0; kb < a.nk; ++kb) {
      const unsigned live = live_bits(a.live, qblock, a.nk, 1, kb);
      if (!live) continue;
      const bool mine = has && (live >> wg & 1u);
      for (int sub = 0; sub < per_k; ++sub, ring.next()) {
        const int s = ring.slot;
        if (s == pending) {
          // The ring is back at the slot whose P V is in flight: every
          // tile since was empty or not this warpgroup's.  Release it
          // before the wait, or the producer (which refills the slot
          // once it is released) and this wait would wait on each other.
          hopper::wgmma_wait<0>();
          hopper::fence_operands(o);
          release(empty + pending);
          pending = -1;
        }
        hopper::mbar_wait(full + s, ring.phase);
        if (mine) {
          hopper::fence_proxy_async();
          const TileAt kt = sub_tile(kb, sub, a.block_k);
          const int* kpos = kpos_s + s * TILE;
          const int* kseg = kseg_s + s * TILE;
          bool whole = q_whole && kt.rows == TILE;
          if (whole) {
            const int4 km = meta[s];   // min, max of k_pos; of k_seg
            if (a.causal && qr.pos_max < km.x) {   // empty: all masked
              release(empty + s);
              continue;
            }
            if (a.causal) whole = qr.pos_min >= km.y;
            if (use_seg)
              whole = whole && qr.seg_min == qr.seg_max && km.z == km.w &&
                      km.z == qr.seg_min;
          }

          float sc[8][4];   // the first product overwrites it
          const uint32_t k_tile = sbase + L::k + s * tile_bytes<D>();
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks)
            hopper::wgmma_ss_n64<T>(sc, hopper::desc_k(q_tile, ks),
                                    hopper::desc_k(k_tile, ks), ks > 0);
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          hopper::fence_operands(o);
          if (pending >= 0) release(empty + pending);

          // s * scale * log2(e): one multiply, then exp2; a full tile
          // needs no mask
          float m_cur[2] = {NEG_INF, NEG_INF};
          if (whole) {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                sc[nt][e] *= c2;
                m_cur[e >> 1] = fmaxf(m_cur[e >> 1], sc[nt][e]);
              }
          } else {
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int col = 8 * nt + 2 * tig + (e & 1), hh = e >> 1;
                bool ok = col < kt.rows;
                if (a.causal) ok = ok && qp[hh] >= kpos[col];
                if (use_seg) ok = ok && qs[hh] == kseg[col];
                sc[nt][e] = ok ? sc[nt][e] * c2 : NEG_INF;
                m_cur[hh] = fmaxf(m_cur[hh], sc[nt][e]);
              }
          }
          float m_exp[2];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float m_new = fmaxf(m[hh], quad_max(m_cur[hh]));
            // a row that has seen nothing yet: exp2(s - m_new) would be 1
            m_exp[hh] = m_new <= NEG_INF / 2 ? 0.f : m_new;
            const float corr = ex2(m[hh] - m_new);
            m[hh] = m_new;
            l[hh] *= corr;
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt) {
              o[nt][2 * hh] *= corr;
              o[nt][2 * hh + 1] *= corr;
            }
          }
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sc[nt][e] = ex2(sc[nt][e] - m_exp[e >> 1]);
              l[e >> 1] += sc[nt][e];   // the sum is of the unrounded p
            }
          to_fragments<T>(sc, p);
          const uint32_t v_tile = sbase + L::v + s * tile_bytes<D>();
          hopper::fence_operands(o);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<T, D>(o, p[kk], hopper::desc_mn(v_tile, kk));
          hopper::wgmma_commit();
          pending = s;
        } else {
          release(empty + s);
        }
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(o);
    if (pending >= 0) release(empty + pending);

    if (has) {
      T* obase = static_cast<T*>(a.o) + bi * a.o_sb + h * a.o_sh;
      float* lse = a.lse + (static_cast<long long>(bi) * a.hq + h) * a.sq;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        const float lsum = quad_sum(l[hh]);
        if (row >= qt.rows) continue;
        const float l_safe = lsum == 0.f ? 1.f : lsum;
        const float inv = 1.f / l_safe;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<unsigned*>(
              obase + (qt.row0 + row) * a.o_ss + 8 * nt + 2 * tig) =
              pack2<T>(o[nt][2 * hh] * inv, o[nt][2 * hh + 1] * inv);
        if (tig == 0)
          lse[qt.row0 + row] =
              lsum == 0.f ? NEG_INF : m[hh] * LN2 + logf(l_safe);
      }
    }
  }
}

// Shared memory of dq, in bytes from a 1024-aligned base: the forward's
// ring behind the warpgroups' Q and dO tiles.
template <int D, int NC>
struct DqSmem {
  static constexpr int STAGES = ring_slots(
      2 * NC * tile_bytes<D>(), 2 * tile_bytes<D>() + 2 * TILE * 4);
  static constexpr int q = 0;                                 // NC tiles
  static constexpr int dout = q + NC * tile_bytes<D>();       // NC tiles
  static constexpr int k = dout + NC * tile_bytes<D>();       // STAGES
  static constexpr int v = k + STAGES * tile_bytes<D>();      // STAGES
  static constexpr int kpos = v + STAGES * tile_bytes<D>();   // [STAGES][64]
  static constexpr int kseg = kpos + STAGES * TILE * 4;
  static constexpr int meta = kseg + STAGES * TILE * 4;       // [STAGES] int4
  static constexpr int bars = meta + STAGES * 16;             // 1 + 2 STAGES
  static constexpr int red = bars + 8 * (1 + 2 * STAGES);     // NC x 16 ints
  static constexpr int bytes = red + NC * 16 * 4 + 1024;      // + alignment
};

// dq: the forward's walk over the k tiles of each warpgroup's q tile,
// recomputing S = Q K^T and dP = dO V^T, P = exp2(S scale log2(e) -
// lse log2(e)) and dS = P (dP - delta), and accumulating dQ += dS K in
// registers; dq = scale dQ is written once, so two runs give the same
// bits (no atomics).
template <typename T, int D, int NC>
__global__ void __launch_bounds__(WG * (NC + 1), 1)
flash_bwd_dq_wgmma_kernel(const FlashArgs a) {
  using L = DqSmem<D, NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sbase = hopper::smem_u32(smem);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = qfull + 1;
  constexpr int STAGES = L::STAGES;
  uint64_t* empty = full + STAGES;
  const int* kpos_s = reinterpret_cast<const int*>(smem + L::kpos);
  const int* kseg_s = reinterpret_cast<const int*>(smem + L::kseg);
  const int4* meta = reinterpret_cast<const int4*>(smem + L::meta);

  const int wg = threadIdx.x / WG;
  // heavy (late, causal) rows first
  const int cta = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const bool use_seg = a.q_seg != nullptr;
  const int per_k = (a.block_k + TILE - 1) / TILE;
  const int nt_q = a.nq * ((a.block_q + TILE - 1) / TILE);
  int qblock[NC];   // each warpgroup's API q block, -1: no tile
#pragma unroll
  for (int w = 0; w < NC; ++w)
    qblock[w] = cta * NC + w < nt_q ? tile_at(cta * NC + w, a.block_q).block
                                    : -1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, WG);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, WG + 1);   // + producer warp 0's meta
      hopper::mbar_init(empty + s, 4 * NC);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------ producer
    if constexpr (NC > 1)
      hopper::setmaxnreg_dec<producer_regs<D, DQ>()>();
    const int tid = threadIdx.x - NC * WG;
    const T* qbase = static_cast<const T*>(a.q) + bi * a.q_sb + h * a.q_sh;
    const T* dobase =
        static_cast<const T*>(a.dout) + bi * a.do_sb + h * a.do_sh;
#pragma unroll
    for (int w = 0; w < NC; ++w)
      if (qblock[w] >= 0) {
        const TileAt qt = tile_at(cta * NC + w, a.block_q);
        load_tile<D>(sbase + L::q + w * tile_bytes<D>(),
                     qbase + qt.row0 * a.q_ss, a.q_ss, qt.rows, tid);
        load_tile<D>(sbase + L::dout + w * tile_bytes<D>(),
                     dobase + qt.row0 * a.do_ss, a.do_ss, qt.rows, tid);
      }
    hopper::cp_async_arrive(qfull);
    stream_kv<T, L, D, NC>(a, smem, full, empty, qblock, bi, hk, tid);
  } else {
    // ------------------------------------------------------ consumers
    if constexpr (NC > 1)
      hopper::setmaxnreg_inc<consumer_regs<D, DQ>()>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tig = lane & 3;
    const bool has = qblock[wg] >= 0;
    const TileAt qt = tile_at(has ? cta * NC + wg : 0, a.block_q);
    const long long stat =
        (static_cast<long long>(bi) * a.hq + h) * a.sq + qt.row0;
    // the thread's two rows of the tile: 16 warp + g and + 8; lse in
    // base 2 (0 for a row that saw nothing, whose p are all masked)
    int qp[2], qs[2];
    bool in[2];
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh;
      in[hh] = has && row < qt.rows;
      qp[hh] = in[hh] ? a.q_pos[bi * a.qpos_sb + qt.row0 + row] : 0;
      qs[hh] = in[hh] && use_seg ? a.q_seg[bi * a.qseg_sb + qt.row0 + row]
                                 : 0;
      const float x = in[hh] ? a.lse[stat + row] : 0.f;
      lse2[hh] = x <= NEG_INF / 2 ? 0.f : x * LOG2E;
      dl[hh] = in[hh] ? a.delta[stat + row] : 0.f;
    }
    const RowRange qr = warpgroup_range(
        qp, qs, in, reinterpret_cast<int*>(smem + L::red) + 16 * wg, wg);
    const bool q_whole = has && qt.rows == TILE;
    const float c2 = a.scale * LOG2E;
    const uint32_t q_tile = sbase + L::q + wg * tile_bytes<D>();
    const uint32_t do_tile = sbase + L::dout + wg * tile_bytes<D>();

    float dq[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

    // dQ += dS K of a tile is issued and left running; the next tile's
    // S and dP queue behind it, and the wait for them also sees dQ done,
    // which releases the earlier tile's slot.  Products are issued and
    // awaited on the tile's one path, so they stay asynchronous.
    unsigned ds[4][4];
    int pending = -1;   // the slot whose dQ += dS K is in flight
    hopper::mbar_wait(qfull, 0);
    Ring<STAGES> ring;
    for (int kb = 0; kb < a.nk; ++kb) {
      const unsigned live = live_bits(a.live, qblock, a.nk, 1, kb);
      if (!live) continue;
      const bool mine = has && (live >> wg & 1u);
      for (int sub = 0; sub < per_k; ++sub, ring.next()) {
        const int s = ring.slot;
        if (s == pending) {
          // The ring is back at the slot whose dQ is in flight: every
          // tile since was empty or not this warpgroup's.  Release it
          // before the wait, or the producer (which refills the slot
          // once it is released) and this wait would wait on each other.
          hopper::wgmma_wait<0>();
          hopper::fence_operands(dq);
          release(empty + pending);
          pending = -1;
        }
        hopper::mbar_wait(full + s, ring.phase);
        if (mine) {
          hopper::fence_proxy_async();
          const TileAt kt = sub_tile(kb, sub, a.block_k);
          const int* kpos = kpos_s + s * TILE;
          const int* kseg = kseg_s + s * TILE;
          bool whole = q_whole && kt.rows == TILE;
          if (whole) {
            const int4 km = meta[s];   // min, max of k_pos; of k_seg
            if (a.causal && qr.pos_max < km.x) {   // empty: all masked
              release(empty + s);
              continue;
            }
            if (a.causal) whole = qr.pos_min >= km.y;
            if (use_seg)
              whole = whole && qr.seg_min == qr.seg_max && km.z == km.w &&
                      km.z == qr.seg_min;
          }

          float sc[8][4], dp[8][4];   // the first products overwrite them
          const uint32_t k_tile = sbase + L::k + s * tile_bytes<D>();
          const uint32_t v_tile = sbase + L::v + s * tile_bytes<D>();
          hopper::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            hopper::wgmma_ss_n64<T>(sc, hopper::desc_k(q_tile, ks),
                                    hopper::desc_k(k_tile, ks), ks > 0);
            hopper::wgmma_ss_n64<T>(dp, hopper::desc_k(do_tile, ks),
                                    hopper::desc_k(v_tile, ks), ks > 0);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<0>();
          hopper::fence_operands(sc);
          hopper::fence_operands(dp);
          hopper::fence_operands(dq);
          if (pending >= 0) release(empty + pending);

          // p = exp2(s * scale * log2(e) - lse * log2(e)): one FMA, then
          // exp2; a full tile needs no mask.  dS overwrites S.
#pragma unroll
          for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int hh = e >> 1;
              bool ok = whole;
              if (!whole) {
                const int col = 8 * nt + 2 * tig + (e & 1);
                ok = col < kt.rows;
                if (a.causal) ok = ok && qp[hh] >= kpos[col];
                if (use_seg) ok = ok && qs[hh] == kseg[col];
              }
              const float pv = ok ? ex2(fmaf(sc[nt][e], c2, -lse2[hh])) : 0.f;
              sc[nt][e] = pv * (dp[nt][e] - dl[hh]);
            }
          to_fragments<T>(sc, ds);
          hopper::fence_operands(dq);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs<T, D>(dq, ds[kk], hopper::desc_mn(k_tile, kk));
          hopper::wgmma_commit();
          pending = s;
        } else {
          release(empty + s);
        }
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(dq);
    if (pending >= 0) release(empty + pending);

    if (has) {
      float* out = a.dq + bi * a.dq_sb + h * a.dq_sh;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        if (row >= qt.rows) continue;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt)
          *reinterpret_cast<float2*>(out + (qt.row0 + row) * a.dq_ss +
                                     8 * nt + 2 * tig) =
              make_float2(dq[nt][2 * hh] * a.scale,
                          dq[nt][2 * hh + 1] * a.scale);
      }
    }
  }
}

// Shared memory of dk/dv, in bytes from a 1024-aligned base.
template <int D, int NC>
struct DkvSmem {
  static constexpr int STAGES = ring_slots(2 * NC * tile_bytes<D>(),
                                           2 * tile_bytes<D>() + 4 * TILE * 4);
  static constexpr int k = 0;                                  // NC tiles
  static constexpr int v = k + NC * tile_bytes<D>();           // NC tiles
  static constexpr int q = v + NC * tile_bytes<D>();           // STAGES
  static constexpr int dout = q + STAGES * tile_bytes<D>();    // STAGES
  static constexpr int lse = dout + STAGES * tile_bytes<D>();  // [STAGES][64]
  static constexpr int delta = lse + STAGES * TILE * 4;
  static constexpr int qpos = delta + STAGES * TILE * 4;
  static constexpr int qseg = qpos + STAGES * TILE * 4;
  static constexpr int meta = qseg + STAGES * TILE * 4;        // [STAGES] int4
  static constexpr int bars = meta + STAGES * 16;              // 1 + 2 STAGES
  static constexpr int red = bars + 8 * (1 + 2 * STAGES);      // NC x 16 ints
  static constexpr int bytes = red + NC * 16 * 4 + 1024;       // + alignment
};

template <typename T, int D, int NC>
__global__ void __launch_bounds__(WG * (NC + 1), 1)
flash_bwd_dkv_mma_kernel(const FlashArgs a) {
  using L = DkvSmem<D, NC>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  const uint32_t sbase = hopper::smem_u32(smem);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* full = kvfull + 1;
  constexpr int STAGES = L::STAGES;
  uint64_t* empty = full + STAGES;
  int4* meta = reinterpret_cast<int4*>(smem + L::meta);

  const int wg = threadIdx.x / WG;
  // light (late, causal) k tiles last
  const int cta = blockIdx.x;
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int group = a.hq / a.hkv;
  const bool use_seg = a.q_seg != nullptr;
  const int per_q = (a.block_q + TILE - 1) / TILE;
  const int nt_k = a.nk * ((a.block_k + TILE - 1) / TILE);
  int kblock[NC];   // each warpgroup's API k block, -1: no tile
#pragma unroll
  for (int w = 0; w < NC; ++w)
    kblock[w] = cta * NC + w < nt_k ? tile_at(cta * NC + w, a.block_k).block
                                    : -1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kvfull, WG);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + s, WG + 1);   // + producer warp 0's meta
      hopper::mbar_init(empty + s, 4 * NC);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    // ------------------------------------------------------ producer
    if constexpr (NC > 1)
      hopper::setmaxnreg_dec<producer_regs<D, DKV>()>();
    const int tid = threadIdx.x - NC * WG;
    const T* kbase = static_cast<const T*>(a.k) + bi * a.k_sb + hk * a.k_sh;
    const T* vbase = static_cast<const T*>(a.v) + bi * a.v_sb + hk * a.v_sh;
#pragma unroll
    for (int w = 0; w < NC; ++w)
      if (kblock[w] >= 0) {
        const TileAt kt = tile_at(cta * NC + w, a.block_k);
        load_tile<D>(sbase + L::k + w * tile_bytes<D>(),
                     kbase + kt.row0 * a.k_ss, a.k_ss, kt.rows, tid);
        load_tile<D>(sbase + L::v + w * tile_bytes<D>(),
                     vbase + kt.row0 * a.v_ss, a.v_ss, kt.rows, tid);
      }
    hopper::cp_async_arrive(kvfull);
    Ring<STAGES> ring;
    for (int gi = 0; gi < group; ++gi) {
      const int h = hk * group + gi;
      const T* qbase = static_cast<const T*>(a.q) + bi * a.q_sb + h * a.q_sh;
      const T* dobase =
          static_cast<const T*>(a.dout) + bi * a.do_sb + h * a.do_sh;
      const long long stat = (static_cast<long long>(bi) * a.hq + h) * a.sq;
      for (int qb = 0; qb < a.nq; ++qb) {
        if (!live_bits(a.live, kblock, 1, a.nk, qb)) continue;
        for (int sub = 0; sub < per_q; ++sub, ring.next()) {
          const TileAt qt = sub_tile(qb, sub, a.block_q);
          const int s = ring.slot;
          hopper::mbar_wait(empty + s, ring.phase ^ 1u);
          if (tid < 32) {
            if (qt.rows == TILE)
              tile_meta(meta + s, a.q_pos + bi * a.qpos_sb + qt.row0,
                        use_seg ? a.q_seg + bi * a.qseg_sb + qt.row0
                                : nullptr,
                        full + s);
            else if (tid == 0)
              hopper::mbar_arrive(full + s);
          }
          load_tile<D>(sbase + L::q + s * tile_bytes<D>(),
                       qbase + qt.row0 * a.q_ss, a.q_ss, qt.rows, tid);
          load_tile<D>(sbase + L::dout + s * tile_bytes<D>(),
                       dobase + qt.row0 * a.do_ss, a.do_ss, qt.rows, tid);
          const int i = tid & (TILE - 1);
          if (tid < TILE) {
            load_word(sbase + L::lse + s * TILE * 4,
                      a.lse + stat + qt.row0, i, qt.rows);
            load_word(sbase + L::qpos + s * TILE * 4,
                      a.q_pos + bi * a.qpos_sb + qt.row0, i, qt.rows);
          } else {
            load_word(sbase + L::delta + s * TILE * 4,
                      a.delta + stat + qt.row0, i, qt.rows);
            if (use_seg)
              load_word(sbase + L::qseg + s * TILE * 4,
                        a.q_seg + bi * a.qseg_sb + qt.row0, i, qt.rows);
          }
          hopper::cp_async_arrive(full + s);
        }
      }
    }
    hopper::cp_async_wait_all();
  } else {
    // ------------------------------------------------------ consumers
    if constexpr (NC > 1)
      hopper::setmaxnreg_inc<consumer_regs<D, DKV>()>();
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    const int g = lane >> 2, tig = lane & 3;
    const bool has = kblock[wg] >= 0;
    const TileAt kt = tile_at(has ? cta * NC + wg : 0, a.block_k);
    // the thread's two k rows: 16 warp + g and + 8
    int kp[2], ksg[2];
    bool in[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = 16 * warp + g + 8 * hh;
      in[hh] = has && row < kt.rows;
      kp[hh] = in[hh] ? a.k_pos[bi * a.kpos_sb + kt.row0 + row] : 0;
      ksg[hh] = in[hh] && use_seg ? a.k_seg[bi * a.kseg_sb + kt.row0 + row]
                                  : 0;
    }
    const RowRange kr = warpgroup_range(
        kp, ksg, in, reinterpret_cast<int*>(smem + L::red) + 16 * wg, wg);
    const bool k_whole = has && kt.rows == TILE;
    const float c2 = a.scale * LOG2E;
    const uint32_t k_tile = sbase + L::k + wg * tile_bytes<D>();
    const uint32_t v_tile = sbase + L::v + wg * tile_bytes<D>();

    float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

    hopper::mbar_wait(kvfull, 0);
    Ring<STAGES> ring;
    for (int gi = 0; gi < group; ++gi) {
      for (int qb = 0; qb < a.nq; ++qb) {
        const unsigned live = live_bits(a.live, kblock, 1, a.nk, qb);
        if (!live) continue;
        const bool mine = has && (live >> wg & 1u);
        for (int sub = 0; sub < per_q; ++sub, ring.next()) {
          const int s = ring.slot;
          hopper::mbar_wait(full + s, ring.phase);
          if (mine) {
            hopper::fence_proxy_async();
            const TileAt qt = sub_tile(qb, sub, a.block_q);
            const int* qpos =
                reinterpret_cast<const int*>(smem + L::qpos) + s * TILE;
            const int* qseg =
                reinterpret_cast<const int*>(smem + L::qseg) + s * TILE;
            const float* lse =
                reinterpret_cast<const float*>(smem + L::lse) + s * TILE;
            const float* delta =
                reinterpret_cast<const float*>(smem + L::delta) + s * TILE;
            bool whole = k_whole && qt.rows == TILE;
            if (whole) {
              const int4 qm = meta[s];   // min, max of q_pos; of q_seg
              if (a.causal && qm.y < kr.pos_min) {   // empty: all masked
                release(empty + s);
                continue;
              }
              if (a.causal) whole = qm.x >= kr.pos_max;
              if (use_seg)
                whole = whole && kr.seg_min == kr.seg_max && qm.z == qm.w &&
                        qm.z == kr.seg_min;
            }

            // transposed tiles: rows are k rows, columns q rows
            float st[8][4], dpt[8][4];
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
            const uint32_t q_tile = sbase + L::q + s * tile_bytes<D>();
            const uint32_t do_tile = sbase + L::dout + s * tile_bytes<D>();
            hopper::fence_operands(st);
            hopper::fence_operands(dpt);
            hopper::wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              hopper::wgmma_ss_n64<T>(st, hopper::desc_k(k_tile, ks),
                                      hopper::desc_k(q_tile, ks), ks > 0);
              hopper::wgmma_ss_n64<T>(dpt, hopper::desc_k(v_tile, ks),
                                      hopper::desc_k(do_tile, ks), ks > 0);
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_operands(st);
            hopper::fence_operands(dpt);

#pragma unroll
            for (int nt = 0; nt < 8; ++nt) {
              const int c0 = 8 * nt + 2 * tig;
              const float2 lv = *reinterpret_cast<const float2*>(lse + c0);
              const float2 dl = *reinterpret_cast<const float2*>(delta + c0);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int qcol = c0 + (e & 1), hh = e >> 1;
                const float x = (e & 1) ? lv.y : lv.x;
                // a row that saw nothing
                const float lse2 = x <= NEG_INF / 2 ? 0.f : x * LOG2E;
                bool ok = whole;
                if (!whole) {
                  ok = in[hh] && qcol < qt.rows;
                  if (a.causal) ok = ok && qpos[qcol] >= kp[hh];
                  if (use_seg) ok = ok && qseg[qcol] == ksg[hh];
                }
                const float p = ok ? ex2(fmaf(st[nt][e], c2, -lse2)) : 0.f;
                st[nt][e] = p;
                dpt[nt][e] = p * (dpt[nt][e] - ((e & 1) ? dl.y : dl.x));
              }
            }
            unsigned pf[4][4], dsf[4][4];
            to_fragments<T>(st, pf);
            to_fragments<T>(dpt, dsf);
            hopper::fence_operands(dv);
            hopper::fence_operands(dk);
            hopper::wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              wgmma_rs<T, D>(dv, pf[kk], hopper::desc_mn(do_tile, kk));
              wgmma_rs<T, D>(dk, dsf[kk], hopper::desc_mn(q_tile, kk));
            }
            hopper::wgmma_commit();
            hopper::wgmma_wait<0>();
            hopper::fence_operands(dv);
            hopper::fence_operands(dk);
          }
          release(empty + s);
        }
      }
    }

    if (has) {
      float* dkp = a.dk + bi * a.dk_sb + hk * a.dk_sh;
      float* dvp = a.dv + bi * a.dv_sb + hk * a.dv_sh;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        if (row >= kt.rows) continue;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          *reinterpret_cast<float2*>(dkp + (kt.row0 + row) * a.dk_ss + 8 * nt +
                                     2 * tig) =
              make_float2(dk[nt][2 * hh] * a.scale,
                          dk[nt][2 * hh + 1] * a.scale);
          *reinterpret_cast<float2*>(dvp + (kt.row0 + row) * a.dv_ss + 8 * nt +
                                     2 * tig) =
              make_float2(dv[nt][2 * hh], dv[nt][2 * hh + 1]);
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launches
inline int tiles_along(int blocks, int block_size) {
  return blocks * ((block_size + TILE - 1) / TILE);
}

template <typename Kernel>
int launch(Kernel kernel, const FlashArgs& a, dim3 grid, int threads,
           size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Consumer warpgroups a Hopper block: `most` (3 in the forward, 2 in
// dq and dk/dv) where that grid over `tiles` 64-row tiles x `heads` x `batch`
// still holds a block for each of the card's SMs; else 1 (64 rows a
// block, the most blocks).
int consumer_warpgroups(int tiles, int heads, int batch, int most) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks =
      static_cast<long long>((tiles + most - 1) / most) * heads * batch;
  return blocks >= sms ? most : 1;
}

template <typename T, int D, int NC>
int fwd_mma(const FlashArgs& a, int tiles, void* stream) {
  return launch(flash_fwd_mma_kernel<T, D, NC>, a,
                dim3((tiles + NC - 1) / NC, a.hq, a.b), WG * (NC + 1),
                FwdSmem<D, NC>::bytes, stream);
}

// T = float: the fp32 arm on the CUDA cores; T = __nv_bfloat16 or
// __half: the Hopper kernels on the tensor cores (wgmma).
template <typename T, int D>
int fwd(const FlashArgs& a, void* stream) {
  const int tiles = tiles_along(a.nq, a.block_q);
  if constexpr (sizeof(T) == 4) {
    return launch(flash_fwd_kernel<D>, a, dim3(tiles, a.hq, a.b), THREADS,
                  smem_bytes<D>(3, 1), stream);
  } else {
    return consumer_warpgroups(tiles, a.hq, a.b, 3) == 3
               ? fwd_mma<T, D, 3>(a, tiles, stream)
               : fwd_mma<T, D, 1>(a, tiles, stream);
  }
}
template <typename T, int D>
int bwd_dq(const FlashArgs& a, void* stream) {
  dim3 grid(tiles_along(a.nq, a.block_q), a.hq, a.b);
  if constexpr (sizeof(T) == 4)
    return launch(flash_bwd_dq_kernel<D>, a, grid, THREADS,
                  smem_bytes<D>(4, 1), stream);
  else if (consumer_warpgroups(grid.x, a.hq, a.b, 2) == 2)
    return launch(flash_bwd_dq_wgmma_kernel<T, D, 2>, a,
                  dim3((grid.x + 1) / 2, a.hq, a.b), 3 * WG,
                  DqSmem<D, 2>::bytes, stream);
  else
    return launch(flash_bwd_dq_wgmma_kernel<T, D, 1>, a, grid, 2 * WG,
                  DqSmem<D, 1>::bytes, stream);
}
template <typename T, int D>
int bwd_dkv(const FlashArgs& a, void* stream) {
  const int tiles = tiles_along(a.nk, a.block_k);
  if constexpr (sizeof(T) == 4)
    return launch(flash_bwd_dkv_kernel<D>, a, dim3(tiles, a.hkv, a.b),
                  THREADS, smem_bytes<D>(4, 2), stream);
  else if (consumer_warpgroups(tiles, a.hkv, a.b, 2) == 2)
    return launch(flash_bwd_dkv_mma_kernel<T, D, 2>, a,
                  dim3((tiles + 1) / 2, a.hkv, a.b), 3 * WG,
                  DkvSmem<D, 2>::bytes, stream);
  else
    return launch(flash_bwd_dkv_mma_kernel<T, D, 1>, a, dim3(tiles, a.hkv, a.b),
                  2 * WG, DkvSmem<D, 1>::bytes, stream);
}

}  // namespace

// Head dims 64 and 128; anything else is cudaErrorInvalidValue (the
// wrapper raises before it gets here).
#define HETU_FLASH_ENTRY(name, fn, T)                                     \
  HETU_EXPORT int name(const FlashArgs* a, int d, void* stream) {         \
    if (d == 64) return fn<T, 64>(*a, stream);                            \
    if (d == 128) return fn<T, 128>(*a, stream);                          \
    return static_cast<int>(cudaErrorInvalidValue);                       \
  }

HETU_FLASH_ENTRY(hetu_flash_fwd_f32, fwd, float)
HETU_FLASH_ENTRY(hetu_flash_fwd_bf16, fwd, __nv_bfloat16)
HETU_FLASH_ENTRY(hetu_flash_fwd_f16, fwd, __half)
HETU_FLASH_ENTRY(hetu_flash_bwd_dq_f32, bwd_dq, float)
HETU_FLASH_ENTRY(hetu_flash_bwd_dq_bf16, bwd_dq, __nv_bfloat16)
HETU_FLASH_ENTRY(hetu_flash_bwd_dq_f16, bwd_dq, __half)
HETU_FLASH_ENTRY(hetu_flash_bwd_dkv_f32, bwd_dkv, float)
HETU_FLASH_ENTRY(hetu_flash_bwd_dkv_bf16, bwd_dkv, __nv_bfloat16)
HETU_FLASH_ENTRY(hetu_flash_bwd_dkv_f16, bwd_dkv, __half)
