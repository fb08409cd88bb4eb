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
// shared memory), the bf16 arm runs on the tensor cores, K and V are read
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
// Arithmetic: two arms, the same three kernels in each.
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
// bf16 inputs (second half): every product is mma.sync.m16n8k16 on the
// tensor cores with fp32 accumulators; the softmax, lse, delta and all
// sums stay fp32, and P and dS are rounded once to bf16 as the next
// product's operand (as FlashAttention-2 does; the TPU kernel keeps them
// fp32).  o is rounded once to bf16 on the way out; dq, dk, dv leave in
// fp32 in both arms.
//
// What is left for later: both arms stage one tile at a time between two
// __syncthreads (no cp.async / TMA ring, no double buffer), the bf16 arm
// uses mma.sync, not wgmma, and the mask is evaluated on every element of
// every live tile.
#include "common.cuh"
#include "mma.cuh"

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

// ===================================================== bf16: tensor cores
//
// The bf16 arm runs every product as mma.sync.m16n8k16 (bf16 operands,
// fp32 accumulators).  A block is 4 warps; a warp owns 16 rows of the
// 64 x 64 score tile.  Tiles are staged in shared memory as bf16 with a
// row stride of D + 8 elements (16 bytes more than a power of two), so
// the 8 rows of an ldmatrix land in 8 different 16-byte bank groups.
// Operands come out of shared memory through ldmatrix: as stored for an
// "A" operand and for a "B" operand that is contracted over d (K in
// Q K^T, V in dO V^T, Q and dO in the transposed products), transposed
// (.trans) for a "B" operand that is contracted over its rows (V in
// P V, K in dS K, dO in P^T dO, Q in dS^T Q).  P and dS never leave
// registers: the accumulators of two neighbouring 8-column tiles are
// exactly one A fragment, after one rounding to bf16.
//
// An accumulator c[nt][e] of a warp's 16 x (8 nt) tile holds row
// g + 8 (e >> 1) and column 8 nt + 2 tig + (e & 1), g = lane >> 2,
// tig = lane & 3.

constexpr int MMA_THREADS = 128;

template <int D>
__host__ __device__ constexpr int ldh() { return D + 8; }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Stage `rows` rows of a [*, D] bf16 operand into dst [TILE][D + 8] with
// 16-byte copies; rows past `rows` are zero.
template <int D>
__device__ __forceinline__ void stage_h(bf16* dst, const bf16* src,
                                        long long stride, int rows) {
  constexpr int VEC = D / 8;
  for (int i = threadIdx.x; i < TILE * VEC; i += MMA_THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * ldh<D>() + c) = val;
  }
}

// c[nt] += A (the warp's 16 rows, [16][D]) . B^T (B a staged [64][D] tile)
template <int D>
__device__ __forceinline__ void warp_abt(const bf16* A, const bf16* B,
                                         float (&c)[8][4]) {
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 takes its 4 matrices' row addresses from lanes 8i .. 8i+7.
  // A: rows 0-7 / 8-15 of columns d .. d+7, then of columns d+8 .. d+15.
  const bf16* a_ptr =
      A + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldh<D>() + (lane >> 4) * 8;
  // B: rows n .. n+7 at columns d and d+8 (one 8-column tile's b0, b1),
  // then rows n+8 .. n+15 (the next tile's).
  const bf16* b_ptr =
      B + ((lane >> 4) * 8 + (lane & 7)) * ldh<D>() + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int d = 0; d < D; d += 16) {
    unsigned a[4];
    ldmatrix_x4(a, a_ptr + d);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      unsigned b[4];
      ldmatrix_x4(b, b_ptr + 16 * t * ldh<D>() + d);
      mma_bf16(c[2 * t], a, b[0], b[1]);
      mma_bf16(c[2 * t + 1], a, b[2], b[3]);
    }
  }
}

// c[nt] += P (16 x 64, as 4 A fragments) . B (a staged [64][D] tile)
template <int D>
__device__ __forceinline__ void warp_pb(const unsigned (&p)[4][4],
                                        const bf16* B,
                                        float (&c)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  // transposed: rows k .. k+7 / k+8 .. k+15 of columns n .. n+7 (one
  // tile's b0, b1), then of columns n+8 .. n+15 (the next tile's)
  const bf16* b_ptr =
      B + (((lane >> 3) & 1) * 8 + (lane & 7)) * ldh<D>() + (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int nn = 0; nn < D / 16; ++nn) {
      unsigned b[4];
      ldmatrix_x4_trans(b, b_ptr + 16 * ks * ldh<D>() + 16 * nn);
      mma_bf16(c[2 * nn], p[ks], b[0], b[1]);
      mma_bf16(c[2 * nn + 1], p[ks], b[2], b[3]);
    }
}

// The 16 x 64 accumulator tile, rounded once to bf16, as the A operand
// of the next product.
__device__ __forceinline__ void to_fragments(const float (&c)[8][4],
                                             unsigned (&p)[4][4]) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    p[ks][0] = pack_bf16(c[2 * ks][0], c[2 * ks][1]);
    p[ks][1] = pack_bf16(c[2 * ks][2], c[2 * ks][3]);
    p[ks][2] = pack_bf16(c[2 * ks + 1][0], c[2 * ks + 1][1]);
    p[ks][3] = pack_bf16(c[2 * ks + 1][2], c[2 * ks + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr size_t mma_smem_bytes(int tiles) {
  return sizeof(bf16) * static_cast<size_t>(tiles) * TILE * ldh<D>() +
         sizeof(float) * 6 * TILE;
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + TILE * ldh<D>();
  bf16* Vs = Ks + TILE * ldh<D>();
  int* qpos = reinterpret_cast<int*>(Vs + TILE * ldh<D>());
  int* qseg = qpos + TILE;
  int* kpos = qseg + TILE;
  int* kseg = kpos + TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const TileAt qt = tile_at(gridDim.x - 1 - blockIdx.x, a.block_q);
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const bool use_seg = a.q_seg != nullptr;
  const int per_k = (a.block_k + TILE - 1) / TILE;

  stage_h<D>(Qs, static_cast<const bf16*>(a.q) + bi * a.q_sb + h * a.q_sh +
                     qt.row0 * a.q_ss, a.q_ss, qt.rows);
  stage_ints(qpos, a.q_pos + bi * a.qpos_sb + qt.row0, qt.rows);
  stage_ints(qseg, use_seg ? a.q_seg + bi * a.qseg_sb + qt.row0 : nullptr,
             qt.rows);

  // the thread's two rows of the tile: warp * 16 + g and + 8
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's part
  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.f;

  const bf16* kbase = static_cast<const bf16*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  for (int kb = 0; kb < a.nk; ++kb) {
    if (!a.live[qt.block * a.nk + kb]) continue;
    for (int sub = 0; sub < per_k; ++sub) {
      const TileAt kt = tile_at(kb * per_k + sub, a.block_k);
      __syncthreads();
      stage_h<D>(Ks, kbase + kt.row0 * a.k_ss, a.k_ss, kt.rows);
      stage_h<D>(Vs, vbase + kt.row0 * a.v_ss, a.v_ss, kt.rows);
      stage_ints(kpos, a.k_pos + bi * a.kpos_sb + kt.row0, kt.rows);
      stage_ints(kseg, use_seg ? a.k_seg + bi * a.kseg_sb + kt.row0 : nullptr,
                 kt.rows);
      __syncthreads();

      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      warp_abt<D>(Qs + warp * 16 * ldh<D>(), Ks, s);

      int qp[2], qs[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        qp[hh] = qpos[warp * 16 + g + 8 * hh];
        qs[hh] = qseg[warp * 16 + g + 8 * hh];
      }
      float m_cur[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * tig + (e & 1), hh = e >> 1;
          bool ok = col < kt.rows;
          if (a.causal) ok = ok && qp[hh] >= kpos[col];
          if (use_seg) ok = ok && qs[hh] == kseg[col];
          s[nt][e] = ok ? s[nt][e] * a.scale : NEG_INF;
          m_cur[hh] = fmaxf(m_cur[hh], s[nt][e]);
        }
      float m_exp[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(m[hh], quad_max(m_cur[hh]));
        // a row that has seen nothing yet: exp(s - m_new) would be 1
        m_exp[hh] = m_new <= NEG_INF / 2 ? 0.f : m_new;
        const float corr = __expf(m[hh] - m_new);
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
          s[nt][e] = __expf(s[nt][e] - m_exp[e >> 1]);
          l[e >> 1] += s[nt][e];   // the sum is of the unrounded p
        }
      unsigned p[4][4];
      to_fragments(s, p);
      warp_pb<D>(p, Vs, o);
    }
  }

  bf16* obase = static_cast<bf16*>(a.o) + bi * a.o_sb + h * a.o_sh;
  float* lse = a.lse + (static_cast<long long>(bi) * a.hq + h) * a.sq;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp * 16 + g + 8 * hh;
    const float lsum = quad_sum(l[hh]);
    if (row >= qt.rows) continue;
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    const float inv = 1.f / l_safe;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(obase + (qt.row0 + row) * a.o_ss +
                                         8 * nt + 2 * tig) =
          __floats2bfloat162_rn(o[nt][2 * hh] * inv, o[nt][2 * hh + 1] * inv);
    if (tig == 0)
      lse[qt.row0 + row] = lsum == 0.f ? NEG_INF : m[hh] + logf(l_safe);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dq_mma_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* dOs = Qs + TILE * ldh<D>();
  bf16* Ks = dOs + TILE * ldh<D>();
  bf16* Vs = Ks + TILE * ldh<D>();
  int* qpos = reinterpret_cast<int*>(Vs + TILE * ldh<D>());
  int* qseg = qpos + TILE;
  int* kpos = qseg + TILE;
  int* kseg = kpos + TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const TileAt qt = tile_at(gridDim.x - 1 - blockIdx.x, a.block_q);
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / (a.hq / a.hkv);
  const bool use_seg = a.q_seg != nullptr;
  const int per_k = (a.block_k + TILE - 1) / TILE;

  stage_h<D>(Qs, static_cast<const bf16*>(a.q) + bi * a.q_sb + h * a.q_sh +
                     qt.row0 * a.q_ss, a.q_ss, qt.rows);
  stage_h<D>(dOs, static_cast<const bf16*>(a.dout) + bi * a.do_sb +
                      h * a.do_sh + qt.row0 * a.do_ss, a.do_ss, qt.rows);
  stage_ints(qpos, a.q_pos + bi * a.qpos_sb + qt.row0, qt.rows);
  stage_ints(qseg, use_seg ? a.q_seg + bi * a.qseg_sb + qt.row0 : nullptr,
             qt.rows);

  const long long stat = (static_cast<long long>(bi) * a.hq + h) * a.sq +
                         qt.row0;
  float lse[2], delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp * 16 + g + 8 * hh;
    const bool in = row < qt.rows;
    const float x = in ? a.lse[stat + row] : 0.f;
    lse[hh] = x <= NEG_INF / 2 ? 0.f : x;  // a row that saw nothing
    delta[hh] = in ? a.delta[stat + row] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nt][e] = 0.f;

  const bf16* kbase = static_cast<const bf16*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const bf16* vbase = static_cast<const bf16*>(a.v) + bi * a.v_sb + hk * a.v_sh;
  for (int kb = 0; kb < a.nk; ++kb) {
    if (!a.live[qt.block * a.nk + kb]) continue;
    for (int sub = 0; sub < per_k; ++sub) {
      const TileAt kt = tile_at(kb * per_k + sub, a.block_k);
      __syncthreads();
      stage_h<D>(Ks, kbase + kt.row0 * a.k_ss, a.k_ss, kt.rows);
      stage_h<D>(Vs, vbase + kt.row0 * a.v_ss, a.v_ss, kt.rows);
      stage_ints(kpos, a.k_pos + bi * a.kpos_sb + kt.row0, kt.rows);
      stage_ints(kseg, use_seg ? a.k_seg + bi * a.kseg_sb + kt.row0 : nullptr,
                 kt.rows);
      __syncthreads();

      float s[8][4], dp[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
      warp_abt<D>(Qs + warp * 16 * ldh<D>(), Ks, s);
      warp_abt<D>(dOs + warp * 16 * ldh<D>(), Vs, dp);

      int qp[2], qs[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        qp[hh] = qpos[warp * 16 + g + 8 * hh];
        qs[hh] = qseg[warp * 16 + g + 8 * hh];
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * nt + 2 * tig + (e & 1), hh = e >> 1;
          bool ok = col < kt.rows;
          if (a.causal) ok = ok && qp[hh] >= kpos[col];
          if (use_seg) ok = ok && qs[hh] == kseg[col];
          const float p = ok ? __expf(s[nt][e] * a.scale - lse[hh]) : 0.f;
          s[nt][e] = p * (dp[nt][e] - delta[hh]);     // dS
        }
      unsigned ds[4][4];
      to_fragments(s, ds);
      warp_pb<D>(ds, Ks, dq);
    }
  }

  float* out = a.dq + bi * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp * 16 + g + 8 * hh;
    if (row >= qt.rows) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(out + (qt.row0 + row) * a.dq_ss + 8 * nt +
                                 2 * tig) =
          make_float2(dq[nt][2 * hh] * a.scale, dq[nt][2 * hh + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_bwd_dkv_mma_kernel(const FlashArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE * ldh<D>();
  bf16* Qs = Vs + TILE * ldh<D>();
  bf16* dOs = Qs + TILE * ldh<D>();
  int* qpos = reinterpret_cast<int*>(dOs + TILE * ldh<D>());
  int* qseg = qpos + TILE;
  int* kpos = qseg + TILE;
  int* kseg = kpos + TILE;
  float* lse = reinterpret_cast<float*>(kseg + TILE);
  float* delta = lse + TILE;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const TileAt kt = tile_at(blockIdx.x, a.block_k);
  const int hk = blockIdx.y, bi = blockIdx.z;
  const int group = a.hq / a.hkv;
  const bool use_seg = a.q_seg != nullptr;
  const int per_q = (a.block_q + TILE - 1) / TILE;

  stage_h<D>(Ks, static_cast<const bf16*>(a.k) + bi * a.k_sb + hk * a.k_sh +
                     kt.row0 * a.k_ss, a.k_ss, kt.rows);
  stage_h<D>(Vs, static_cast<const bf16*>(a.v) + bi * a.v_sb + hk * a.v_sh +
                     kt.row0 * a.v_ss, a.v_ss, kt.rows);
  stage_ints(kpos, a.k_pos + bi * a.kpos_sb + kt.row0, kt.rows);
  stage_ints(kseg, use_seg ? a.k_seg + bi * a.kseg_sb + kt.row0 : nullptr,
             kt.rows);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const bf16* qbase = static_cast<const bf16*>(a.q) + bi * a.q_sb + h * a.q_sh;
    const bf16* dobase =
        static_cast<const bf16*>(a.dout) + bi * a.do_sb + h * a.do_sh;
    const long long stat = (static_cast<long long>(bi) * a.hq + h) * a.sq;
    for (int qb = 0; qb < a.nq; ++qb) {
      if (!a.live[qb * a.nk + kt.block]) continue;
      for (int sub = 0; sub < per_q; ++sub) {
        const TileAt qt = tile_at(qb * per_q + sub, a.block_q);
        __syncthreads();
        stage_h<D>(Qs, qbase + qt.row0 * a.q_ss, a.q_ss, qt.rows);
        stage_h<D>(dOs, dobase + qt.row0 * a.do_ss, a.do_ss, qt.rows);
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

        // transposed tiles: rows are the warp's 16 k rows, columns q rows
        float st[8][4], dpt[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
        warp_abt<D>(Ks + warp * 16 * ldh<D>(), Qs, st);
        warp_abt<D>(Vs + warp * 16 * ldh<D>(), dOs, dpt);

        int kp[2], ksg[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          kp[hh] = kpos[warp * 16 + g + 8 * hh];
          ksg[hh] = kseg[warp * 16 + g + 8 * hh];
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qcol = 8 * nt + 2 * tig + (e & 1), hh = e >> 1;
            bool ok = warp * 16 + g + 8 * hh < kt.rows && qcol < qt.rows;
            if (a.causal) ok = ok && qpos[qcol] >= kp[hh];
            if (use_seg) ok = ok && qseg[qcol] == ksg[hh];
            const float p =
                ok ? __expf(st[nt][e] * a.scale - lse[qcol]) : 0.f;
            st[nt][e] = p;
            dpt[nt][e] = p * (dpt[nt][e] - delta[qcol]);   // dS^T
          }
        unsigned frag[4][4];
        to_fragments(st, frag);
        warp_pb<D>(frag, dOs, dv);
        to_fragments(dpt, frag);
        warp_pb<D>(frag, Qs, dk);
      }
    }
  }

  float* dkp = a.dk + bi * a.dk_sb + hk * a.dk_sh;
  float* dvp = a.dv + bi * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = warp * 16 + g + 8 * hh;
    if (row >= kt.rows) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const long long at = (kt.row0 + row) * a.dk_ss + 8 * nt + 2 * tig;
      *reinterpret_cast<float2*>(dkp + at) =
          make_float2(dk[nt][2 * hh] * a.scale, dk[nt][2 * hh + 1] * a.scale);
      *reinterpret_cast<float2*>(
          dvp + (kt.row0 + row) * a.dv_ss + 8 * nt + 2 * tig) =
          make_float2(dv[nt][2 * hh], dv[nt][2 * hh + 1]);
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

// T = float: the fp32 arm on the CUDA cores; T = bf16: the tensor cores.
template <typename T, int D>
int fwd(const FlashArgs& a, void* stream) {
  dim3 grid(tiles_along(a.nq, a.block_q), a.hq, a.b);
  if constexpr (sizeof(T) == 4)
    return launch(flash_fwd_kernel<D>, a, grid, THREADS, smem_bytes<D>(3, 1),
                  stream);
  else
    return launch(flash_fwd_mma_kernel<D>, a, grid, MMA_THREADS,
                  mma_smem_bytes<D>(3), stream);
}
template <typename T, int D>
int bwd_dq(const FlashArgs& a, void* stream) {
  dim3 grid(tiles_along(a.nq, a.block_q), a.hq, a.b);
  if constexpr (sizeof(T) == 4)
    return launch(flash_bwd_dq_kernel<D>, a, grid, THREADS,
                  smem_bytes<D>(4, 1), stream);
  else
    return launch(flash_bwd_dq_mma_kernel<D>, a, grid, MMA_THREADS,
                  mma_smem_bytes<D>(4), stream);
}
template <typename T, int D>
int bwd_dkv(const FlashArgs& a, void* stream) {
  dim3 grid(tiles_along(a.nk, a.block_k), a.hkv, a.b);
  if constexpr (sizeof(T) == 4)
    return launch(flash_bwd_dkv_kernel<D>, a, grid, THREADS,
                  smem_bytes<D>(4, 2), stream);
  else
    return launch(flash_bwd_dkv_mma_kernel<D>, a, grid, MMA_THREADS,
                  mma_smem_bytes<D>(4), stream);
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
HETU_FLASH_ENTRY(hetu_flash_bwd_dq_f32, bwd_dq, float)
HETU_FLASH_ENTRY(hetu_flash_bwd_dq_bf16, bwd_dq, __nv_bfloat16)
HETU_FLASH_ENTRY(hetu_flash_bwd_dkv_f32, bwd_dkv, float)
HETU_FLASH_ENTRY(hetu_flash_bwd_dkv_bf16, bwd_dkv, __nv_bfloat16)
