// Paged attention over the serving KV pool through each slot's page
// table (gather-free): the decode step (one query token a slot) and the
// speculative verify step (C = k + 1 query tokens a slot), over exact,
// int8 or int4 pages.
//
// Replaces hetu_tpu/ops/pallas/paged_attention.py `_kernel` (:154) /
// `paged_attention` (decode) and `_verify_kernel` (:208) /
// `paged_verify` (verify), with the quantized page modes of `_load_page`
// (:137).
//   q         [S, C, nq, hd]        C query tokens a slot (decode: C = 1),
//                                   fp32, bf16 or fp16
//   k/v pool  [P, page_size, n_kv, hd_p], page 0 = the null page;
//             exact: q's type, hd_p = hd; int8: int8, hd_p = hd;
//             int4: uint8, hd_p = hd / 2, two nibbles a byte (even index
//             in the LOW nibble, value + 8)
//   k/v scale [P, page_size, n_kv] fp32 (quantized pages only): one
//             absmax scale a head vector
//   table     [S, max_pages] int32  page ids
//   positions [S] int32             query c of slot s sits at
//                                   positions[s] + c and sees global
//                                   keys 0..positions[s] + c
//   out       [S, C, nq, hd]        in q's type
// Scores in fp32, scale applied after the dot, online softmax, l == 0 ->
// 1.
//
// What bounds it on an H100: the bytes of the live pages.  Every live
// K/V row is read once for 4 * C * group flops, and quantized pages move
// 1 (int8) or 1/2 (int4) byte a value plus a 4-byte scale a row.  The
// verify step's C * group = 20 query rows a kv head (Llama-3-8B) come to
// about 20 flops a byte, the whole fp32 FMA rate at 3.35 TB/s, so bf16
// queries take S = Q K^T on the tensor cores.
//
// Design.
// * Split and merge.  The grid is (splits, n_kv * row chunks, S): block j
//   of a (slot, kv head) takes the keys [j K, (j + 1) K), K =
//   `keys_per_split` a multiple of the page size, from the host's plan
//   (ops/cuda/paged_attention.py `split_plan`: the table's width and the
//   row count alone, never `positions`, which lies on the card — reading
//   it would synchronise the host and break CUDA-graph capture).  A block
//   whose range starts past the slot's last visible key (positions[s] +
//   C - 1) exits at once, loading nothing; split 0 always runs.  With one
//   split the block writes the output; otherwise each live split writes
//   fp32 partials (each row's running max m, sum l and unnormalised
//   accumulator) to a scratch tensor the wrapper allocates, and a second
//   small kernel, launched from the same C entry point, combines the
//   live splits of each (slot, query row) in split order.  No atomics:
//   two runs give the same bits.  A row with no visible key in a split
//   keeps l = 0 and m at the finite sentinel PA_NEG, so the merge's
//   exp(m - M) is 0, never exp(-inf + inf).  K = 256 keys at up to 8 rows
//   a kv head, 128 above: at the Llama-3-8B decode shape of
//   chip_smoke.py (depths to 2,047) that is 232 live blocks for 132 SMs,
//   at its verify shape (depths to 1,100, C = 5) 344, at GPT-2-large's
//   380.  Chosen on the card (tools_paged_bench.py on trees that differ
//   in split_plan's two sizes, NVIDIA H100 80GB HBM3 at 700 W; the times
//   in PERF.md): the live blocks should fit one wave.  Exact verify is
//   the exception: its 78 KB of shared memory hold 2 blocks an SM, so
//   its 344 blocks take two waves, and 256 keys would suit it better.
// * Warps walk their own keys.  A block's 4 warps take its 16-key tiles
//   in turn (tile t to warp t % 4), each with its own online softmax and
//   its own ring of 2 or 3 shared-memory stages filled by 16-byte
//   cp.async copies (`cg`), so tile t + 1's pages are in flight while
//   tile t computes, and nothing in the key loop waits on another warp
//   (__syncwarp only).  The block's page-table rows are resolved once at
//   block start.  The warps merge once at the end, in warp order.
// * Pages are staged as stored: bf16 / fp16 as they are, int8 / int4
//   payloads as bytes, their scales beside them; int8 / int4 values are
//   widened in registers (k, nibble - 8, exact in bf16, fp16 and fp32)
//   and the key's scale multiplies its score column, the V scale its
//   probability.  The scales stay fp32.
// * Products.  16-bit queries (bf16 or fp16, one kernel body for both:
//   `mma16<T>`, `pack16<T>` of mma.cuh): S^T = K Q^T with
//   mma.sync.m16n8k16 (16-bit in, fp32 accumulate; bf16 and fp16
//   products are exact in fp32, and int8 values and nibbles - 8 are
//   exact in both types), a tile's 16 keys the M side, 8
//   query rows an n-block, a lane's k-slots mapped onto 8 contiguous
//   head dims so K and Q are read with one 16-byte (16-bit), 8-byte (int8)
//   or 4-byte (int4) load a row.  fp32 queries (the 2-layer fp32 checks)
//   take the same score layout on fp32 FMAs.  P.V stays on fp32 FMAs for
//   all (P rounded to 16 bits would break the tolerance), and o is
//   rounded once to q's type at the end: a lane owns hd /
//   32 head dims of every row of its block, P and the rows' corrections
//   reach it through the warp's own shared buffer.
// * Shared-memory layout: exact K (and 16-bit Q) rows are dense with the
//   16-byte chunk c of row r at c ^ 4 (r & 1), int8 / int4 rows padded by
//   32 / 16 bytes, fp32 Q rows by 16, so each load phase hits 32
//   distinct banks.  Head dims are padded to 64, 128 or 256 (HDP) with
//   zeros in K and Q; the template's row count RA (1, 4, 8, 16, 20, 32)
//   is the smallest that holds C * group (20: Llama-3-8B's verify),
//   and a head dim of 256 takes at most 16 rows a block (more rows run
//   as row chunks along grid y) so a lane's accumulators stay within
//   128 registers.  P reaches P.V four rows a shared-memory load.
// * Keys past positions[s] + C - 1 are never loaded: freed and null
//   pages hold stale bytes, and multiplying a masked probability by them
//   (0 * NaN) would poison the output.  A partial tile's unloaded rows
//   are masked by selection, never multiplied.
// ptxas (sm_90a, CUDA 12.8; chip_smoke.py prints every instantiation):
// decode bf16 exact / int8 / int4 at hd 128 (RA 4) 86 / 70 / 64
// registers, verify (RA 20) 168 each (exact: 4 bytes spilled), GPT's
// hd 64 decode (RA 1) 48 / 54 and int8 verify (RA 8) 64, the fp32 arm
// (RA 4) 64, the merge 48; no other spills on those paths.  Shared
// memory is dynamic (PaLayout::bytes): 70 KB for the bf16 exact decode
// block, 78 KB exact verify, 70 KB int8 verify.
// The kernels and their launch live here; each query type's symbols are
// exported by a source of their own (paged_attention_bf16.cu,
// paged_attention_f32.cu, paged_attention_f16.cu: PA_EXPORTS below), so
// the three build in parallel: one source holding all 147 entry functions took 188 s to
// build (nvcc 12.8 on the H100 machine's CPUs), 160 s more than any
// other source.
#pragma once

#include <math.h>
#include <stdint.h>

#include <atomic>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

constexpr int PA_TK = 16;           // keys a warp tile (the mma's M side)
constexpr int PA_MAX_ROWS = 32;     // query rows (C * group) a kv head
constexpr int PA_MAX_HD = 256;
constexpr int PA_MAX_SPLIT = 1024;  // keys a block (its row table)
constexpr float PA_NEG = -1e30f;
constexpr int PA_MAX_DEVICES = 64;  // devices the launch remembers

enum PageMode { PA_EXACT = 0, PA_INT8 = 1, PA_INT4 = 2 };

template <typename T, int MODE>
struct Page;
template <typename T>
struct Page<T, PA_EXACT> {
  using P = T;
};
template <typename T>
struct Page<T, PA_INT8> {
  using P = int8_t;
};
template <typename T>
struct Page<T, PA_INT4> {
  using P = uint8_t;
};

// Sizes of one instantiation: q type T, page mode, head dims padded to
// HDP, RA query rows a block.
template <typename T, int MODE, int HDP, int RA>
struct PaLayout {
  using P = typename Page<T, MODE>::P;
  static constexpr bool MMA = sizeof(T) == 2;  // bf16 or fp16 queries
  static constexpr int NB = (RA + 7) / 8;      // 8-row n-blocks of S
  static constexpr int RAP = NB * 8;           // rows the score tile holds
  static constexpr int DPL = HDP / 32;         // head dims a lane owns in P.V
  static constexpr int ROWB =
      MODE == PA_INT4 ? HDP / 2 : HDP * static_cast<int>(sizeof(P));
  static constexpr int KSTR =
      ROWB + (MODE == PA_EXACT ? 0 : MODE == PA_INT8 ? 32 : 16);
  static constexpr int VSTR = ROWB;
  static constexpr int SCB = MODE == PA_EXACT ? 0 : 2 * PA_TK * 4;
  static constexpr int STAGE = PA_TK * (KSTR + VSTR) + SCB;
  static constexpr int NS = STAGE <= 6144 ? 3 : 2;     // ring stages a warp
  static constexpr int NW = 4 * NS * STAGE <= 160 * 1024 ? 4 : 2;
  static constexpr int THREADS = NW * 32;
  static constexpr int RING = NW * NS * STAGE;
  static constexpr int MERGE = (NW - 1) * RA * HDP * 4;  // warps 1.. acc
  static constexpr int AREA = RING > MERGE ? RING : MERGE;
  static constexpr int QSTR = MMA ? HDP * 2 : HDP * 4 + 16;
  static constexpr int QB = RAP * QSTR;
  static constexpr int PB = NW * PA_TK * RAP * 4;  // a warp's P tile
  static constexpr int CB = NW * RAP * 4;          // a warp's corrections
  static constexpr int MLB = NW * RAP * 2 * 4;     // each warp's m, l
  static size_t bytes(int kps) {
    return static_cast<size_t>(AREA + QB + PB + CB + MLB) + 8u * kps;
  }
  // what a launch of PA_MAX_SPLIT keys a block asks for
  static constexpr int MAX_BYTES = AREA + QB + PB + CB + MLB + 8 * PA_MAX_SPLIT;
  static_assert(MAX_BYTES <= 227 * 1024, "more shared memory than an SM has");
};

struct PaArgs {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* positions;
  void* out;
  float* part;  // [S][n_kv][splits][R][hd] acc, then [..][R] (m, l)
  int S, C, n_kv, group, hd, ps, mp, kps, splits, chunks;
  float scale;
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float sx8(uint32_t w, int b) {  // signed byte b
  return static_cast<float>(static_cast<int>(w << (24 - 8 * b)) >> 24);
}
__device__ __forceinline__ float nib(uint32_t w, int n) {  // nibble n - 8
  return static_cast<float>(static_cast<int>((w >> (4 * n)) & 0xFu) - 8);
}

// Byte offset of 16-byte chunk c of row r in a dense swizzled row set.
__device__ __forceinline__ int swz(int r, int c, int rowb) {
  return r * rowb + ((c ^ ((r & 1) << 2)) << 4);
}

// Head dims 8 gi .. 8 gi + 7 of K row r of a stage, as four pairs of the
// 16-bit query type T (the mma's A words; int8 values and nibbles - 8
// are exact in bf16 and in fp16).
template <typename T, int MODE, int HDP, int RA>
__device__ __forceinline__ void k8_16(const unsigned char* ks, int r,
                                        int gi, uint32_t (&w)[4]) {
  using L = PaLayout<T, MODE, HDP, RA>;
  if constexpr (MODE == PA_EXACT) {
    const uint4 x = *reinterpret_cast<const uint4*>(ks + swz(r, gi, L::KSTR));
    w[0] = x.x; w[1] = x.y; w[2] = x.z; w[3] = x.w;
  } else if constexpr (MODE == PA_INT8) {
    const uint2 x =
        *reinterpret_cast<const uint2*>(ks + r * L::KSTR + 8 * gi);
    w[0] = pack16<T>(sx8(x.x, 0), sx8(x.x, 1));
    w[1] = pack16<T>(sx8(x.x, 2), sx8(x.x, 3));
    w[2] = pack16<T>(sx8(x.y, 0), sx8(x.y, 1));
    w[3] = pack16<T>(sx8(x.y, 2), sx8(x.y, 3));
  } else {
    const uint32_t x =
        *reinterpret_cast<const uint32_t*>(ks + r * L::KSTR + 4 * gi);
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = pack16<T>(nib(x, 2 * i), nib(x, 2 * i + 1));
  }
}

// The same dims as fp32 (the fp32-query arm).
template <typename T, int MODE, int HDP, int RA>
__device__ __forceinline__ void k8_f32(const unsigned char* ks, int r, int gi,
                                       float (&k)[8]) {
  using L = PaLayout<T, MODE, HDP, RA>;
  if constexpr (MODE == PA_EXACT) {
    const float4 a =
        *reinterpret_cast<const float4*>(ks + swz(r, 2 * gi, L::KSTR));
    const float4 b =
        *reinterpret_cast<const float4*>(ks + swz(r, 2 * gi + 1, L::KSTR));
    k[0] = a.x; k[1] = a.y; k[2] = a.z; k[3] = a.w;
    k[4] = b.x; k[5] = b.y; k[6] = b.z; k[7] = b.w;
  } else if constexpr (MODE == PA_INT8) {
    const uint2 x =
        *reinterpret_cast<const uint2*>(ks + r * L::KSTR + 8 * gi);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      k[b] = sx8(x.x, b);
      k[4 + b] = sx8(x.y, b);
    }
  } else {
    const uint32_t x =
        *reinterpret_cast<const uint32_t*>(ks + r * L::KSTR + 4 * gi);
#pragma unroll
    for (int n = 0; n < 8; ++n) k[n] = nib(x, n);
  }
}

// Head dims lane * DPL .. + DPL - 1 of V row j of a stage, as fp32
// (quantized: the payload value; its scale multiplies P).
template <typename T, int MODE, int HDP, int RA>
__device__ __forceinline__ void v_row(const unsigned char* vs, int j,
                                      int lane,
                                      float (&v)[PaLayout<T, MODE, HDP, RA>::DPL]) {
  using L = PaLayout<T, MODE, HDP, RA>;
  constexpr int DPL = L::DPL;
  const unsigned char* row = vs + j * L::VSTR;
  if constexpr (MODE == PA_EXACT) {
    const T* x = reinterpret_cast<const T*>(row) + lane * DPL;
    if constexpr (sizeof(T) == 2) {
      if constexpr (DPL == 2) {
        const float2 f = unpack16x2<T>(*reinterpret_cast<const uint32_t*>(x));
        v[0] = f.x; v[1] = f.y;
      } else {
#pragma unroll
        for (int i = 0; i < DPL; i += 4) {
          const uint2 u = *reinterpret_cast<const uint2*>(x + i);
          const float2 a = unpack16x2<T>(u.x);
          const float2 b = unpack16x2<T>(u.y);
          v[i] = a.x; v[i + 1] = a.y; v[i + 2] = b.x; v[i + 3] = b.y;
        }
      }
    } else {
      if constexpr (DPL == 2) {
        const float2 f = *reinterpret_cast<const float2*>(x);
        v[0] = f.x; v[1] = f.y;
      } else {
#pragma unroll
        for (int i = 0; i < DPL; i += 4) {
          const float4 f = *reinterpret_cast<const float4*>(x + i);
          v[i] = f.x; v[i + 1] = f.y; v[i + 2] = f.z; v[i + 3] = f.w;
        }
      }
    }
  } else if constexpr (MODE == PA_INT8) {
    const unsigned char* x = row + lane * DPL;
    if constexpr (DPL == 2) {
      const uint32_t u = *reinterpret_cast<const unsigned short*>(x);
      v[0] = sx8(u, 0); v[1] = sx8(u, 1);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; i += 4) {
        const uint32_t u = *reinterpret_cast<const uint32_t*>(x + i);
#pragma unroll
        for (int b = 0; b < 4; ++b) v[i + b] = sx8(u, b);
      }
    }
  } else {
    const unsigned char* x = row + lane * DPL / 2;
    uint32_t u;
    if constexpr (DPL == 2) u = *x;
    else if constexpr (DPL == 4) u = *reinterpret_cast<const unsigned short*>(x);
    else u = *reinterpret_cast<const uint32_t*>(x);
#pragma unroll
    for (int n = 0; n < DPL; ++n) v[n] = nib(u, n);
  }
}

// The split kernel: one block a (split, kv head x row chunk, slot).
template <typename T, int MODE, int HDP, int RA>
__global__ void __launch_bounds__(PaLayout<T, MODE, HDP, RA>::THREADS)
    paged_split_kernel(const PaArgs a) {
  using L = PaLayout<T, MODE, HDP, RA>;
  constexpr int NW = L::NW, NS = L::NS, NB = L::NB, RAP = L::RAP;
  constexpr int DPL = L::DPL;
  constexpr bool QUANT = MODE != PA_EXACT;

  const int j = blockIdx.x;
  const int h = blockIdx.y / a.chunks;
  const int r0 = (blockIdx.y - h * a.chunks) * RA;  // the block's first row
  const int s = blockIdx.z;
  const int R = a.C * a.group;
  const int rows = min(RA, R - r0);
  const int pos = a.positions[s];
  // keys at global positions 0..pos + C - 1, never past the table
  const int n_keys = min(pos + a.C, a.mp * a.ps);
  const int k0 = j * a.kps;
  // an empty split exits before it loads anything (its block frees its
  // SM slot at once: most of a verify grid's blocks are empty)
  if (j > 0 && k0 >= n_keys) return;
  const int k1 = max(k0, min(k0 + a.kps, n_keys));

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* area = smem;                      // ring, then merge
  unsigned char* q_s = area + L::AREA;             // [RAP][QSTR]
  float* p_all = reinterpret_cast<float*>(q_s + L::QB);  // [NW][TK][RAP]
  float* corr_all = p_all + NW * PA_TK * RAP;            // [NW][RAP]
  float* ml_s = corr_all + NW * RAP;                     // [NW][RAP][2]
  long long* rows_s = reinterpret_cast<long long*>(ml_s + NW * RAP * 2);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2, tig = lane & 3;
  const int nq = a.n_kv * a.group;

  // 1. each key's pool row through the page table, once
  for (int i = tid; i < k1 - k0; i += L::THREADS) {
    const int key = k0 + i;
    const long long page = a.table[static_cast<long long>(s) * a.mp + key / a.ps];
    rows_s[i] = (page * a.ps + key % a.ps) * a.n_kv + h;
  }
  // 2. the block's query rows (row r = c * group + g': token c, q head
  //    h * group + g'), zero past its rows and head dim
  for (int i = tid; i < RAP * HDP; i += L::THREADS) {
    const int rr = i / HDP, d = i - rr * HDP;
    float x = 0.0f;
    if (rr < rows && d < a.hd) {
      const int r = r0 + rr, c = r / a.group, gg = r - c * a.group;
      x = to_f32(static_cast<const T*>(a.q)[
          ((static_cast<long long>(s) * a.C + c) * nq + h * a.group + gg) *
              a.hd + d]);
    }
    if constexpr (L::MMA) {
      *reinterpret_cast<T*>(q_s + swz(rr, d >> 3, L::QSTR) + 2 * (d & 7)) =
          from_f32<T>(x);
    } else {
      reinterpret_cast<float*>(q_s + rr * L::QSTR)[d] = x;
    }
  }
  // K's padded head dims must hold zeros (Q's are zero; 0 * NaN is not)
  if (a.hd < HDP)
    for (int i = tid; i < L::RING / 16; i += L::THREADS)
      reinterpret_cast<uint4*>(area)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // each lane's score rows 8 nb + 2 tig + e and their last visible key
  int lim[NB][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rr = 8 * nb + 2 * tig + e;
      lim[nb][e] = rr < rows ? pos + (r0 + rr) / a.group : -1;
    }
  float m[NB][2], l[NB][2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    m[nb][0] = m[nb][1] = PA_NEG;
    l[nb][0] = l[nb][1] = 0.0f;
  }
  float acc[RA][DPL];
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[r][d] = 0.0f;

  unsigned char* ring = area + warp * NS * L::STAGE;
  float* p_s = p_all + warp * PA_TK * RAP;
  float* corr_s = corr_all + warp * RAP;
  const int hd_bytes = MODE == PA_INT4 ? a.hd / 2
                                       : a.hd * static_cast<int>(sizeof(typename L::P));
  const int cpr = hd_bytes / 16;  // 16-byte chunks a pool row
  const unsigned char* kp = static_cast<const unsigned char*>(a.k_pool);
  const unsigned char* vp = static_cast<const unsigned char*>(a.v_pool);

  // the warp's tiles: t = warp, warp + NW, ...
  const int nt = (k1 - k0 + PA_TK - 1) / PA_TK;
  const int mine = warp < nt ? (nt - 1 - warp) / NW + 1 : 0;
  auto issue = [&](int it) {
    const int t = warp + it * NW;
    unsigned char* st = ring + (it % NS) * L::STAGE;
    const int kt0 = t * PA_TK;  // within the split
    const int nk = min(PA_TK, k1 - k0 - kt0);
    for (int i = lane; i < nk * cpr; i += 32) {
      const int jj = i / cpr, c = i - jj * cpr;
      const long long off = rows_s[kt0 + jj] * hd_bytes + 16 * c;
      const int kd = MODE == PA_EXACT ? swz(jj, c, L::KSTR)
                                      : jj * L::KSTR + 16 * c;
      hopper::cp_async16(hopper::smem_u32(st + kd), kp + off, true);
      hopper::cp_async16(
          hopper::smem_u32(st + PA_TK * L::KSTR + jj * L::VSTR + 16 * c),
          vp + off, true);
    }
    if constexpr (QUANT) {
      float* sc = reinterpret_cast<float*>(st + PA_TK * (L::KSTR + L::VSTR));
      if (lane < nk) {
        const long long row = rows_s[kt0 + lane];
        hopper::cp_async4(hopper::smem_u32(sc + lane), a.k_scale + row, true);
        hopper::cp_async4(hopper::smem_u32(sc + PA_TK + lane),
                          a.v_scale + row, true);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < mine) issue(i);
    cp_async_commit();
  }
  for (int it = 0; it < mine; ++it) {
    if (it + NS - 1 < mine) issue(it + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncwarp();

    const unsigned char* st = ring + (it % NS) * L::STAGE;
    const unsigned char* ks = st;
    const unsigned char* vs = st + PA_TK * L::KSTR;
    const float* ksc = reinterpret_cast<const float*>(vs + PA_TK * L::VSTR);
    const float* vsc = ksc + PA_TK;
    const int kt0 = k0 + (warp + it * NW) * PA_TK;  // global key of row 0
    const int nk = min(PA_TK, k1 - kt0);

    // scores: sc[nb][e] holds key g + 8 (e >> 1), row 8 nb + 2 tig + (e & 1)
    float sc[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.0f;
    if constexpr (L::MMA) {
#pragma unroll
      for (int kq = 0; kq < HDP / 32; ++kq) {
        const int gi = 4 * kq + tig;  // this lane's 8 head dims
        uint32_t ka[4], kb[4];
        k8_16<T, MODE, HDP, RA>(ks, g, gi, ka);
        k8_16<T, MODE, HDP, RA>(ks, g + 8, gi, kb);
        const unsigned a0[4] = {ka[0], kb[0], ka[1], kb[1]};
        const unsigned a1[4] = {ka[2], kb[2], ka[3], kb[3]};
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const uint4 qw = *reinterpret_cast<const uint4*>(
              q_s + swz(8 * nb + g, gi, L::QSTR));
          mma16<T>(sc[nb], a0, qw.x, qw.y);
          mma16<T>(sc[nb], a1, qw.z, qw.w);
        }
      }
    } else {
#pragma unroll 2
      for (int gi = 0; gi < HDP / 8; ++gi) {
        float ka[8], kb[8];
        k8_f32<T, MODE, HDP, RA>(ks, g, gi, ka);
        k8_f32<T, MODE, HDP, RA>(ks, g + 8, gi, kb);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* qr = reinterpret_cast<const float*>(
                q_s + (8 * nb + 2 * tig + e) * L::QSTR) + 8 * gi;
            const float4 x0 = *reinterpret_cast<const float4*>(qr);
            const float4 x1 = *reinterpret_cast<const float4*>(qr + 4);
            const float qv[8] = {x0.x, x0.y, x0.z, x0.w,
                                 x1.x, x1.y, x1.z, x1.w};
#pragma unroll
            for (int d = 0; d < 8; ++d) {
              sc[nb][e] = fmaf(qv[d], ka[d], sc[nb][e]);
              sc[nb][e + 2] = fmaf(qv[d], kb[d], sc[nb][e + 2]);
            }
          }
      }
    }

    // mask (by selection: a partial tile's unloaded rows hold stale
    // bytes), then the online softmax of each row over the tile's keys;
    // a quantized key's scale multiplies its score column
    float ksk[2] = {1.0f, 1.0f};
    if constexpr (QUANT) {
      ksk[0] = ksc[g];
      ksk[1] = ksc[g + 8];
    }
    bool ok[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt0 + g + 8 * (e >> 1);
        ok[nb][e] = key < k1 && key <= lim[nb][e & 1];
        const float x = QUANT ? (sc[nb][e] * ksk[e >> 1]) * a.scale
                              : sc[nb][e] * a.scale;
        sc[nb][e] = ok[nb][e] ? x : PA_NEG;
      }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(sc[nb][e], sc[nb][e + 2]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[nb][e], mx);
        const float p0 = ok[nb][e] ? expf(sc[nb][e] - m_new) : 0.0f;
        const float p1 = ok[nb][e + 2] ? expf(sc[nb][e + 2] - m_new) : 0.0f;
        float sum = p0 + p1;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, o);
        const float corr = expf(m[nb][e] - m_new);
        l[nb][e] = l[nb][e] * corr + sum;
        m[nb][e] = m_new;
        const int rr = 8 * nb + 2 * tig + e;
        p_s[g * RAP + rr] = p0;
        p_s[(g + 8) * RAP + rr] = p1;
        if (g == 0) corr_s[rr] = corr;
      }
    __syncwarp();

    // acc = acc * corr + P . V over this lane's head dims
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const float c = corr_s[r];
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r][d] *= c;
    }
#pragma unroll 2
    for (int jj = 0; jj < nk; ++jj) {
      float v[DPL];
      v_row<T, MODE, HDP, RA>(vs, jj, lane, v);
      // key jj's probabilities, four rows a load (a broadcast)
      float pr[RA];
      if constexpr (RA % 4 == 0) {
#pragma unroll
        for (int r = 0; r < RA; r += 4) {
          const float4 x = *reinterpret_cast<const float4*>(p_s + jj * RAP + r);
          pr[r] = x.x; pr[r + 1] = x.y; pr[r + 2] = x.z; pr[r + 3] = x.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RA; ++r) pr[r] = p_s[jj * RAP + r];
      }
      const float vsj = QUANT ? vsc[jj] : 1.0f;
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const float w = QUANT ? pr[r] * vsj : pr[r];
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[r][d] = fmaf(w, v[d], acc[r][d]);
      }
    }
    __syncwarp();  // the slot and p_s are refilled next
  }
  cp_async_wait<0>();

  // 3. merge the warps in warp order: warps 1.. hand their state over in
  //    shared memory (the ring is dead), warp 0 combines and writes
  if (g == 0)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rr = 8 * nb + 2 * tig + e;
        ml_s[(warp * RAP + rr) * 2] = m[nb][e];
        ml_s[(warp * RAP + rr) * 2 + 1] = l[nb][e];
      }
  __syncthreads();
  float* mrg = reinterpret_cast<float*>(area);  // [NW - 1][RA][HDP]
  if (warp > 0)
#pragma unroll
    for (int r = 0; r < RA; ++r)
#pragma unroll
      for (int d = 0; d < DPL; ++d)
        mrg[((warp - 1) * RA + r) * HDP + lane * DPL + d] = acc[r][d];
  __syncthreads();
  if (warp != 0) return;

  const bool direct = a.splits == 1;
  const long long unit = (static_cast<long long>(s) * a.n_kv + h) * a.splits + j;
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    if (r >= rows) break;
    float M = PA_NEG;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, ml_s[(w * RAP + r) * 2]);
    float Lsum = 0.0f, f[NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      f[w] = expf(ml_s[(w * RAP + r) * 2] - M);
      Lsum += ml_s[(w * RAP + r) * 2 + 1] * f[w];
    }
    float o[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      o[d] = acc[r][d] * f[0];
#pragma unroll
      for (int w = 1; w < NW; ++w)
        o[d] = fmaf(mrg[((w - 1) * RA + r) * HDP + lane * DPL + d], f[w], o[d]);
    }
    const int rg = r0 + r;  // the row among the kv head's C * group
    if (direct) {
      const int c = rg / a.group, gg = rg - c * a.group;
      T* orow = static_cast<T*>(a.out) +
                ((static_cast<long long>(s) * a.C + c) * nq + h * a.group + gg) *
                    a.hd;
      const float inv = 1.0f / (Lsum == 0.0f ? 1.0f : Lsum);
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        const int dd = lane * DPL + d;
        if (dd < a.hd) orow[dd] = from_f32<T>(o[d] * inv);
      }
    } else {
      float* pacc = a.part + (unit * R + rg) * a.hd;
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        const int dd = lane * DPL + d;
        if (dd < a.hd) pacc[dd] = o[d];
      }
      if (lane == 0)
        reinterpret_cast<float2*>(
            a.part + static_cast<long long>(a.S) * a.n_kv * a.splits * R *
                         a.hd)[unit * R + rg] = make_float2(M, Lsum);
    }
  }
}

// The merge: a warp a (query row, kv head, slot) combines the row's live
// splits in split order.  Lane j reads split j's (m, l) (32 at a time),
// so the row's max takes one round of loads; then every lane walks the
// splits in order, scaling the accumulators of its 4 head dims (a float4
// a 128-dim step) by exp(m_j - M), several splits' loads in flight.
constexpr int PA_MERGE_WARPS = 4;

template <typename T>
__global__ void __launch_bounds__(PA_MERGE_WARPS * 32)
    paged_merge_kernel(const PaArgs a) {
  const int lane = threadIdx.x & 31;
  const int R = a.C * a.group, nq = a.n_kv * a.group;
  const int r = blockIdx.x * PA_MERGE_WARPS + (threadIdx.x >> 5);
  const int h = blockIdx.y, s = blockIdx.z;
  if (r >= R) return;
  const int n_keys = min(a.positions[s] + a.C, a.mp * a.ps);
  const int live = max(1, min(a.splits, (n_keys + a.kps - 1) / a.kps));
  const long long unit0 = (static_cast<long long>(s) * a.n_kv + h) * a.splits;
  const float4* acc = reinterpret_cast<const float4*>(
      a.part + (unit0 * R + r) * a.hd);  // split j at + j * R * hd / 4
  const float2* ml = reinterpret_cast<const float2*>(
                         a.part + static_cast<long long>(a.S) * a.n_kv *
                                      a.splits * R * a.hd) +
                     unit0 * R + r;  // split j at + j * R
  float M = PA_NEG;
  for (int j = lane; j < live; j += 32) M = fmaxf(M, ml[j * R].x);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  const int steps = a.hd / 4;  // float4s a row
  const long long jstride = static_cast<long long>(R) * steps;
  float Lsum = 0.0f;
  float4 o[2] = {make_float4(0.f, 0.f, 0.f, 0.f), make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll 4
  for (int j = 0; j < live; ++j) {
    const float2 mj = ml[j * R];
    const float f = expf(mj.x - M);
    Lsum = fmaf(mj.y, f, Lsum);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int i = lane + 32 * k;
      if (i < steps) {
        const float4 x = acc[j * jstride + i];
        o[k].x = fmaf(x.x, f, o[k].x);
        o[k].y = fmaf(x.y, f, o[k].y);
        o[k].z = fmaf(x.z, f, o[k].z);
        o[k].w = fmaf(x.w, f, o[k].w);
      }
    }
  }
  const float inv = 1.0f / (Lsum == 0.0f ? 1.0f : Lsum);
  const int c = r / a.group, gg = r - c * a.group;
  T* orow = static_cast<T*>(a.out) +
            ((static_cast<long long>(s) * a.C + c) * nq + h * a.group + gg) *
                a.hd;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int i = lane + 32 * k;
    if (i < steps) {
      orow[4 * i] = from_f32<T>(o[k].x * inv);
      orow[4 * i + 1] = from_f32<T>(o[k].y * inv);
      orow[4 * i + 2] = from_f32<T>(o[k].z * inv);
      orow[4 * i + 3] = from_f32<T>(o[k].w * inv);
    }
  }
}

template <typename T, int MODE, int HDP, int RA>
static int launch_as(PaArgs a, void* stream) {
  using L = PaLayout<T, MODE, HDP, RA>;
  auto kernel = paged_split_kernel<T, MODE, HDP, RA>;
  // Allow each instantiation the most any split size asks for, once a
  // device: the driver call stays off the per-launch path.
  static std::atomic<bool> allowed[PA_MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= PA_MAX_DEVICES || !allowed[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::MAX_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < PA_MAX_DEVICES) allowed[dev].store(true, std::memory_order_release);
  }
  const size_t smem = L::bytes(a.kps);
  a.chunks = (a.C * a.group + RA - 1) / RA;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(a.splits, a.n_kv * a.chunks, a.S), L::THREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const int R = a.C * a.group;
  paged_merge_kernel<T><<<dim3((R + PA_MERGE_WARPS - 1) / PA_MERGE_WARPS,
                               a.n_kv, a.S),
                          PA_MERGE_WARPS * 32, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE, int HDP>
static int launch_rows(const PaArgs& a, void* stream) {
  const int rows = a.C * a.group;
  if (rows <= 1) return launch_as<T, MODE, HDP, 1>(a, stream);
  if (rows <= 4) return launch_as<T, MODE, HDP, 4>(a, stream);
  if (rows <= 8) return launch_as<T, MODE, HDP, 8>(a, stream);
  if (HDP > 128 || rows <= 16) return launch_as<T, MODE, HDP, 16>(a, stream);
  if constexpr (HDP <= 128) {
    if (rows <= 20) return launch_as<T, MODE, HDP, 20>(a, stream);
    return launch_as<T, MODE, HDP, 32>(a, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int MODE>
static int launch(const void* q, const void* k_pool, const void* v_pool,
                  const void* k_scale, const void* v_scale, const void* table,
                  const void* positions, void* out, int S, int C, int n_kv,
                  int group, int hd, int ps, int mp, float scale, void* part,
                  int kps, void* stream) {
  using P = typename Page<T, MODE>::P;
  const int hd_p = MODE == PA_INT4 ? hd / 2 : hd;
  // 16-byte copies need every page row to start on a 16-byte boundary
  if (C < 1 || group < 1 || C * group > PA_MAX_ROWS || hd < 1 ||
      hd > PA_MAX_HD || (MODE == PA_INT4 && hd % 2) || ps < 1 || mp < 1 ||
      (hd_p * sizeof(P)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0 ||
      (MODE != PA_EXACT && (k_scale == nullptr || v_scale == nullptr)) ||
      kps < 1 || kps > PA_MAX_SPLIT || kps % ps != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 0) return 0;
  PaArgs a;
  a.q = q; a.k_pool = k_pool; a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.table = static_cast<const int*>(table);
  a.positions = static_cast<const int*>(positions);
  a.out = out;
  a.part = static_cast<float*>(part);
  a.S = S; a.C = C; a.n_kv = n_kv; a.group = group; a.hd = hd; a.ps = ps;
  a.mp = mp; a.kps = kps; a.chunks = 1; a.scale = scale;
  // the split count from the table's width alone (never from positions)
  a.splits = static_cast<int>((static_cast<long long>(mp) * ps + kps - 1) / kps);
  if (a.splits > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 64) return launch_rows<T, MODE, 64>(a, stream);
  if (hd <= 128) return launch_rows<T, MODE, 128>(a, stream);
  return launch_rows<T, MODE, 256>(a, stream);
}

// One exported entry point: query type T over pages of MODE.  `part` is
// the wrapper's fp32 scratch for the splits' partials (null when one
// split covers the table), `kps` the keys a split; the decode step
// passes C = 1.
#define PA_EXPORT(T, MODE, name)                                            \
  HETU_EXPORT int name(                                                     \
      const void* q, const void* k_pool, const void* v_pool,                \
      const void* k_scale, const void* v_scale, const void* table,          \
      const void* positions, void* out, int S, int C, int n_kv, int group,  \
      int hd, int ps, int mp, float scale, void* part, int kps,             \
      void* stream) {                                                       \
    return launch<T, MODE>(q, k_pool, v_pool, k_scale, v_scale, table,      \
                           positions, out, S, C, n_kv, group, hd, ps, mp,   \
                           scale, part, kps, stream);                       \
  }

// A query type's three symbols, one a page mode:
// hetu_paged_attention{,_int8,_int4}<sfx>.
#define PA_EXPORTS(T, sfx)                                  \
  PA_EXPORT(T, PA_EXACT, hetu_paged_attention##sfx)         \
  PA_EXPORT(T, PA_INT8, hetu_paged_attention_int8##sfx)     \
  PA_EXPORT(T, PA_INT4, hetu_paged_attention_int4##sfx)
