// The device body of bf16 attention for Hopper (sm_90a): one thread block
// computes softmax(q·kᵀ)·v for one (batch, head) and one tile of queries, with
// the online softmax carried in registers.
//
//   - both products run on the tensor cores as warpgroup MMAs (wgmma
//     m64n64k16, bf16 operands, fp32 accumulators): four warps issue one
//     asynchronous product of a 64-query tile; a block holds two warpgroups,
//     so 128 queries share every K/V tile that is brought in;
//   - the score tile S lives in the accumulator registers only. In that
//     layout a row's values lie in the four lanes of a quad, so the row max is
//     two __shfl_xor_sync steps; the row sum of the rounded p is taken by
//     the tensor cores (p times a column of ones, beside p·v);
//   - p = bf16(exp2(s − m)) is packed in registers straight into the A operand
//     of the P·V product (the accumulator layout of two neighbouring 16 x 8
//     score tiles is the A layout of one 16 x 16 step). P never touches shared
//     memory. Q is held as A fragments in registers too (read once with
//     ldmatrix), so the scores' product reads only K from shared memory;
//   - K and V tiles of 64 keys travel through a ring of kStages shared-memory
//     slots filled by cp.async (16 bytes a thread), three tiles ahead of the
//     one being multiplied, with one __syncthreads() per tile;
//   - tiles are stored unpadded (128-byte rows) with their 16-byte chunks
//     XOR-swizzled by the row: the 128-byte-swizzle layout that wgmma's matrix
//     descriptors name (8-row groups 1024 bytes apart). K is the K-major B
//     operand of S as it lies ([key][d]); V, which lies [key][d] too, is the B
//     operand of P·V through the descriptor's transpose bit;
//   - inside a warpgroup the products and the softmax take turns: the scores
//     of tile i + 1 and P_i·V_i are issued together and waited for together,
//     then the softmax of tile i + 1 runs as one pass (max, exp2, pack). The
//     tensor cores are kept busy by the SM's other warpgroups, four of them at
//     two blocks an SM. Taking the exp2 beside the running P·V and packing p
//     after it (p's registers are read until the product is done) was measured
//     and is slower, 0.69 against 0.58 ms: the pass is bound by the
//     special-function unit and by instruction issue, and splitting it costs
//     more than the overlap brings.
//
// Semantics: softmax over keys < n_valid only (later keys are masked with
// −inf before the max; their V rows are zero-filled, so 0·v stays 0); no
// clamp of the max; p is rounded to bf16 before P·V and the row sum adds the
// rounded values; the output is bf16(acc · 1/l). Tile 0 always holds key 0, so
// the running max is finite after the first tile and exp2(−inf − m) is 0, not
// NaN; tiles must be walked from 0 upward for that to hold.
//
// RoPE (rope_rotate, for K1's RoPE mode in rope_attention.cu, which runs this
// file's pieces at head dim 128): DINOv3's axial rotation of the patch rows
// of q and k, x' = x·cos + rotate_half(x)·sin with rotate_half([x1 | x2]) =
// [−x2 | x1], in fp32 from bf16 and rounded once to bf16, products and sum
// each rounded as PyTorch's fp32 ops round them. Rows < prefix (CLS,
// registers) are left alone; patch p = row − prefix sits at grid row p / w,
// column p % w. Dims d and d + 64 share one angle: of the 64 angles the
// first 32 are the grid row's, the next 32 the column's, so the table is
// (2, h + w, 32) fp32 (cos, then sin; rows 0..h−1 by grid row, h.. by
// column), held in shared memory. A row of 256 bytes is held as two 128-byte
// sub-tiles (dims 0-63, 64-127) of the swizzled layout; one call turns chunk
// c of both.
//
// Template parameters: kMax = carry the row max (false: p = exp2(s), for
// callers whose scores are known to be small); kPreScaled = q already holds
// the factor 1/sqrt(hd)·log2(e), so s is in the exp2 domain as it comes out of
// the product (false: the factor is applied in fp32, in the same FMA that
// subtracts the max, and q stays unrounded); kFloorSum = the row sum is held
// at >= 1e-38 before the division (K3's twin does so).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "async_copy.cuh"
#include "wgmma_common.cuh"

namespace attention_core {

using async_copy::cp_async16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;
using wgmma_common::fence_proxy_async;
using wgmma_common::pack_bf16;
using wgmma_common::pin;
using wgmma_common::swz;
using wgmma_common::tile_desc;
using wgmma_common::wgmma_commit;
using wgmma_common::wgmma_fence;
using wgmma_common::wgmma_wait;

typedef __nv_bfloat16 bf16;

constexpr int kHd = 64;      // head dim of every DINO / DINOv2 arch (K1, K3)
constexpr int kBk = 64;      // keys per tile
constexpr int kStages = 4;   // K/V ring depth: copies run three tiles ahead
constexpr int kSubBytes = kBk * 128;  // one 64-row sub-tile of 128-byte rows: 8 KB

constexpr int kWg = 2;       // warpgroups per block: 128 queries share every K/V tile brought in
constexpr int kThreads = 128 * kWg;
constexpr int kBlockRows = 64 * kWg;
constexpr int kOnesBytes = 1024;  // a B operand of ones: the row sums of p come from the tensor cores
constexpr int kRopeAngles = 32;   // a grid axis's angles at head dim 128

// a block's shared memory: Q, the K/V ring, the ones
constexpr int kSmemBytes = kBlockRows * kHd * 2 + kStages * 2 * kBk * kHd * 2 + kOnesBytes;

// RoPE: the table in device memory and where its rows apply
struct Rope {
  const float* table;  // (2, grid_h + grid_w, kRopeAngles) fp32, 16-byte aligned
  int prefix, grid_h, grid_w;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// 2^x by the special-function unit alone (ex2.approx: 2 ulp over the whole
// range; results below 2^-126 flush to 0). x <= 0 here, so nothing overflows.
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The pieces below work on one 16-row tile of queries as a warp holds it in
// MMA fragments: thread (g = lane / 4, t = lane % 4) holds, of column tile j
// (8 keys or 8 dims), elements 0, 1 = row g, columns 2t, 2t + 1 and elements
// 2, 3 = row g + 8, the same columns. mma.sync m16n8k16 and a warp's share
// of wgmma m64nNk16 both lay their accumulators out so.

// Keys >= n_valid leave the softmax: -inf before the max. key0 = the tile's
// first key + 2t.
__device__ __forceinline__ void mask_tail(float (&s)[8][4], int key0, int n_valid) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (key0 + 8 * j + (e & 1) >= n_valid) s[j][e] = -CUDART_INF_F;
}

// One online-softmax step on a 16 x 64 score tile: new row max (two shuffles
// over the quad), the factor alpha = exp2(old max - new max) by which the
// output and row-sum accumulators must be rescaled (rescale), and p =
// bf16(exp2(s - max)) packed as the four A fragments of the P·V product (key
// step kk: a0, a1 = rows g, g + 8 of column tile 2kk; a2, a3 of 2kk + 1). pf
// may only be written once the product that reads the previous p has finished.
template <bool kMax, bool kPreScaled>
__device__ __forceinline__ void softmax_step(const float (&s)[8][4], float (&m)[2],
                                             float (&alpha)[2], uint32_t (&pf)[4][4],
                                             float scale_log2) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // row g + 8h: elements 2h, 2h + 1 of each tile
    float shift = 0.f;           // the max in the exp2 domain
    alpha[h] = 1.f;
    if (kMax) {
      float mx = m[h];
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      shift = kPreScaled ? mx : mx * scale_log2;
      alpha[h] = exp2_fast(kPreScaled ? m[h] - mx : (m[h] - mx) * scale_log2);
      m[h] = mx;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 =
          exp2_fast(kPreScaled ? s[j][2 * h] - shift : fmaf(s[j][2 * h], scale_log2, -shift));
      const float p1 = exp2_fast(kPreScaled ? s[j][2 * h + 1] - shift
                                            : fmaf(s[j][2 * h + 1], scale_log2, -shift));
      pf[j >> 1][(j & 1) * 2 + h] = pack_bf16(p0, p1);
    }
  }
}

// acc (each 64-dim sub-tile's) and the row sums: rows g, g + 8 times
// alpha[0], alpha[1]
template <int kSub>
__device__ __forceinline__ void rescale(float (&acc)[kSub][8][4], float (&lsum)[4],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[u][j][0] *= alpha[0];
      acc[u][j][1] *= alpha[0];
      acc[u][j][2] *= alpha[1];
      acc[u][j][3] *= alpha[1];
    }
  lsum[0] *= alpha[0];
  lsum[1] *= alpha[0];
  lsum[2] *= alpha[1];
  lsum[3] *= alpha[1];
}

// out rows = bf16(acc · 1/l), l = the row sums as the tensor cores took them
// (lsum: every column of the 16 x 8 tile holds its row's sum). row0 = the
// tile's first query; rows >= n_q are not stored. kFloorSum: l is held at
// >= 1e-38, so a row whose every p underflowed (l = 0, no row max) gives 0 and
// not 0 · inf.
template <bool kFloorSum>
__device__ __forceinline__ void store_rows(const float (&acc)[8][4], const float (&lsum)[4],
                                           bf16* o, int64_t ldo, int row0, int n_q, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = 1.f / (kFloorSum ? fmaxf(lsum[2 * h], 1e-38f) : lsum[2 * h]);
    const int row = row0 + g + 8 * h;
    if (row < n_q) {
      bf16* orow = o + (int64_t)row * ldo + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(acc[j][2 * h] * inv, acc[j][2 * h + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma: the instruction (descriptor and fences: wgmma_common.cuh)
// ---------------------------------------------------------------------------

#define VITTF_ACC4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define VITTF_ACC32                                                                       \
  VITTF_ACC4(0), VITTF_ACC4(1), VITTF_ACC4(2), VITTF_ACC4(3), VITTF_ACC4(4), VITTF_ACC4(5), \
      VITTF_ACC4(6), VITTF_ACC4(7)
#define VITTF_D32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x 64, this thread's share) = a·b (+ d if accumulate): a = this
// thread's A fragment in registers, 16 deep; b in shared memory, either 64 rows
// of a [n][k] tile, k contiguous (kTransB = false), or 16 rows of a [k][n]
// tile, n contiguous, read transposed (kTransB = true)
template <bool kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " VITTF_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : VITTF_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(kTransB ? 1 : 0));
}
// d (64 x 8, this thread's share) += a·b: b = 8 rows of 16 bf16 in shared
// memory. Used with b all ones, so every column of d gathers the row sums of a.
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef VITTF_ACC4
#undef VITTF_ACC32
#undef VITTF_D32

// RoPE: rotate in place a row pair (chunk c of both 128-byte sub-tiles of
// row `row` of a tile of `sub_bytes` a sub-tile),
// whose index in the (batch, head) is `abs_row`, unless it is a prefix row
// or lies past n_valid (the zeros of a ragged tile). `tab`: the table in
// shared memory (see the header).
__device__ __forceinline__ void rope_rotate(unsigned char* tile, int sub_bytes, int row,
                                            int chunk, int abs_row, int n_valid,
                                            const Rope& rope, const float* tab) {
  const int p = abs_row - rope.prefix;
  if (p < 0 || abs_row >= n_valid) return;
  const int gi = p / rope.grid_w;
  const int trow = chunk < 4 ? gi : rope.grid_h + (p - gi * rope.grid_w);
  const float4* cs = reinterpret_cast<const float4*>(tab + trow * kRopeAngles + (chunk & 3) * 8);
  const float4* sn = cs + (rope.grid_h + rope.grid_w) * kRopeAngles / 4;
  const float4 c4[2] = {cs[0], cs[1]}, s4[2] = {sn[0], sn[1]};
  const float c[8] = {c4[0].x, c4[0].y, c4[0].z, c4[0].w, c4[1].x, c4[1].y, c4[1].z, c4[1].w};
  const float sv[8] = {s4[0].x, s4[0].y, s4[0].z, s4[0].w, s4[1].x, s4[1].y, s4[1].z, s4[1].w};
  uint4* lo = reinterpret_cast<uint4*>(tile + swz(row, chunk));
  uint4* hi = reinterpret_cast<uint4*>(tile + sub_bytes + swz(row, chunk));
  uint4 a = *lo, b = *hi;
  uint32_t* aw = reinterpret_cast<uint32_t*>(&a);
  uint32_t* bw = reinterpret_cast<uint32_t*>(&b);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    const float2 x1 = wgmma_common::unpack_bf16(aw[w]), x2 = wgmma_common::unpack_bf16(bw[w]);
    const float c0 = c[2 * w], c1 = c[2 * w + 1], s0 = sv[2 * w], s1 = sv[2 * w + 1];
    aw[w] = pack_bf16(__fadd_rn(__fmul_rn(x1.x, c0), __fmul_rn(-x2.x, s0)),
                      __fadd_rn(__fmul_rn(x1.y, c1), __fmul_rn(-x2.y, s1)));
    bw[w] = pack_bf16(__fadd_rn(__fmul_rn(x2.x, c0), __fmul_rn(x1.x, s0)),
                      __fadd_rn(__fmul_rn(x2.y, c1), __fmul_rn(x1.y, s1)));
  }
  *lo = a;
  *hi = b;
}

// One block's work. q, k, v, o point at row 0 of this (batch, head); ld* are
// row pitches in elements (rows 16-byte aligned); queries q0.. of n_q, keys
// 0..n_valid-1. kThreads threads, all of which must call; warp w owns rows
// 16w... `smem` holds kSmemBytes bytes, 1024-byte aligned.
//
// The loop is bound by the instructions it issues beside the MMAs (one exp2,
// one max, one FMA, half a pack per score), so what only the last key tile
// needs (the row mask of its copies, the -inf mask of its scores) is kept out
// of the loop's body: the last tile's softmax is a copy of the step of its
// own, and the output is rescaled only where a row's max moved.
template <bool kMax, bool kPreScaled, bool kFloorSum = false>
__device__ __forceinline__ void attention_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ o, int64_t ldq, int64_t ldk, int64_t ldv, int64_t ldo, int q0, int n_q,
    int n_valid, float scale_log2, unsigned char* smem) {
  constexpr int kSub = kHd / 64;           // 128-byte sub-tiles of a row: one
  constexpr int kTileBytes = kBk * kHd * 2;  // one K or V tile: 8 KB
  constexpr int kQSub = kBlockRows * 128;  // one sub-tile of the Q block
  constexpr int kPassRows = kThreads / 8;  // rows the block copies at once: 8 chunks a row
  constexpr int kPasses = kBk / kPassRows;
  const uint32_t q_s = async_copy::shared_addr(smem);
  const uint32_t kv_s = q_s + kBlockRows * kHd * 2;
  const uint32_t ones_s = kv_s + kStages * 2 * kTileBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int n_tiles = (n_valid + kBk - 1) / kBk;

  // this thread's share of a K/V tile's copy: chunk threadIdx & 7 of rows
  // threadIdx / 8 + kPassRows·i, in every sub-tile; the swizzle of those rows
  // is the same
  const int copy_row = threadIdx.x >> 3, copy_chunk = threadIdx.x & 7;
  const uint32_t copy_dst = swz(copy_row, copy_chunk);
  const bf16* k_src = k + (int64_t)copy_row * ldk + copy_chunk * 8;  // of the next tile to copy
  const bf16* v_src = v + (int64_t)copy_row * ldv + copy_chunk * 8;
  auto load_kv = [&](int tile) {
    if (tile < n_tiles) {
      const uint32_t dst = kv_s + (tile % kStages) * 2 * kTileBytes + copy_dst;
      if (tile + 1 < n_tiles) {  // a whole tile
#pragma unroll
        for (int i = 0; i < kPasses; ++i)
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            cp_async16(dst + u * kSubBytes + i * kPassRows * 128,
                       k_src + (int64_t)i * kPassRows * ldk + u * 64, 16);
            cp_async16(dst + kTileBytes + u * kSubBytes + i * kPassRows * 128,
                       v_src + (int64_t)i * kPassRows * ldv + u * 64, 16);
          }
      } else {  // the last tile: rows >= n_valid become zeros (the copy names row 0's address)
#pragma unroll
        for (int i = 0; i < kPasses; ++i) {
          const bool ok = tile * kBk + copy_row + i * kPassRows < n_valid;
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            cp_async16(dst + u * kSubBytes + i * kPassRows * 128,
                       ok ? k_src + (int64_t)i * kPassRows * ldk + u * 64 : k, ok ? 16 : 0);
            cp_async16(dst + kTileBytes + u * kSubBytes + i * kPassRows * 128,
                       ok ? v_src + (int64_t)i * kPassRows * ldv + u * 64 : v, ok ? 16 : 0);
          }
        }
      }
      k_src += (int64_t)kBk * ldk;
      v_src += (int64_t)kBk * ldv;
    }
    cp_async_commit();  // an empty group keeps the count of pending groups uniform
  };

  uint32_t qf[kHd / 16][4];  // the warp's 16 queries as A fragments, all of hd
  float acc[kSub][8][4], s[8][4], m[2] = {-CUDART_INF_F, -CUDART_INF_F}, alpha[2];
  float lsum[4] = {0.f, 0.f, 0.f, 0.f};  // the row sums of the rounded p, as a 16 x 8 MMA tile
  uint32_t pf[4][4];  // p of the tile being multiplied
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;

  // s = q·kᵀ for key tile `tile`, issued and committed, not waited for
  auto issue_scores = [&](int tile) {
    const uint32_t k_s = kv_s + (tile % kStages) * 2 * kTileBytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)  // 16 dims a step: 32 bytes along the swizzled rows
      wgmma_rs<false>(s, qf[kk], tile_desc(k_s + (kk >> 2) * kSubBytes + (kk & 3) * 32),
                      kk != 0);
    wgmma_commit();
  };
  // acc += p·v and lsum += p·1 for key tile `tile`, issued and committed, not
  // waited for. The row sum rides on the tensor cores (an eighth of p·v's
  // work at head dim 64) because on the other cores it costs an unpack and
  // two adds per pair of scores, in a loop that is bound by such instructions.
  auto issue_pv = [&](int tile) {
    const uint32_t v_s = kv_s + (tile % kStages) * 2 * kTileBytes + kTileBytes;
    wgmma_fence();  // acc, lsum and pf were written by ordinary instructions
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step: two 8-row groups of V
#pragma unroll
      for (int u = 0; u < kSub; ++u)
        wgmma_rs<true>(acc[u], pf[kk], tile_desc(v_s + u * kSubBytes + kk * 2048), 1);
      wgmma_rs_n8(lsum, pf[kk], tile_desc(ones_s));
    }
    wgmma_commit();
  };
  // One step: the scores of tile + 1 and p_tile·v_tile are issued together and
  // waited for together, then the softmax of tile + 1 is taken: the rescale
  // of the output and the packing of the next p must wait for p_tile·v_tile
  // anyway, because the product reads p's registers until it is done. The
  // tensor cores are kept busy meanwhile by the SM's other warpgroups, which
  // are at other points of this step. `last`: tile + 1 is the ragged tile.
  auto step = [&](int tile, auto last) {
    cp_async_wait<kStages - 3>();  // this thread's copies of tile + 1 have landed
    fence_proxy_async();
    __syncthreads();  // ... everyone's have, and no thread still reads tile - 1
    load_kv(tile + kStages - 1);  // into the slot tile - 1 used
    issue_scores(tile + 1);
    issue_pv(tile);
    wgmma_wait<0>(s);
    wgmma_wait<0>(acc);
    pin(lsum);
    if (decltype(last)::value) mask_tail(s, (tile + 1) * kBk + 2 * t, n_valid);
    softmax_step<kMax, kPreScaled>(s, m, alpha, pf, scale_log2);
    if (kMax && __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
      rescale(acc, lsum, alpha);
  };

  // Q rides in the first copy group, with tile 0
#pragma unroll
  for (int i = 0; i < kBlockRows * 8 / kThreads; ++i) {
    const int r = copy_row + i * kPassRows;
    const bool ok = q0 + r < n_q;
#pragma unroll
    for (int u = 0; u < kSub; ++u)
      cp_async16(q_s + u * kQSub + swz(r, copy_chunk),
                 ok ? q + (int64_t)(q0 + r) * ldq + u * 64 + copy_chunk * 8 : q, ok ? 16 : 0);
  }
  for (int tile = 0; tile < kStages - 1; ++tile) load_kv(tile);
  for (int i = threadIdx.x; i < kOnesBytes / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(smem + (ones_s - q_s))[i] = 0x3F803F80u;  // bf16 1.0, twice
  cp_async_wait<kStages - 2>();
  fence_proxy_async();
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    ldmatrix_x4(qf[kk], q_s + (kk >> 2) * kQSub +
                            swz(warp * 16 + (lane & 15), (kk & 3) * 2 + (lane >> 4)));

  // tile 0's scores and softmax; then the steps; then the last tile's product
  issue_scores(0);
  wgmma_wait<0>(s);
  if (n_tiles == 1) mask_tail(s, 2 * t, n_valid);
  softmax_step<kMax, kPreScaled>(s, m, alpha, pf, scale_log2);  // acc and lsum are 0: no rescale
  for (int tile = 0; tile + 2 < n_tiles; ++tile) step(tile, std::false_type());
  if (n_tiles >= 2) step(n_tiles - 2, std::true_type());
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  issue_pv(n_tiles - 1);
  wgmma_wait<0>(acc);
  pin(lsum);
#pragma unroll
  for (int u = 0; u < kSub; ++u)
    store_rows<kFloorSum>(acc[u], lsum, o + u * 64, ldo, q0 + warp * 16, n_q, lane);
}

}  // namespace attention_core
