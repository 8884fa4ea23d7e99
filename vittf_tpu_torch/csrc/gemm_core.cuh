// The device body of a tensor-core GEMM for Hopper (sm_90a): one thread block
// computes a 128 x kBN tile of C = A(M, K) · B(N, K)ᵀ, both operands K-major
// as they lie in device memory (A row-major; B = a weight in (out, in) layout,
// or a transposed (in, out) one), in bf16 with fp32 sums or in s8 with s32 sums.
// K3's four linears (fused_block.cu) and K9's three modes (chain_gemm.cu) are
// this one main loop with different epilogues.
//
//   - the product runs as warpgroup MMAs (wgmma m64nNk16 for bf16, m64nNk32
//     for s8: one MMA step is 32 bytes of K in both), A and B read from shared
//     memory through matrix descriptors, sums in registers; a block holds two
//     warpgroups, 64 rows each of the 128-row tile, that share every B tile;
//   - tiles hold 128 bytes of K a row (64 bf16 / 128 s8), unpadded and
//     XOR-swizzled by the row (wgmma_common.cuh), filled by cp.async, 16 bytes a
//     thread, through a ring of kStages slots: copies run kAhead = 2 chunks
//     ahead of the chunk being multiplied, one __syncthreads() a chunk, and one
//     group of MMAs stays in flight while the next chunk's are issued (the
//     fourth slot is the one that group still reads);
//   - rows past the ragged edge of A are zero-filled by the copy (size 0) and
//     left to the epilogue not to store;
//   - two forms: ring_product streams A and B (any K); resident_a_product
//     finds the block's whole A row block in shared memory (K/64 chunk tiles,
//     put there once by the caller, e.g. after a LayerNorm) and walks all
//     column tiles of that row block itself, so A is read from device memory
//     once and only B tiles go through the ring, across tile boundaries: an
//     epilogue runs while the next tile's first chunks arrive.
//
// The accumulators come in wgmma's layout: acc[j][e] of thread (g = lane / 4,
// t = lane % 4) of warp w of warpgroup wg is row 64·wg + 16·w + g + 8·(e / 2),
// column 8·j + 2·t + (e % 2) of the tile. Epilogues move 16 bytes a thread:
// wgmma_common::quad_transpose turns the column pairs of four neighbouring
// tiles into one tile's eight columns and back.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "wgmma_common.cuh"

namespace gemm_core {

using async_copy::cp_async16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;
using wgmma_common::fence_proxy_async;
using wgmma_common::pack_bf16;
using wgmma_common::pin;
using wgmma_common::quad_transpose;
using wgmma_common::swz;
using wgmma_common::tile_desc;
using wgmma_common::wgmma_commit;
using wgmma_common::wgmma_fence;
using wgmma_common::wgmma_wait;
using wgmma_common::wgmma_wait_group;

constexpr int kRows = 128;        // rows of an output tile: two warpgroups of 64
constexpr int kThreads = 256;
constexpr int kChunkBytes = 128;  // K bytes a tile row holds
constexpr int kStages = 4;        // ring depth
constexpr int kAhead = kStages - 2;  // chunks the copies run ahead
constexpr int kATileBytes = kRows * kChunkBytes;  // one A chunk tile: 16 KB

// ring bytes: B tiles alone (resident A) or A and B tiles side by side
__host__ __device__ constexpr int ring_bytes(int bn, bool with_a) {
  return kStages * (bn * kChunkBytes + (with_a ? kATileBytes : 0));
}

// ---------------------------------------------------------------------------
// wgmma with both operands in shared memory, 64 x 128 and 64 x 192, bf16 / s8
// ---------------------------------------------------------------------------
#define VITTF_ACC4(c, j) c(d[j][0]), c(d[j][1]), c(d[j][2]), c(d[j][3])
#define VITTF_ACC16(c, j) \
  VITTF_ACC4(c, (j)), VITTF_ACC4(c, (j) + 1), VITTF_ACC4(c, (j) + 2), VITTF_ACC4(c, (j) + 3)
#define VITTF_ACC64(c) VITTF_ACC16(c, 0), VITTF_ACC16(c, 4), VITTF_ACC16(c, 8), VITTF_ACC16(c, 12)
#define VITTF_ACC96(c) VITTF_ACC64(c), VITTF_ACC16(c, 16), VITTF_ACC16(c, 20)
#define VITTF_D64                                              \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "         \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, " \
  "%60, %61, %62, %63"
#define VITTF_D96                                              \
  VITTF_D64 ", %64, %65, %66, %67, %68, %69, %70, %71, "       \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, " \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"

// d (64 x kBN, this thread's share) = a·bᵀ (+ d if accumulate): a = 64 rows,
// b = kBN rows of swizzled tiles, one MMA step (32 bytes of K) each
__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" VITTF_D64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : VITTF_ACC64("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[24][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {" VITTF_D96
      "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
      : VITTF_ACC96("+f")
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(int (&d)[16][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" VITTF_D64 "}, %64, %65, p;\n}\n"
      : VITTF_ACC64("+r")
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(int (&d)[24][4], uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {" VITTF_D96 "}, %96, %97, p;\n}\n"
      : VITTF_ACC96("+r")
      : "l"(a), "l"(b), "r"(accumulate));
}
#undef VITTF_ACC4
#undef VITTF_ACC16
#undef VITTF_ACC64
#undef VITTF_ACC96
#undef VITTF_D64
#undef VITTF_D96

template <typename T, int kTiles>
__device__ __forceinline__ void zero(T (&acc)[kTiles][4]) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
}

// Copy kTileRows rows of 128 bytes into the swizzled tile at `dst`. src = row
// 0 of the tile at this K chunk, pitch in bytes; rows >= rows_valid become
// zeros (the copy names row 0's address, which must be valid). All kThreads
// threads call: 8 chunks a row, 32 rows a pass.
template <int kTileRows>
__device__ __forceinline__ void copy_tile(uint32_t dst, const unsigned char* src, int64_t pitch,
                                          int rows_valid) {
  constexpr int kPassRows = kThreads / 8;
  const int row = threadIdx.x >> 3, chunk = threadIdx.x & 7;
  const uint32_t dst0 = dst + swz(row, chunk);  // rows 32 apart share the swizzle
  const unsigned char* src0 = src + (int64_t)row * pitch + chunk * 16;
#pragma unroll
  for (int i = 0; i < kTileRows / kPassRows; ++i) {
    const bool ok = row + i * kPassRows < rows_valid;
    cp_async16(dst0 + i * kPassRows * kChunkBytes, ok ? src0 + (int64_t)i * kPassRows * pitch : src,
               ok ? 16 : 0);
  }
}

// acc (+)= one K chunk: a_tile = this warpgroup's 64 rows of an A chunk tile,
// b_tile = a B chunk tile of kBN rows. Issued and committed, not waited for.
template <typename Acc, int kTiles>
__device__ __forceinline__ void mma_chunk(Acc (&acc)[kTiles][4], uint32_t a_tile, uint32_t b_tile,
                                          bool first) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kChunkBytes / 32; ++kk)
    wgmma_ss(acc, tile_desc(a_tile + kk * 32), tile_desc(b_tile + kk * 32), !(first && kk == 0));
  wgmma_commit();
}

// acc = A rows · B rowsᵀ over n_chunks K chunks, both operands through the
// ring at ring_s (ring_bytes(kBN, true), 1024-byte aligned). a, b = row 0 of
// the tile's rows at K byte 0; pitches in bytes; A rows >= a_rows_valid read
// as zeros. All threads call; the sums are final on return.
template <typename Acc, int kBN>
__device__ __forceinline__ void ring_product(Acc (&acc)[kBN / 8][4], const unsigned char* a,
                                             int64_t lda, int a_rows_valid,
                                             const unsigned char* b, int64_t ldb, int n_chunks,
                                             uint32_t ring_s) {
  constexpr int kStageBytes = kATileBytes + kBN * kChunkBytes;
  const int wg = threadIdx.x >> 7;
  auto load = [&](int chunk) {
    if (chunk < n_chunks) {
      const uint32_t dst = ring_s + (chunk % kStages) * kStageBytes;
      copy_tile<kRows>(dst, a + (int64_t)chunk * kChunkBytes, lda, a_rows_valid);
      copy_tile<kBN>(dst + kATileBytes, b + (int64_t)chunk * kChunkBytes, ldb, kBN);
    }
    cp_async_commit();  // an empty group keeps the count of pending groups uniform
  };
  __syncthreads();  // no thread still reads the ring for an earlier product
  for (int chunk = 0; chunk < kAhead; ++chunk) load(chunk);
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of `chunk` have landed
    fence_proxy_async();
    __syncthreads();  // ... everyone's have, and chunk - 2's MMAs are done everywhere
    load(chunk + kAhead);  // into the slot chunk - 2 used
    const uint32_t stage = ring_s + (chunk % kStages) * kStageBytes;
    mma_chunk(acc, stage + wg * 64 * kChunkBytes, stage + kATileBytes, chunk == 0);
    wgmma_wait_group<1>();  // chunk - 1 is done; this chunk's MMAs stay in flight
  }
  wgmma_wait<0>(acc);
}

// For every column tile n0 = 0, kBN, .. of n_tiles: acc = A row block · B rows
// n0..ᵀ, then epilogue(acc, n0, j0) for each group of four 8-column tiles (j0 =
// 0, 4, ..: a constant after unrolling, so acc is indexed statically). The A
// row block lies in shared memory at a_s as n_k chunk tiles of kATileBytes
// (written by the caller; ordinary stores or cp.async without a commit: the
// first wait and fence here cover both); B tiles stream through the ring at
// ring_s (ring_bytes(kBN, false)). b = row 0 of B at K byte 0, pitch ldb bytes.
template <typename Acc, int kBN, typename Epilogue>
__device__ __forceinline__ void resident_a_product(uint32_t a_s, int n_k, const unsigned char* b,
                                                   int64_t ldb, int n_tiles, uint32_t ring_s,
                                                   Epilogue epilogue) {
  constexpr int kBTileBytes = kBN * kChunkBytes;
  const int wg = threadIdx.x >> 7;
  const int total = n_tiles * n_k;
  int load_tile = 0, load_k = 0;  // of the next step to copy
  auto load = [&](int step) {
    if (step < total) {
      copy_tile<kBN>(ring_s + (step % kStages) * kBTileBytes,
                     b + (int64_t)load_tile * kBN * ldb + (int64_t)load_k * kChunkBytes, ldb, kBN);
      if (++load_k == n_k) load_k = 0, ++load_tile;
    }
    cp_async_commit();
  };
  Acc acc[kBN / 8][4];
  zero(acc);
  for (int step = 0; step < kAhead; ++step) load(step);
  int step = 0;
  for (int tile = 0; tile < n_tiles; ++tile) {
    for (int kc = 0; kc < n_k; ++kc, ++step) {
      cp_async_wait<kAhead - 1>();
      fence_proxy_async();
      __syncthreads();
      load(step + kAhead);
      mma_chunk(acc, a_s + kc * kATileBytes + wg * 64 * kChunkBytes,
                ring_s + (step % kStages) * kBTileBytes, kc == 0);
      wgmma_wait_group<1>();
    }
    wgmma_wait<0>(acc);
#pragma unroll
    for (int j0 = 0; j0 < kBN / 8; j0 += 4) epilogue(acc, tile * kBN, j0);
  }
}

}  // namespace gemm_core
