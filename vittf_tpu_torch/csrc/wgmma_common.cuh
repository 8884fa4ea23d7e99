// What every warpgroup-MMA (wgmma) body of this package shares on Hopper
// (sm_90a): the swizzled shared-memory tile that cp.async fills and a matrix
// descriptor names, the descriptor itself, and the fences around the
// asynchronous products. Used by attention_core.cuh (K1, and K3's attention
// launch) and gemm_core.cuh (K3's linears, K9).
//
// A tile holds rows of 128 bytes (64 bf16 or 128 s8 along K), unpadded, with
// the eight 16-byte chunks of a row XOR-swizzled by the row: the
// 128-byte-swizzle layout of wgmma's descriptors, 8-row groups 1024 bytes
// apart. A tile starts on a 1024-byte boundary; one MMA step along K is 32
// bytes for either operand width, taken by adding 32 to the descriptor's
// start address.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_common {

// byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// Matrix descriptor of a swizzled tile of 128-byte rows (or a slice of it that
// starts `addr` bytes into shared memory): 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)  // start address
         | (uint64_t)1 << 16                // leading byte offset: unused with a swizzle
         | (uint64_t)(1024 >> 4) << 32      // stride byte offset
         | (uint64_t)1 << 62;               // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most kPending committed groups are in flight
template <int kPending>
__device__ __forceinline__ void wgmma_wait_group() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}
// Pin accumulators whose group has finished with the last wait: the compiler
// must not read them before the wait.
__device__ __forceinline__ void pin(float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[e])::"memory");
}
__device__ __forceinline__ void pin(int (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[e])::"memory");
}
template <typename T, int kTiles>
__device__ __forceinline__ void pin(T (&d)[kTiles][4]) {
#pragma unroll
  for (int j = 0; j < kTiles; ++j) pin(d[j]);
}
template <typename T, int kParts, int kTiles>
__device__ __forceinline__ void pin(T (&d)[kParts][kTiles][4]) {
#pragma unroll
  for (int u = 0; u < kParts; ++u) pin(d[u]);
}
// the wait and the pin together
template <int kPending, typename T, int kTiles>
__device__ __forceinline__ void wgmma_wait(T (&d)[kTiles][4]) {
  wgmma_wait_group<kPending>();
  pin(d);
}
template <int kPending, typename T, int kParts, int kTiles>
__device__ __forceinline__ void wgmma_wait(T (&d)[kParts][kTiles][4]) {
  wgmma_wait_group<kPending>();
  pin(d);
}
// (x, y) rounded to bf16 and packed, x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// The 4 x 4 transpose of 32-bit words over a quad of lanes (lane t = lane % 4):
// lane t's word k goes to lane k as its word t. Its own inverse. In the
// accumulator layout a thread holds two neighbouring columns of each 8-column
// tile of a row and its quad the other six: with w[k] = the thread's pair of
// tile j0 + k, lane t comes out holding all 8 columns of tile j0 + t, 16
// contiguous bytes in bf16; and 16 bytes loaded so come out as the pairs the
// thread's accumulators sit on. All 32 lanes must call.
__device__ __forceinline__ void quad_transpose(uint32_t (&w)[4]) {
  const bool odd = threadIdx.x & 1, high = threadIdx.x & 2;
  uint32_t r;
  r = __shfl_xor_sync(0xffffffffu, odd ? w[0] : w[1], 1);
  (odd ? w[0] : w[1]) = r;
  r = __shfl_xor_sync(0xffffffffu, odd ? w[2] : w[3], 1);
  (odd ? w[2] : w[3]) = r;
  r = __shfl_xor_sync(0xffffffffu, high ? w[0] : w[2], 2);
  (high ? w[0] : w[2]) = r;
  r = __shfl_xor_sync(0xffffffffu, high ? w[1] : w[3], 2);
  (high ? w[1] : w[3]) = r;
}

// cp.async and ordinary stores write shared memory through the generic proxy;
// wgmma reads it through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace wgmma_common
