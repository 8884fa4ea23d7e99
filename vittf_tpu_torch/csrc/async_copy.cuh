// cp.async: 16-byte copies from device memory into shared memory that the
// issuing thread does not wait for, grouped so that a thread can wait until all
// but its newest kPending groups have landed. Used by the tile rings of
// attention_core.cuh and similarity.cu.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace async_copy {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// dst: a 16-byte aligned shared-memory address; src_bytes = 16 copies, 0 writes
// 16 zero bytes and reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

}  // namespace async_copy
