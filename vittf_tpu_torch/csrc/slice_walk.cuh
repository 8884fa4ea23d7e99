// What the two slices (K5 in bilateral.cu, K7b in bilateral_reblock.cu) and
// the blur (K8 in bilateral.cu) share: division by a runtime divisor without a
// division instruction, and the split of one class's elements into 16-byte
// runs.
//
// Each slice reads one 4-byte word of a class (a voxel's luma, a slot's bin),
// gathers one lattice value and writes one 4-byte word. A thread takes kVec
// runs of four consecutive elements: one 16-byte load, four gathers and one
// 16-byte store a run, the loads of all its runs issued first, so that 4 *
// kVec gathers are in flight. Class b's n elements start at element b * n of
// arrays whose base is 16-byte aligned, so a class starts on a 16-byte
// boundary only when b * n % 4 == 0: its first `head` elements up to the
// boundary and the last (n - head) % 4 are taken one at a time by the first
// block's first threads (Class below).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace slice_walk {

constexpr int kThreads = 256;
constexpr int kVec = 2;  // 16-byte runs a thread

// n / d for 0 <= n < 2^31 and 1 <= d < 2^31 as (n * m) >> s, with
// s = 31 + ceil(log2 d) and m = ceil(2^s / d) < 2^32 (the host's
// ops/bilateral.py::_div_magic, held against // there): m exceeds 2^s / d by
// less than 1, so the product exceeds n / d by less than 2^31 / 2^s <= 1 / d
// and never reaches the next integer. Passed from the host as m | s << 32.
struct Magic {
  uint32_t m, s;
  __host__ __device__ explicit Magic(uint64_t packed)
      : m((uint32_t)packed), s((uint32_t)(packed >> 32)) {}
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (uint32_t)(((uint64_t)n * m) >> s);
  }
  // the constants above for 1 <= d < 2^31 (host side)
  static Magic of(uint32_t d) {
    uint32_t log2_up = 0;
    while ((1ull << log2_up) < d) ++log2_up;
    const uint64_t s = 31 + log2_up;
    return Magic(((1ull << s) + d - 1) / d | s << 32);
  }
  // whether (m, s) are the constants above for d (host side)
  bool is_for(uint32_t d) const {
    if (d < 1 || d > INT32_MAX) return false;
    const Magic want = of(d);
    return m == want.m && s == want.s;
  }
};

// Class b's n elements starting at element `start`: `head` one at a time up
// to the first 16-byte boundary, then `runs` runs of four, then the tail.
struct Class {
  uint32_t head, runs;
  __device__ __forceinline__ Class(uint64_t start, uint32_t n)
      : head(min((uint32_t)(0 - start) & 3u, n)), runs((n - head) / 4) {}
  // the element the scalar thread t < 8 takes (threads 0-3 the head, 4-7 the
  // tail), or n when it takes none
  __device__ __forceinline__ uint32_t scalar(uint32_t t, uint32_t n) const {
    if (t < 4) return t < head ? t : n;
    const uint32_t i = head + 4 * runs + (t - 4);
    return i < n ? i : n;
  }
};

// Blocks along x for a class of n elements: its runs, and at least one block
// for the head and the tail.
inline unsigned blocks(int64_t n) {
  const int64_t per_block = (int64_t)kThreads * kVec;
  return (unsigned)(n / 4 / per_block + 1);
}

}  // namespace slice_walk
