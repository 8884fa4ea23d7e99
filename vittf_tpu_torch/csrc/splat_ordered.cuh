// Order-fixed histogram sums for the bilateral splats (K4 in bilateral.cu, K7a
// in bilateral_reblock.cu).
//
// One warp owns one lattice cell. Lane l keeps the sums [count, sum c,
// sum t*c] of the cell's luma bins l, l + 32, ... (kU of them) in registers.
// The cell's pixels are staged 32 at a time in shared memory, in ascending
// pixel index, as (bin, c, t*c); then every lane walks the staged pixels in
// that order (one 16-byte broadcast read each) and adds a pixel if it names one
// of the lane's bins. So every
// vertex is summed by one thread in one fixed order, ascending pixel index: the
// order index_add_ takes on a CPU tensor. No atomics: a splat equals its own
// repeat, and the plain twin run on CPU tensors, bit for bit. The adds are
// __fadd_rn so that nothing is contracted or reassociated.
#pragma once
#include <cuda_runtime.h>

#include <type_traits>

namespace splat_ordered {

constexpr int kMaxBins = 256;  // luma bins a cell may have: 8 per lane

// One staged pixel: x = its bin as int bits (-1: no vertex), y = c, z = t*c.
typedef float4 Staged;

__device__ __forceinline__ Staged staged(int bin, int L, float c, float tc) {
  return make_float4(__int_as_float(bin >= 0 && bin < L ? bin : -1), c, tc, 0.f);
}

template <int kU>
struct Sums {
  float n[kU], c[kU], tc[kU];  // of the bins lane + 32u

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int u = 0; u < kU; ++u) n[u] = c[u] = tc[u] = 0.f;
  }

  // Add the first `count` staged pixels, in staged order. Every lane of the
  // warp calls it, after writing its own slot of `stage`.
  __device__ __forceinline__ void add(const Staged* stage, int count, int lane) {
    __syncwarp();
#pragma unroll 4
    for (int j = 0; j < count; ++j) {
      const Staged px = stage[j];  // one address for the whole warp: a broadcast
      const int b = __float_as_int(px.x);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (b == lane + 32 * u) {  // three predicated adds, no branch
          n[u] = __fadd_rn(n[u], 1.f);
          c[u] = __fadd_rn(c[u], px.y);
          tc[u] = __fadd_rn(tc[u], px.z);
        }
      }
    }
    __syncwarp();
  }

  // Write the cell's vertices: plane k of the output starts at out + k*plane.
  __device__ __forceinline__ void store(float* out, int64_t plane, int L, int lane) const {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int l = lane + 32 * u;
      if (l < L) {
        out[l] = n[u];
        out[plane + l] = c[u];
        out[2 * plane + l] = tc[u];
      }
    }
  }
};

// Calls f(std::integral_constant<int, kU>) with the smallest kU of 1, 2, 4, 8
// whose 32*kU bins cover L; L <= kMaxBins.
template <typename F>
int dispatch_bins(int L, F&& f) {
  if (L <= 32) return f(std::integral_constant<int, 1>());
  if (L <= 64) return f(std::integral_constant<int, 2>());
  if (L <= 128) return f(std::integral_constant<int, 4>());
  return f(std::integral_constant<int, 8>());
}

}  // namespace splat_ordered
