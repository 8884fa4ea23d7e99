// The lattice blur's stencil, shared by K8 (bls_blur_kernel in bilateral.cu)
// and K12 (lattice_solve.cu): a vertex's place in a class's dense lattice
// (Z, Y, X, L), luma bin fastest, and its blur 2*dim*y + the +-1 neighbours
// along every lattice axis, zero boundaries, summed in the plain twin's order
// (vittf_tpu_torch/ops/bilateral.py::_blur) with the first product kept out of
// an FMA, so that the result equals _blur's bit for bit.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "slice_walk.cuh"

namespace blur_stencil {

// A lattice's shape: the extents, the word strides of y and z, the
// multiply-high constants for L, X and Y, and the central factor 2 * dim.
struct BlurShape {
  uint32_t Z, Y, X, L, sy, sz;  // sy = X * L, sz = Y * X * L
  slice_walk::Magic by_l, by_x, by_y;
  float center;

  // the shape of a (Z, Y, X, L) lattice (host side); a class's words < 2^31
  static BlurShape of(int Z, int Y, int X, int L, int blur_dim) {
    return {(uint32_t)Z,
            (uint32_t)Y,
            (uint32_t)X,
            (uint32_t)L,
            (uint32_t)((int64_t)X * L),
            (uint32_t)((int64_t)Y * X * L),
            slice_walk::Magic::of(L),
            slice_walk::Magic::of(X),
            slice_walk::Magic::of(Y),
            2.0f * (float)blur_dim};
  }
};

// A vertex's place in its class's lattice.
struct Vertex {
  uint32_t z, y, x, l;
  // the next vertex in memory order
  __device__ __forceinline__ void step(const BlurShape& p) {
    if (++l < p.L) return;
    l = 0;
    if (++x < p.X) return;
    x = 0;
    if (++y < p.Y) return;
    y = 0;
    ++z;
  }
};

// The vertex at word i of a class (i < 2^31: the host checks).
__device__ __forceinline__ Vertex place(uint32_t i, const BlurShape& p) {
  const uint32_t xr = p.by_l.div(i), zy = p.by_x.div(xr), z = p.by_y.div(zy);
  return {z, zy - z * p.Y, xr - zy * p.X, i - xr * p.L};
}

// One vertex's blur in the plain twin's order: its centre, then its
// neighbours z+1, z-1, y+1, y-1, x+1, x-1, l+1, l-1 (0 past an edge).
__device__ __forceinline__ float sum9(float center, float c, float zp, float zm, float yp,
                                      float ym, float xp, float xm, float lp, float lm) {
  float o = __fmul_rn(center, c);
  o = __fadd_rn(o, zp);
  o = __fadd_rn(o, zm);
  o = __fadd_rn(o, yp);
  o = __fadd_rn(o, ym);
  o = __fadd_rn(o, xp);
  o = __fadd_rn(o, xm);
  o = __fadd_rn(o, lp);
  return __fadd_rn(o, lm);
}

// The blur of vertex w at word i of a class, its words read by ld(word).
template <class Load>
__device__ __forceinline__ float blur_vertex(const Load& ld, uint32_t i, Vertex w,
                                             const BlurShape& p) {
  return sum9(p.center, ld(i), w.z + 1 < p.Z ? ld(i + p.sz) : 0.f,
              w.z > 0 ? ld(i - p.sz) : 0.f, w.y + 1 < p.Y ? ld(i + p.sy) : 0.f,
              w.y > 0 ? ld(i - p.sy) : 0.f, w.x + 1 < p.X ? ld(i + p.L) : 0.f,
              w.x > 0 ? ld(i - p.L) : 0.f, w.l + 1 < p.L ? ld(i + 1) : 0.f,
              w.l > 0 ? ld(i - 1) : 0.f);
}

}  // namespace blur_stencil
