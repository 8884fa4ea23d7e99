// Dense-lattice bilateral grid operators for Hopper (sm_90a): splat, slice and
// blur of the grayscale bilateral solver, each with a leading batch (class)
// axis so that one launch serves every class of a refinement chunk.
//
// Lattice: voxel (z, y, x) with luma value v lies in spatial cell
// (z/ss, y/ss, x/ss) and luma bin (int)(v / sigma_luma), a true IEEE division
// truncated toward zero (no reciprocal multiply: it can move a knife-edge
// voxel into the neighbouring bin). The lattice is (NCZ, NCY, NCX, L), with
// NC = (S - 1)/ss + 1 and L = int(255/sigma_luma) + 1, stored flat with the
// luma bin fastest: the vertex order of vittf_tpu/ops/bilateral.py::_vertex_ids.
//
// K4 splat. Replaces vittf_tpu/ops/bilateral.py::_splat_fused3d_pallas.
//   out[b, 0, cell, bin] = #voxels, out[b, 1, ...] = sum c, out[b, 2, ...] = sum t*c.
//   One block per (cy, cz, b) slab of ss x ss x X voxels, as the Pallas grid
//   walks (cz, cy); inside it a warp per spatial cell cx. The warp stages the
//   cell's voxels 32 at a time in (dz, dy, dx) order, which is ascending flat
//   voxel index within the cell, and every lane adds them, in that order, into
//   the sums of the luma bins it owns, which it keeps in registers
//   (splat_ordered.cuh), then writes the cell's vertices out. Device memory
//   sees one read of each input plane and one write of the lattice. Voxels
//   past Z/Y/X (the ragged last cell) are skipped by index, not padded.
//   No atomics: every vertex is summed in ascending voxel order, as
//   bls_splat_plain sums it on CPU tensors, so the result equals that one bit
//   for bit and a launch equals its repeat. The price: the 32 voxels of a step
//   are walked one after the other, and a cell's reads are runs of ss floats.
//   L <= 256. Bound: the three input planes, 12 bytes per voxel.
// K5 slice. Replaces vittf_tpu/ops/bilateral.py::_slice_fused3d_pallas.
//   out[b, z, y, x] = grid[b, cell, bin]. Bound by bytes: one luma read and one
//   write, 8 bytes a voxel; the lattice (a few MB) stays in the 50 MB L2, a
//   voxel row's lattice row (NCX * L words) in L1. One thread a voxel with
//   four 32-bit divisions by runtime divisors and 64-bit addresses made the
//   first version bound by instruction issue instead. Now a thread takes
//   16-byte runs of four voxels (slice_walk.cuh: kVec runs, their loads first,
//   4 * kVec gathers in flight), places a run that lies in one voxel row once
//   (its lattice row, then one x / ss a voxel), divides by X, Y and ss with
//   multiply-high constants from the host (slice_walk::Magic) and addresses a
//   class's lattice in 32 bits. A run that crosses a row end, and a class's
//   head and tail, place each voxel alone. The bin is a true IEEE division
//   (__fdiv_rn) truncated toward zero; a bin outside [0, L) reads nothing and
//   gives 0. Luma is read and out written with streaming hints, so that the
//   lattice keeps its place in L2.
// K8 blur. Replaces vittf_tpu/ops/bilateral.py::_blur_pallas4d.
//   out = 2*dim*y + sum over the four lattice axes of y[+1] + y[-1], with zero
//   boundaries on every axis. Bound: one read and one write of the lattice, 8
//   bytes per vertex. One thread a vertex, with three `%` and three `/` by
//   runtime divisors and nine 4-byte loads, was bound by instruction issue
//   (1.1 TB/s at the request's lattice, warm in L2). So a thread takes one
//   16-byte run of four consecutive vertices of a class (slice_walk.cuh's
//   split into head, runs and tail, so the stores are 16 bytes wide however
//   the class starts), places it once with multiply-high constants for L, X
//   and Y (slice_walk::Magic, made by the C entry), and reads the run and its
//   z, y and x neighbours as 16-byte loads where they are 16-byte aligned
//   (each is, or is not, for every run at once: it depends on L, X*L, Y*X*L
//   and the input's base). A run that lies in one x (l + 3 < L) tests the six
//   spatial boundaries once; its l neighbours are its own words, and one word
//   at each end. A run that crosses an x boundary (L % 4 != 0), and a class's
//   head and tail, go one vertex at a time. Every vertex sums in the plain
//   twin's order (z+1, z-1, y+1, y-1, x+1, x-1, l+1, l-1) with the first
//   product kept out of an FMA, so the result equals _blur's bit for bit.
//   Plain stores: the solve's next passes read the output from L2. What is
//   left is the traffic between L2 and the SMs: each vertex is read five times
//   (as a centre and as a y or z neighbour of four others), which holds the
//   whole-grid lattice (beyond L2) at 1.05x a device-to-device copy of the
//   same bytes; keeping planes z - 1 and z in registers while a thread walks
//   along z measured slower (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

#include "slice_walk.cuh"
#include "splat_ordered.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int kU>  // luma bins per lane: L <= 32*kU
__global__ void __launch_bounds__(kThreads)
bls_splat_kernel(const float* __restrict__ luma, const float* __restrict__ target,
                 const float* __restrict__ conf, float* __restrict__ out, int Z, int Y,
                 int X, int ss, float sigma_luma, int NCZ, int NCY, int NCX, int L) {
  __shared__ splat_ordered::Staged stages[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cy = blockIdx.x, cz = blockIdx.y, b = blockIdx.z;
  const int z0 = cz * ss, y0 = cy * ss;
  const int nz = min(ss, Z - z0), ny = min(ss, Y - y0);
  const int64_t base = (int64_t)b * Z * Y * X;
  const int64_t plane = (int64_t)NCZ * NCY * NCX * L;
  const int64_t cell0 = ((int64_t)cz * NCY + cy) * NCX;
  // a warp per spatial cell of the slab; whole warps loop, no block barrier
  for (int cx = warp; cx < NCX; cx += kWarps) {
    splat_ordered::Sums<kU> sums;
    sums.clear();
    const int x0 = cx * ss, nx = min(ss, X - x0);
    const int n = nz * ny * nx;  // the cell's voxels, (dz, dy, dx): ascending flat index
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      if (i < n) {
        const int row = i / nx, dx = i - row * nx;
        const int dz = row / ny, dy = row - dz * ny;
        const int64_t v = base + ((int64_t)(z0 + dz) * Y + (y0 + dy)) * X + x0 + dx;
        const float c = conf[v];
        // luma outside [0, 255] has no vertex
        stages[warp][lane] = splat_ordered::staged((int)(luma[v] / sigma_luma), L, c,
                                                   __fmul_rn(target[v], c));
      }
      sums.add(stages[warp], min(32, n - i0), lane);
    }
    sums.store(out + (int64_t)b * 3 * plane + (cell0 + cx) * L, plane, L, lane);
  }
}

// A voxel's place in the lattice. A class's voxel and lattice indices fit 32
// bits (the host checks).
struct SliceShape {
  uint32_t X, Y, NCY, NCX, L, cells_L;  // cells_L: one class's lattice words
  slice_walk::Magic by_x, by_y, by_ss;
  float sigma_luma;
};

// The value at bin (int)(v / sigma_luma) of lattice cell `cell`; 0 when the
// bin is outside [0, L).
__device__ __forceinline__ float slice_read(const float* __restrict__ g, uint32_t cell, float v,
                                            const SliceShape& p) {
  const int bin = (int)__fdiv_rn(v, p.sigma_luma);
  return (unsigned)bin < p.L ? __ldg(g + cell * p.L + bin) : 0.f;
}

// The lattice cell of voxel i of a class.
__device__ __forceinline__ uint32_t voxel_cell(uint32_t i, const SliceShape& p) {
  const uint32_t zy = p.by_x.div(i), x = i - zy * p.X;
  const uint32_t z = p.by_y.div(zy), y = zy - z * p.Y;
  return (p.by_ss.div(z) * p.NCY + p.by_ss.div(y)) * p.NCX + p.by_ss.div(x);
}

__global__ void __launch_bounds__(slice_walk::kThreads)
bls_slice_kernel(const float* __restrict__ luma, const float* __restrict__ grid,
                 float* __restrict__ out, SliceShape p, uint32_t vol) {
  constexpr int kT = slice_walk::kThreads, kVec = slice_walk::kVec;
  const uint64_t start = (uint64_t)blockIdx.y * vol;
  const float* lb = luma + start;
  float* ob = out + start;
  const float* g = grid + (uint64_t)blockIdx.y * p.cells_L;
  const slice_walk::Class cl(start, vol);
  const uint32_t r0 = blockIdx.x * kT * kVec + threadIdx.x;
  float4 v[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (r0 + k * kT < cl.runs)
      v[k] = __ldcs(reinterpret_cast<const float4*>(lb + cl.head) + r0 + k * kT);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const uint32_t r = r0 + k * kT;
    if (r >= cl.runs) break;
    const uint32_t i = cl.head + 4 * r;
    const uint32_t zy = p.by_x.div(i), x = i - zy * p.X;
    float4 o;
    if (x + 3 < p.X) {  // the run lies in one voxel row
      const uint32_t z = p.by_y.div(zy), y = zy - z * p.Y;
      const uint32_t row = (p.by_ss.div(z) * p.NCY + p.by_ss.div(y)) * p.NCX;
      o.x = slice_read(g, row + p.by_ss.div(x), v[k].x, p);
      o.y = slice_read(g, row + p.by_ss.div(x + 1), v[k].y, p);
      o.z = slice_read(g, row + p.by_ss.div(x + 2), v[k].z, p);
      o.w = slice_read(g, row + p.by_ss.div(x + 3), v[k].w, p);
    } else {
      o.x = slice_read(g, voxel_cell(i, p), v[k].x, p);
      o.y = slice_read(g, voxel_cell(i + 1, p), v[k].y, p);
      o.z = slice_read(g, voxel_cell(i + 2, p), v[k].z, p);
      o.w = slice_read(g, voxel_cell(i + 3, p), v[k].w, p);
    }
    __stcs(reinterpret_cast<float4*>(ob + cl.head) + r, o);
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {  // the class's head and tail
    const uint32_t i = cl.scalar(threadIdx.x, vol);
    if (i < vol) ob[i] = slice_read(g, voxel_cell(i, p), lb[i], p);
  }
}

// A lattice's shape for K8: the extents, the word strides of y and z, the
// multiply-high constants for L, X and Y, and the central factor 2 * dim.
struct BlurShape {
  uint32_t Z, Y, X, L, sy, sz;  // sy = X * L, sz = Y * X * L
  slice_walk::Magic by_l, by_x, by_y;
  float center;
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

// Four consecutive words at q: one 16-byte load where q is 16-byte aligned.
__device__ __forceinline__ float4 ld4(const float* q) {
  if ((reinterpret_cast<uintptr_t>(q) & 15) == 0) return __ldg(reinterpret_cast<const float4*>(q));
  return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
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

// Vertex w at word i, alone (a class's head and tail, runs across an x edge).
__device__ __forceinline__ float blur_one(const float* __restrict__ yb, uint32_t i, Vertex w,
                                          const BlurShape& p) {
  return sum9(p.center, __ldg(yb + i), w.z + 1 < p.Z ? __ldg(yb + i + p.sz) : 0.f,
              w.z > 0 ? __ldg(yb + i - p.sz) : 0.f, w.y + 1 < p.Y ? __ldg(yb + i + p.sy) : 0.f,
              w.y > 0 ? __ldg(yb + i - p.sy) : 0.f, w.x + 1 < p.X ? __ldg(yb + i + p.L) : 0.f,
              w.x > 0 ? __ldg(yb + i - p.L) : 0.f, w.l + 1 < p.L ? __ldg(yb + i + 1) : 0.f,
              w.l > 0 ? __ldg(yb + i - 1) : 0.f);
}

constexpr int kBlurRuns = 1;  // 16-byte runs a thread takes (two: 6% slower at the whole grid)

__global__ void __launch_bounds__(slice_walk::kThreads)
bls_blur_kernel(const float* __restrict__ y, float* __restrict__ out, BlurShape p, uint32_t per) {
  constexpr int kT = slice_walk::kThreads;
  const uint64_t start = (uint64_t)blockIdx.y * per;
  const float* yb = y + start;
  float* ob = out + start;
  const slice_walk::Class cl(start, per);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const uint32_t r0 = blockIdx.x * kT * kBlurRuns + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kBlurRuns; ++k) {
    const uint32_t r = r0 + k * kT;
    if (r >= cl.runs) break;
    const uint32_t i = cl.head + 4 * r;
    const Vertex w = place(i, p);
    float4 o;
    if (w.l + 3 < p.L) {  // the run lies in one x: one test a boundary
      const float* q = yb + i;
      const float4 c = ld4(q);
      const float4 zp = w.z + 1 < p.Z ? ld4(q + p.sz) : zero;
      const float4 zm = w.z > 0 ? ld4(q - p.sz) : zero;
      const float4 yp = w.y + 1 < p.Y ? ld4(q + p.sy) : zero;
      const float4 ym = w.y > 0 ? ld4(q - p.sy) : zero;
      const float4 xp = w.x + 1 < p.X ? ld4(q + p.L) : zero;
      const float4 xm = w.x > 0 ? ld4(q - p.L) : zero;
      const float lp = w.l + 4 < p.L ? __ldg(q + 4) : 0.f;  // l+1 of the run's last word
      const float lm = w.l > 0 ? __ldg(q - 1) : 0.f;        // l-1 of its first
      o.x = sum9(p.center, c.x, zp.x, zm.x, yp.x, ym.x, xp.x, xm.x, c.y, lm);
      o.y = sum9(p.center, c.y, zp.y, zm.y, yp.y, ym.y, xp.y, xm.y, c.z, c.x);
      o.z = sum9(p.center, c.z, zp.z, zm.z, yp.z, ym.z, xp.z, xm.z, c.w, c.y);
      o.w = sum9(p.center, c.w, zp.w, zm.w, yp.w, ym.w, xp.w, xm.w, lp, c.z);
    } else {  // the run crosses an x boundary: each vertex alone
      Vertex v = w;
      o.x = blur_one(yb, i, v, p);
      v.step(p);
      o.y = blur_one(yb, i + 1, v, p);
      v.step(p);
      o.z = blur_one(yb, i + 2, v, p);
      v.step(p);
      o.w = blur_one(yb, i + 3, v, p);
    }
    *reinterpret_cast<float4*>(ob + i) = o;
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {  // the class's head and tail
    const uint32_t i = cl.scalar(threadIdx.x, per);
    if (i < per) ob[i] = blur_one(yb, i, place(i, p), p);
  }
}

inline int cells(int S, int ss) { return (S - 1) / ss + 1; }

}  // namespace

// luma, target, conf (B, Z, Y, X) and out (B, 3, NCZ*NCY*NCX, L): contiguous fp32.
// Returns cudaGetLastError() after the launch.
extern "C" int vittf_bls_splat(const float* luma, const float* target, const float* conf,
                               float* out, int B, int Z, int Y, int X, int ss,
                               float sigma_luma, int L, void* stream) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || ss < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  if (L > splat_ordered::kMaxBins || NCZ > 65535 || (int64_t)ss * ss * ss > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(NCY, NCZ, B);
  return splat_ordered::dispatch_bins(L, [&](auto u) {
    constexpr int kU = decltype(u)::value;
    bls_splat_kernel<kU><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        luma, target, conf, out, Z, Y, X, ss, sigma_luma, NCZ, NCY, NCX, L);
    return (int)cudaGetLastError();
  });
}

// luma and out (B, Z, Y, X), grid (B, NCZ*NCY*NCX, L): contiguous fp32, luma
// and out 16-byte aligned. by_x, by_y, by_ss: slice_walk::Magic for X, Y, ss.
extern "C" int vittf_bls_slice(const float* luma, const float* grid, float* out, int B,
                               int Z, int Y, int X, int ss, float sigma_luma, int L,
                               uint64_t by_x, uint64_t by_y, uint64_t by_ss, void* stream) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || ss < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  const int64_t vol = (int64_t)Z * Y * X, cells_L = (int64_t)NCZ * NCY * NCX * L;
  const SliceShape p{(uint32_t)X, (uint32_t)Y, (uint32_t)NCY, (uint32_t)NCX, (uint32_t)L,
                     (uint32_t)cells_L, slice_walk::Magic(by_x), slice_walk::Magic(by_y),
                     slice_walk::Magic(by_ss), sigma_luma};
  if (vol > INT32_MAX || cells_L > INT32_MAX || !p.by_x.is_for(X) || !p.by_y.is_for(Y) ||
      !p.by_ss.is_for(ss) || (reinterpret_cast<uintptr_t>(luma) & 15) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 g(slice_walk::blocks(vol), B);
  bls_slice_kernel<<<g, slice_walk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, grid, out, p, (uint32_t)vol);
  return (int)cudaGetLastError();
}

// y and out (B, Z, Y, X, L): contiguous fp32, out 16-byte aligned; a lattice
// of lower rank passes its missing leading axes as 1 (their zero boundaries
// add nothing). The multiply-high constants are made here, not passed: the
// blur is launched ~37 times a solve, and three more ctypes words cost the
// wrapper about a microsecond a call.
extern "C" int vittf_bls_blur(const float* y, float* out, int B, int Z, int Y, int X, int L,
                              int blur_dim, void* stream) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t per = (int64_t)Z * Y * X * L;
  if (per > INT32_MAX || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const BlurShape p{(uint32_t)Z,
                    (uint32_t)Y,
                    (uint32_t)X,
                    (uint32_t)L,
                    (uint32_t)((int64_t)X * L),
                    (uint32_t)((int64_t)Y * X * L),
                    slice_walk::Magic::of(L),
                    slice_walk::Magic::of(X),
                    slice_walk::Magic::of(Y),
                    2.0f * (float)blur_dim};
  // the class's runs, and at least one block for its head and tail
  const dim3 g((unsigned)(per / 4 / (slice_walk::kThreads * kBlurRuns) + 1), B);
  bls_blur_kernel<<<g, slice_walk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, out, p, (uint32_t)per);
  return (int)cudaGetLastError();
}
