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
//   out[b, z, y, x] = grid[b, cell, bin]: one thread per voxel, one luma read,
//   one gather from the lattice (a few MB, resident in the 50 MB L2) and one
//   write. Bound: 8 bytes of device memory per voxel.
// K8 blur. Replaces vittf_tpu/ops/bilateral.py::_blur_pallas4d.
//   out = 2*dim*y + sum over the four lattice axes of y[+1] + y[-1], with zero
//   boundaries on every axis. One thread per vertex; the eight neighbour reads
//   hit L1/L2 (neighbouring threads share them). The sum runs in the order of
//   the plain twin (z+1, z-1, y+1, y-1, x+1, x-1, l+1, l-1) with the first
//   product kept out of an FMA, so it is bit-identical to it. Bound: one read
//   and one write of the lattice, 8 bytes per vertex; at the refinement's
//   small lattices (7 MB at five 128^3 crops) the index arithmetic and the
//   launch weigh as much.
#include <cuda_runtime.h>
#include <stdint.h>

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

// The per-class index fits 32 bits (the host checks), so the coordinate
// divisions are 32-bit: 64-bit integer division is a long software sequence.
__global__ void __launch_bounds__(kThreads)
bls_slice_kernel(const float* __restrict__ luma, const float* __restrict__ grid,
                 float* __restrict__ out, int Z, int Y, int X, int ss, float sigma_luma,
                 int NCY, int NCX, int L, int64_t n_cells) {
  const int b = blockIdx.y;
  const unsigned vol = (unsigned)Z * Y * X;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= vol) return;
  const int x = (int)(i % X);
  const unsigned zy = i / X;
  const int y = (int)(zy % Y), z = (int)(zy / Y);
  const int64_t v = (int64_t)b * vol + i;
  const int bin = (int)(luma[v] / sigma_luma);
  float val = 0.f;
  if (bin >= 0 && bin < L) {
    const int64_t cell = ((int64_t)(z / ss) * NCY + y / ss) * NCX + x / ss;
    val = grid[((int64_t)b * n_cells + cell) * L + bin];
  }
  out[v] = val;
}

__global__ void __launch_bounds__(kThreads)
bls_blur_kernel(const float* __restrict__ y, float* __restrict__ out, int Z, int Y, int X,
                int L, float center) {
  const int b = blockIdx.y;
  const unsigned per = (unsigned)Z * Y * X * L;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= per) return;
  const float* yb = y + (int64_t)b * per;
  const int l = (int)(i % L);
  unsigned r = i / L;
  const int x = (int)(r % X);
  r /= X;
  const int yy = (int)(r % Y), z = (int)(r / Y);
  const unsigned sz = (unsigned)Y * X * L, sy = (unsigned)X * L, sx = L;
  float o = __fmul_rn(center, yb[i]);
  o = __fadd_rn(o, z + 1 < Z ? yb[i + sz] : 0.f);
  o = __fadd_rn(o, z > 0 ? yb[i - sz] : 0.f);
  o = __fadd_rn(o, yy + 1 < Y ? yb[i + sy] : 0.f);
  o = __fadd_rn(o, yy > 0 ? yb[i - sy] : 0.f);
  o = __fadd_rn(o, x + 1 < X ? yb[i + sx] : 0.f);
  o = __fadd_rn(o, x > 0 ? yb[i - sx] : 0.f);
  o = __fadd_rn(o, l + 1 < L ? yb[i + 1] : 0.f);
  o = __fadd_rn(o, l > 0 ? yb[i - 1] : 0.f);
  out[(int64_t)b * per + i] = o;
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

// luma and out (B, Z, Y, X), grid (B, NCZ*NCY*NCX, L): contiguous fp32.
extern "C" int vittf_bls_slice(const float* luma, const float* grid, float* out, int B,
                               int Z, int Y, int X, int ss, float sigma_luma, int L,
                               void* stream) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || ss < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  const int64_t vol = (int64_t)Z * Y * X;
  if (vol > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (vol + kThreads - 1) / kThreads;
  const dim3 g((unsigned)blocks, B);
  bls_slice_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      luma, grid, out, Z, Y, X, ss, sigma_luma, NCY, NCX, L, (int64_t)NCZ * NCY * NCX);
  return (int)cudaGetLastError();
}

// y and out (B, Z, Y, X, L): contiguous fp32; a lattice of lower rank passes
// its missing leading axes as 1 (their zero boundaries add nothing).
extern "C" int vittf_bls_blur(const float* y, float* out, int B, int Z, int Y, int X, int L,
                              int blur_dim, void* stream) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t per = (int64_t)Z * Y * X * L;
  if (per > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (per + kThreads - 1) / kThreads;
  const dim3 g((unsigned)blocks, B);
  bls_blur_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      y, out, Z, Y, X, L, 2.0f * (float)blur_dim);
  return (int)cudaGetLastError();
}
