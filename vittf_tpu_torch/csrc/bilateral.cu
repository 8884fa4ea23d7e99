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
//   walks (cz, cy). The block keeps the slab's (3, NCX, L) histogram in shared
//   memory (11.9 KB at a 128^3 crop with ss 7, sigma_luma 5; 46 KB at 512^3),
//   adds every voxel with shared-memory atomics and writes the histogram out
//   once, so device memory sees one read of each input plane and one write of
//   the lattice. Voxels past Z/Y (the ragged last cell) are skipped by index,
//   not padded. Bound: the three input planes, 12 bytes per voxel.
//   The counts are exact; the fp32 sums depend on the order in which the
//   atomics land and so may differ from run to run in the last bits.
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

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;  // what one Hopper block may use
constexpr int kDefaultSmemBytes = 49152;

__global__ void __launch_bounds__(kThreads)
bls_splat_kernel(const float* __restrict__ luma, const float* __restrict__ target,
                 const float* __restrict__ conf, float* __restrict__ out, int Z, int Y,
                 int X, int ss, float sigma_luma, int NCZ, int NCY, int NCX, int L) {
  extern __shared__ float hist[];  // [3][NCX][L]
  const int cy = blockIdx.x, cz = blockIdx.y, b = blockIdx.z;
  const int plane = NCX * L;
  for (int i = threadIdx.x; i < 3 * plane; i += kThreads) hist[i] = 0.f;
  __syncthreads();

  const int z0 = cz * ss, y0 = cy * ss;
  const int nz = min(ss, Z - z0), ny = min(ss, Y - y0);
  const int64_t base = (int64_t)b * Z * Y * X;
  const int n = nz * ny * X;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int row = i / X, x = i - row * X;
    const int dz = row / ny, dy = row - dz * ny;
    const int64_t v = base + ((int64_t)(z0 + dz) * Y + (y0 + dy)) * X + x;
    const int bin = (int)(luma[v] / sigma_luma);
    if (bin < 0 || bin >= L) continue;  // luma outside [0, 255]: no vertex
    const float c = conf[v];
    const int h = (x / ss) * L + bin;
    atomicAdd(&hist[h], 1.f);
    atomicAdd(&hist[plane + h], c);
    atomicAdd(&hist[2 * plane + h], __fmul_rn(target[v], c));
  }
  __syncthreads();

  const int64_t n_cells = (int64_t)NCZ * NCY * NCX;
  const int64_t cell0 = ((int64_t)cz * NCY + cy) * NCX;
  for (int i = threadIdx.x; i < 3 * plane; i += kThreads) {
    const int k = i / plane, j = i - k * plane;
    out[((int64_t)b * 3 + k) * n_cells * L + cell0 * L + j] = hist[i];
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
  const int64_t smem = 3LL * NCX * L * sizeof(float);
  if (smem > kMaxSmemBytes || NCZ > 65535 || (int64_t)ss * ss * X > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmemBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        bls_splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(NCY, NCZ, B);
  bls_splat_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      luma, target, conf, out, Z, Y, X, ss, sigma_luma, NCZ, NCY, NCX, L);
  return (int)cudaGetLastError();
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
