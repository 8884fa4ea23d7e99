// Blocked-form bilateral grid transfers for Hopper (sm_90a): the cell-blocking
// transposes and the splat/slice that read cell-blocked pixels. Together they
// are the split ("reblock") form of the dense-lattice splat and slice of
// bilateral.cu, and the form every solve of rank other than 3 takes. Each
// kernel has a leading batch (class) axis, so one launch serves a refinement
// chunk.
//
// Blocked layouts (ss = sigma_spatial, NC = (S - 1)/ss + 1 cells per axis):
//   rank 3:  (Z, Y, X) -> (n_cells*ss, ss*ss); row cell*ss + dx holds pixel
//            column dx of spatial cell (cz, cy, cx), lane dz*ss + dy. The rows
//            of one (cz, cy) slab are one contiguous (NCX*ss, ss*ss) span.
//            G = ss rows per cell, PB = ss*ss pixels per row.
//   other:   (n_cells, ss^rank), made by plain reshapes outside any kernel;
//            G = 1, PB = ss^rank.
// Slots past the volume hold a fill word: bin -1 for the luma bins (it matches
// no lattice vertex), 0 for the value planes.
//
// K6a reblock.   Replaces vittf_tpu/ops/bilateral.py::_reblock3d_pallas.
// K6b unreblock. Replaces vittf_tpu/ops/bilateral.py::_unreblock3d_pallas.
//   One block per (cy, cz, b) slab of ss x ss x X words. The slab is walked in
//   chunks of 32 x positions: the chunk is read with x fastest (coalesced,
//   128-byte segments), staged in a shared-memory tile of ss*ss rows padded to
//   33 words (conflict-free in both directions) and written as 32 output rows
//   of ss*ss words, which are contiguous in the blocked array. Elements are
//   moved as 32-bit words, so one kernel serves the int32 bins and the fp32
//   planes; the ragged z/y/x edge is filled (or cropped, in K6b) by index, so
//   no padded copy of the volume is made. Bound: one read and one write, 8
//   bytes per voxel.
// K7a blocked splat. Replaces vittf_tpu/ops/bilateral.py::_splat_pallas.
//   out[b, 0, cell, l] = #pixels of the cell in bin l, out[b, 1] = sum c,
//   out[b, 2] = sum t*c. One warp per cell: its G*PB pixels are contiguous, the
//   warp stages them 32 at a time and every lane adds them, in ascending slot
//   order, into the sums of the bins it owns, which it keeps in registers
//   (splat_ordered.cuh). A bin outside [0, L) adds nothing. No atomics: the
//   sums are those of bls_splat_blocked_plain on CPU tensors bit for bit, and a
//   launch equals its repeat. The price is a serial walk of the 32 staged
//   pixels per step where atomics would run 32 wide. L <= 256. Bound: the
//   three blocked planes, 12 bytes per pixel slot, plus the lattice write.
// K7b blocked slice. Replaces vittf_tpu/ops/bilateral.py::_slice_pallas.
//   out[b, row, p] = yl[b, row / G, il[b, row, p]], 0 where the bin is outside
//   [0, L). One thread per pixel slot: one coalesced bin read, one gather from
//   the cell's lattice row (L2-resident), one coalesced write. Exact. Bound:
//   8 bytes per pixel slot.
#include <cuda_runtime.h>
#include <stdint.h>

#include "splat_ordered.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;             // x positions staged per tile
constexpr int kPitch = kChunk + 1;     // tile row pitch in words
constexpr int kMaxSmemBytes = 232448;  // what one Hopper block may use
constexpr int kDefaultSmemBytes = 49152;

__global__ void __launch_bounds__(kThreads)
bls_reblock_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int Z, int Y,
                   int X, int ss, int NCY, int NCX, uint32_t fill, int64_t n_slabs) {
  extern __shared__ uint32_t tile[];  // [ss*ss][kPitch]
  const int cy = blockIdx.x, cz = blockIdx.y, b = blockIdx.z;
  const int P = ss * ss, Xp = NCX * ss;
  const int z0 = cz * ss, y0 = cy * ss;
  const uint32_t* xb = x + (int64_t)b * Z * Y * X;
  uint32_t* ob = out + ((int64_t)b * n_slabs + (int64_t)cz * NCY + cy) * Xp * P;
  for (int x0 = 0; x0 < Xp; x0 += kChunk) {
    const int nx = min(kChunk, Xp - x0);
    for (int i = threadIdx.x; i < P * kChunk; i += kThreads) {
      const int p = i / kChunk, xc = i - p * kChunk;
      const int dz = p / ss, dy = p - dz * ss;
      const int z = z0 + dz, y = y0 + dy, xx = x0 + xc;
      uint32_t v = fill;
      if (z < Z && y < Y && xx < X) v = xb[((int64_t)z * Y + y) * X + xx];
      tile[p * kPitch + xc] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nx * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      ob[(int64_t)(x0 + r) * P + p] = tile[p * kPitch + r];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
bls_unreblock_kernel(const uint32_t* __restrict__ xb, uint32_t* __restrict__ out, int Z, int Y,
                     int X, int ss, int NCY, int NCX, int64_t n_slabs) {
  extern __shared__ uint32_t tile[];  // [ss*ss][kPitch]
  const int cy = blockIdx.x, cz = blockIdx.y, b = blockIdx.z;
  const int P = ss * ss, Xp = NCX * ss;
  const int z0 = cz * ss, y0 = cy * ss;
  const uint32_t* ib = xb + ((int64_t)b * n_slabs + (int64_t)cz * NCY + cy) * Xp * P;
  uint32_t* ob = out + (int64_t)b * Z * Y * X;
  for (int x0 = 0; x0 < X; x0 += kChunk) {
    const int nx = min(kChunk, X - x0);
    for (int i = threadIdx.x; i < nx * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      tile[p * kPitch + r] = ib[(int64_t)(x0 + r) * P + p];
    }
    __syncthreads();
    for (int i = threadIdx.x; i < P * kChunk; i += kThreads) {
      const int p = i / kChunk, xc = i - p * kChunk;
      const int dz = p / ss, dy = p - dz * ss;
      const int z = z0 + dz, y = y0 + dy;
      if (z < Z && y < Y && xc < nx)
        ob[((int64_t)z * Y + y) * X + x0 + xc] = tile[p * kPitch + xc];
    }
    __syncthreads();
  }
}

template <int kU>  // luma bins per lane: L <= 32*kU
__global__ void __launch_bounds__(kThreads)
bls_splat_blocked_kernel(const int* __restrict__ il, const float* __restrict__ c,
                         const float* __restrict__ tc, float* __restrict__ out, int n_cells,
                         int cell_pixels, int L) {
  __shared__ splat_ordered::Staged stages[kWarps][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cell = blockIdx.x * kWarps + warp, b = blockIdx.y;
  if (cell >= n_cells) return;  // whole warps leave; no block-wide barrier below
  splat_ordered::Sums<kU> sums;
  sums.clear();
  const int64_t base = ((int64_t)b * n_cells + cell) * cell_pixels;
  for (int i0 = 0; i0 < cell_pixels; i0 += 32) {
    const int i = i0 + lane;
    if (i < cell_pixels)
      stages[warp][lane] = splat_ordered::staged(il[base + i], L, c[base + i], tc[base + i]);
    sums.add(stages[warp], min(32, cell_pixels - i0), lane);
  }
  const int64_t plane = (int64_t)n_cells * L;
  sums.store(out + (int64_t)b * 3 * plane + (int64_t)cell * L, plane, L, lane);
}

// The per-class slot index fits 32 bits (the host checks), so the divisions
// are 32-bit.
__global__ void __launch_bounds__(kThreads)
bls_slice_blocked_kernel(const int* __restrict__ il, const float* __restrict__ yl,
                         float* __restrict__ out, unsigned per, unsigned cell_pixels,
                         int n_cells, int L) {
  const int b = blockIdx.y;
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= per) return;
  const int64_t v = (int64_t)b * per + i;
  const int bin = il[v];
  float val = 0.f;
  if (bin >= 0 && bin < L) val = yl[((int64_t)b * n_cells + i / cell_pixels) * L + bin];
  out[v] = val;
}

inline int cells(int S, int ss) { return (S - 1) / ss + 1; }

// Checks shared by K6a and K6b; sets the tile's size and returns a CUDA error.
template <typename Kernel>
int reblock_setup(Kernel kernel, int B, int Z, int Y, int X, int ss, int64_t* smem) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || ss < 1)
    return (int)cudaErrorInvalidValue;
  *smem = (int64_t)ss * ss * kPitch * sizeof(uint32_t);
  const int64_t slab = (int64_t)ss * ss * cells(X, ss) * ss;
  if (*smem > kMaxSmemBytes || cells(Z, ss) > 65535 || slab > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (*smem > kDefaultSmemBytes)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
  return (int)cudaSuccess;
}

}  // namespace

// x (B, Z, Y, X) and out (B, NCZ*NCY*NCX*ss, ss*ss): contiguous 32-bit words;
// fill_bits is the word written to slots past the volume. Returns
// cudaGetLastError() after the launch.
extern "C" int vittf_bls_reblock(const void* x, void* out, int B, int Z, int Y, int X, int ss,
                                 unsigned fill_bits, void* stream) {
  int64_t smem = 0;
  const int e = reblock_setup(bls_reblock_kernel, B, Z, Y, X, ss, &smem);
  if (e != 0) return e;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  const dim3 grid(NCY, NCZ, B);
  bls_reblock_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), Z, Y, X, ss, NCY, NCX,
      fill_bits, (int64_t)NCZ * NCY);
  return (int)cudaGetLastError();
}

// xb (B, NCZ*NCY*NCX*ss, ss*ss) and out (B, Z, Y, X): contiguous 32-bit words.
extern "C" int vittf_bls_unreblock(const void* xb, void* out, int B, int Z, int Y, int X,
                                   int ss, void* stream) {
  int64_t smem = 0;
  const int e = reblock_setup(bls_unreblock_kernel, B, Z, Y, X, ss, &smem);
  if (e != 0) return e;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  const dim3 grid(NCY, NCZ, B);
  bls_unreblock_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xb), static_cast<uint32_t*>(out), Z, Y, X, ss, NCY, NCX,
      (int64_t)NCZ * NCY);
  return (int)cudaGetLastError();
}

// il (int32), c and tc (fp32): (B, n_cells*G, PB) contiguous, cell_pixels =
// G*PB; out (B, 3, n_cells, L) fp32.
extern "C" int vittf_bls_splat_blocked(const int* il, const float* c, const float* tc,
                                       float* out, int B, int n_cells, int cell_pixels, int L,
                                       void* stream) {
  if (B < 1 || B > 65535 || n_cells < 1 || cell_pixels < 1 || L < 1 ||
      L > splat_ordered::kMaxBins)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_cells + kWarps - 1) / kWarps, B);
  return splat_ordered::dispatch_bins(L, [&](auto u) {
    constexpr int kU = decltype(u)::value;
    bls_splat_blocked_kernel<kU><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        il, c, tc, out, n_cells, cell_pixels, L);
    return (int)cudaGetLastError();
  });
}

// il and out (B, n_cells*G, PB), yl (B, n_cells, L): contiguous.
extern "C" int vittf_bls_slice_blocked(const int* il, const float* yl, float* out, int B,
                                       int n_cells, int cell_pixels, int L, void* stream) {
  if (B < 1 || B > 65535 || n_cells < 1 || cell_pixels < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t per = (int64_t)n_cells * cell_pixels;
  if (per > INT32_MAX) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (per + kThreads - 1) / kThreads;
  const dim3 g((unsigned)blocks, B);
  bls_slice_blocked_kernel<<<g, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      il, yl, out, (unsigned)per, (unsigned)cell_pixels, n_cells, L);
  return (int)cudaGetLastError();
}
