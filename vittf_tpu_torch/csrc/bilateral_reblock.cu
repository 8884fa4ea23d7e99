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
//   Bound: one read and one write, 8 bytes per voxel. K6b's design (one block
//   a slab, chunks of 32 x positions, two divisions by runtime divisors per
//   element, 4-byte accesses) is bound by instruction issue here. So a block
//   takes a chunk of W x positions of one (cy, cz, b) slab: the slab's row of
//   Xp = NCX*ss positions is split evenly into chunks of at most kReblockWidth,
//   W a multiple of 4, so no chunk is a sliver. The chunk's output is one
//   contiguous span of W*P words (P = ss*ss), and the block's shared-memory
//   tile holds it in that layout, placed so that its 16-byte units fall where
//   the span's do in device memory. Reads: with X % 4 == 0 (and the volume
//   16-byte aligned) a thread loads 16-byte runs of four x positions of one
//   row and writes their four words into the tile P apart; otherwise one word
//   at a time, 32 consecutive x of a row a warp. A thread's first (row, run)
//   is divided out once; after that it steps by adds. Rows and x past the
//   volume are filled by index. After one barrier the span is written as
//   16-byte runs from the tile, its head and tail a word at a time. Plain
//   stores: the solve reads the blocked planes again at once.
// K6b unreblock. Replaces vittf_tpu/ops/bilateral.py::_unreblock3d_pallas.
//   One block per (cy, cz, b) slab of ss x ss x X words. The slab is walked in
//   chunks of 32 x positions: the chunk is read with x fastest (coalesced,
//   128-byte segments), staged in a shared-memory tile of ss*ss rows padded to
//   33 words (conflict-free in both directions) and written as 32 output rows
//   of ss*ss words, which are contiguous in the blocked array. Elements are
//   moved as 32-bit words, so one kernel serves the int32 bins and the fp32
//   planes; the ragged z/y/x edge is cropped by index, so no padded copy of
//   the volume is made. Bound: one read and one write, 8 bytes per voxel.
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
//   [0, L). Bound by bytes: one bin read and one write, 8 bytes a slot; the
//   lattice stays in L2. A cell's G * PB slots are contiguous, so the slot's
//   cell is slot / cell_pixels. A thread takes 16-byte runs of four slots
//   (slice_walk.cuh: kVec runs, 4 * kVec gathers in flight), divides by
//   cell_pixels with a multiply-high constant from the host (the first version
//   took a 32-bit division a slot) and addresses a class's lattice in 32 bits;
//   a class's head and tail go one slot at a time. Exact.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "slice_walk.cuh"
#include "splat_ordered.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;             // K6b: x positions staged per tile
constexpr int kPitch = kChunk + 1;     // K6b: tile row pitch in words
constexpr int kReblockWidth = 128;     // K6a: the most x positions a block takes
constexpr int kMaxSmemBytes = 232448;  // what one Hopper block may use
constexpr int kDefaultSmemBytes = 49152;

// K6a's walk over the tile rows p = dz * ss + dy of a slab, by adds: a
// thread's first row is divided out once, then it steps.
struct SlabRow {
  int p, dz, dy;
  __device__ __forceinline__ SlabRow(int p0, int ss) : p(p0), dz(p0 / ss), dy(p0 - dz * ss) {}
  __device__ __forceinline__ void next(int ss) {
    ++p;
    if (++dy == ss) dy = 0, ++dz;
  }
  // forward by dp = adz * ss + ady rows
  __device__ __forceinline__ void skip(int dp, int adz, int ady, int ss) {
    p += dp, dz += adz, dy += ady;
    if (dy >= ss) dy -= ss, ++dz;
  }
};

__global__ void __launch_bounds__(kThreads)
bls_reblock_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int Z, int Y,
                   int X, int ss, int NCY, int NCX, uint32_t fill, int64_t n_slabs, int W,
                   int n_chunks, int vec) {
  extern __shared__ __align__(16) uint32_t tile[];  // span word j at tile[lead + j]
  const int cy = blockIdx.x / n_chunks, chunk = blockIdx.x - cy * n_chunks;
  const int cz = blockIdx.y, b = blockIdx.z;
  const int P = ss * ss, Xp = NCX * ss;
  const int z0 = cz * ss, y0 = cy * ss, x0 = chunk * W, nx = min(W, Xp - x0);
  const uint32_t* xb = x + (int64_t)b * Z * Y * X;
  uint32_t* span = out + ((b * n_slabs + (int64_t)cz * NCY + cy) * Xp + x0) * P;
  const int lead = (int)((reinterpret_cast<uintptr_t>(span) >> 2) & 3);
  // a thread's items (row p, column unit u) of the rows x cols grid, p-major;
  // a unit is 4 x positions (vec) or 1
  const int unit = vec ? 4 : 1, cols = W / unit;
  const int step_p = kThreads / cols, step_u = kThreads - step_p * cols;
  const int adz = step_p / ss, ady = step_p - adz * ss;
  int u = threadIdx.x % cols;
  SlabRow row(threadIdx.x / cols, ss);
  while (row.p < P) {
    const int z = z0 + row.dz, y = y0 + row.dy, xc = u * unit, xx = x0 + xc;
    const bool inside = z < Z && y < Y && xx < X;
    const int64_t src = ((int64_t)z * Y + y) * X + xx;
    uint32_t* t = tile + lead + xc * P + row.p;  // x position xc of the span, lane p
    if (vec) {  // X % 4 == 0: xx < X puts the whole run inside the row
      const uint4 v = inside ? __ldg(reinterpret_cast<const uint4*>(xb + src))
                             : make_uint4(fill, fill, fill, fill);
      t[0] = v.x, t[P] = v.y, t[2 * P] = v.z, t[3 * P] = v.w;
    } else {
      t[0] = inside ? __ldg(xb + src) : fill;
    }
    row.skip(step_p, adz, ady, ss);
    if ((u += step_u) >= cols) u -= cols, row.next(ss);
  }
  __syncthreads();
  // the span's nx * P words: a head up to the first 16-byte boundary, 16-byte
  // runs, a tail
  const int n = nx * P, head = min((4 - lead) & 3, n), runs = (n - head) / 4;
  for (int r = threadIdx.x; r < runs; r += kThreads) {
    const int j = head + 4 * r;
    *reinterpret_cast<uint4*>(span + j) = *reinterpret_cast<const uint4*>(tile + lead + j);
  }
  const int t = threadIdx.x;
  if (t < 8) {
    const int j = t < 4 ? (t < head ? t : n) : head + 4 * runs + t - 4;
    if (j < n) span[j] = tile[lead + j];
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

// The value of slot i of a class with bin `bin`: 0 when the bin is outside
// [0, L). A class's slot and lattice indices fit 32 bits (the host checks).
__device__ __forceinline__ float blocked_slot(const float* __restrict__ g, uint32_t i, int bin,
                                              slice_walk::Magic by_cell, uint32_t L) {
  const uint32_t cell = by_cell.div(i);
  return (unsigned)bin < L ? __ldg(g + cell * L + bin) : 0.f;
}

__global__ void __launch_bounds__(slice_walk::kThreads)
bls_slice_blocked_kernel(const int* __restrict__ il, const float* __restrict__ yl,
                         float* __restrict__ out, uint32_t per, slice_walk::Magic by_cell,
                         uint32_t L, uint32_t cells_L) {
  constexpr int kT = slice_walk::kThreads, kVec = slice_walk::kVec;
  const uint64_t start = (uint64_t)blockIdx.y * per;
  const int* ib = il + start;
  float* ob = out + start;
  const float* g = yl + (uint64_t)blockIdx.y * cells_L;
  const slice_walk::Class cl(start, per);
  const uint32_t r0 = blockIdx.x * kT * kVec + threadIdx.x;
  int4 bins[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (r0 + k * kT < cl.runs)
      bins[k] = __ldcs(reinterpret_cast<const int4*>(ib + cl.head) + r0 + k * kT);
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const uint32_t r = r0 + k * kT;
    if (r >= cl.runs) break;
    const uint32_t i = cl.head + 4 * r;
    const float4 o = make_float4(blocked_slot(g, i, bins[k].x, by_cell, L),
                                 blocked_slot(g, i + 1, bins[k].y, by_cell, L),
                                 blocked_slot(g, i + 2, bins[k].z, by_cell, L),
                                 blocked_slot(g, i + 3, bins[k].w, by_cell, L));
    __stcs(reinterpret_cast<float4*>(ob + cl.head) + r, o);
  }
  if (blockIdx.x == 0 && threadIdx.x < 8) {  // the class's head and tail
    const uint32_t i = cl.scalar(threadIdx.x, per);
    if (i < per) ob[i] = blocked_slot(g, i, ib[i], by_cell, L);
  }
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

// x (B, Z, Y, X) and out (B, NCZ*NCY*NCX*ss, ss*ss): contiguous 32-bit words,
// out 16-byte aligned; fill_bits is the word written to slots past the volume.
// Returns cudaGetLastError() after the launch.
extern "C" int vittf_bls_reblock(const void* x, void* out, int B, int Z, int Y, int X, int ss,
                                 unsigned fill_bits, void* stream) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || ss < 1 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  const int64_t P = (int64_t)ss * ss, Xp = (int64_t)NCX * ss;
  // chunks: Xp split evenly into pieces of at most kReblockWidth x positions
  // (fewer where the tile would not fit), each a multiple of 4
  const int64_t widest = std::min<int64_t>(kReblockWidth, (kMaxSmemBytes / 4 - 4) / P) & ~3;
  if (NCZ > 65535 || P * Xp > INT32_MAX || widest < 4) return (int)cudaErrorInvalidValue;
  const int64_t pieces = (Xp + widest - 1) / widest;
  const int W = (int)(((Xp + pieces - 1) / pieces + 3) & ~3);
  const int64_t n_chunks = (Xp + W - 1) / W, smem = (W * P + 4) * (int64_t)sizeof(uint32_t);
  if (n_chunks * NCY > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmemBytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        bls_reblock_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int vec = X % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid((unsigned)(n_chunks * NCY), NCZ, B);
  bls_reblock_kernel<<<grid, kThreads, (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), Z, Y, X, ss, NCY, NCX,
      fill_bits, (int64_t)NCZ * NCY, W, (int)n_chunks, vec);
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

// il and out (B, n_cells*G, PB), yl (B, n_cells, L): contiguous, il and out
// 16-byte aligned. by_cell: slice_walk::Magic for cell_pixels.
extern "C" int vittf_bls_slice_blocked(const int* il, const float* yl, float* out, int B,
                                       int n_cells, int cell_pixels, int L, uint64_t by_cell,
                                       void* stream) {
  if (B < 1 || B > 65535 || n_cells < 1 || cell_pixels < 1 || L < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t per = (int64_t)n_cells * cell_pixels, cells_L = (int64_t)n_cells * L;
  const slice_walk::Magic magic(by_cell);
  if (per > INT32_MAX || cells_L > INT32_MAX || !magic.is_for(cell_pixels) ||
      (reinterpret_cast<uintptr_t>(il) & 15) || (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const dim3 g(slice_walk::blocks(per), B);
  bls_slice_blocked_kernel<<<g, slice_walk::kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      il, yl, out, (uint32_t)per, magic, (uint32_t)L, (uint32_t)cells_L);
  return (int)cudaGetLastError();
}
