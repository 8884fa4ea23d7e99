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
//   Bound: one read and one write, 8 bytes per voxel. The first design (one
//   block a slab, chunks of 32 x positions, two divisions by runtime divisors
//   per element, 4-byte accesses) was bound by instruction issue. So a block
//   takes a chunk of W x positions of one (cy, cz, b) slab: the slab's row of
//   Xp = NCX*ss positions is split evenly into chunks of at most kReblockWidth,
//   W a multiple of 4, so no chunk is a sliver (reblock_setup, shared with
//   K6b). The chunk's output is one contiguous span of W*P words (P = ss*ss),
//   and the block's shared-memory tile holds it in that layout, placed so that
//   its 16-byte units fall where the span's do in device memory (Chunk). Reads:
//   with X % 4 == 0 (and the volume 16-byte aligned) a thread loads 16-byte
//   runs of four x positions of one row and writes their four words into the
//   tile P apart; otherwise one word at a time, 32 consecutive x of a row a
//   warp. A thread's first (row, run) is divided out once; after that it steps
//   by adds (ChunkItems). Rows and x past the volume are filled by index.
//   After one barrier the span is written as 16-byte runs from the tile, its
//   head and tail a word at a time. Plain stores: the solve reads the blocked
//   planes again at once.
// K6b unreblock. Replaces vittf_tpu/ops/bilateral.py::_unreblock3d_pallas.
//   Bound: one read and one write, 8 bytes per voxel. K6a's design in
//   reverse (the first design, one block a slab walked 32 x positions at a
//   time, read 0.058 ms at five 128³ fp32 planes, 2.2x its bound): a block
//   takes the same chunk of a slab; its span of W*P blocked words is read as
//   16-byte loads into the tile in the span's layout, head and tail a word at
//   a time. After one barrier each thread writes output rows (dz, dy) of the
//   chunk: 16-byte runs of four x positions, gathered from tile words P
//   apart, where X % 4 == 0 and the output is 16-byte aligned; otherwise one
//   word at a time, 32 consecutive x of a row a warp. Rows z >= Z, y >= Y and
//   positions x >= X are cropped by index, never written. At odd ss a run's
//   four words are P apart, P odd; at ss 4 (P = 16) they share a bank (no
//   solve of the port takes ss 4 on this kernel). 0.0367 ms at five 128³
//   fp32 planes, 1.05x a copy of its bytes and 1.38x its bound (H100 80GB
//   HBM3, 700 W, ten calls an event pair); streaming loads, streaming stores,
//   chunks of 128 or fewer positions, and reads rotated against bank
//   conflicts each measured slower. Both kernels move 32-bit words, so one
//   kernel serves the int32 bins and the fp32 planes.
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
// K6: the most x positions a block takes. At the 128³ crops of the blocked
// path (Xp = 133 at ss 7) a chunk is a whole slab row, so K6b writes whole
// 512-byte rows (128 took two chunks a row: K6b 4% slower, K6a 1.5% faster)
constexpr int kReblockWidth = 136;
constexpr int kMaxSmemBytes = 232448;  // what one Hopper block may use
constexpr int kDefaultSmemBytes = 49152;

// The walk over the tile rows p = dz * ss + dy of a slab, by adds: a
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

// A thread's items (row p, column unit u) of a chunk's P x cols grid,
// p-major, kThreads apart; a unit is 4 x positions (16-byte accesses) or 1.
struct ChunkItems {
  SlabRow row;
  int u;
  const int cols, step_p, step_u, adz, ady;
  __device__ __forceinline__ ChunkItems(int cols_, int ss)
      : row(threadIdx.x / cols_, ss), u(threadIdx.x % cols_), cols(cols_),
        step_p(kThreads / cols_), step_u(kThreads - step_p * cols_), adz(step_p / ss),
        ady(step_p - adz * ss) {}
  __device__ __forceinline__ void next(int ss) {
    row.skip(step_p, adz, ady, ss);
    if ((u += step_u) >= cols) u -= cols, row.next(ss);
  }
};

// The span of a (cy, cz, b) slab's blocked rows that block blockIdx takes:
// n = nx * P contiguous words from x position x0 of the slab, held in the
// shared tile at tile[lead + j] so that the tile's 16-byte units fall where
// the span's do in device memory.
struct Chunk {
  int cy, cz, b, x0, nx, n, lead;
  int64_t span;  // the span's first word in the blocked array
  __device__ __forceinline__ Chunk(int P, int NCY, int NCX, int ss, int64_t n_slabs, int W,
                                   int n_chunks, uintptr_t blocked) {
    cy = blockIdx.x / n_chunks;
    x0 = (blockIdx.x - cy * n_chunks) * W;
    cz = blockIdx.y, b = blockIdx.z;
    const int Xp = NCX * ss;
    nx = min(W, Xp - x0), n = nx * P;
    span = ((b * n_slabs + (int64_t)cz * NCY + cy) * Xp + x0) * P;
    lead = (int)(((blocked >> 2) + span) & 3);
  }
  // the span's head up to its first 16-byte boundary and its runs of 4 words
  __device__ __forceinline__ int head() const { return min((4 - lead) & 3, n); }
  __device__ __forceinline__ int runs() const { return (n - head()) / 4; }
  // the word thread t < 8 moves one at a time, or n: t < 4 the head, else the tail
  __device__ __forceinline__ int scalar(int t) const {
    return t < 4 ? (t < head() ? t : n) : head() + 4 * runs() + t - 4;
  }
};

__global__ void __launch_bounds__(kThreads)
bls_reblock_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out, int Z, int Y,
                   int X, int ss, int NCY, int NCX, uint32_t fill, int64_t n_slabs, int W,
                   int n_chunks, int vec) {
  extern __shared__ __align__(16) uint32_t tile[];  // span word j at tile[lead + j]
  const int P = ss * ss;
  const Chunk ch(P, NCY, NCX, ss, n_slabs, W, n_chunks, reinterpret_cast<uintptr_t>(out));
  const int z0 = ch.cz * ss, y0 = ch.cy * ss, x0 = ch.x0, lead = ch.lead;
  const uint32_t* xb = x + (int64_t)ch.b * Z * Y * X;
  uint32_t* span = out + ch.span;
  const int unit = vec ? 4 : 1;
  for (ChunkItems it(W / unit, ss); it.row.p < P; it.next(ss)) {
    const int z = z0 + it.row.dz, y = y0 + it.row.dy, xc = it.u * unit, xx = x0 + xc;
    const bool inside = z < Z && y < Y && xx < X;
    const int64_t src = ((int64_t)z * Y + y) * X + xx;
    uint32_t* t = tile + lead + xc * P + it.row.p;  // x position xc of the span, lane p
    if (vec) {  // X % 4 == 0: xx < X puts the whole run inside the row
      const uint4 v = inside ? __ldg(reinterpret_cast<const uint4*>(xb + src))
                             : make_uint4(fill, fill, fill, fill);
      t[0] = v.x, t[P] = v.y, t[2 * P] = v.z, t[3 * P] = v.w;
    } else {
      t[0] = inside ? __ldg(xb + src) : fill;
    }
  }
  __syncthreads();
  const int head = ch.head(), runs = ch.runs();
  for (int r = threadIdx.x; r < runs; r += kThreads) {
    const int j = head + 4 * r;
    *reinterpret_cast<uint4*>(span + j) = *reinterpret_cast<const uint4*>(tile + lead + j);
  }
  if (threadIdx.x < 8) {
    const int j = ch.scalar(threadIdx.x);
    if (j < ch.n) span[j] = tile[lead + j];
  }
}

__global__ void __launch_bounds__(kThreads)
bls_unreblock_kernel(const uint32_t* __restrict__ xb, uint32_t* __restrict__ out, int Z, int Y,
                     int X, int ss, int NCY, int NCX, int64_t n_slabs, int W, int n_chunks,
                     int vec) {
  extern __shared__ __align__(16) uint32_t tile[];  // span word j at tile[lead + j]
  const int P = ss * ss;
  const Chunk ch(P, NCY, NCX, ss, n_slabs, W, n_chunks, reinterpret_cast<uintptr_t>(xb));
  const int lead = ch.lead, head = ch.head(), runs = ch.runs();
  const uint32_t* span = xb + ch.span;
  // plain loads: a span's first and last 32-byte sectors are its neighbours'
  // too, which streaming loads (__ldcs) evict before they are read again
#pragma unroll 4
  for (int r = threadIdx.x; r < runs; r += kThreads) {
    const int k = head + 4 * r;
    *reinterpret_cast<uint4*>(tile + lead + k) = __ldg(reinterpret_cast<const uint4*>(span + k));
  }
  if (threadIdx.x < 8) {
    const int k = ch.scalar(threadIdx.x);
    if (k < ch.n) tile[lead + k] = __ldg(span + k);
  }
  __syncthreads();
  const int z0 = ch.cz * ss, y0 = ch.cy * ss, unit = vec ? 4 : 1;
  uint32_t* ob = out + (int64_t)ch.b * Z * Y * X;
  for (ChunkItems w(W / unit, ss); w.row.p < P; w.next(ss)) {
    const int z = z0 + w.row.dz, y = y0 + w.row.dy, wc = w.u * unit, wx = ch.x0 + wc;
    if (z >= Z || y >= Y || wx >= X) continue;  // the ragged edge is cropped, never written
    const uint32_t* s = tile + lead + wc * P + w.row.p;
    uint32_t* o = ob + ((int64_t)z * Y + y) * X + wx;
    if (vec)  // X % 4 == 0: wx < X puts the whole run inside the row
      *reinterpret_cast<uint4*>(o) = make_uint4(s[0], s[P], s[2 * P], s[3 * P]);
    else
      *o = s[0];
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

// K6a's and K6b's chunking, with the checks both share: a slab's Xp = NCX*ss
// x positions split evenly into chunks of at most kReblockWidth (fewer where
// the tile would not fit), W a multiple of 4, so no chunk is a sliver; the
// tile holds W*P words and a lead of up to 3. Sets the kernel's dynamic
// shared memory size; returns a CUDA error.
struct Chunking {
  int W, n_chunks;
  int64_t smem;
};

template <typename Kernel>
int reblock_setup(Kernel kernel, int B, int Z, int Y, int X, int ss, Chunking* c) {
  if (B < 1 || B > 65535 || Z < 1 || Y < 1 || X < 1 || ss < 1)
    return (int)cudaErrorInvalidValue;
  const int64_t P = (int64_t)ss * ss, Xp = (int64_t)cells(X, ss) * ss;
  const int64_t widest = std::min<int64_t>(kReblockWidth, (kMaxSmemBytes / 4 - 4) / P) & ~3;
  if (cells(Z, ss) > 65535 || P * Xp > INT32_MAX || widest < 4)
    return (int)cudaErrorInvalidValue;
  const int64_t pieces = (Xp + widest - 1) / widest;
  c->W = (int)(((Xp + pieces - 1) / pieces + 3) & ~3);
  const int64_t n_chunks = (Xp + c->W - 1) / c->W;
  if (n_chunks * cells(Y, ss) > INT32_MAX) return (int)cudaErrorInvalidValue;
  c->n_chunks = (int)n_chunks;
  c->smem = (c->W * P + 4) * (int64_t)sizeof(uint32_t);
  if (c->smem > kDefaultSmemBytes)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)c->smem);
  return (int)cudaSuccess;
}

}  // namespace

// x (B, Z, Y, X) and out (B, NCZ*NCY*NCX*ss, ss*ss): contiguous 32-bit words,
// out 16-byte aligned; fill_bits is the word written to slots past the volume.
// Returns cudaGetLastError() after the launch.
extern "C" int vittf_bls_reblock(const void* x, void* out, int B, int Z, int Y, int X, int ss,
                                 unsigned fill_bits, void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15) return (int)cudaErrorInvalidValue;
  Chunking c;
  const int e = reblock_setup(bls_reblock_kernel, B, Z, Y, X, ss, &c);
  if (e != 0) return e;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  const int vec = X % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const dim3 grid((unsigned)(c.n_chunks * NCY), NCZ, B);
  bls_reblock_kernel<<<grid, kThreads, (size_t)c.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<uint32_t*>(out), Z, Y, X, ss, NCY, NCX,
      fill_bits, (int64_t)NCZ * NCY, c.W, c.n_chunks, vec);
  return (int)cudaGetLastError();
}

// xb (B, NCZ*NCY*NCX*ss, ss*ss) and out (B, Z, Y, X): contiguous 32-bit words.
// Rows are written 16 bytes wide where X % 4 == 0 and out is 16-byte aligned.
extern "C" int vittf_bls_unreblock(const void* xb, void* out, int B, int Z, int Y, int X,
                                   int ss, void* stream) {
  Chunking c;
  const int e = reblock_setup(bls_unreblock_kernel, B, Z, Y, X, ss, &c);
  if (e != 0) return e;
  const int NCZ = cells(Z, ss), NCY = cells(Y, ss), NCX = cells(X, ss);
  const int vec = X % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const dim3 grid((unsigned)(c.n_chunks * NCY), NCZ, B);
  bls_unreblock_kernel<<<grid, kThreads, (size_t)c.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xb), static_cast<uint32_t*>(out), Z, Y, X, ss, NCY, NCX,
      (int64_t)NCZ * NCY, c.W, c.n_chunks, vec);
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
