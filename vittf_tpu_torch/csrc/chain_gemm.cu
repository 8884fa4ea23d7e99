// Chained square GEMM probe (K9) for Hopper (sm_90a): x <- f(x · W), `chain`
// times, in bf16 and in int8 with two epilogues.
//
// Replaces: scripts/bench_int8_gemm.py::run (Pallas bodies _bf16_kernel,
// _int8_kernel, _int8_noquant_kernel). The TPU kernel is one program that
// holds all of x (rows, dim) and W (dim, dim) in VMEM and loops `chain` times
// inside the body. No Hopper block holds that, but the card has thread block
// clusters, and row m of step i + 1 needs only row m of step i: so ONE launch
// runs the whole chain. A cluster is the dim / kBN column tiles of one
// 128-row block (8 blocks of 128 x 192 at dim 1536: 16 clusters = 128 blocks,
// one wave of the 132 SMs, co-scheduled by the hardware). Each block computes
// its tile with gemm_core::ring_product (wgmma, cp.async ring), writes it to
// the ping-pong buffer in device memory (it stays in L2), the cluster meets at
// a barrier (arrive.release / wait.acquire), and the next step reads the
// buffer back: no grid-wide barrier, no launch gaps.
//
// The three modes are instantiations of that one kernel; they differ in the
// operand width (one MMA step is 32 bytes of K in both), the accumulator type
// (fp32 / s32) and the epilogue, taken from the accumulator registers:
//   bf16          out = bf16(acc)
//   int8+shift    out = low 8 bits of (acc >> 8)
//   int8+requant  a block takes max|acc| of its 192 columns per row, the
//                 cluster's blocks read each other's 128 partial maxima
//                 through distributed shared memory, and each quantises its
//                 own registers: scale = 127 / max(m, 1e-6), out =
//                 int8(rint(float(acc) · scale)), IEEE division and multiply,
//                 round half to even. An integer max has no order, so the
//                 result is bit-defined. No scratch, no atomics, no second
//                 launch.
// All three store 16 bytes a thread (wgmma_common::quad_transpose). W is
// transposed once per call into (N, K) so that both MMA operands are K-major
// in shared memory; bf16 could read W as it lies through the descriptor's
// transpose bit, s8 has no such bit, and one path for the three modes is the
// simpler code (the transpose is one launch of a few µs in 32 steps).
//
// What bounds it on the H100: 2·rows·dim² operations per step against
// (rows + dim)·dim operand bytes, ~1750 op/byte in bf16 at 2048 x 1536:
// arithmetic by the roofline. Measured (NVIDIA H100 80GB HBM3, 700 W; chain
// 32 at 2048 x 1536, chip_smoke.py and scripts/kernel_variants.py
// gemm-ablation): bf16 0.91-0.98 ms, int8+requant 0.69-0.72, int8+shift
// 0.53-0.56 (on warp-level MMAs before: 2.31 / 1.48 / 1.40). The same kernel
// launched once a step instead (no cluster barrier, chain outside) read
// 0.97-1.05 / 0.79-0.87 / 0.58-0.63 in the same calls, so the chain stayed
// inside. What holds it now (the same script): with the MMAs and the copies
// both taken out a third of the time is still there, the part of a step that
// nothing overlaps: epilogue, cluster barrier, refilling the ring, the last
// chunk's MMAs. The copies ((128 + 192)·dim bytes a tile and step out of L2,
// ~4 TB/s in all) cost 5-7% beside the MMAs. The loop's MMAs alone run at
// ~530 TFLOP/s, with the SM clock reading ~1.25 GHz under this load (clock64
// against event times), where the published peak assumes 1.83. Tried and
// slower: four warpgroups a block, 2 x 2 over the same tile (1.33 / 0.89 /
// 0.76 ms); each 64 x 192 MMA as two 64 x 96 on separate accumulators (1.09-
// 1.12 bf16). Next would be TMA multicast of the A rows across the cluster and
// a producer warp (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_core.cuh"

namespace {

constexpr int kRows = gemm_core::kRows, kThreads = gemm_core::kThreads;

enum { kModeBf16 = 0, kModeRequant = 1, kModeShift = 2 };

struct ChainArgs {
  const unsigned char* x;   // (M, D) operands of step 0
  const unsigned char* wt;  // (D, D) row-major: W transposed
  unsigned char* out;       // (M, D): the last step's result, and every second one before it
  unsigned char* tmp;       // (M, D): the other ping-pong buffer
  int M, D, chain;
};

template <int MODE> struct Acc { typedef int type; };
template <> struct Acc<kModeBf16> { typedef float type; };

__device__ __forceinline__ unsigned abs_u(int v) { return v < 0 ? 0u - (unsigned)v : (unsigned)v; }

// the cluster's barrier: writes before the arrive (device and shared memory)
// are visible to every thread of the cluster after its wait (release / acquire
// at cluster scope), so the next step's copies read what the other blocks wrote
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_blocks() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}
// the word at this block's shared-memory address `addr`, read in block `rank` of the cluster
__device__ __forceinline__ uint32_t ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t remote, v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// The whole chain for one 128 x kBN tile; the cluster = all column tiles of
// the row block. Step s reads x (s = 0) or the buffer step s - 1 wrote, and
// writes tmp or out so that step chain - 1 lands in out.
template <int MODE, int kBN>
__global__ void __launch_bounds__(kThreads, 1) chain_kernel(ChainArgs p) {
  constexpr int ES = MODE == kModeBf16 ? 2 : 1;  // operand bytes
  typedef typename Acc<MODE>::type acc_t;
  extern __shared__ __align__(1024) unsigned char smem_chain[];
  const uint32_t ring_s = async_copy::shared_addr(smem_chain);
  const uint32_t part_s = ring_s + gemm_core::ring_bytes(kBN, true);  // 128 partial row maxima
  unsigned* part_max = reinterpret_cast<unsigned*>(smem_chain + gemm_core::ring_bytes(kBN, true));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kBN;
  const int64_t row_bytes = (int64_t)p.D * ES;
  auto buffer = [&](int step) { return ((p.chain - 1 - step) & 1) ? p.tmp : p.out; };

  acc_t acc[kBN / 8][4];
  gemm_core::zero(acc);
  for (int step = 0; step < p.chain; ++step) {
    const unsigned char* src = step == 0 ? p.x : buffer(step - 1);
    unsigned char* dst = buffer(step);
    gemm_core::ring_product<acc_t, kBN>(acc, src + m0 * row_bytes, row_bytes, p.M - m0,
                                        p.wt + n0 * row_bytes, row_bytes, (int)(row_bytes / 128),
                                        ring_s);

    // epilogue from the accumulator registers: element pairs (2h, 2h + 1) of
    // acc[j] are row g + 8h of the warp's 16-row slab, columns 8j + 2t, + 1
    float scale[2] = {0.f, 0.f};
    if constexpr (MODE == kModeRequant) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned row_abs = 0u;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          row_abs = max(row_abs, max(abs_u(acc[j][2 * h]), abs_u(acc[j][2 * h + 1])));
        row_abs = max(row_abs, __shfl_xor_sync(0xffffffffu, row_abs, 1));
        row_abs = max(row_abs, __shfl_xor_sync(0xffffffffu, row_abs, 2));
        if (t == 0) part_max[warp * 16 + g + 8 * h] = row_abs;
      }
      cluster_sync();  // every block's partial maxima are written
      const uint32_t n_blocks = cluster_blocks();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned row_abs = 0u;
        for (uint32_t rank = 0; rank < n_blocks; ++rank)
          row_abs = max(row_abs, ld_cluster(part_s + (warp * 16 + g + 8 * h) * 4, rank));
        scale[h] = __fdiv_rn(127.0f, fmaxf((float)row_abs, 1e-6f));
      }
    }
    // 16-byte stores: quad_transpose gives lane t the eight columns of tile
    // j0 + t (bf16), or the sixteen of tiles j0 + 2t, j0 + 2t + 1 (int8)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + g + 8 * h;
      const bool stored = m < p.M;
      unsigned char* orow = dst + m * row_bytes + (int64_t)n0 * ES;
      if constexpr (MODE == kModeBf16) {
#pragma unroll
        for (int j0 = 0; j0 < kBN / 8; j0 += 4) {
          uint32_t w[4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            w[k] = wgmma_common::pack_bf16(acc[j0 + k][2 * h], acc[j0 + k][2 * h + 1]);
          wgmma_common::quad_transpose(w);
          if (stored)
            *reinterpret_cast<uint4*>(orow + (j0 + t) * 16) = make_uint4(w[0], w[1], w[2], w[3]);
        }
      } else {
        // the two int8 results of tile j, packed into 16 bits
        auto quantise = [&](int j) {
          int q0, q1;
          if (MODE == kModeShift) {  // arithmetic shift, then the low 8 bits: an int8 cast's wrap
            q0 = acc[j][2 * h] >> 8, q1 = acc[j][2 * h + 1] >> 8;
          } else {
            q0 = (int)rintf(__fmul_rn((float)acc[j][2 * h], scale[h]));
            q1 = (int)rintf(__fmul_rn((float)acc[j][2 * h + 1], scale[h]));
          }
          return ((unsigned)q0 & 0xffu) | (((unsigned)q1 & 0xffu) << 8);
        };
#pragma unroll
        for (int j0 = 0; j0 < kBN / 8; j0 += 8) {
          uint32_t w[4];  // word k: tile j0 + 2k in the low half, j0 + 2k + 1 in the high
#pragma unroll
          for (int k = 0; k < 4; ++k) w[k] = quantise(j0 + 2 * k) | (quantise(j0 + 2 * k + 1) << 16);
          wgmma_common::quad_transpose(w);
          // word s now: lane s's columns of tile j0 + 2t (low) and j0 + 2t + 1 (high)
          if (stored)
            *reinterpret_cast<uint4*>(orow + j0 * 8 + t * 16) =
                make_uint4(__byte_perm(w[0], w[1], 0x5410), __byte_perm(w[2], w[3], 0x5410),
                           __byte_perm(w[0], w[1], 0x7632), __byte_perm(w[2], w[3], 0x7632));
        }
      }
    }
    // the next step reads what the cluster's other blocks wrote; and no block
    // may leave, or write its partial maxima again, while another reads them
    if (step + 1 < p.chain || MODE == kModeRequant) cluster_sync();
  }
}

// wt(N, K) = w(K, N)ᵀ for 1- or 2-byte elements; block (32, 8), 32 x 32 tiles
template <typename T>
__global__ void transpose_kernel(const T* w, T* wt, int K, int N) {
  __shared__ T tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  for (int j = threadIdx.y; j < 32; j += 8)
    tile[j][threadIdx.x] = w[(size_t)(k0 + j) * N + n0 + threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8)
    wt[(size_t)(n0 + j) * K + k0 + threadIdx.x] = tile[threadIdx.x][j];
}

template <int MODE, int kBN>
int launch_chain(const ChainArgs& p, cudaStream_t s) {
  constexpr int smem = gemm_core::ring_bytes(kBN, true) + kRows * 4;
  cudaFuncSetAttribute(chain_kernel<MODE, kBN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.D / kBN;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.D / kBN, (p.M + kRows - 1) / kRows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, chain_kernel<MODE, kBN>, p);
}

template <int kBN>
int launch_mode(int mode, const ChainArgs& p, cudaStream_t s) {
  if (mode == kModeBf16) return launch_chain<kModeBf16, kBN>(p, s);
  if (mode == kModeShift) return launch_chain<kModeShift, kBN>(p, s);
  return launch_chain<kModeRequant, kBN>(p, s);
}

// The column tile width for `dim`, or 0 where the kernel does not take it:
// the tiles of a row block are one cluster of 1, 2, 4 or 8 blocks.
int tile_width(int dim) {
  if (dim < 128 || dim % 128) return 0;
  for (int bn = 192; bn >= 128; bn -= 64) {
    const int n = dim / bn;
    if (dim % bn == 0 && (n == 1 || n == 2 || n == 4 || n == 8)) return bn;
  }
  return 0;
}

}  // namespace

// x (M, D), w (D, D) -> out (M, D) after `chain` steps. wt (D, D) and tmp
// (M, D) are scratch of the operand type; D as tile_width takes it. Two
// launches: the transpose and the chain. Returns the first CUDA error.
extern "C" int vittf_chain_gemm(const void* x, const void* w, void* wt, void* out, void* tmp,
                                int M, int D, int chain, int mode, void* stream) {
  const int bn = tile_width(D);
  if (!bn || M < 1 || chain < 1 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid(D / 32, D / 32), tblock(32, 8);
  if (mode == kModeBf16)
    transpose_kernel<unsigned short><<<tgrid, tblock, 0, s>>>(
        static_cast<const unsigned short*>(w), static_cast<unsigned short*>(wt), D, D);
  else
    transpose_kernel<unsigned char><<<tgrid, tblock, 0, s>>>(
        static_cast<const unsigned char*>(w), static_cast<unsigned char*>(wt), D, D);
  int err = (int)cudaGetLastError();
  if (err) return err;

  ChainArgs p;
  p.x = static_cast<const unsigned char*>(x);
  p.wt = static_cast<const unsigned char*>(wt);
  p.out = static_cast<unsigned char*>(out);
  p.tmp = static_cast<unsigned char*>(tmp);
  p.M = M, p.D = D, p.chain = chain;
  return bn == 192 ? launch_mode<192>(mode, p, s) : launch_mode<128>(mode, p, s);
}
