// Fused per-voxel similarity maps for Hopper (sm_90a):
//
//   out[c, n] = sum_a M[a, c] * g(f_n . q_a)        (mean_first = 0)
//   out[c, n] = g(sum_a M[a, c] * (f_n . q_a))      (mean_first = 1)
//
// with g(s) = where(s >= threshold, s, 0) ** exponent, all in IEEE fp32.
//
// Replaces: vittf_tpu/ops/similarity.py::similarity_pallas and its body
// _similarity_kernel. As there, the (N x A) score matrix never reaches device
// memory, and every annotation chunk is summed inside the block (the TPU
// kernel carried the sum across its sequential grid axis instead), so there is
// no cross-block reduction and no atomic: a launch equals its repeat.
//
// What bounds it on the H100: the score GEMM, 2·N·F·A flops (258 GFLOP at
// N = 64³, F = 384, A = 1280), in fp32 because the similarity maps are
// bit-defined by the reference and TF32 keeps only ~3 decimal digits. So it is
// bound by the FP32 cores (no tensor core takes IEEE fp32), and next to them
// by the path from shared memory into the registers: it returns 128 bytes a
// clock to an SM whatever a load broadcasts, so a 16-byte load per thread costs
// four clocks, the time of sixteen FMAs. The design is about that ratio:
//   - a block owns 128 voxels and walks chunks of 256 annotations; each of 256
//     threads owns a 16 x 8 patch of the 128 x 256 score tile, 512 FMAs per
//     twenty-four 16-byte loads (an 8 x 4 patch does 32 per three, an 8 x 8
//     patch 256 per sixteen: measured 33.8 against 42.8 TFLOP/s for the
//     larger patch in the product alone);
//   - feature and query rows arrive as slabs of 32 features in a three-slot
//     cp.async ring: slab i + 2 is in flight while slab i is multiplied, with
//     one __syncthreads() a slab. Rows lie k-major as they arrive (no
//     transposing stores) with a pitch of 36 words, so the eight rows a
//     quarter-warp reads fall in distinct banks;
//   - a warp owns 16 voxels across all 256 annotations of the chunk: its 32
//     lanes hold the same 16 voxels and 32 x 8 different annotations. So the
//     class contraction needs no block-wide step. It runs in annotation order,
//     one fmaf chain per (voxel, class), through a per-warp transposing
//     buffer and the warp's own rows of a (C, 128) shared-memory accumulator:
//     rows of M that are 0 change nothing, so a class's map has the same bits
//     whatever other classes are computed beside it (the served session
//     recomputes edited classes alone and must equal a full recompute);
//   - g costs one powf per score, the kernel's only long dependent chain. A
//     row of the patch is one voxel against runs of 32 neighbouring
//     annotations, so a whole warp skips g for a voxel that passes the
//     threshold nowhere (the value is then powf(0, exponent), taken once).
// Zero-filled query rows past A give s = 0 and are left out of the
// contraction; any F % 4 == 0 and any A, N work (ragged edges are zero-filled
// by the copies).
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

using async_copy::cp_async16;
using async_copy::cp_async_commit;
using async_copy::cp_async_wait;

constexpr int kBn = 128;      // voxels per block: 8 warps x 16
constexpr int kBa = 256;      // annotations per chunk
constexpr int kBk = 32;       // features per slab
constexpr int kStages = 3;    // ring depth
constexpr int kThreads = 256; // 8 warps; a warp owns 16 voxels x the chunk's 256 annotations
constexpr int kVi = 16;       // voxels per thread:      w0 + i, the same for all 32 lanes
constexpr int kAj = 8;        // annotations per thread: lane + 32j
constexpr int kMaxC = 32;
constexpr int kPitch = kBk + 4;      // slab row pitch in words
constexpr int kRows = kBn + kBa;     // rows of one ring slot: voxels, then annotations
constexpr int kVecs = kBk / 4;       // 16-byte vectors per slab row
constexpr int kTbPitch = 33;         // transposing buffer: 32 annotations + 1 word of padding
constexpr int kChains = 4;           // classes a lane contracts side by side

struct Args {
  const float* feats;    // (N, F)
  const float* queries;  // (A, F)
  const float* mmat;     // (A, C)
  float* out;            // (C, N)
  int N, F, A, C;
  float threshold, exponent;
  int mean_first;
};

inline size_t smem_bytes(int C) {
  return (size_t)(kStages * kRows * kPitch + C * kBn + (kThreads / 32) * kVi * kTbPitch) *
         sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 1) similarity_kernel(const Args p) {
  extern __shared__ __align__(16) float smem[];
  float* os = smem + kStages * kRows * kPitch;  // [C][kBn]: the maps' accumulator
  const float* __restrict__ mmat = p.mmat;
  const int N = p.N, F = p.F, A = p.A, C = p.C, mean_first = p.mean_first;
  const float threshold = p.threshold, exponent = p.exponent;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int w0 = warp * kVi;  // the warp's first voxel of the tile
  float* tb = os + C * kBn + warp * kVi * kTbPitch;  // [kVi][kTbPitch]: the warp's transposing buffer
  const int n0 = blockIdx.x * kBn;
  const int n_slabs = (F + kBk - 1) / kBk;
  const int n_steps = (A + kBa - 1) / kBa * n_slabs;
  const float pow_zero = powf(0.f, exponent);  // g below the threshold

  // step = (annotation chunk, feature slab), chunks outermost
  int ld_slab = 0, ld_a0 = 0;
  auto load_step = [&](int step) {
    if (step < n_steps) {
      float* slot = smem + (step % kStages) * kRows * kPitch;
      const int f0 = ld_slab * kBk;
      for (int idx = t; idx < kRows * kVecs; idx += kThreads) {
        const int r = idx / kVecs, c = (idx % kVecs) * 4;
        const bool is_query = r >= kBn;
        const int row = is_query ? ld_a0 + r - kBn : n0 + r;
        const bool ok = row < (is_query ? A : N) && f0 + c < F;
        // a masked copy still names a valid address: the matrix's first element
        const float* src = (is_query ? p.queries : p.feats) + (ok ? (int64_t)row * F + f0 + c : 0);
        cp_async16(async_copy::shared_addr(slot + r * kPitch + c), src, ok ? 16 : 0);
      }
      if (++ld_slab == n_slabs) {
        ld_slab = 0;
        ld_a0 += kBa;
      }
    }
    cp_async_commit();  // an empty group keeps the count of pending groups uniform
  };

  load_step(0);
  load_step(1);
  for (int i = lane; i < C * kVi; i += 32) os[(i / kVi) * kBn + w0 + i % kVi] = 0.f;

  float s[kVi][kAj];
#pragma unroll
  for (int i = 0; i < kVi; ++i)
#pragma unroll
    for (int j = 0; j < kAj; ++j) s[i][j] = 0.f;

  int slab = 0, a0 = 0;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>();   // this thread's copies of `step` have landed
    __syncthreads();                // ... everyone's have, and step - 1 is no longer read
    load_step(step + kStages - 1);  // into the slot step - 1 used

    const float* slot = smem + (step % kStages) * kRows * kPitch;
    const float* fb = slot + w0 * kPitch;
    const float* qb = slot + (kBn + lane) * kPitch;
#pragma unroll
    for (int k = 0; k < kBk; k += 4) {
      float4 y[kAj];
#pragma unroll
      for (int j = 0; j < kAj; ++j)
        y[j] = *reinterpret_cast<const float4*>(qb + 32 * j * kPitch + k);
#pragma unroll
      for (int i = 0; i < kVi; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(fb + i * kPitch + k);  // a broadcast
#pragma unroll
        for (int j = 0; j < kAj; ++j) {
          s[i][j] = fmaf(x.x, y[j].x, s[i][j]);
          s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
          s[i][j] = fmaf(x.z, y[j].z, s[i][j]);
          s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
        }
      }
    }
    if (++slab < n_slabs) continue;

    // The chunk's scores are complete. A row of s is one voxel against 32
    // consecutive annotations per j, so whether it passes the threshold is
    // nearly uniform over the warp: g is skipped for a row none of whose
    // scores passes. powf is ~120 instructions, one dependent chain (265
    // clocks a call at two warps a scheduler); g works on row 0 and the rows
    // rotate (16 turns bring them home), so the code holds 8 copies of it and
    // not 128, which would not stay in the instruction cache (measured: 7.6
    // against 9.9 ms for the whole kernel).
    if (!mean_first) {
#pragma unroll 1
      for (int turn = 0; turn < kVi; ++turn) {
        float row[kAj];
        bool any = false;
#pragma unroll
        for (int j = 0; j < kAj; ++j) {
          row[j] = s[0][j];
          any |= row[j] >= threshold;
        }
        if (__any_sync(0xffffffffu, any)) {
#pragma unroll
          for (int j = 0; j < kAj; ++j) {
            const bool pass = row[j] >= threshold;
            const float pw = powf(pass ? row[j] : 1.f, exponent);
            row[j] = pass ? pw : pow_zero;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kAj; ++j) row[j] = pow_zero;
        }
#pragma unroll
        for (int j = 0; j < kAj; ++j) {
#pragma unroll
          for (int i = 0; i + 1 < kVi; ++i) s[i][j] = s[i + 1][j];
          s[kVi - 1][j] = row[j];
        }
      }
    }
    // Contract with M in annotation order: out[v][c] = fmaf(M[a][c], g[v][a],
    // out[v][c]) for a ascending, one chain per (voxel, class). A row of M
    // that is 0 leaves the sum as it is, so a class's map depends on its own
    // annotations only, not on where they lie among the others': the same
    // class alone gives the same bits. The chains run along the annotations,
    // which lie across the lanes, so each group of 32 annotations goes through
    // a per-warp transposing buffer: lane (v, c mod 2) then walks voxel v's 32
    // scores for its classes, keeping the sums in the warp's rows of `os`.
    const int v = lane & 15;
#pragma unroll
    for (int j = 0; j < kAj; ++j) {
      const int a_first = a0 + 32 * j, n_a = min(32, A - a_first);
      if (n_a > 0) {  // the same for the whole block
#pragma unroll
        for (int i = 0; i < kVi; ++i) tb[i * kTbPitch + lane] = s[i][j];
        __syncwarp();
        // a lane's classes go four at a time, so that four chains overlap
        for (int c0 = lane >> 4; c0 < C; c0 += 2 * kChains) {
          float sum[kChains];
#pragma unroll
          for (int k = 0; k < kChains; ++k)
            sum[k] = c0 + 2 * k < C ? os[(c0 + 2 * k) * kBn + w0 + v] : 0.f;
          const float* m_row = mmat + (int64_t)a_first * C + c0;
#pragma unroll 8
          for (int x = 0; x < n_a; ++x, m_row += C) {
            const float gx = tb[v * kTbPitch + x];
#pragma unroll
            for (int k = 0; k < kChains; ++k)
              if (c0 + 2 * k < C) sum[k] = fmaf(__ldg(m_row + 2 * k), gx, sum[k]);
          }
#pragma unroll
          for (int k = 0; k < kChains; ++k)
            if (c0 + 2 * k < C) os[(c0 + 2 * k) * kBn + w0 + v] = sum[k];
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int i = 0; i < kVi; ++i)
#pragma unroll
      for (int j = 0; j < kAj; ++j) s[i][j] = 0.f;
    slab = 0;
    a0 += kBa;
  }
  cp_async_wait<0>();  // nothing of this block is in flight when it leaves

  __syncwarp();
  for (int i = lane; i < C * kVi; i += 32) {
    const int c = i / kVi, r = w0 + i % kVi;
    if (n0 + r < N) {
      const float v = os[c * kBn + r];
      p.out[(int64_t)c * N + n0 + r] =
          mean_first ? (v >= threshold ? powf(v, exponent) : pow_zero) : v;
    }
  }
}

}  // namespace

// feats (N, F), queries (A, F), mmat (A, C), out (C, N): contiguous fp32.
// Requires F % 4 == 0, 16-byte aligned feats/queries, 1 <= C <= 32.
// Returns cudaGetLastError() after the launch.
extern "C" int vittf_similarity(const float* feats, const float* queries, const float* mmat,
                                float* out, int N, int F, int A, int C, float threshold,
                                float exponent, int mean_first, void* stream) {
  if (C < 1 || C > kMaxC || F < 4 || F % 4 != 0 || N < 1 || A < 1)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(C);
  const cudaError_t e = cudaFuncSetAttribute(
      similarity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const Args p = {feats, queries, mmat, out, N, F, A, C, threshold, exponent, mean_first};
  similarity_kernel<<<(N + kBn - 1) / kBn, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
