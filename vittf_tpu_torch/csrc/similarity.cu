// Fused per-voxel similarity maps for Hopper (sm_90a):
//
//   out[c, n] = sum_a M[a, c] * g(f_n . q_a)        (mean_first = 0)
//   out[c, n] = g(sum_a M[a, c] * (f_n . q_a))      (mean_first = 1)
//
// with g(s) = where(s >= threshold, s, 0) ** exponent, all in IEEE fp32.
//
// Replaces: vittf_tpu/ops/similarity.py::similarity_pallas and its body
// _similarity_kernel. As there, the (N x A) score matrix never reaches device
// memory: each block owns 128 voxels, loops over 64-annotation chunks, forms
// the 128x64 score tile from shared-memory slabs of 16 features, applies g and
// contracts the tile with the chunk's rows of M into a (C x 128) fp32
// accumulator. Every annotation chunk is summed inside the block, so no
// cross-block reduction is needed (the TPU kernel carried the sum across its
// sequential grid axis instead).
//
// What bounds it on the H100: the score GEMM, 2·N·F·A flops (258 GFLOP at
// N = 64³, F = 384, A = 1280), in fp32 because the similarity maps are
// bit-defined by the reference and TF32 keeps only ~3 decimal digits. So it is
// bound by the FP32 cores. Each thread keeps an 8x4 patch of the score tile in
// registers and reads three float4 per 32 FMAs. The class contraction
// (C/F of the flops) runs from shared memory. powf costs one call per score.
// Zero-padded query rows give s = 0 and meet zero rows of M, so they add 0.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBn = 128;      // voxels per block
constexpr int kBa = 64;       // annotations per chunk
constexpr int kBk = 16;       // features per shared-memory slab
constexpr int kThreads = 256; // 16 voxel groups of 8 x 16 annotation groups of 4
constexpr int kMaxC = 32;
constexpr int kFsPad = kBn + 4;  // row pads keep float4 alignment, halve bank conflicts
constexpr int kQsPad = kBa + 4;

struct Slabs {
  float f[kBk][kFsPad];  // [feature][voxel]
  float q[kBk][kQsPad];  // [feature][annotation]
};
union __align__(16) SharedTiles {
  Slabs slab;
  float gs[kBa][kBn];    // score tile after g, [annotation][voxel]
};

__device__ __forceinline__ float g(float s, float threshold, float exponent) {
  return powf(s >= threshold ? s : 0.f, exponent);
}

__global__ void __launch_bounds__(kThreads)
similarity_kernel(const float* __restrict__ feats, const float* __restrict__ queries,
                  const float* __restrict__ mmat, float* __restrict__ out, int N, int F,
                  int A, int C, float threshold, float exponent, int mean_first) {
  __shared__ SharedTiles sm;
  __shared__ float ms[kBa][kMaxC];

  const int t = threadIdx.x;
  const int tn = t & 15, ta = t >> 4;  // voxels tn*8..+7, annotations ta*4..+3
  const int n0 = blockIdx.x * kBn;
  const int en = t & (kBn - 1), ec = t >> 7;  // epilogue: voxel en, classes ec, ec+2, ...
  float acc[kMaxC / 2];
#pragma unroll
  for (int j = 0; j < kMaxC / 2; ++j) acc[j] = 0.f;

  for (int a0 = 0; a0 < A; a0 += kBa) {
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int f0 = 0; f0 < F; f0 += kBk) {
      __syncthreads();  // previous slab (or epilogue tile) fully read
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int idx = t + it * kThreads, row = idx >> 2, c4 = (idx & 3) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n0 + row < N && f0 + c4 < F)
          v = *reinterpret_cast<const float4*>(feats + (int64_t)(n0 + row) * F + f0 + c4);
        sm.slab.f[c4 + 0][row] = v.x;
        sm.slab.f[c4 + 1][row] = v.y;
        sm.slab.f[c4 + 2][row] = v.z;
        sm.slab.f[c4 + 3][row] = v.w;
      }
      {
        const int row = t >> 2, c4 = (t & 3) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (a0 + row < A && f0 + c4 < F)
          v = *reinterpret_cast<const float4*>(queries + (int64_t)(a0 + row) * F + f0 + c4);
        sm.slab.q[c4 + 0][row] = v.x;
        sm.slab.q[c4 + 1][row] = v.y;
        sm.slab.q[c4 + 2][row] = v.z;
        sm.slab.q[c4 + 3][row] = v.w;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBk; ++k) {
        const float4 x0 = *reinterpret_cast<const float4*>(&sm.slab.f[k][tn * 8]);
        const float4 x1 = *reinterpret_cast<const float4*>(&sm.slab.f[k][tn * 8 + 4]);
        const float4 y = *reinterpret_cast<const float4*>(&sm.slab.q[k][ta * 4]);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(xv[i], yv[j], s[i][j]);
      }
    }

    __syncthreads();  // slabs are dead; the union becomes the score tile
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float e[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = mean_first ? s[i][j] : g(s[i][j], threshold, exponent);
      *reinterpret_cast<float4*>(&sm.gs[ta * 4 + j][tn * 8]) = make_float4(e[0], e[1], e[2], e[3]);
      *reinterpret_cast<float4*>(&sm.gs[ta * 4 + j][tn * 8 + 4]) = make_float4(e[4], e[5], e[6], e[7]);
    }
    for (int idx = t; idx < kBa * C; idx += kThreads) {
      const int a = idx / C, c = idx - a * C;
      ms[a][c] = (a0 + a < A) ? mmat[(int64_t)(a0 + a) * C + c] : 0.f;
    }
    __syncthreads();
    for (int a = 0; a < kBa; ++a) {
      const float gv = sm.gs[a][en];
#pragma unroll
      for (int j = 0; j < kMaxC / 2; ++j) {
        const int c = ec + 2 * j;
        if (c < C) acc[j] = fmaf(ms[a][c], gv, acc[j]);
      }
    }
  }

  if (n0 + en < N) {
#pragma unroll
    for (int j = 0; j < kMaxC / 2; ++j) {
      const int c = ec + 2 * j;
      if (c < C)
        out[(int64_t)c * N + n0 + en] = mean_first ? g(acc[j], threshold, exponent) : acc[j];
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
  if (C < 1 || C > kMaxC || F % 4 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kBn - 1) / kBn;
  similarity_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      feats, queries, mmat, out, N, F, A, C, threshold, exponent, mean_first);
  return (int)cudaGetLastError();
}
