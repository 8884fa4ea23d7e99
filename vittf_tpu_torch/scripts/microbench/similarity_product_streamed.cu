// Micro-benchmark behind the design of csrc/similarity.cu: the fp32 score
// product alone (no g, no class contraction) with both operands streamed
// through a three-slot cp.async ring, 128 voxels a block, for 8 x 8 and 8 x 16
// patches a thread (128 or 256 annotations a chunk) and slabs of 16 or 32
// features. Prints ms and TFLOP/s at N = 64^3, F = 384, A = 1280.
//
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 \
//        -o similarity_product_streamed similarity_product_streamed.cu
//   ./similarity_product_streamed
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
#include "../../csrc/async_copy.cuh"
using async_copy::cp_async16; using async_copy::cp_async_commit; using async_copy::cp_async_wait;
constexpr int kBn = 128, kStages = 3, kThreads = 256;
struct Args { const float* feats; const float* queries; float* out; int N, F, A; };

template <int kBk, int kBa>  // kBa = 128 (8x8) or 256 (8x16)
__global__ void __launch_bounds__(kThreads, 1) k(const Args p) {
  constexpr int kPitch = kBk + 4, kJ = kBa / 16, kRows = kBn + kBa, kVec = kBk / 4;
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, F = p.F, A = p.A;
  const int n_slabs = (F + kBk - 1) / kBk;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, vg = lane >> 4, ag = lane & 15;
  const int n0 = blockIdx.x * kBn;
  const int n_steps = (A + kBa - 1) / kBa * n_slabs;
  int ld_slab = 0, ld_a0 = 0;
  auto load_step = [&](int step) {
    if (step < n_steps) {
      float* slot = smem + (step % kStages) * kRows * kPitch;
      const int f0 = ld_slab * kBk;
      for (int idx = t; idx < kRows * kVec; idx += kThreads) {
        const int r = idx / kVec, c = (idx % kVec) * 4;
        const bool isq = r >= kBn;
        const int row = isq ? ld_a0 + r - kBn : n0 + r;
        const bool ok = row < (isq ? A : N) && f0 + c < F;
        const float* src = (isq ? p.queries : p.feats) + (ok ? (int64_t)row * F + f0 + c : 0);
        cp_async16(async_copy::shared_addr(slot + r * kPitch + c), src, ok ? 16 : 0);
      }
      if (++ld_slab == n_slabs) { ld_slab = 0; ld_a0 += kBa; }
    }
    cp_async_commit();
  };
  load_step(0); load_step(1);
  float s[8][kJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) s[i][j] = 0.f;
  int slab = 0; float total = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>(); __syncthreads(); load_step(step + kStages - 1);
    const float* fb = smem + (step % kStages) * kRows * kPitch + (warp * 16 + vg) * kPitch;
    const float* qb = smem + (step % kStages) * kRows * kPitch + (kBn + ag) * kPitch;
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 4) {
      float4 x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = *reinterpret_cast<const float4*>(fb + 2 * i * kPitch + kk);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const float4 y = *reinterpret_cast<const float4*>(qb + 16 * j * kPitch + kk);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i][j] = fmaf(x[i].x, y.x, s[i][j]); s[i][j] = fmaf(x[i].y, y.y, s[i][j]);
          s[i][j] = fmaf(x[i].z, y.z, s[i][j]); s[i][j] = fmaf(x[i].w, y.w, s[i][j]);
        }
      }
    }
    if (++slab < n_slabs) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kJ; ++j) { total += s[i][j]; s[i][j] = 0.f; }
    slab = 0;
  }
  cp_async_wait<0>();
  p.out[(int64_t)blockIdx.x * kThreads + t] = total;
}

template <int kBk, int kBa> void run(const Args& a, const char* name) {
  const int bytes = kStages * (kBn + kBa) * (kBk + 4) * 4;
  cudaFuncSetAttribute(k<kBk, kBa>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  float best = 1e9;
  for (int r = 0; r < 4; ++r) {
    cudaEventRecord(e0); k<kBk, kBa><<<(a.N + 127) / 128, kThreads, bytes>>>(a); cudaEventRecord(e1);
    cudaEventSynchronize(e1); float ms; cudaEventElapsedTime(&ms, e0, e1); if (ms < best) best = ms;
  }
  printf("%s: smem %d  %.3f ms  %.1f TFLOP/s  err=%d\n", name, bytes, best, 2.0 * a.N * a.A * a.F / best / 1e9, (int)cudaGetLastError());
}
int main() {
  Args a; a.N = 262144; a.F = 384; a.A = 1280;
  float *f, *q, *o; cudaMalloc(&f, (size_t)a.N * a.F * 4); cudaMalloc(&q, (size_t)a.A * a.F * 4); cudaMalloc(&o, (size_t)a.N * 8 * 4);
  cudaMemset(f, 0, (size_t)a.N * a.F * 4); cudaMemset(q, 0, (size_t)a.A * a.F * 4);
  a.feats = f; a.queries = q; a.out = o;
  run<16, 128>(a, "8x8 kBk16"); run<32, 128>(a, "8x8 kBk32"); run<16, 256>(a, "8x16 kBk16"); run<32, 256>(a, "8x16 kBk32");
  run<32, 256>(a, "8x16 kBk32 again");
  return 0;
}
