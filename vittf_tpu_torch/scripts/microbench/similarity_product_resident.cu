// Micro-benchmark behind the design of csrc/similarity.cu: the fp32 score
// product alone (no g, no class contraction), 128 voxels x 128 annotations a
// block, 8 x 8 a thread, the voxels' feature rows resident in shared memory
// and the queries through a cp.async ring. It times the product with all of
// its shared-memory loads, without the feature loads, without the query
// loads, without either, and under a second lane mapping: what the loads cost
// and whether what they broadcast matters. Prints ms and TFLOP/s at
// N = 64^3, F = 384, A = 1280.
//
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -std=c++17 \
//        -o similarity_product_resident similarity_product_resident.cu
//   ./similarity_product_resident
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
#include "../../csrc/async_copy.cuh"
using async_copy::cp_async16; using async_copy::cp_async_commit; using async_copy::cp_async_wait;
constexpr int kBa = 128, kBk = 16, kStages = 3, kThreads = 256, kQPitch = kBk + 4;
struct Args { const float* feats; const float* queries; float* out; int N, F, A; };

// V: 0 = mapping A (warp 16 vox x 128 ann), 1 = no A loads, 2 = no B loads, 3 = neither,
//    4 = mapping B (warp 32 vox x 64 ann), 5 = mapping A with B rows ag*8+j (contiguous)
template <int V>
__global__ void __launch_bounds__(kThreads, 1) k(const Args p) {
  constexpr int kVi = 8, kBn = 128;
  extern __shared__ __align__(16) float smem[];
  const int N = p.N, F = p.F, A = p.A;
  const int n_slabs = (F + kBk - 1) / kBk, fpitch = n_slabs * kBk + 4;
  float* fs = smem; float* qs = fs + kBn * fpitch;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  int vrow0, vstep, arow0, astep;
  if (V == 4) { const int wv = warp >> 1, wa = warp & 1, vg = lane >> 3, ag = lane & 7;
    vrow0 = wv * 32 + vg; vstep = 4; arow0 = wa * 64 + ag; astep = 8; }
  else if (V == 5) { const int vg = lane >> 4, ag = lane & 15; vrow0 = warp * 16 + vg; vstep = 2; arow0 = ag * 8; astep = 1; }
  else { const int vg = lane >> 4, ag = lane & 15; vrow0 = warp * 16 + vg; vstep = 2; arow0 = ag; astep = 16; }
  const int n0 = blockIdx.x * kBn;
  const int n_steps = (A + kBa - 1) / kBa * n_slabs;
  auto load_step = [&](int step) {
    if (step < n_steps) {
      const int chunk = step / n_slabs, f0 = (step - chunk * n_slabs) * kBk, a0 = chunk * kBa;
      float* slot = qs + (step % kStages) * kBa * kQPitch;
      for (int idx = t; idx < kBa * 4; idx += kThreads) {
        const int r = idx >> 2, c = (idx & 3) * 4; const bool ok = a0 + r < A && f0 + c < F;
        cp_async16(async_copy::shared_addr(slot + r * kQPitch + c), p.queries + (ok ? (int64_t)(a0 + r) * F + f0 + c : 0), ok ? 16 : 0);
      }
      if (chunk == 0) for (int idx = t; idx < kBn * 4; idx += kThreads) {
        const int r = idx >> 2, c = (idx & 3) * 4; const bool ok = n0 + r < N && f0 + c < F;
        cp_async16(async_copy::shared_addr(fs + r * fpitch + f0 + c), p.feats + (ok ? (int64_t)(n0 + r) * F + f0 + c : 0), ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  load_step(0); load_step(1);
  float s[kVi][8];
#pragma unroll
  for (int i = 0; i < kVi; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
  int slab = 0; float total = 0.f;
  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<kStages - 2>(); __syncthreads(); load_step(step + kStages - 1);
    const float* qb = qs + (step % kStages) * kBa * kQPitch + arow0 * kQPitch;
    const float* fb = fs + vrow0 * fpitch + slab * kBk;
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 4) {
      float4 y[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (V == 2 || V == 3) y[j] = make_float4(1.f + j, 2.f, 3.f + kk, 4.f);
        else y[j] = *reinterpret_cast<const float4*>(qb + astep * j * kQPitch + kk);
      }
#pragma unroll
      for (int i = 0; i < kVi; ++i) {
        float4 x;
        if (V == 1 || V == 3) x = make_float4(1.f + i, 2.f + kk, 3.f, 4.f + step);
        else x = *reinterpret_cast<const float4*>(fb + vstep * i * fpitch + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[i][j] = fmaf(x.x, y[j].x, s[i][j]); s[i][j] = fmaf(x.y, y[j].y, s[i][j]);
          s[i][j] = fmaf(x.z, y[j].z, s[i][j]); s[i][j] = fmaf(x.w, y[j].w, s[i][j]);
        }
      }
    }
    if (++slab < n_slabs) continue;
#pragma unroll
    for (int i = 0; i < kVi; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) { total += s[i][j]; s[i][j] = 0.f; }
    slab = 0;
  }
  cp_async_wait<0>();
  p.out[(int64_t)blockIdx.x * kThreads + t] = total;
}

template <int V> void run(const Args& a, const char* name) {
  const int n_slabs = (a.F + kBk - 1) / kBk;
  const int bytes = (128 * (n_slabs * kBk + 4) + kStages * kBa * kQPitch) * 4;
  cudaFuncSetAttribute(k<V>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  float best = 1e9;
  for (int r = 0; r < 4; ++r) {
    cudaEventRecord(e0); k<V><<<(a.N + 127) / 128, kThreads, bytes>>>(a); cudaEventRecord(e1);
    cudaEventSynchronize(e1); float ms; cudaEventElapsedTime(&ms, e0, e1); if (ms < best) best = ms;
  }
  printf("%s: %.3f ms  %.1f TFLOP/s  err=%d\n", name, best, 2.0 * a.N * a.A * a.F / best / 1e9, (int)cudaGetLastError());
}
int main() {
  Args a; a.N = 262144; a.F = 384; a.A = 1280;
  float *f, *q, *o; cudaMalloc(&f, (size_t)a.N * a.F * 4); cudaMalloc(&q, (size_t)a.A * a.F * 4); cudaMalloc(&o, (size_t)a.N * 8 * 4);
  cudaMemset(f, 0, (size_t)a.N * a.F * 4); cudaMemset(q, 0, (size_t)a.A * a.F * 4);
  a.feats = f; a.queries = q; a.out = o;
  run<0>(a, "V0 mapping A, all loads"); run<1>(a, "V1 no A loads"); run<2>(a, "V2 no B loads");
  run<3>(a, "V3 no loads"); run<4>(a, "V4 mapping B (32x64 warp)"); run<5>(a, "V5 mapping A, contiguous B rows");
  run<0>(a, "V0 again");
  return 0;
}
