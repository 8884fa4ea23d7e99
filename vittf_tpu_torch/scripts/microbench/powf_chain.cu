// Micro-benchmark behind the g pass of csrc/similarity.cu: what one powf costs
// a warp when few warps share a scheduler, as one dependent chain and as four
// chains side by side. Prints ms and clocks per powf and warp (at 1.7 GHz).
//
//   nvcc -O3 -gencode arch=compute_90a,code=sm_90a -o powf_chain powf_chain.cu
//   ./powf_chain
#include <cstdio>
#include <cuda_runtime.h>
__global__ void k(float* out, float e, int iters) {
  float x = 0.3f + 1e-6f * (threadIdx.x + blockIdx.x), acc = 0.f;
  for (int i = 0; i < iters; ++i) { acc += powf(x, e); x += 1e-4f; }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
__global__ void k4(float* out, float e, int iters) {
  float x = 0.3f + 1e-6f * (threadIdx.x + blockIdx.x), a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int i = 0; i < iters; i += 4) { a0 += powf(x, e); a1 += powf(x + 0.1f, e); a2 += powf(x + 0.2f, e); a3 += powf(x + 0.3f, e); x += 1e-4f; }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1 + a2 + a3;
}
int main() {
  float* o; cudaMalloc(&o, 132 * 2048 * 4);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  for (int warps : {8, 16}) for (int v = 0; v < 2; ++v) {
    const int iters = 1024; float ms;
    for (int r = 0; r < 2; ++r) {
      cudaEventRecord(e0);
      if (v == 0) k<<<132, warps * 32>>>(o, 2.5f, iters); else k4<<<132, warps * 32>>>(o, 2.5f, iters);
      cudaEventRecord(e1); cudaEventSynchronize(e1); cudaEventElapsedTime(&ms, e0, e1);
    }
    printf("warps/SM %d, %s: %.4f ms, %.1f clk per powf per warp (at 1.7 GHz), %.2f Gpowf/s\n", warps, v ? "4 chains" : "1 chain",
           ms, ms * 1e-3 * 1.7e9 / iters, 132.0 * warps * 32 * iters / ms / 1e6);
  }
  return 0;
}
