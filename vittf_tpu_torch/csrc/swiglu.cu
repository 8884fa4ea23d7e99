// K10: the SwiGLU gate of DINOv2's FFN, out = bf16(silu(x1) * x2), where
// [x1 | x2] is a row of the w12 projection (bias already added by cuBLAS).
//
// Replaces no TPU kernel: the JAX package's ViT has no SwiGLU FFN. It exists
// so that the gate between the two cuBLAS products of a DINOv2 ViT-g block is
// one pass over the (M, 2H) projection instead of PyTorch's chunk, silu, cast
// and multiply passes.
//
// Bound: memory. A launch reads 4·M·H bytes and writes 2·M·H (6·M·H in all,
// 809 MB at M = 32 928, H = 4096: 0.242 ms at 3.35 TB/s) and does a few
// operations a value. Design: each thread takes one 16-byte vector of x1, the
// matching vector of x2 and writes one 16-byte vector of out (8 bf16 each),
// neighbouring threads on neighbouring vectors, so every load and store is a
// full 128-byte line per 8 threads; silu and the product run in fp32 and
// round once, as ops/swiglu.py::swiglu_plain does. The grid strides over all
// M · H/8 output vectors; the row of a vector is one 32-bit division where
// the count fits 32 bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

template <typename Index>
__global__ void __launch_bounds__(kThreads)
swiglu_gate_kernel(const uint4* __restrict__ x12, uint4* __restrict__ out, Index total,
                   Index hv) {
  const Index stride = (Index)gridDim.x * kThreads;
  for (Index v = (Index)blockIdx.x * kThreads + threadIdx.x; v < total; v += stride) {
    const Index r = v / hv;
    const Index c = v - r * hv;
    const uint4 a = __ldg(x12 + 2 * r * hv + c);
    const uint4 b = __ldg(x12 + 2 * r * hv + hv + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
    uint4 o;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(a2[i]);
      const float2 fb = __bfloat1622float2(b2[i]);
      o2[i] = __floats2bfloat162_rn(silu(fa.x) * fb.x, silu(fa.y) * fb.y);
    }
    out[v] = o;
  }
}

}  // namespace

// x12: (rows, 2 * hidden) bf16, contiguous, 16-byte aligned; out: (rows,
// hidden) bf16, contiguous. hidden a multiple of 8.
extern "C" int vittf_swiglu(const void* x12, void* out, long long rows, int hidden,
                            void* stream) {
  if (rows < 0 || hidden <= 0 || hidden % 8) return (int)cudaErrorInvalidValue;
  const int64_t hv = hidden / 8;
  const int64_t total = (int64_t)rows * hv;
  if (total == 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* in = static_cast<const uint4*>(x12);
  uint4* o = static_cast<uint4*>(out);
  if (2 * total < ((int64_t)1 << 32))
    swiglu_gate_kernel<uint32_t><<<grid, kThreads, 0, s>>>(in, o, (uint32_t)total, (uint32_t)hv);
  else
    swiglu_gate_kernel<int64_t><<<grid, kThreads, 0, s>>>(in, o, total, hv);
  return (int)cudaGetLastError();
}
