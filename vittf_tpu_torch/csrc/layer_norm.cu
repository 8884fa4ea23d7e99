// K11: the residual adds and LayerNorms of a per-op ViT block, one pass over
// the rows of the (M, D) bf16 residual stream, in three modes:
//   LN:            y  = bf16(bf16(bf16((x - mu) * rsqrt(var + eps)) * w) + b)
//   residual + LN: x' = bf16(x + bf16(a * gamma)), or bf16(x + a) without
//                  gamma, then y = LN(x') of the rounded x'
//   residual:      x' alone
// mu and var in fp32 from the row held in registers: the mean, then the mean
// of the squared deviations (not E[x^2] - E[x]^2). It rounds where
// ops/layer_norm.py::_layer_norm and residual_plain round; only the order of
// the two fp32 sums differs from PyTorch's.
//
// Replaces no TPU kernel: XLA fuses these passes in the JAX package. In
// PyTorch the per-op block ran about ten launches a LayerNorm (a cast, two
// means, a subtract, a square, rsqrt, a multiply, a cast, the scale, the
// shift) and two more a residual, ~132-140 bytes an element of the residual
// stream a block; with K11 a block moves 18 (LN1 4, residual + LN2 8, the
// last residual 6).
//
// Bound: memory, a few operations a byte. Design: one warp a row; a lane
// holds V = ceil(D / 256) 16-byte vectors (8 bf16 values each) of x and of a,
// neighbouring lanes on neighbouring vectors, so every load and store moves
// whole 128-byte lines; the sums are warp shuffles, with no shared memory;
// gamma, w and b (the same for every row) come through the read-only cache.
// Blocks of 4 warps (8 or 16 ran 1-4% slower); the grid strides over the
// rows. V is a template parameter: 1 to 8 (D <= 2048), and 16 for any wider
// row up to 4096 (DINOv3 ViT-7B's D 4096: a lane holds its 128 values of x'
// in registers, as at the narrower widths).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxVecs = 16;  // a lane's vectors: D <= 16 * 8 * 32
constexpr int64_t kMaxBlocks = 132 * 64;
enum Mode { kLn = 0, kResidualLn = 1, kResidual = 2 };

__device__ __forceinline__ void to_float(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 to_bf16(const float* f) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// RES: x' = x + a (times gamma where gamma is given) is formed and written to
// x_out; NORM: y = LN(x') (LN(x) without RES) is written to y_out.
template <int V, bool RES, bool NORM>
__global__ void __launch_bounds__(kWarps * 32)
residual_layer_norm_kernel(const uint4* __restrict__ x, const uint4* __restrict__ a,
                           const uint4* __restrict__ gamma, const uint4* __restrict__ w,
                           const uint4* __restrict__ b, uint4* __restrict__ x_out,
                           uint4* __restrict__ y_out, int64_t rows, int dv, float inv_d,
                           float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t r = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5); r < rows; r += stride) {
    const int64_t row = r * dv;
    uint4 xv[V], av[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      if (c < dv) {
        xv[i] = x[row + c];
        if (RES) av[i] = a[row + c];
      }
    }
    float v[V][8];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      if (c < dv) {
        to_float(xv[i], v[i]);
        if (RES) {
          float t[8];
          to_float(av[i], t);
          if (gamma != nullptr) {
            float g[8];
            to_float(__ldg(gamma + c), g);
#pragma unroll
            for (int k = 0; k < 8; ++k) t[k] = round_bf16(t[k] * g[k]);
          }
#pragma unroll
          for (int k = 0; k < 8; ++k) v[i][k] = round_bf16(v[i][k] + t[k]);
          x_out[row + c] = to_bf16(v[i]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) sum += v[i][k];
      }
    }
    if (!NORM) continue;
    const float mu = __fmul_rn(warp_sum(sum), inv_d);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (lane + 32 * i < dv) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = v[i][k] - mu;
          sq += d * d;
        }
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(sq), inv_d), eps));
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = lane + 32 * i;
      if (c < dv) {
        float wf[8], bf[8];
        to_float(__ldg(w + c), wf);
        to_float(__ldg(b + c), bf);
#pragma unroll
        for (int k = 0; k < 8; ++k)  // the shift's sum is rounded by to_bf16
          v[i][k] = round_bf16(round_bf16((v[i][k] - mu) * rstd) * wf[k]) + bf[k];
        y_out[row + c] = to_bf16(v[i]);
      }
    }
  }
}

using Kernel = void (*)(const uint4*, const uint4*, const uint4*, const uint4*, const uint4*,
                        uint4*, uint4*, int64_t, int, float, float);

template <int V>
Kernel pick_mode(int mode) {
  if (mode == kLn) return residual_layer_norm_kernel<V, false, true>;
  if (mode == kResidualLn) return residual_layer_norm_kernel<V, true, true>;
  return residual_layer_norm_kernel<V, true, false>;
}

Kernel pick(int vecs, int mode) {
  switch (vecs) {
    case 1: return pick_mode<1>(mode);
    case 2: return pick_mode<2>(mode);
    case 3: return pick_mode<3>(mode);
    case 4: return pick_mode<4>(mode);
    case 5: return pick_mode<5>(mode);
    case 6: return pick_mode<6>(mode);
    case 7: return pick_mode<7>(mode);
    case 8: return pick_mode<8>(mode);
    default: return vecs <= kMaxVecs ? pick_mode<kMaxVecs>(mode) : nullptr;
  }
}

int lane_vectors(int dim) { return (dim / 8 + 31) / 32; }

}  // namespace

// x, a, x_out, y_out: (rows, dim) bf16, contiguous, 16-byte aligned; gamma, w,
// b: (dim,) bf16, 16-byte aligned; dim a multiple of 8, at most 4096. The mode
// follows from what is given: no a, LN (x_out unused); no w, residual (b and
// y_out unused); both, residual + LN. gamma may be null.
extern "C" int vittf_layer_norm(const void* x, const void* a, const void* gamma, const void* w,
                                const void* b, void* x_out, void* y_out, long long rows,
                                int dim, float eps, void* stream) {
  if (rows < 0 || dim <= 0 || dim % 8 || dim > kMaxVecs * 256) return (int)cudaErrorInvalidValue;
  const int mode = a == nullptr ? kLn : (w == nullptr ? kResidual : kResidualLn);
  if ((mode != kResidual && (w == nullptr || b == nullptr || y_out == nullptr)) ||
      (mode != kLn && x_out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  const dim3 grid((unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks));
  pick(lane_vectors(dim), mode)<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(a),
      static_cast<const uint4*>(gamma), static_cast<const uint4*>(w),
      static_cast<const uint4*>(b), static_cast<uint4*>(x_out), static_cast<uint4*>(y_out),
      rows, dim / 8, 1.0f / (float)dim, eps);
  return (int)cudaGetLastError();
}

