// Forward multi-head attention with an online softmax, for Hopper (sm_90a).
//
// Replaces: vittf_tpu/ops/attention.py::_attention_pallas and its body
// _fused_attention_kernel. That TPU kernel holds one head's whole K/V in VMEM
// and computes one 512-row q block against it; on the H100 a block has at most
// 227 KB of shared memory, so K/V stream through in 64-key tiles instead and
// the softmax is carried online (running max, running sum, rescaled output).
//
// Semantics follow the plain twin (_attention_xla in the JAX package,
// attention_plain in ops/attention.py of this package): softmax over the valid
// keys only. Keys >= N are masked with -inf. The Pallas kernel's zero-padded
// keys clamp the row max at >= 0 (ops/attention.py:58-62); that clamp is NOT
// copied here, so all-negative rows stay shift-invariant as in the plain math.
// In bf16 the unnormalised probabilities are rounded to bf16 before the PV
// product, as both JAX paths round p before PV; the row sum adds the rounded
// values, so the output is a convex combination of V rows.
//
// What bounds it on the H100: at N = 4097, hd = 64 the work is 4·N²·hd flops
// per (batch, head), ~206 GFLOP for the (8, 6, 4097, 64) extraction batch,
// against ~1 MB of K/V per head that stays in L2 across its q tiles. It is
// bound by arithmetic, and beside the two products by one exp2 per score
// (the SM's special-function unit does 16 a clock).
//
// bf16 (the extraction default): attention_core.cuh. Both products are
// warpgroup MMAs (wgmma) on the tensor cores, the scores and p never leave the
// registers, the softmax's row sums ride on the tensor cores too, and K/V
// tiles arrive through a four-slot cp.async ring; a block of two warpgroups
// owns 128 queries. The scale 1/sqrt(hd)·log2(e) is applied to the
// fp32 scores, not to q, so q is not rounded a second time.
//
// RoPE at head dim 128 (DINOv3 ViT-7B/16: 32 heads of 128) is K1's RoPE mode,
// rope_attention_kernel in rope_attention.cu: a warp-specialised kernel of its
// own that runs attention_core's pieces. The TPU side has no such kernel: the
// JAX package's ViT has a learned position table and head dim 64.
//
// fp32 (parity mode, --compute-dtype float32): the products must be IEEE fp32
// (TF32 keeps ~3 decimal digits and would break the 2e-5 agreement with the
// plain twin), so this instantiation stays on the FP32 cores: each of 256
// threads owns a 4x4 patch of the 64x64 score tile and of the 64x64 output
// tile and reads its operands as float4 from transposed shared-memory tiles,
// two 16-byte loads per 16 FMAs. It is not on the default path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_core.cuh"

namespace {

constexpr int kHd = 64;       // head dim (every DINO / DINOv2 arch)
constexpr int kBq = 64;       // queries per block
constexpr int kBk = 64;       // keys per tile
constexpr int kThreads = 256; // fp32 kernel: 16 x 16 threads, each a 4x4 patch
constexpr int kSmemFloats = 4 * kHd * 64;  // Qt, Kt, Vs, Pt

// Load a (64 rows x 64 dims) fp32 tile from global memory into shared
// memory, rows >= n_valid read as 0, each value times `scale`. Threads move
// 16-byte vectors. Transposed (dst[d][row]): a warp covers 32 consecutive rows
// at one dim chunk, so its scalar stores hit 32 distinct banks. Row-major
// (dst[row][d]): consecutive threads take consecutive chunks of a row, so the
// global reads coalesce and the stores are contiguous float4s.
template <bool transpose>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int64_t row_stride,
                                          int row0, int n_valid, float scale) {
  constexpr int kVec = 4;                       // elements per 16-byte vector
  constexpr int kChunks = kHd / kVec;           // vectors per row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < 64 * kChunks / kThreads; ++i) {
    int row, chunk;
    if (transpose) {
      const int w = warp + i * (kThreads / 32);
      row = lane + 32 * (w & 1);
      chunk = w >> 1;
    } else {
      const int idx = threadIdx.x + i * kThreads;
      row = idx / kChunks;
      chunk = idx % kChunks;
    }
    const int grow = row0 + row;
    float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
    if (grow < n_valid)
      raw = *reinterpret_cast<const float4*>(base + grow * row_stride + chunk * kVec);
    const float x[kVec] = {raw.x * scale, raw.y * scale, raw.z * scale, raw.w * scale};
    if (transpose) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[(chunk * kVec + j) * 64 + row] = x[j];
    } else {
      *reinterpret_cast<float4*>(dst + row * kHd + chunk * kVec) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
attention_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int H, int N,
                      int64_t sqb, int64_t sqh, int64_t sqn,
                      int64_t skb, int64_t skh, int64_t skn,
                      int64_t svb, int64_t svh, int64_t svn,
                      int64_t sob, int64_t soh, int64_t son, float scale_log2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                 // [d][query], pre-scaled into the exp2 domain
  float* Kt = Qt + kHd * kBq;       // [d][key]
  float* Vs = Kt + kHd * kBk;       // [key][d]
  float* Pt = Vs + kBk * kHd;       // [key][query]

  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.x * kBq;
  const float* qb = q + b * sqb + h * sqh;
  const float* kb = k + b * skb + h * skh;
  const float* vb = v + b * svb + h * svh;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // ty: 4 query rows, tx: 4 cols

  load_tile<true>(Qt, qb, sqn, q0, N, scale_log2);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += kBk) {
    __syncthreads();  // previous tile's Kt/Vs/Pt reads are done
    load_tile<true>(Kt, kb, skn, k0, N, 1.f);
    load_tile<false>(Vs, vb, svn, k0, N, 1.f);
    __syncthreads();

    // s = (q·scale·log2e)·k for rows ty*4.., keys tx*4..
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kHd; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * kBq + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * kBk + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax; a row's 64 keys live on the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + tx * 4 + j >= N) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);  // finite: tile 0 holds key 0
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kBq + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p·v for rows ty*4.., dims tx*4..
#pragma unroll 8
    for (int kk = 0; kk < kBk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(Pt + kk * kBq + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Vs + kk * kHd + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
    }
  }

  float* ob = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) ob[row * son + tx * 4 + j] = acc[i][j] * inv;
  }
}

int launch_fp32(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                const int64_t* st, float scale_log2, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaFuncSetAttribute(attention_fp32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((N + kBq - 1) / kBq, B * H);
  attention_fp32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), H, N, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

// bf16: attention_core's block (two warpgroups, 128 queries), two blocks an SM:
// 128 registers a thread
__global__ void __launch_bounds__(attention_core::kThreads, 2)
attention_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                      int N, int64_t sqb, int64_t sqh, int64_t sqn, int64_t skb, int64_t skh,
                      int64_t skn, int64_t svb, int64_t svh, int64_t svn, int64_t sob,
                      int64_t soh, int64_t son, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  attention_core::attention_block<true, false>(
      q + b * sqb + h * sqh, k + b * skb + h * skh, v + b * svb + h * svh,
      o + b * sob + h * soh, sqn, skn, svn, son, blockIdx.x * attention_core::kBlockRows, N, N,
      scale_log2, smem_bf16);
}

int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                const int64_t* st, float scale_log2, cudaStream_t stream) {
  constexpr int smem = attention_core::kSmemBytes, rows = attention_core::kBlockRows;
  cudaFuncSetAttribute(attention_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  dim3 grid((N + rows - 1) / rows, B * H);
  attention_bf16_kernel<<<grid, attention_core::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, N, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: (B, H, N, 64) views, last dim contiguous, given by element strides
// strides[12] = {q: b, h, n; k: b, h, n; v: b, h, n; o: b, h, n}.
// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int vittf_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int H, int N, int hd,
                                   const int64_t* strides, float scale_log2,
                                   void* stream) {
  if (hd != kHd) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_fp32(q, k, v, o, B, H, N, strides, scale_log2, s);
  if (dtype == 1) return launch_bf16(q, k, v, o, B, H, N, strides, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}
