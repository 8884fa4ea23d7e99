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
// against ~1 MB of K/V per head that stays in L2 across its 65 q tiles. It is
// bound by arithmetic. This first version runs the two products on the FP32
// cores (no tensor cores, no TF32, so fp32 parity mode is IEEE fp32): each of
// 256 threads owns a 4x4 patch of the 64x64 score tile and of the 64x64
// output tile and reads its operands as float4 from transposed shared-memory
// tiles, two 16-byte loads per 16 FMAs. wgmma/TMA is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHd = 64;       // head dim (every DINO / DINOv2 arch)
constexpr int kBq = 64;       // queries per block
constexpr int kBk = 64;       // keys per tile
constexpr int kThreads = 256; // 16 x 16 threads, each a 4x4 patch
constexpr int kSmemFloats = 4 * kHd * 64;  // Qt, Kt, Vs, Pt

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// value of p as the PV product sees it: rounded to T (bf16 in speed mode)
template <typename T> __device__ __forceinline__ float round_p(float p) {
  return to_f(from_f<T>(p));
}

// Load a (64 rows x 64 dims) tile of T from global memory into fp32 shared
// memory, rows >= n_valid read as 0, each value times `scale`. Threads move
// 16-byte vectors. Transposed (dst[d][row]): a warp covers 32 consecutive rows
// at one dim chunk, so its scalar stores hit 32 distinct banks. Row-major
// (dst[row][d]): consecutive threads take consecutive chunks of a row, so the
// global reads coalesce and the stores are contiguous float4s.
template <typename T, bool transpose>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int64_t row_stride,
                                          int row0, int n_valid, float scale) {
  constexpr int kVec = 16 / sizeof(T);          // elements per 16-byte vector
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
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);  // all-zero bits are 0.0 in fp32 and bf16
    if (grow < n_valid)
      raw = *reinterpret_cast<const uint4*>(base + grow * row_stride + chunk * kVec);
    const T* e = reinterpret_cast<const T*>(&raw);
    float x[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) x[j] = to_f(e[j]) * scale;
    if (transpose) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) dst[(chunk * kVec + j) * 64 + row] = x[j];
    } else {
#pragma unroll
      for (int j = 0; j < kVec; j += 4)
        *reinterpret_cast<float4*>(dst + row * kHd + chunk * kVec + j) =
            make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int N,
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
  const T* qb = q + b * sqb + h * sqh;
  const T* kb = k + b * skb + h * skh;
  const T* vb = v + b * svb + h * svh;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;  // ty: 4 query rows, tx: 4 cols

  load_tile<T, true>(Qt, qb, sqn, q0, N, scale_log2);

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
    load_tile<T, true>(Kt, kb, skn, k0, N, 1.f);
    load_tile<T, false>(Vs, vb, svn, k0, N, 1.f);
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
        s[i][j] = round_p<T>(exp2f(s[i][j] - m_new));
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

  T* ob = o + b * sob + h * soh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= N) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) ob[row * son + tx * 4 + j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
           const int64_t* st, float scale_log2, cudaStream_t stream) {
  const size_t smem = kSmemFloats * sizeof(float);
  cudaFuncSetAttribute(attention_fwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((N + kBq - 1) / kBq, B * H);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, N, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], st[9], st[10], st[11], scale_log2);
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
  if (dtype == 0) return launch<float>(q, k, v, o, B, H, N, strides, scale_log2, s);
  if (dtype == 1) return launch<__nv_bfloat16>(q, k, v, o, B, H, N, strides, scale_log2, s);
  return (int)cudaErrorInvalidValue;
}
