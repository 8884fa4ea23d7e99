// One pre-LN ViT block (K3) in bf16 for Hopper (sm_90a): five hand-written
// launches, every product a warpgroup MMA (wgmma) on the tensor cores.
//
// Replaces: vittf_tpu/ops/fused_block.py::fused_block (Pallas bodies
// _fused_block_kernel, _fused_block_kernel_rows and their shared
// _row_block_body). The TPU kernel keeps one slice's whole residual stream
// in VMEM (~3 MB at 4097 x 384 bf16); no Hopper block holds that, so here
// the block is a short sequence of launches whose intermediates (qkv,
// attention output, x + attn, the MLP activation) stay in device memory and
// mostly in the 50 MB L2:
//   (a) LN1 as the prologue of the qkv product, bias in the epilogue (q is
//       pre-scaled by 1/sqrt(hd)·log2(e) in its weights);
//   (b) exp2-domain attention per (slice, head, 128-query tile);
//   (c) proj, with bias + LayerScale + residual in the epilogue;
//   (d) LN2 as the prologue of fc1, bias + tanh-GELU in the epilogue;
//   (e) fc2, with bias + LayerScale + residual in the epilogue.
// Rounding points follow _row_block_body and ops/fused_block.py's
// fused_block_plain: fp32 accumulation everywhere; q/k/v = bf16(acc + b);
// proj/fc1/fc2 = bf16(bf16(acc) + b); LN statistics in fp32, then
// bf16(bf16(bf16(x̂)·g) + b); p = bf16(exp2(s − m)) (or exp2(s) without the
// row max), denominator = the sum of that rounded p (held at >= 1e-38),
// output = bf16(num · (1/den)). The row max, when asked for, runs over the
// valid keys only (the TPU kernel's zero-score padded keys clamp it at >= 0;
// the softmax is shift-invariant, so the two differ only by rounding), and
// it is the running max of an online softmax: p is rounded against the max
// so far and the sums are rescaled in fp32 when it moves, where the twin
// rounds against the final max. Both round p to 8 bits relative to a power
// of two within the row's range; the difference is inside the 0.02 limits
// (chip_smoke.py prints the readings).
//
// What bounds it on the H100: at (8, 4097, 384) one block is 116 GFLOP of
// linear products plus 206 GFLOP of attention against ~0.35 GB of traffic,
// ~900 FLOP/byte, above the card's ~295 bf16 ridge: arithmetic, and inside
// the attention the exp2 unit (attention_core.cuh). What the design does:
//   - (b) is attention_core::attention_block, the body of K1, called on the
//     thirds of the qkv buffer with their row pitch 3·D: scores and p stay in
//     registers, K/V tiles arrive through a cp.async ring, two blocks an SM;
//   - (a), (c), (d) are gemm_core::resident_a_product: a thread block owns
//     128 token rows, brings them in ONCE (K = D <= 512 fits: 128 x 384 bf16
//     is 96 KB), applies the LayerNorm once while it writes them as the
//     swizzled A operand, and then walks every column tile of its row block
//     with only the weight tiles (L2-resident) streaming through the ring;
//   - (e), K = the MLP width, streams both operands (gemm_core::ring_product);
//     so do (a), (c), (d) at D > 512 (ViT-B and wider), where the row block
//     no longer fits: the LayerNorm is then a launch of K11's LN mode
//     (layer_norm.cu, the same rounding points as layer_norm8, D <= 2048),
//     once a row, into the attention buffer, which is free at both points;
//   - epilogues run from the accumulator registers, 16 bytes a load and a
//     store (wgmma_common::quad_transpose), with the card's own tanh in the
//     GELU.
// Measured (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py phase 5 at
// (8, 4097, 384)): the block 0.86 ms (4.09 with warp-level MMAs, LayerNorm per
// column tile and a two-pass attention), its launches alone (a) 0.107, (b)
// 0.397, (c) 0.060, (d) 0.157, (e) 0.095 ms. With the MMAs or the copies taken
// out of the linears (scripts/kernel_variants.py gemm-ablation) no launch
// gains more than a fifth: a block's prologue, MMA loop and epilogues follow
// one another, one block an SM, and nothing overlaps them. Two accumulator
// sets, so that a tile's epilogue runs beside the next tile's MMAs, made ptxas
// serialize every wgmma (C7514; the block then read 1.11 ms); a producer warp
// with TMA is the next move (ROADMAP).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_core.cuh"
#include "gemm_core.cuh"

// K11 (layer_norm.cu), built into the same library
extern "C" int vittf_layer_norm(const void* x, const void* a, const void* gamma, const void* w,
                                const void* b, void* x_out, void* y_out, long long rows,
                                int dim, float eps, void* stream);

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

// sum over the 16 lanes of a half warp
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Linear products: out(M, N) = epilogue(A(M, K) · W(N, K)ᵀ), W in torch's
// (out, in) layout, which is the K-major B operand of the MMA.
// ---------------------------------------------------------------------------
constexpr int kThreads = gemm_core::kThreads, kRows = gemm_core::kRows;
constexpr int kMaxResidentK = 512;  // the A row block must fit beside the ring

enum { kEpiBias = 0, kEpiGelu = 1, kEpiResid = 2 };

struct GemmArgs {
  const bf16* a;      // (M, K) row-major
  const bf16* w;      // (N, K) row-major
  const bf16* bias;   // (N)
  const bf16* ln_w;   // (K): LayerNorm of the A rows (LN variants)
  const bf16* ln_b;   // (K)
  const bf16* ls;     // (N): LayerScale gamma (kEpiResid)
  const bf16* resid;  // (M, N): residual stream (kEpiResid)
  bf16* out;          // (M, N)
  int M, N, K;
};

// 8 bf16 of one A row, LayerNormed: bf16(bf16(bf16((x − mu)·rs)·g) + b)
__device__ __forceinline__ uint4 layer_norm8(uint4 v, float mu, float rs, const bf16* g,
                                             const bf16* b) {
  const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g));
  const uint4 bv = __ldg(reinterpret_cast<const uint4*>(b));
  bf16* e = reinterpret_cast<bf16*>(&v);
  const bf16* ge = reinterpret_cast<const bf16*>(&gv);
  const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float y = rbf((bf(e[j]) - mu) * rs);
    e[j] = __float2bfloat16(rbf(y * bf(ge[j])) + bf(be[j]));
  }
  return v;
}

// tanh-GELU with the card's own tanh (tanh.approx.f32: one special-function
// instruction, relative error 2^-11, under the bf16 rounding that follows)
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2/pi)
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(kBeta * (x + 0.044715f * x * x * x)));
  return 0.5f * x * (1.f + th);
}

// 16 bytes that no launch of this file writes while it reads them (weights,
// the launch's own input): the compiler may move the load above stores
__device__ __forceinline__ void load_words(uint32_t (&w)[4], const bf16* p) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
}

// Columns n0 + 8·j0 .. + 31 (four 8-column tiles) of a 128 x (8·kTiles) tile
// out of the accumulator registers: rows m_warp + g and + 8 of this warp's
// 16-row slab. A thread's sums sit on the column pairs 8j + 2t of every tile
// j; bias, gamma and residual are loaded, and the result stored, as the 16
// bytes of tile j0 + t, through quad_transpose.
template <int EPI, int kTiles>
__device__ __forceinline__ void epilogue(const float (&acc)[kTiles][4], const GemmArgs& p,
                                         int m_warp, int n0, int j0) {
  using wgmma_common::quad_transpose;
  using wgmma_common::unpack_bf16;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n = n0 + 8 * (j0 + t);
  const int m[2] = {m_warp + g, m_warp + g + 8};
  uint32_t bias[4], gamma[4] = {0u, 0u, 0u, 0u}, x[2][4] = {};
  if (EPI == kEpiResid) {  // both rows' loads in flight before either is used
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (m[h] < p.M) load_words(x[h], p.resid + (size_t)m[h] * p.N + n);
    load_words(gamma, p.ls + n);
    quad_transpose(gamma);
  }
  load_words(bias, p.bias + n);
  quad_transpose(bias);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t o[4];
    if (EPI == kEpiResid) quad_transpose(x[h]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float c0 = acc[j0 + k][2 * h], c1 = acc[j0 + k][2 * h + 1];
      const float2 b = unpack_bf16(bias[k]);
      if (EPI == kEpiBias) {
        o[k] = wgmma_common::pack_bf16(c0 + b.x, c1 + b.y);
      } else if (EPI == kEpiGelu) {
        o[k] = wgmma_common::pack_bf16(gelu_tanh(rbf(rbf(c0) + b.x)),
                                       gelu_tanh(rbf(rbf(c1) + b.y)));
      } else {
        const float2 xr = unpack_bf16(x[h][k]), ls = unpack_bf16(gamma[k]);
        o[k] = wgmma_common::pack_bf16(xr.x + rbf(rbf(rbf(c0) + b.x) * ls.x),
                                       xr.y + rbf(rbf(rbf(c1) + b.y) * ls.y));
      }
    }
    quad_transpose(o);
    const bool stored = m[h] < p.M;
    if (stored)
      *reinterpret_cast<uint4*>(p.out + (size_t)m[h] * p.N + n) = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// (a), (c), (d): a thread block owns rows m0.. of A, stages them once
// (LayerNormed if LN) as K/64 swizzled chunk tiles and walks all N / kBN
// column tiles. Dynamic shared memory: K/64 A tiles, then the B ring.
template <int EPI, bool LN, int kBN>
__global__ void __launch_bounds__(kThreads, 1) linear_resident_kernel(GemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_resident[];
  const uint32_t a_s = async_copy::shared_addr(smem_resident);
  const int n_k = p.K / 64;
  const uint32_t ring_s = a_s + n_k * gemm_core::kATileBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * kRows;

  // the row block as it lies, rows >= M as zeros; without a LayerNorm these
  // copies join the ring's first group
  for (int kc = 0; kc < n_k; ++kc)
    gemm_core::copy_tile<kRows>(a_s + kc * gemm_core::kATileBytes,
                                reinterpret_cast<const unsigned char*>(p.a + (size_t)m0 * p.K) +
                                    kc * gemm_core::kChunkBytes,
                                (int64_t)p.K * 2, p.M - m0);
  if (LN) {
    // In place, once per row block: a half warp takes a row, lane l the
    // 16-byte vectors l, l + 16, .. of it (K / 128 of them, vector c in chunk
    // tile c / 8); the statistics are two passes over those registers in fp32.
    async_copy::cp_async_commit();
    async_copy::cp_async_wait<0>();
    __syncthreads();
    constexpr int kMaxVec = kMaxResidentK / 128;
    const int n_vec = p.K / 128, l16 = lane & 15;
#pragma unroll 2
    for (int it = 0; it < 8; ++it) {
      const int r = warp * 16 + it * 2 + (lane >> 4);
      const bool valid = m0 + r < p.M;  // rows >= M stay zeros (every lane takes the shuffles)
      uint4* vec[kMaxVec];
      uint4 v[kMaxVec];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i) {
        const int c = l16 + 16 * i;
        vec[i] = reinterpret_cast<uint4*>(smem_resident + (c >> 3) * gemm_core::kATileBytes +
                                          wgmma_common::swz(r, c & 7));
        v[i] = i < n_vec ? *vec[i] : make_uint4(0u, 0u, 0u, 0u);
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += bf(e[j]);
      }
      const float mu = half_warp_sum(s) / p.K;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i) {
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (i < n_vec) q += (bf(e[j]) - mu) * (bf(e[j]) - mu);
      }
      const float rs = rsqrtf(half_warp_sum(q) / p.K + 1e-6f);
#pragma unroll
      for (int i = 0; i < kMaxVec; ++i)
        if (i < n_vec && valid)
          *vec[i] = layer_norm8(v[i], mu, rs, p.ln_w + (l16 + 16 * i) * 8, p.ln_b + (l16 + 16 * i) * 8);
    }
  }
  const int m_warp = m0 + warp * 16;  // warps 0-3 = warpgroup 0 = rows 0-63
  gemm_core::resident_a_product<float, kBN>(
      a_s, n_k, reinterpret_cast<const unsigned char*>(p.w), (int64_t)p.K * 2, p.N / kBN, ring_s,
      [&](const float (&acc)[kBN / 8][4], int n0, int j0) {
        epilogue<EPI>(acc, p, m_warp, n0, j0);
      });
}

// (e), and every linear at D > kMaxResidentK: one 128 x kBN tile, both
// operands through the ring
template <int EPI, int kBN>
__global__ void __launch_bounds__(kThreads, 1) linear_ring_kernel(GemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_ring[];
  const int m0 = blockIdx.y * kRows, n0 = blockIdx.x * kBN;
  float acc[kBN / 8][4];
  gemm_core::zero(acc);
  gemm_core::ring_product<float, kBN>(
      acc, reinterpret_cast<const unsigned char*>(p.a + (size_t)m0 * p.K), (int64_t)p.K * 2,
      p.M - m0, reinterpret_cast<const unsigned char*>(p.w + (size_t)n0 * p.K), (int64_t)p.K * 2,
      p.K / 64, async_copy::shared_addr(smem_ring));
  const int m_warp = m0 + (threadIdx.x >> 5) * 16;
#pragma unroll
  for (int j0 = 0; j0 < kBN / 8; j0 += 4) epilogue<EPI>(acc, p, m_warp, n0, j0);
}

// ---------------------------------------------------------------------------
// (b) Attention over the (B·N, 3D) qkv buffer: q | k | v, head h at columns
// h·64 of its third; output (B·N, D), head h at columns h·64. One block =
// attention_core's 128 queries of one (slice, head); q is pre-scaled, so
// scale_log2 is unused. Two blocks an SM, as K1 has it.
// ---------------------------------------------------------------------------
template <bool kMax>
__global__ void __launch_bounds__(attention_core::kThreads, 2)
qkv_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int n_valid,
                     int D) {
  extern __shared__ __align__(1024) unsigned char smem_attention[];
  const int64_t ld = 3 * (int64_t)D;
  const bf16* q = qkv + (int64_t)blockIdx.z * N * ld + blockIdx.y * attention_core::kHd;
  attention_core::attention_block<kMax, /*kPreScaled=*/true, /*kFloorSum=*/true>(
      q, q + D, q + 2 * D, out + (int64_t)blockIdx.z * N * D + blockIdx.y * attention_core::kHd,
      ld, ld, ld, D, blockIdx.x * attention_core::kBlockRows, N, n_valid, 0.f, smem_attention);
}

template <int EPI, bool LN, int kBN>
int launch_resident_tiles(const GemmArgs& a, cudaStream_t s) {
  const int smem = a.K / 64 * gemm_core::kATileBytes + gemm_core::ring_bytes(kBN, false);
  cudaFuncSetAttribute(linear_resident_kernel<EPI, LN, kBN>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  linear_resident_kernel<EPI, LN, kBN><<<(a.M + kRows - 1) / kRows, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <int EPI, int kBN>
int launch_ring_tiles(const GemmArgs& a, cudaStream_t s) {
  constexpr int smem = gemm_core::ring_bytes(kBN, true);
  cudaFuncSetAttribute(linear_ring_kernel<EPI, kBN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid(a.N / kBN, (a.M + kRows - 1) / kRows);
  linear_ring_kernel<EPI, kBN><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// column tiles are 192 wide where N allows it (fewer, larger MMAs), else 128
template <int EPI, bool LN>
int launch_resident(const GemmArgs& a, cudaStream_t s) {
  return a.N % 192 == 0 ? launch_resident_tiles<EPI, LN, 192>(a, s)
                        : launch_resident_tiles<EPI, LN, 128>(a, s);
}
template <int EPI>
int launch_ring(const GemmArgs& a, cudaStream_t s) {
  return a.N % 192 == 0 ? launch_ring_tiles<EPI, 192>(a, s) : launch_ring_tiles<EPI, 128>(a, s);
}

// A linear with an optional LayerNorm of its input: resident A where the row
// block fits; else K11's LN mode into `normed` (M, K), then the streamed form
template <int EPI, bool LN>
int launch_linear(GemmArgs a, bf16* normed, cudaStream_t s) {
  if (a.K <= kMaxResidentK) return launch_resident<EPI, LN>(a, s);
  if (LN) {
    if (int err = vittf_layer_norm(a.a, nullptr, nullptr, a.ln_w, a.ln_b, nullptr, normed, a.M,
                                   a.K, 1e-6f, s))
      return err;
    a.a = normed;
  }
  return launch_ring<EPI>(a, s);
}

template <bool kMax>
int launch_attention(const bf16* qkv, bf16* out, int B, int N, int n_valid, int H, cudaStream_t s) {
  constexpr int smem = attention_core::kSmemBytes, rows = attention_core::kBlockRows;
  cudaFuncSetAttribute(qkv_attention_kernel<kMax>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  dim3 grid((N + rows - 1) / rows, H, B);
  qkv_attention_kernel<kMax><<<grid, attention_core::kThreads, smem, s>>>(
      qkv, out, N, n_valid, H * attention_core::kHd);
  return (int)cudaGetLastError();
}

}  // namespace

// One block over x (B, N, D) bf16, all buffers contiguous.
// ptrs[20] = {x, ln1_w, ln1_b, wqkv (3D, D), bqkv, wproj (D, D), bproj, ls1,
//             ln2_w, ln2_b, wfc1 (Hd, D), bfc1, wfc2 (D, Hd), bfc2, ls2,
//             scratch qkv (B, N, 3D), scratch attn (B, N, D),
//             scratch x2 (B, N, D), scratch mid (B, N, Hd), out (B, N, D)}.
// Keys >= n_valid are left out of every softmax. Requires D = 64·H, D and
// Hd multiples of 128, D <= 2048 (ops/fused_block.py::MAX_DIM). `launches` is a
// mask of the five launches to run, bit 0 = (a) .. bit 4 = (e): 31 for the
// block, one bit to time a launch alone on buffers a whole run has filled.
// Returns the first cudaGetLastError() of the launches.
extern "C" int vittf_fused_block(const void* const* ptrs, int B, int N, int n_valid, int D,
                                 int H, int Hd, int softmax_max, int launches, void* stream) {
  if (D != H * attention_core::kHd || D % 128 || D > 2048 || Hd % 128 || n_valid < 1 ||
      n_valid > N)
    return (int)cudaErrorInvalidValue;
  const bf16* const* p = reinterpret_cast<const bf16* const*>(ptrs);
  const bf16 *x = p[0], *ln1_w = p[1], *ln1_b = p[2], *wqkv = p[3], *bqkv = p[4];
  const bf16 *wproj = p[5], *bproj = p[6], *ls1 = p[7], *ln2_w = p[8], *ln2_b = p[9];
  const bf16 *wfc1 = p[10], *bfc1 = p[11], *wfc2 = p[12], *bfc2 = p[13], *ls2 = p[14];
  bf16* qkv = const_cast<bf16*>(p[15]);
  bf16* attn = const_cast<bf16*>(p[16]);
  bf16* x2 = const_cast<bf16*>(p[17]);
  bf16* mid = const_cast<bf16*>(p[18]);
  bf16* out = const_cast<bf16*>(p[19]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * N;
  int err = 0;

  // (a) LN1 + qkv
  if (launches & 1)
    err = launch_linear<kEpiBias, true>(
        {x, wqkv, bqkv, ln1_w, ln1_b, nullptr, nullptr, qkv, M, 3 * D, D}, attn, s);
  // (b) attention
  if (!err && (launches & 2))
    err = softmax_max ? launch_attention<true>(qkv, attn, B, N, n_valid, H, s)
                      : launch_attention<false>(qkv, attn, B, N, n_valid, H, s);
  // (c) proj + LayerScale + residual
  if (!err && (launches & 4))
    err = launch_linear<kEpiResid, false>(
        {attn, wproj, bproj, nullptr, nullptr, ls1, x, x2, M, D, D}, nullptr, s);
  // (d) LN2 + fc1 + GELU
  if (!err && (launches & 8))
    err = launch_linear<kEpiGelu, true>(
        {x2, wfc1, bfc1, ln2_w, ln2_b, nullptr, nullptr, mid, M, Hd, D}, attn, s);
  // (e) fc2 + LayerScale + residual
  if (!err && (launches & 16))
    err = launch_ring<kEpiResid>({mid, wfc2, bfc2, nullptr, nullptr, ls2, x2, out, M, D, Hd}, s);
  return err;
}
