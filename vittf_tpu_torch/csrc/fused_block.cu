// One pre-LN ViT block (K3) in bf16 for Hopper (sm_90a): five hand-written
// launches, every product on the tensor cores.
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
//   (b) exp2-domain attention per (slice, head, 64-query tile);
//   (c) proj, with bias + LayerScale + residual in the epilogue;
//   (d) LN2 as the prologue of fc1, bias + tanh-GELU in the epilogue;
//   (e) fc2, with bias + LayerScale + residual in the epilogue.
// Rounding points follow _row_block_body and ops/fused_block.py's
// fused_block_plain: fp32 accumulation everywhere; q/k/v = bf16(acc + b);
// proj/fc1/fc2 = bf16(bf16(acc) + b); LN statistics in fp32, then
// bf16(bf16(bf16(x̂)·g) + b); p = bf16(exp2(s − m)) (or exp2(s) without the
// row max), denominator = fp32 sum of that rounded p, output = bf16(num ·
// (1/den)). The row max, when asked for, runs over the valid keys only
// (the TPU kernel's zero-score padded keys clamp it at >= 0; the softmax is
// shift-invariant, so the two differ only by rounding).
//
// What bounds it on the H100: at (8, 4097, 384) one block is 116 GFLOP of
// linear products plus 206 GFLOP of attention against ~0.35 GB of traffic,
// ~900 FLOP/byte, above the card's ~295 bf16 ridge: arithmetic. So all
// products run as warp-level bf16 tensor-core MMAs (nvcuda::wmma 16x16x16
// fragments, lowered to mma.sync, fp32 accumulators). The linears use
// 128x128 output tiles over 32-deep K chunks staged through registers into
// shared memory (the next chunk's loads are in flight during the current
// chunk's MMAs), LayerNorm applied to the A chunk on its way into shared
// memory from per-row statistics taken in the prologue. Attention holds a
// warp's 16 queries as A fragments and streams 64-key K/V tiles; scores go
// through a per-warp shared-memory tile for the softmax, so the (N x N)
// matrix never reaches device memory. With the row max, a first pass over
// the keys takes it, so p is rounded exactly as the plain twin rounds it.
// wgmma/TMA pipelines are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float rbf(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Linear products: out(M, N) = epilogue(A(M, K) · W(N, K)ᵀ), W in torch's
// (out, in) layout, which is the column-major B operand of the MMA.
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32, kGemmThreads = 256;
constexpr int kLdS = kBK + 8;  // shared-memory row pitch in bf16 (80 bytes)

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
  const uint4 gv = *reinterpret_cast<const uint4*>(g);
  const uint4 bv = *reinterpret_cast<const uint4*>(b);
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

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.f + tanhf(kBeta * (x + 0.044715f * x * x * x)));
}

template <int EPI, bool LN>
__global__ void __launch_bounds__(kGemmThreads, 2) linear_kernel(GemmArgs p) {
  __shared__ __align__(128) bf16 As[kBM * kLdS];
  __shared__ __align__(128) bf16 Bs[kBN * kLdS];
  __shared__ __align__(128) float Cs[kGemmThreads / 32][16 * 16];  // per-warp epilogue tile
  __shared__ float row_mu[kBM], row_rs[kBM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  if (LN) {
    // per-row mean and 1/sqrt(var + eps) in fp32, two passes over the row
    for (int r = warp; r < kBM; r += kGemmThreads / 32) {
      const int m = m0 + r;
      float mu = 0.f, rs = 0.f;
      if (m < p.M) {
        const bf16* row = p.a + (size_t)m * p.K;
        float s = 0.f;
        for (int k = lane * 2; k < p.K; k += 64) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + k));
          s += v.x + v.y;
        }
        mu = warp_sum(s) / p.K;
        float q = 0.f;
        for (int k = lane * 2; k < p.K; k += 64) {
          const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + k));
          q += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu);
        }
        rs = rsqrtf(warp_sum(q) / p.K + 1e-6f);
      }
      if (lane == 0) {
        row_mu[r] = mu;
        row_rs[r] = rs;
      }
    }
    __syncthreads();
  }

  // each thread moves two 16-byte vectors of A and two of W per K chunk
  uint4 ra[2], rw[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kGemmThreads, r = idx >> 2, c = (idx & 3) * 8;
      const int m = m0 + r;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m < p.M) ra[i] = *reinterpret_cast<const uint4*>(p.a + (size_t)m * p.K + k0 + c);
      rw[i] = *reinterpret_cast<const uint4*>(p.w + (size_t)(n0 + r) * p.K + k0 + c);
    }
  };
  auto store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kGemmThreads, r = idx >> 2, c = (idx & 3) * 8;
      uint4 v = ra[i];
      if (LN && m0 + r < p.M) v = layer_norm8(v, row_mu[r], row_rs[r], p.ln_w + k0 + c, p.ln_b + k0 + c);
      *reinterpret_cast<uint4*>(As + r * kLdS + c) = v;
      *reinterpret_cast<uint4*>(Bs + r * kLdS + c) = rw[i];
    }
  };

  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm·64.., cols wn·32..
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load(0);
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous chunk
    store(k0);
    __syncthreads();
    if (k0 + kBK < p.K) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], As + (wm * 64 + i * 16) * kLdS + kk, kLdS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], Bs + (wn * 32 + j * 16) * kLdS + kk, kLdS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
  }

  // epilogue: one 16x16 fragment at a time through the warp's tile; each
  // lane finishes 8 consecutive outputs of one row and stores 16 bytes
  float* cs = Cs[warp];
  const int r = lane >> 1, c = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int m = m0 + wm * 64 + i * 16 + r, n = n0 + wn * 32 + j * 16 + c;
      if (m < p.M) {
        const uint4 bv = *reinterpret_cast<const uint4*>(p.bias + n);
        const bf16* be = reinterpret_cast<const bf16*>(&bv);
        uint4 ov;
        bf16* oe = reinterpret_cast<bf16*>(&ov);
        if (EPI == kEpiBias) {
#pragma unroll
          for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16(cs[r * 16 + c + e] + bf(be[e]));
        } else if (EPI == kEpiGelu) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            oe[e] = __float2bfloat16(gelu_tanh(rbf(rbf(cs[r * 16 + c + e]) + bf(be[e]))));
        } else {
          const uint4 lv = *reinterpret_cast<const uint4*>(p.ls + n);
          const uint4 xv = *reinterpret_cast<const uint4*>(p.resid + (size_t)m * p.N + n);
          const bf16* le = reinterpret_cast<const bf16*>(&lv);
          const bf16* xe = reinterpret_cast<const bf16*>(&xv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float a = rbf(rbf(cs[r * 16 + c + e]) + bf(be[e]));
            oe[e] = __float2bfloat16(bf(xe[e]) + rbf(a * bf(le[e])));
          }
        }
        *reinterpret_cast<uint4*>(p.out + (size_t)m * p.N + n) = ov;
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// Attention over the (B·N, 3D) qkv buffer: q | k | v, head h at columns
// h·64 of its third. Output (B·N, D), head h at columns h·64.
// ---------------------------------------------------------------------------
constexpr int kHd = 64, kTile = 64, kAttnThreads = 128;  // 4 warps x 16 queries
constexpr int kLdT = kHd + 8;                              // bf16 tile pitch (144 bytes)
constexpr int kLdF = kTile + 4;                            // fp32 score pitch
constexpr size_t kAttnSmem = 3 * kTile * kLdT * sizeof(bf16) +  // Q, K, V tiles
                             4 * 16 * kLdF * sizeof(float) +    // per-warp scores
                             4 * 16 * kLdT * sizeof(bf16);      // per-warp p

// 64 rows x 64 bf16 from rows row0.. of src (pitch ld) into dst; rows >= limit are 0
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld, int row0, int limit) {
#pragma unroll
  for (int i = 0; i < kTile * kHd / 8 / kAttnThreads; ++i) {
    const int idx = threadIdx.x + i * kAttnThreads, r = idx >> 3, c = (idx & 7) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * kLdT + c) = v;
  }
}

template <bool kMax, bool kScoreBf16>
__global__ void __launch_bounds__(kAttnThreads, 4)
block_attention_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int n_valid,
                       int H) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kTile * kLdT;
  bf16* Vs = Ks + kTile * kLdT;
  float* Ss = reinterpret_cast<float*>(Vs + kTile * kLdT);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + 4 * 16 * kLdF);

  const int D = H * kHd, ld = 3 * D;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* base = qkv + (size_t)b * N * ld;
  const bf16* qg = base + h * kHd;
  const bf16* kg = base + D + h * kHd;
  const bf16* vg = base + 2 * D + h * kHd;
  float* Sw = Ss + warp * 16 * kLdF;
  bf16* Pw = Ps + warp * 16 * kLdT;
  const int r = lane >> 1, c0 = (lane & 1) * 32;  // the lane's row of the warp's 16, its 32 columns

  load_tile(Qs, qg, ld, q0, N);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[kHd / 16];
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * kLdT + kk * 16, kLdT);

  // Sw = q·kᵀ for the warp's 16 queries and the K tile's 64 keys (fp32)
  auto scores = [&]() {
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> s;
      wmma::fill_fragment(s, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHd / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * kLdT + kk * 16, kLdT);
        wmma::mma_sync(s, qf[kk], kf, s);
      }
      wmma::store_matrix_sync(Sw + j * 16, s, kLdF, wmma::mem_row_major);
    }
    __syncwarp();
  };
  auto score = [&](int col) {
    const float s = Sw[r * kLdF + col];
    return kScoreBf16 ? rbf(s) : s;
  };

  float m = 0.f;
  if (kMax) {  // first pass: the row max over the valid keys
    m = -CUDART_INF_F;
    for (int k0 = 0; k0 < n_valid; k0 += kTile) {
      __syncthreads();
      load_tile(Ks, kg, ld, k0, n_valid);
      __syncthreads();
      scores();
      for (int c = 0; c < 32; ++c)
        if (k0 + c0 + c < n_valid) m = fmaxf(m, score(c0 + c));
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[kHd / 16];
#pragma unroll
  for (int j = 0; j < kHd / 16; ++j) wmma::fill_fragment(of[j], 0.f);
  float l = 0.f;
  for (int k0 = 0; k0 < n_valid; k0 += kTile) {
    __syncthreads();
    load_tile(Ks, kg, ld, k0, n_valid);
    load_tile(Vs, vg, ld, k0, n_valid);
    __syncthreads();
    scores();
    for (int c = 0; c < 32; ++c) {
      float pv = 0.f;
      if (k0 + c0 + c < n_valid) {
        const float s = score(c0 + c);
        const float e = kMax ? (kScoreBf16 ? rbf(s - m) : s - m) : s;
        pv = rbf(exp2f(e));
      }
      l += pv;
      Pw[r * kLdT + c0 + c] = __float2bfloat16(pv);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, Pw + kk * 16, kLdT);
#pragma unroll
      for (int j = 0; j < kHd / 16; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, Vs + kk * 16 * kLdT + j * 16, kLdT);
        wmma::mma_sync(of[j], pf, vf, of[j]);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  const float inv = 1.f / fmaxf(l, 1e-38f);

  __syncwarp();
#pragma unroll
  for (int j = 0; j < kHd / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, of[j], kLdF, wmma::mem_row_major);
  __syncwarp();
  const int q = q0 + warp * 16 + r;
  if (q < N) {
    bf16* og = out + ((size_t)b * N + q) * D + h * kHd + c0;
#pragma unroll
    for (int c = 0; c < 32; c += 8) {
      uint4 ov;
      bf16* oe = reinterpret_cast<bf16*>(&ov);
#pragma unroll
      for (int e = 0; e < 8; ++e) oe[e] = __float2bfloat16(Sw[r * kLdF + c0 + c + e] * inv);
      *reinterpret_cast<uint4*>(og + c) = ov;
    }
  }
}

template <int EPI, bool LN>
int launch_linear(const GemmArgs& a, cudaStream_t s) {
  dim3 grid(a.N / kBN, (a.M + kBM - 1) / kBM);
  linear_kernel<EPI, LN><<<grid, kGemmThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kMax, bool kScoreBf16>
int launch_attention(const bf16* qkv, bf16* out, int B, int N, int n_valid, int H,
                     cudaStream_t s) {
  cudaFuncSetAttribute(block_attention_kernel<kMax, kScoreBf16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kAttnSmem);
  dim3 grid((N + kTile - 1) / kTile, H, B);
  block_attention_kernel<kMax, kScoreBf16><<<grid, kAttnThreads, kAttnSmem, s>>>(
      qkv, out, N, n_valid, H);
  return (int)cudaGetLastError();
}

}  // namespace

// One block over x (B, N, D) bf16, all buffers contiguous.
// ptrs[20] = {x, ln1_w, ln1_b, wqkv (3D, D), bqkv, wproj (D, D), bproj, ls1,
//             ln2_w, ln2_b, wfc1 (Hd, D), bfc1, wfc2 (D, Hd), bfc2, ls2,
//             scratch qkv (B, N, 3D), scratch attn (B, N, D),
//             scratch x2 (B, N, D), scratch mid (B, N, Hd), out (B, N, D)}.
// Keys >= n_valid are left out of every softmax. Requires D = 64·H, D and
// Hd multiples of 128. Returns the first cudaGetLastError() of the five
// launches.
extern "C" int vittf_fused_block(const void* const* ptrs, int B, int N, int n_valid, int D,
                                 int H, int Hd, int softmax_max, int score_bf16, void* stream) {
  if (D != H * kHd || D % kBN || Hd % kBN || n_valid < 1 || n_valid > N)
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
  int err;

  // (a) LN1 + qkv
  if ((err = launch_linear<kEpiBias, true>(
           {x, wqkv, bqkv, ln1_w, ln1_b, nullptr, nullptr, qkv, M, 3 * D, D}, s)))
    return err;
  // (b) attention
  if (softmax_max && score_bf16) err = launch_attention<true, true>(qkv, attn, B, N, n_valid, H, s);
  else if (softmax_max) err = launch_attention<true, false>(qkv, attn, B, N, n_valid, H, s);
  else if (score_bf16) err = launch_attention<false, true>(qkv, attn, B, N, n_valid, H, s);
  else err = launch_attention<false, false>(qkv, attn, B, N, n_valid, H, s);
  if (err) return err;
  // (c) proj + LayerScale + residual
  if ((err = launch_linear<kEpiResid, false>(
           {attn, wproj, bproj, nullptr, nullptr, ls1, x, x2, M, D, D}, s)))
    return err;
  // (d) LN2 + fc1 + GELU
  if ((err = launch_linear<kEpiGelu, true>(
           {x2, wfc1, bfc1, ln2_w, ln2_b, nullptr, nullptr, mid, M, Hd, D}, s)))
    return err;
  // (e) fc2 + LayerScale + residual
  return launch_linear<kEpiResid, false>(
      {mid, wfc2, bfc2, nullptr, nullptr, ls2, x2, out, M, D, Hd}, s);
}
