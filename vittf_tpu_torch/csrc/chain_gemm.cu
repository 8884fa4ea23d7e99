// Chained square GEMM probe (K9) for Hopper (sm_90a): x <- f(x · W), `chain`
// times, in bf16 and in int8 with two epilogues.
//
// Replaces: scripts/bench_int8_gemm.py::run (Pallas bodies _bf16_kernel,
// _int8_kernel, _int8_noquant_kernel). The TPU kernel is one program that
// holds all of x (rows, dim) and W (dim, dim) in VMEM and loops `chain` times
// inside the body. No Hopper block holds that (W alone is 4.7 MB in bf16
// against 227 KB of shared memory), and the re-quantizing epilogue needs a
// whole row of `dim` products before it can write one element. So here one
// chain step is one GEMM launch over two ping-pong buffers in device memory
// (x, W and the scratch are 11-30 MB and stay in the 50 MB L2 between steps);
// a block that kept its rows resident for the whole chain would have to be
// 16-32 rows tall to fit, and would then re-read all of W from L2 for every
// 16-32 rows of output, 4-8 times the traffic of the 128 x 128 tiles used
// here. The entry point issues all `chain` steps on the caller's stream.
//
// The three modes are instantiations of ONE kernel: the same 128 x 128 output
// tile, the same 64-byte K chunk staged through registers into shared memory,
// the same 2 x 4 warp layout and the same mma.sync fragment addressing, which
// is byte-identical for both operand widths (one MMA consumes 32 bytes of K:
// m16n8k16 for bf16, m16n8k32 for s8). What differs is the operand width, the
// k per MMA, the accumulator type (fp32 / s32) and the epilogue:
//   bf16          out = bf16(acc)                            (4-byte stores)
//   int8+shift    out = low 8 bits of (acc >> 8)             (2-byte stores)
//   int8+requant  acc -> s32 scratch (rows, dim) + per-row max|acc| by
//                 atomicMax; a second launch per step reads the row max,
//                 scale = 127 / max(m, 1e-6), out = int8(rint(float(acc) ·
//                 scale)). IEEE division and multiply, round half to even.
// W is transposed once per call into (N, K) so that both MMA operands are
// K-contiguous in shared memory (ldmatrix has no byte transpose).
//
// What bounds it on the H100: 2·rows·dim² operations per step against
// (rows + dim)·dim operand bytes, ~1750 op/byte in bf16 at 2048 x 1536:
// arithmetic. Every product runs on the tensor cores as warp-level mma.sync;
// wgmma/TMA pipelines are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 128, kThreads = 256;
constexpr int kBKB = 64;           // bytes of K per chunk, for either operand width
constexpr int kPitch = kBKB + 16;  // shared-memory row pitch in bytes (20 words: no bank conflicts)

enum { kModeBf16 = 0, kModeRequant = 1, kModeShift = 2 };

struct StepArgs {
  const unsigned char* a;   // (M, K) row-major operands
  const unsigned char* wt;  // (N, K) row-major: W transposed
  unsigned char* out;       // (M, N) operands of the next step (bf16, shift)
  int* y;                   // (M, N) s32 products (requant)
  unsigned* row_max;        // (M) max |product| per row, zero on entry (requant)
  int M, N, K;              // K in elements
};

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MODE> struct Acc { typedef int type; };
template <> struct Acc<kModeBf16> { typedef float type; };

__device__ __forceinline__ unsigned abs_u(int v) { return v < 0 ? 0u - (unsigned)v : (unsigned)v; }

// One chain step: out(M, N) = epilogue(A(M, K) · Wt(N, K)ᵀ).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 2) gemm_step_kernel(StepArgs p) {
  constexpr int ES = MODE == kModeBf16 ? 2 : 1;  // operand bytes
  typedef typename Acc<MODE>::type acc_t;
  __shared__ __align__(16) unsigned char As[kBM * kPitch];
  __shared__ __align__(16) unsigned char Bs[kBN * kPitch];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // the MMA's row group and column pair
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const size_t row_bytes = (size_t)p.K * ES;

  // each thread moves two 16-byte vectors of A and two of Wt per K chunk
  uint4 ra[2], rw[2];
  auto load = [&](size_t kb) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 2, c = (idx & 3) * 16;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < p.M)
        ra[i] = *reinterpret_cast<const uint4*>(p.a + (size_t)(m0 + r) * row_bytes + kb + c);
      rw[i] = *reinterpret_cast<const uint4*>(p.wt + (size_t)(n0 + r) * row_bytes + kb + c);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx >> 2, c = (idx & 3) * 16;
      *reinterpret_cast<uint4*>(As + r * kPitch + c) = ra[i];
      *reinterpret_cast<uint4*>(Bs + r * kPitch + c) = rw[i];
    }
  };

  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm·64.., cols wn·32..
  acc_t acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  load(0);
  for (size_t kb = 0; kb < row_bytes; kb += kBKB) {
    __syncthreads();  // every warp is done with the previous chunk
    store();
    __syncthreads();
    if (kb + kBKB < row_bytes) load(kb + kBKB);
#pragma unroll
    for (int ks = 0; ks < kBKB; ks += 32) {
      // fragment words: row g (and g + 8), K bytes 4t.. and 16 + 4t.. of this
      // 32-byte step, the same for bf16 pairs and s8 quads
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned char* base = As + (wm * 64 + i * 16 + g) * kPitch + ks + 4 * t;
        af[i][0] = *reinterpret_cast<const uint32_t*>(base);
        af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kPitch);
        af[i][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kPitch + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* base = Bs + (wn * 32 + j * 8 + g) * kPitch + ks + 4 * t;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(base);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[i][j], af[i], bfr[j]);
    }
  }

  // epilogue from the accumulator registers: element pairs (2h, 2h + 1) of
  // acc[i][j] are row g + 8h, columns 2t, 2t + 1 of the 16 x 8 tile
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      unsigned row_abs = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        const size_t at = (size_t)m * p.N + n;
        const acc_t c0 = acc[i][j][2 * h], c1 = acc[i][j][2 * h + 1];
        if (MODE == kModeBf16) {
          if (m < p.M)
            *reinterpret_cast<__nv_bfloat162*>(p.out + at * 2) =
                __floats2bfloat162_rn((float)c0, (float)c1);
        } else if (MODE == kModeShift) {
          // arithmetic shift, then the low 8 bits: the wrap of an int8 cast
          const unsigned lo = ((unsigned)((int)c0 >> 8) & 0xffu) |
                              (((unsigned)((int)c1 >> 8) & 0xffu) << 8);
          if (m < p.M) *reinterpret_cast<unsigned short*>(p.out + at) = (unsigned short)lo;
        } else {
          if (m < p.M) *reinterpret_cast<int2*>(p.y + at) = make_int2((int)c0, (int)c1);
          row_abs = max(row_abs, max(abs_u((int)c0), abs_u((int)c1)));
        }
      }
      if (MODE == kModeRequant) {
        row_abs = max(row_abs, __shfl_xor_sync(0xffffffffu, row_abs, 1));
        row_abs = max(row_abs, __shfl_xor_sync(0xffffffffu, row_abs, 2));
        if (t == 0 && m < p.M) atomicMax(p.row_max + m, row_abs);
      }
    }
  }
}

// The requant epilogue's second pass, one block per row: the whole row's max
// is known only after every column tile of the step has finished.
__global__ void __launch_bounds__(kThreads) requant_kernel(const int* y, unsigned* row_max,
                                                           unsigned char* out, int N) {
  const int m = blockIdx.x;
  const float mx = (float)row_max[m];
  const float scale = __fdiv_rn(127.0f, fmaxf(mx, 1e-6f));
  const int* row = y + (size_t)m * N;
  for (int n = threadIdx.x * 4; n < N; n += kThreads * 4) {
    const int4 v = *reinterpret_cast<const int4*>(row + n);
    const int q0 = (int)rintf(__fmul_rn((float)v.x, scale));
    const int q1 = (int)rintf(__fmul_rn((float)v.y, scale));
    const int q2 = (int)rintf(__fmul_rn((float)v.z, scale));
    const int q3 = (int)rintf(__fmul_rn((float)v.w, scale));
    const uint32_t pk = ((unsigned)q0 & 0xffu) | (((unsigned)q1 & 0xffu) << 8) |
                        (((unsigned)q2 & 0xffu) << 16) | (((unsigned)q3 & 0xffu) << 24);
    *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) = pk;
  }
  __syncthreads();
  if (threadIdx.x == 0) row_max[m] = 0u;  // ready for the next step
}

// wt(N, K) = w(K, N)ᵀ for 1- or 2-byte elements; block (32, 8), 32 x 32 tiles
template <typename T>
__global__ void transpose_kernel(const T* w, T* wt, int K, int N) {
  __shared__ T tile[32][33];
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  for (int j = threadIdx.y; j < 32; j += 8)
    tile[j][threadIdx.x] = w[(size_t)(k0 + j) * N + n0 + threadIdx.x];
  __syncthreads();
  for (int j = threadIdx.y; j < 32; j += 8)
    wt[(size_t)(n0 + j) * K + k0 + threadIdx.x] = tile[threadIdx.x][j];
}

}  // namespace

// x (M, D), w (D, D) -> out (M, D) after `chain` steps. wt (D, D) and tmp
// (M, D) are scratch of the operand type; y (M, D) s32 and row_max (M) u32,
// zeroed by the caller, are used by mode 1 only. D % 128 == 0.
extern "C" int vittf_chain_gemm(const void* x, const void* w, void* wt, void* out, void* tmp,
                                void* y, void* row_max, int M, int D, int chain, int mode,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 tgrid(D / 32, D / 32), tblock(32, 8);
  if (mode == kModeBf16)
    transpose_kernel<unsigned short><<<tgrid, tblock, 0, s>>>(
        static_cast<const unsigned short*>(w), static_cast<unsigned short*>(wt), D, D);
  else
    transpose_kernel<unsigned char><<<tgrid, tblock, 0, s>>>(
        static_cast<const unsigned char*>(w), static_cast<unsigned char*>(wt), D, D);

  StepArgs p;
  p.wt = static_cast<const unsigned char*>(wt);
  p.y = static_cast<int*>(y);
  p.row_max = static_cast<unsigned*>(row_max);
  p.M = M, p.N = D, p.K = D;
  const dim3 grid(D / kBN, (M + kBM - 1) / kBM);
  const unsigned char* src = static_cast<const unsigned char*>(x);
  for (int step = 0; step < chain; ++step) {
    // ping-pong so that the last step lands in `out`
    unsigned char* dst = static_cast<unsigned char*>(((chain - 1 - step) & 1) ? tmp : out);
    p.a = src;
    p.out = dst;
    if (mode == kModeBf16) {
      gemm_step_kernel<kModeBf16><<<grid, kThreads, 0, s>>>(p);
    } else if (mode == kModeShift) {
      gemm_step_kernel<kModeShift><<<grid, kThreads, 0, s>>>(p);
    } else {
      gemm_step_kernel<kModeRequant><<<grid, kThreads, 0, s>>>(p);
      requant_kernel<<<M, kThreads, 0, s>>>(p.y, p.row_max, dst, D);
    }
    src = dst;
  }
  return static_cast<int>(cudaGetLastError());
}
