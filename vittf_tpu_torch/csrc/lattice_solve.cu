// K12: the bilateral solver's lattice-side solve in one launch, for Hopper
// (sm_90a): bistochastization, then Jacobi-preconditioned CG on
//   A(y) = lam * (m_b * y - n * blur(n * y)) + w * y,  the identity on empty vertices,
// of vittf_tpu_torch/ops/bilateral.py::_lattice_solve, which stays as its plain
// twin. Of the TPU's kernels it takes in the Pallas blur (K8's source,
// vittf_tpu/ops/bilateral.py::_blur_pallas4d), which the JAX package runs
// inside the same loops under jax.jit, where XLA fuses each step into a few
// fusions around it (vittf_tpu/ops/bilateral.py::_lattice_solve). Run op by
// op from the host the solve is ~800 launches (10 bistochastization steps of
// a blur and ~7 ops, ~25 ops of set-up, 25 CG steps of ~28 ops), each on a
// lattice of at most a few MB: bound by its launch and by the gap between two
// graph nodes, not by bytes.
//
// Bound: the inputs m, w, b read and x written once, 16 bytes a vertex, against
// ~40 fp32 operations a vertex a CG step; at the refined edit's lattice the
// operations bound it, a few microseconds. What the launch pays instead is one
// grid-wide barrier between every two dependent phases: ~86 a solve at 25 steps.
//
// Design. A persistent grid of B * S blocks of 1024 threads, one block an SM
// (B * S <= SMs), launched cooperatively: the driver starts the grid only
// with every block resident at once, or refuses it, so the barrier never
// waits on a block that does not run. A stream capture records the launch as
// one cooperative kernel node.
// Class c's N vertices are cut into S segments of `seg` vertices; block
// k = c * S + s owns segment s of class c for the whole solve. Its state (m, n,
// m_b, w, a_diag, x, r, p, A p) stays in shared memory when 11 vectors of `seg`
// words fit ("resident"), else in a device scratch ("streamed", the whole-grid
// refinement's lattice); the host picks by the lattice's shape
// (ops/bilateral.py::_solve_plan). The blur's input (n, n * x, n * p) is
// written to device memory, where the other blocks read a segment's halo:
// its +-1 neighbours along every lattice axis. A resident block also keeps its
// own copy and reads its own words from there (HaloLoad); where both fit,
// streamed takes 1.28x as long (PERF.md). The stencil is K8's
// (blur_stencil.cuh), so a blur here equals bls_blur's bit for bit.
//
// Barrier: a counter in device memory, zeroed by the host before the launch
// (a graph node of its own), that every block adds 1 to and waits for;
// device-memory words another block wrote are read through L2 (__ldcg).
// Per vertex every formula is _lattice_solve's, with no FMA contraction
// (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn) and the torch.where
// semantics; fp32 throughout. Dots: each thread sums its vertices in order, a
// block reduces in a fixed tree, and every block of a class sums the class's
// S block partials in one fixed order after the barrier, so a solve equals its
// repeat and a graph replay the eager launch, bit for bit; not the plain twin,
// whose sums take PyTorch's order. A class whose r.r <= atol^2 is frozen
// (x, r, p, gamma kept), as the twin's per-class mask does; all 25 steps run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "blur_stencil.cuh"

namespace {

using blur_stencil::BlurShape;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
// a segment's vectors, in this order
enum { kM, kN, kMB, kW, kAD, kX, kR, kP, kAP, kStreamedVectors, kU0 = kStreamedVectors, kU1,
       kResidentVectors };
// the block partials of the dots: p.Ap, r.z, r.r, b.b
enum { kPAp, kRZ, kRR, kBB, kDots };

struct Solve {
  const float* m;   // (B, N) splat(1) at class stride `in_stride` words
  const float* w;   // splat(c)
  const float* b;   // splat(t * c)
  const float* y0;  // (B, N) start, or nullptr: b / w
  float* x;         // (B, N) out
  float* u;         // 2 * (B, N): the blur's input, double-buffered
  float* state;     // streamed: kStreamedVectors * B * S * seg words; resident: unused
  unsigned* count;  // the barrier's counter, then kDots * B * S partials
  BlurShape shape;
  int64_t in_stride;
  uint32_t N, S, seg;
  float lam, a_diag_min, tol2;
  int bistoch_iters, cg_maxiter;
};

// The blur's input of one class: a resident block's own words [lo, lo + len)
// from its copy in shared memory, the halo (and every word of a streamed
// block) from device memory through L2, where the other blocks wrote it
// before the last barrier.
template <bool kResident>
struct HaloLoad {
  const float* own;
  const float* u;
  uint32_t lo, len;
  __device__ __forceinline__ float operator()(uint32_t i) const {
    if (kResident && i - lo < len) return own[i - lo];
    return __ldcg(u + i);
  }
};

// Every block adds 1 to the counter and waits until all have: barrier
// number t ends when the counter reads t * gridDim.x. The add releases what
// the block wrote before the first __syncthreads, the poll acquires what the
// others wrote (no fence besides: 6% of the solve, kernel_variants
// lattice-solve-ablation; cooperative groups' grid sync is such a fence
// barrier).
__device__ __forceinline__ void grid_sync(unsigned* count, unsigned& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(count), "r"(1u) : "memory");
    for (unsigned seen = 0; seen < target;)
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
  }
  __syncthreads();
}

// The sum over a warp in a fixed tree, in lane 0.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// The sums over the block of each thread's v[0..n), in a fixed tree, written
// to part[q[j]] by thread 0.
template <int n>
__device__ __forceinline__ void block_partials(const float (&v)[n], float* part,
                                               const int (&q)[n], uint32_t stride) {
  __shared__ float red[n][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < n; ++j) {
    const float s = warp_sum(v[j]);
    if (lane == 0) red[j][warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      const float s = warp_sum(red[j][lane]);
      if (lane == 0) __stcg(part + q[j] * stride + blockIdx.x, s);
    }
  }
}

// The class totals of dots q[0..n): the S partials of class c summed in one
// fixed order (lanes take s, s + 32, ...; then a fixed tree), by every block
// of the class alike; returned to every thread.
template <int n>
__device__ __forceinline__ void class_totals(const float* part, const int (&q)[n],
                                             uint32_t stride, uint32_t first, uint32_t S,
                                             float (&out)[n]) {
  __shared__ float slot[n];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < n; ++j) {
      float s = 0.f;
      for (uint32_t t = lane; t < S; t += 32)
        s = __fadd_rn(s, __ldcg(part + q[j] * stride + first + t));
      s = warp_sum(s);
      if (lane == 0) slot[j] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < n; ++j) out[j] = slot[j];
}

// kResident: the segment's vectors in shared memory, addressed as such; else
// in the device scratch.
template <bool kResident>
__global__ void __launch_bounds__(kThreads, 1) lattice_solve_kernel(const Solve a) {
  extern __shared__ float smem[];
  const uint32_t T = gridDim.x, B = T / a.S;
  const uint32_t k = blockIdx.x, c = k / a.S, lo = (k % a.S) * a.seg;
  const uint32_t len = lo < a.N ? min(a.seg, a.N - lo) : 0;
  // vector v of this segment: its word j
  auto V = [&](int v) {
    return kResident ? smem + v * a.seg : a.state + ((uint64_t)v * T + k) * a.seg;
  };
  // the blur's input, buffer `buf` of class c in device memory
  auto ug = [&](int buf) { return a.u + ((uint64_t)buf * B + c) * a.N; };
  auto halo = [&](int buf) {
    return HaloLoad<kResident>{kResident ? V(kU0 + buf) : nullptr, ug(buf), lo, len};
  };
  // the blur's input at word j: to device memory, and to the resident copy
  auto put_u = [&](int buf, uint32_t j, float v) {
    __stcg(ug(buf) + lo + j, v);
    if (kResident) V(kU0 + buf)[j] = v;
  };
  const float* mi = a.m + c * a.in_stride;
  const float* wi = a.w + c * a.in_stride;
  const float* bi = a.b + c * a.in_stride;
  float* part = reinterpret_cast<float*>(a.count + 1);
  unsigned target = 0;

  // the blur at word j of the segment, its input in buffer `buf`
  auto blur_at = [&](int buf, uint32_t j) {
    const uint32_t i = lo + j;
    return blur_stencil::blur_vertex(halo(buf), i, blur_stencil::place(i, a.shape), a.shape);
  };
  // A(y) at word j of the segment, the blur's input n * y in buffer `buf`
  auto apply_A = [&](int buf, uint32_t j, float y) {
    const float smooth = __fsub_rn(__fmul_rn(V(kMB)[j], y), __fmul_rn(V(kN)[j], blur_at(buf, j)));
    return V(kM)[j] > 0.f ? __fadd_rn(__fmul_rn(a.lam, smooth), __fmul_rn(V(kW)[j], y)) : y;
  };

  // the inputs in; n = occupancy
  for (uint32_t j = threadIdx.x; j < len; j += kThreads) {
    const float m = __ldg(mi + lo + j);
    V(kM)[j] = m;
    V(kW)[j] = __ldg(wi + lo + j);
    const float n = m > 0.f ? 1.f : 0.f;
    V(kN)[j] = n;
    put_u(0, j, n);
  }
  grid_sync(a.count, target);
  int cur = 0;
  // bistochastization: n = sqrt(n * m / blur(n)) on occupied vertices
  for (int it = 0; it < a.bistoch_iters; ++it) {
    for (uint32_t j = threadIdx.x; j < len; j += kThreads) {
      const float bn = blur_at(cur, j);
      const float m = V(kM)[j];
      const float n = m > 0.f ? __fsqrt_rn(__fdiv_rn(__fmul_rn(V(kN)[j], m), bn > 0.f ? bn : 1.f))
                              : 0.f;
      V(kN)[j] = n;
      put_u(cur ^ 1, j, n);
    }
    grid_sync(a.count, target);
    cur ^= 1;
  }
  // m_b = n * blur(n), a_diag, the start x; n * x to the other buffer
  {
    float bb = 0.f;
    for (uint32_t j = threadIdx.x; j < len; j += kThreads) {
      const uint32_t i = lo + j;
      const float n = V(kN)[j], w = V(kW)[j], b = __ldg(bi + i);
      const float mb = __fmul_rn(n, blur_at(cur, j));
      const float dn = __fmul_rn(__fmul_rn(a.shape.center, n), n);  // 2 * dim * n * n
      float ad = __fadd_rn(__fmul_rn(a.lam, __fsub_rn(mb, dn)), w);
      ad = V(kM)[j] > 0.f ? (ad < a.a_diag_min ? a.a_diag_min : ad) : 1.f;  // NaN stays NaN
      const float x = a.y0 ? __ldg(a.y0 + (uint64_t)c * a.N + i)
                           : (w > 0.f ? __fdiv_rn(b, w) : 0.f);
      V(kMB)[j] = mb;
      V(kAD)[j] = ad;
      V(kX)[j] = x;
      put_u(cur ^ 1, j, __fmul_rn(n, x));
      bb = __fmaf_rn(b, b, bb);
    }
    const float v[1] = {bb};
    const int q[1] = {kBB};
    block_partials(v, part, q, T);
  }
  grid_sync(a.count, target);
  cur ^= 1;
  // r = b - A x, p = z = r / a_diag; n * p to the other buffer
  {
    float rz = 0.f, rr = 0.f;
    for (uint32_t j = threadIdx.x; j < len; j += kThreads) {
      const float r = __fsub_rn(__ldg(bi + lo + j), apply_A(cur, j, V(kX)[j]));
      const float z = __fdiv_rn(r, V(kAD)[j]);
      V(kR)[j] = r;
      V(kP)[j] = z;
      put_u(cur ^ 1, j, __fmul_rn(V(kN)[j], z));
      rz = __fmaf_rn(r, z, rz);
      rr = __fmaf_rn(r, r, rr);
    }
    const float v[2] = {rz, rr};
    const int q[2] = {kRZ, kRR};
    block_partials(v, part, q, T);
  }
  grid_sync(a.count, target);
  cur ^= 1;
  float gamma, rr, atol2;
  {
    const int q[3] = {kRZ, kRR, kBB};
    float t[3];
    class_totals(part, q, T, c * a.S, a.S, t);
    gamma = t[0];
    rr = t[1];
    const float bound = __fmul_rn(a.tol2, t[2]);
    atol2 = bound < 0.f ? 0.f : bound;  // NaN stays NaN
  }
  // Jacobi-PCG; the blur's input n * p stays in buffer `cur`
  for (int step = 0; step < a.cg_maxiter; ++step) {
    const bool active = rr > atol2;  // a class that has converged keeps x, r, p and gamma
    if (active) {
      float pap = 0.f;
      for (uint32_t j = threadIdx.x; j < len; j += kThreads) {
        const float p = V(kP)[j], ap = apply_A(cur, j, p);
        V(kAP)[j] = ap;
        pap = __fmaf_rn(p, ap, pap);
      }
      const float v[1] = {pap};
      const int q[1] = {kPAp};
      block_partials(v, part, q, T);
    }
    grid_sync(a.count, target);
    if (active) {
      const int qp[1] = {kPAp};
      float t[1];
      class_totals(part, qp, T, c * a.S, a.S, t);
      const float alpha = __fdiv_rn(gamma, t[0]);
      float rz = 0.f, rr_new = 0.f;
      for (uint32_t j = threadIdx.x; j < len; j += kThreads) {
        const float p = V(kP)[j];
        V(kX)[j] = __fadd_rn(V(kX)[j], __fmul_rn(alpha, p));
        const float r = __fsub_rn(V(kR)[j], __fmul_rn(alpha, V(kAP)[j]));
        const float z = __fdiv_rn(r, V(kAD)[j]);
        V(kR)[j] = r;
        rz = __fmaf_rn(r, z, rz);
        rr_new = __fmaf_rn(r, r, rr_new);
      }
      const float v[2] = {rz, rr_new};
      const int q[2] = {kRZ, kRR};
      block_partials(v, part, q, T);
    }
    if (step + 1 == a.cg_maxiter) break;  // x is final; p is not read again
    grid_sync(a.count, target);
    if (active) {
      const int q[2] = {kRZ, kRR};
      float t[2];
      class_totals(part, q, T, c * a.S, a.S, t);
      const float beta = __fdiv_rn(t[0], gamma);
      for (uint32_t j = threadIdx.x; j < len; j += kThreads) {
        const float z = __fdiv_rn(V(kR)[j], V(kAD)[j]);
        const float p = __fadd_rn(z, __fmul_rn(beta, V(kP)[j]));
        V(kP)[j] = p;
        put_u(cur, j, __fmul_rn(V(kN)[j], p));
      }
      gamma = t[0];
      rr = t[1];
    }
    grid_sync(a.count, target);
  }
  __syncthreads();
  for (uint32_t j = threadIdx.x; j < len; j += kThreads) a.x[(uint64_t)c * a.N + lo + j] = V(kX)[j];
}

}  // namespace

// m, w, b: (B, N) fp32 rows at class stride in_stride words; y0: (B, N) or
// null; x: (B, N); u: 2 * B * N words; state: kStreamedVectors * B * S * seg words
// when streamed, else unused; count: 1 + kDots * B * S words, zeroed. N = Z *
// Y * X * L; S segments of seg vertices a class (S * seg >= N); resident: 11
// vectors of seg words in shared memory. Returns the cooperative launch's
// error (cudaErrorCooperativeLaunchTooLarge for a grid that cannot be resident
// at once), else cudaGetLastError() after it.
extern "C" int vittf_lattice_solve(const float* m, const float* w, const float* b,
                                   long long in_stride, const float* y0, float* x, float* u,
                                   float* state, unsigned* count, int B, int Z, int Y, int X,
                                   int L, int blur_dim, int S, int seg, int resident, float lam,
                                   float a_diag_min, float tol2, int bistoch_iters,
                                   int cg_maxiter, void* stream) {
  if (B < 1 || Z < 1 || Y < 1 || X < 1 || L < 1 || S < 1 || seg < 1 || bistoch_iters < 0 ||
      cg_maxiter < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t N = (int64_t)Z * Y * X * L;
  if (N > INT32_MAX || (int64_t)S * seg < N || (int64_t)S * seg - seg >= N ||
      (!resident && state == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = resident ? (size_t)kResidentVectors * seg * sizeof(float) : 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  const auto kernel = resident ? lattice_solve_kernel<true> : lattice_solve_kernel<false>;
  static size_t smem_set[64] = {};  // per device: the most dynamic shared memory allowed so far
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (smem > smem_set[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = smem;
  }
  const Solve a{m,
                w,
                b,
                y0,
                x,
                u,
                state,
                count,
                BlurShape::of(Z, Y, X, L, blur_dim),
                (int64_t)in_stride,
                (uint32_t)N,
                (uint32_t)S,
                (uint32_t)seg,
                lam,
                a_diag_min,
                tol2,
                bistoch_iters,
                cg_maxiter};
  // cooperative: every block resident at once, or the launch fails
  // (cudaErrorCooperativeLaunchTooLarge); a stream capture records it as one
  // cooperative kernel node
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * S));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
