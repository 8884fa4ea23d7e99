// K1's RoPE mode: bf16 attention at head dim 128 with DINOv3's axial rotation
// of q's and k's patch rows, for Hopper (sm_90a), warp-specialised.
//
// Replaces: no TPU kernel. The JAX package's ViT has a learned position table
// and head dim 64; this kernel serves DINOv3 ViT-7B/16 (32 heads of 128).
//
// What bounds it: 4·N²·hd operations a (batch, head) on the tensor cores,
// 0.56 ms at the bf16 peak for the ViT-7B/16 cell's (32, 32, 1029, 128),
// against ~0.5 MB of K/V a head that stays in L2 across its query blocks. The
// exp2 of every score needs about half that time on the special-function
// unit, and the rotation (redone by each of a head's query blocks) more
// instructions than the softmax, so the tensor cores stay fed only if those
// run beside the products, on enough warps.
//
// Design: one persistent block an SM walks over work items (batch·head,
// block of 128 queries), batch·head major. A block is four warpgroups:
//   - the producers, warpgroups 0 and 3 (setmaxnreg.dec: they give their
//     registers to the consumers). One thread of warp 0 keeps TMA loads in
//     flight: an item's Q block, then its K and V tiles of 64 keys into a
//     ring of kStages slots, each onto an mbarrier that counts the bytes (K:
//     `landed`, V: `full`); a slot's K and V are refilled once their own
//     `empty` mbarriers say that every consumer warp's products that read
//     them are done (K a turn before V). The tensor maps name the strided
//     (B, H, N, 128) views (e.g. of the fused qkv buffer) in boxes of 64
//     dims x 64 rows with the 128-byte swizzle that wgmma's descriptors
//     name, rows past N filled with zeros. The other seven producer warps
//     rotate the patch rows of each Q block and K tile in shared memory once
//     it has landed (attention_core.cuh's rope_rotate, PyTorch's roundings),
//     fence the async proxy and hand it on through a `ready` mbarrier: the
//     rotation is off the consumers' path. Three rotating warps were too few
//     (2.6 ms against 1.9 at the cell's shape on an H100).
//   - two consumers, warpgroups 1 and 2 (setmaxnreg.inc), each owning 64 of
//     the item's queries, run attention_core's pieces: Q as wgmma A
//     fragments in registers, the scores product, the online softmax, P·V
//     with the row sums on the tensor cores. They take turns on two named barriers to issue their
//     products (ping-pong): one warpgroup's softmax runs while the other's
//     products do. No block barrier after the start. A consumer loads its Q
//     fragments at an item's start and releases the Q block at once, so the
//     next item's Q and first tiles load under this item's last tiles and
//     stores.
//
// Semantics (attention_core.cuh's header): keys >= N are -inf before the max
// (their V rows are zeros); no clamp of the max; p is rounded to bf16 before
// P·V and the row sum adds the rounded values; the output is bf16(acc · 1/l);
// rows < prefix are not rotated. Every sum is taken in a fixed order, so a
// result equals its repeat bit for bit.
#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is looked up at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "attention_core.cuh"

namespace {

namespace ac = attention_core;
namespace wc = wgmma_common;
using ac::Rope;
typedef __nv_bfloat16 bf16;

constexpr int kHd = 128;
constexpr int kBk = 64;                       // keys a tile
constexpr int kRows = 128;                    // queries a work item: 64 a consumer warpgroup
constexpr int kStages = 4;                    // K/V ring slots
constexpr int kSubBytes = kBk * 128;          // 64 rows of 128 bytes: dims 0-63 or 64-127 of a tile
constexpr int kTileBytes = 2 * kSubBytes;     // one K or V tile: 16 KB
constexpr int kStageBytes = 2 * kTileBytes;   // K, then V
constexpr int kQSub = kRows * 128;            // one 64-dim half of the Q block: 16 KB
constexpr int kQBytes = 2 * kQSub;
constexpr int kOnesBytes = 1024;              // a B operand of bf16 ones: the row sums of p
constexpr int kThreads = 512;
constexpr int kRotators = 224;                // warps 1-3 and 12-15
constexpr int kConsumerWarps = 8;
constexpr int kProducerRegs = 40, kConsumerRegs = 216;
constexpr int kTurnBar = 1;                   // named barriers 1, 2: consumer 0's, 1's turn
constexpr int kRotatorBar = 3;

// mbarriers: Q's, then one of each kind a ring slot
enum { kQLanded, kQReady, kQEmpty, kKLanded, kKReady = kKLanded + kStages,
       kVFull = kKReady + kStages, kEmpty = kVFull + kStages, kEmptyV = kEmpty + kStages,
       kBars = kEmptyV + kStages };
constexpr int kBarBytes = 256;
static_assert(8 * kBars <= kBarBytes, "mbarriers");
// Q, the ring, the ones, the mbarriers; then the RoPE table
constexpr int kSmemFixed = kQBytes + kStages * kStageBytes + kOnesBytes + kBarBytes;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive and expect `bytes` more from the copies that name this barrier
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// Until the phase of this parity has completed. A wait of more than ~2^33
// cycles (seconds) can only be a fault of the pipeline: it traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 33)) __trap();
}

// one box of a (B, H, N, 128) view: dims d0..d0+63 of rows row0..row0+63 of
// head h, batch b, onto mbarrier `bar`
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap& map, uint32_t bar, int d0,
                                        int row0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(bar), "r"(d0), "r"(row0), "r"(h), "r"(b)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Consumer wg waits for its turn to issue products, then hands the turn on.
__device__ __forceinline__ void turn_begin(int wg) { bar_sync(kTurnBar + wg, 256); }
__device__ __forceinline__ void turn_end(int wg) { bar_arrive(kTurnBar + (wg ^ 1), 256); }

__global__ void __launch_bounds__(kThreads, 1)
rope_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map, bf16* __restrict__ o, int H, int N,
                      int64_t sob, int64_t soh, int64_t son, float scale_log2, Rope rope,
                      int n_qblocks, int n_items) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = async_copy::shared_addr(smem);
  const uint32_t ring_s = q_s + kQBytes;
  const uint32_t ones_s = ring_s + kStages * kStageBytes;
  const uint32_t bar_s = ones_s + kOnesBytes;
  float* tab = reinterpret_cast<float*>(smem + kSmemFixed);
  auto bar = [&](int i) { return bar_s + 8 * i; };
  const int n_tiles = (N + kBk - 1) / kBk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar(kQLanded), 1);
    mbar_init(bar(kQReady), kRotators);
    mbar_init(bar(kQEmpty), kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar(kKLanded + s), 1);
      mbar_init(bar(kKReady + s), kRotators);
      mbar_init(bar(kVFull + s), 1);
      mbar_init(bar(kEmpty + s), kConsumerWarps);
      mbar_init(bar(kEmptyV + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < kOnesBytes / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(smem + (ones_s - q_s))[i] = 0x3F803F80u;  // bf16 1.0, twice
  wc::fence_proxy_async();
  __syncthreads();

  if (warp < 4 || warp >= 12) {  // the producers: warpgroups 0 and 3
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == 0) {
      if (lane != 0) return;
      prefetch_map(q_map);
      prefetch_map(k_map);
      prefetch_map(v_map);
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qblocks, q0 = (item - bh * n_qblocks) * kRows;
        const int b = bh / H, h = bh - b * H;
        mbar_wait(bar(kQEmpty), (it & 1) ^ 1);
        mbar_expect(bar(kQLanded), kQBytes);
        for (int u = 0; u < 2; ++u)
          for (int half = 0; half < 2; ++half)
            tma_box(q_s + u * kQSub + half * kSubBytes, q_map, bar(kQLanded), u * 64,
                    q0 + half * kBk, h, b);
        for (int tile = 0; tile < n_tiles; ++tile) {
          const uint32_t k_s = ring_s + stage * kStageBytes;
          mbar_wait(bar(kEmpty + stage), phase ^ 1);
          mbar_expect(bar(kKLanded + stage), kTileBytes);
          for (int u = 0; u < 2; ++u)
            tma_box(k_s + u * kSubBytes, k_map, bar(kKLanded + stage), u * 64, tile * kBk, h, b);
          mbar_wait(bar(kEmptyV + stage), phase ^ 1);
          mbar_expect(bar(kVFull + stage), kTileBytes);
          for (int u = 0; u < 2; ++u)
            tma_box(k_s + kTileBytes + u * kSubBytes, v_map, bar(kVFull + stage), u * 64,
                    tile * kBk, h, b);
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    } else {  // warps 1-3 and 12-15: the rotation, thread r of kRotators
      const int r = warp < 4 ? threadIdx.x - 32 : threadIdx.x - 384 + 96;
      const float4* table = reinterpret_cast<const float4*>(rope.table);
      for (int i = r; i < (rope.grid_h + rope.grid_w) * ac::kRopeAngles / 2; i += kRotators)
        reinterpret_cast<float4*>(tab)[i] = table[i];
      bar_sync(kRotatorBar, kRotators);
      // rows row0.. of a landed tile of `rows` rows, each 128-byte sub-tile `sub` bytes
      auto rotate = [&](uint32_t tile_s, int sub, int rows, int row0) {
        unsigned char* tile = smem + (tile_s - q_s);
        for (int i = r; i < rows * 8; i += kRotators)
          ac::rope_rotate(tile, sub, i >> 3, i & 7, row0 + (i >> 3), N, rope, tab);
        wc::fence_proxy_async();  // wgmma reads the rows through the async proxy
      };
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
        const int bh = item / n_qblocks, q0 = (item - bh * n_qblocks) * kRows;
        mbar_wait(bar(kQLanded), it & 1);
        rotate(q_s, kQSub, kRows, q0);
        mbar_arrive(bar(kQReady));
        for (int tile = 0; tile < n_tiles; ++tile) {
          mbar_wait(bar(kKLanded + stage), phase);
          rotate(ring_s + stage * kStageBytes, kSubBytes, kBk, tile * kBk);
          mbar_arrive(bar(kKReady + stage));
          if (++stage == kStages) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns the item's queries 64·wg..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = (threadIdx.x >> 7) - 1, t = lane & 3;
  const int row = wg * 64 + (warp & 3) * 16;  // this warp's first query of the block
  uint32_t qf[kHd / 16][4];                   // its 16 queries as A fragments, all 128 dims
  float acc[2][8][4], s[8][4], m[2], alpha[2], lsum[4];
  uint32_t pf[4][4];  // p of the tile being multiplied
  int stage = 0;
  uint32_t phase = 0;

  // s = q·kᵀ for the K tile in slot st, issued and committed, not waited for
  auto issue_scores = [&](int st) {
    const uint32_t k_s = ring_s + st * kStageBytes;
    wc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)  // 16 dims a step: 32 bytes along the swizzled rows
      ac::wgmma_rs<false>(s, qf[kk], wc::tile_desc(k_s + (kk >> 2) * kSubBytes + (kk & 3) * 32),
                          kk != 0);
    wc::wgmma_commit();
  };
  // acc += p·v and lsum += p·1 for the V tile in slot st, issued and committed
  auto issue_pv = [&](int st) {
    const uint32_t v_s = ring_s + st * kStageBytes + kTileBytes;
    wc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys a step: two 8-row groups of V
#pragma unroll
      for (int u = 0; u < 2; ++u)
        ac::wgmma_rs<true>(acc[u], pf[kk], wc::tile_desc(v_s + u * kSubBytes + kk * 2048), 1);
      ac::wgmma_rs_n8(lsum, pf[kk], wc::tile_desc(ones_s));
    }
    wc::wgmma_commit();
  };
  // every warp of both consumers arrives once the products that read slot st are done
  auto release = [&](int kind, int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kind + st));
  };
  // One turn: the scores of tile + 1 and p_tile·v_tile, issued together and
  // waited for together, then the softmax of tile + 1, while the other
  // consumer's products run. `last`: tile + 1 is the ragged tile.
  auto step = [&](int tile, auto last) {
    int next = stage + 1;
    uint32_t next_phase = phase;
    if (next == kStages) next = 0, next_phase ^= 1;
    mbar_wait(bar(kKReady + next), next_phase);
    mbar_wait(bar(kVFull + stage), phase);
    turn_begin(wg);
    issue_scores(next);
    issue_pv(stage);
    turn_end(wg);
    wc::wgmma_wait<0>(s);
    wc::wgmma_wait<0>(acc);
    wc::pin(lsum);
    release(kEmpty, next);
    release(kEmptyV, stage);
    stage = next, phase = next_phase;
    if (decltype(last)::value) ac::mask_tail(s, (tile + 1) * kBk + 2 * t, N);
    ac::softmax_step<true, false>(s, m, alpha, pf, scale_log2);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) ac::rescale(acc, lsum, alpha);
  };

  if (wg == 1) turn_end(1);  // consumer 0 takes the first turn
  for (int item = blockIdx.x, it = 0; item < n_items; item += gridDim.x, ++it) {
    const int bh = item / n_qblocks, q0 = (item - bh * n_qblocks) * kRows;
    const int b = bh / H, h = bh - b * H;
    mbar_wait(bar(kQReady), it & 1);
#pragma unroll
    for (int kk = 0; kk < kHd / 16; ++kk)
      ac::ldmatrix_x4(qf[kk], q_s + (kk >> 2) * kQSub +
                                  wc::swz(row + (lane & 15), (kk & 3) * 2 + (lane >> 4)));
    __syncwarp();
    if (lane == 0) mbar_arrive(bar(kQEmpty));
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
    m[0] = m[1] = -CUDART_INF_F;
    lsum[0] = lsum[1] = lsum[2] = lsum[3] = 0.f;

    // tile 0's scores and softmax; then the steps; then the last tile's product
    mbar_wait(bar(kKReady + stage), phase);
    turn_begin(wg);
    issue_scores(stage);
    turn_end(wg);
    wc::wgmma_wait<0>(s);
    release(kEmpty, stage);
    if (n_tiles == 1) ac::mask_tail(s, 2 * t, N);
    ac::softmax_step<true, false>(s, m, alpha, pf, scale_log2);  // acc and lsum are 0
    for (int tile = 0; tile + 2 < n_tiles; ++tile) step(tile, std::false_type());
    if (n_tiles >= 2) step(n_tiles - 2, std::true_type());
    mbar_wait(bar(kVFull + stage), phase);
    turn_begin(wg);
    issue_pv(stage);
    // the last turn of all: no turn of consumer 0 is left to hand on to
    if (wg == 0 || item + gridDim.x < n_items) turn_end(wg);
    wc::wgmma_wait<0>(acc);
    wc::pin(lsum);
    release(kEmptyV, stage);
    if (++stage == kStages) stage = 0, phase ^= 1;
    bf16* ob = o + b * sob + h * soh;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      ac::store_rows<false>(acc[u], lsum, ob + u * 64, son, q0 + row, N, lane);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a (B, H, N, 128) bf16 view whose batches, heads and rows
// lie st[0], st[1], st[2] elements apart: boxes of 64 dims x 64 rows,
// 128-byte swizzled, rows >= N read as zeros. False where the encoder refuses.
bool make_map(CUtensorMap* map, const void* base, int B, int H, int N, const int64_t* st) {
  const cuuint64_t dims[4] = {kHd, (cuuint64_t)N, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {64, kBk, 1, 1}, unit[4] = {1, 1, 1, 1};
  const EncodeTiled encode = encode_tiled();
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// q, k, v, o: (B, H, N, 128) bf16 views as vittf_attention_fwd takes them
// (strides[12]: q, k, v, o, each b, h, n; rows 16-byte aligned); table: (2,
// grid_h + grid_w, 32) fp32, 16-byte aligned (cos, then sin; rows by grid row,
// then by grid column); rows >= prefix of q and k are patches (prefix +
// grid_h * grid_w = N). One launch; returns cudaGetLastError() after it.
extern "C" int vittf_rope_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        int B, int H, int N, const int64_t* st,
                                        float scale_log2, const void* table, int prefix,
                                        int grid_h, int grid_w, void* stream) {
  const int smem =
      kSmemFixed + 2 * (grid_h + grid_w) * attention_core::kRopeAngles * (int)sizeof(float);
  if (prefix < 0 || grid_h < 1 || grid_w < 1 || prefix + grid_h * grid_w != N || B < 1 ||
      H < 1 || smem > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* views[3] = {q, k, v};
  for (int i = 0; i < 3; ++i)
    if (!make_map(&maps[i], views[i], B, H, N, st + 3 * i)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_qblocks = (N + kRows - 1) / kRows;
  const int64_t n_items = (int64_t)B * H * n_qblocks;
  if (n_items > INT32_MAX) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(rope_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  rope_attention_kernel<<<(int)(n_items < sms ? n_items : sms), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(o), H, N, st[9], st[10], st[11], scale_log2,
      Rope{static_cast<const float*>(table), prefix, grid_h, grid_w}, n_qblocks, (int)n_items);
  return (int)cudaGetLastError();
}
