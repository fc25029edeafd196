// Indexed linear: y = x @ w[li]^T from a stacked weight, forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/indexed_linear.py:_kernel,
// launched by _call: a Pallas grid over N blocks whose weight BlockSpec
// reads the layer index as a scalar prefetch, so only layer li's blocks
// leave HBM and no slice is copied first.  The stacked streaming scan
// (backbone.apply_streaming over backbone.stack_layers) runs every
// backbone linear through it.
//
// Semantics (ops/indexed_linear.indexed_linear_ref, without the bias):
//   x: bf16 (M, K), row stride x_rs; w: bf16 (n_layers, N, K) contiguous
//   (the nn.Linear orientation, layer-major); li: int32 on the device;
//   out: bf16 (M, N) contiguous,
//   out[m, n] = bf16(sum_k x[m, k] * w[li, n, k])  (f32 sums).
// The layer index is read by the kernel from device memory, as the TPU
// kernel reads its scalar prefetch: the host never learns it, so a step
// that keeps its layer counter on the device needs no synchronisation.  An
// index outside [0, n_layers) reads nothing and writes NaN.
//
// What bounds it on an H100 (3.35 TB/s, 989 bf16 TFLOP/s): at the
// streaming step (M 60) a layer's (768, 2304) qkv weight is 3.5 MB read
// for 2 x 60 operations a weight, 60 operations a byte, far below the 295
// a byte where the tensor cores would bound it: bytes bound (>= 1.1 us).
// A block's time is a chain: the read of the layer index, the first weight
// bytes' trip from HBM, its x and weight bytes into the SM (every column
// tile reads x's whole K run: 96 of the 144 KB of a qkv block), the last
// step's products; a K split adds the reduction across the cluster.
//
// Design (Hopper: TMA, mbarriers, wgmma, a thread-block cluster; the
// helpers for each, and the split's reduction, are hopper.cuh's):
// - A block is one warpgroup (128 threads) and computes a 64-row x BN
//   output tile (BN 64, 32 or 16) with wgmma m64nBNk16 (bf16 in, f32
//   sums in registers), A (the x tile) and B (the weight tile) both read
//   from shared memory through descriptors; rows past M are zero-filled by
//   the copy and not stored.
// - Copies: thread 0 issues one TMA tensor copy a tile (x: 64 rows x 64 K
//   from a 2-D map over (M, K) with x's row stride; w: BN rows x 64 K of
//   layer li from a 3-D map over (n_layers, N, K), the layer a coordinate,
//   so the 64-bit layer offset is the copy engine's), both 128-byte
//   swizzled, the layout wgmma's descriptors read without bank conflicts.
//   The ring holds as many 64-deep K steps as shared memory takes (16 at
//   BN 16 and 32, 13 at BN 64), one mbarrier a stage counting the bytes
//   in: at the decode shapes a block's whole K run fits in the ring, so
//   every copy is asked for at once (a stage refilled only after its
//   products would pay a memory round trip each time) and no thread
//   spends instructions on addresses; the products of step k run while
//   step k + 1 lands.
// - Split K across the blocks of a cluster (up to 8, the portable size):
//   cluster rank r sums K run r.  Each rank owns a share of the output
//   tile; every rank writes its f32 partial sums of a share into a slot of
//   the owner's shared memory (distributed shared memory stores), then
//   after one cluster barrier each owner sums its slots in rank order (no
//   atomics: deterministic) and writes.  No two ranks of a cluster read
//   the same x bytes (their K runs differ), so there is nothing to
//   multicast.
// - ops/indexed_linear.plan picks (BN, cluster size) per shape, read from
//   the plans chip_smoke.py times at the streaming step's shapes: no K
//   split where a block's whole K run fits its ring, the narrowest tile
//   whose grid fits one wave (the cluster's reduction costs more than the
//   x bytes it saves: at qkv 0.0046 ms in 72 blocks unsplit, 0.0056 in 108
//   blocks of three ranks, H100 SXM); else the largest grid within a wave.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int BM = 64;        // rows of a block tile: wgmma's M
constexpr int THREADS = 128;  // one warpgroup
constexpr int BK = 64;        // K step: 64 bf16 = one 128-byte swizzled row, 4 x k16
constexpr int MAX_STAGES = 16;
constexpr int MAX_CLUSTER = 8;

// A ring of as many K steps as fit (at most MAX_STAGES), then the rank's
// share of the tile from every rank (at most BM x BN f32, plus the rounding
// of the shares to float4s), then one mbarrier a stage; the base is
// aligned up to 1024 bytes at run time.
template <int BN>
struct Smem {
  static constexpr int x_bytes = BM * BK * 2;
  static constexpr int w_bytes = BN * BK * 2;
  static constexpr int stage = x_bytes + w_bytes;  // a multiple of 1024: tiles stay aligned
  static constexpr int slot_bytes = 4 * (BM * BN + 4 * MAX_CLUSTER);
  static constexpr int fit = (SMEM_MAX - TILE_ALIGN - slot_bytes - 8 * MAX_STAGES) / stage;
  static constexpr int stages = fit < MAX_STAGES ? fit : MAX_STAGES;
  static constexpr int slots = stages * stage;
  static constexpr int bars = slots + slot_bytes;
  static constexpr int bytes = bars + 8 * stages + TILE_ALIGN;
};

__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
indexed_linear_kernel(const __grid_constant__ CUtensorMap x_map,
                      const __grid_constant__ CUtensorMap w_map, const int* __restrict__ li_ptr,
                      int n_layers, __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  using S = Smem<BN>;
  constexpr int STAGES = S::stages;
  constexpr int R = BN / 2;  // accumulators a thread: 64 x BN over 128 threads
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(smem);  // the ring starts the aligned block
  const uint32_t bars = ring + S::bars;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)cluster.num_blocks();

  const int n0 = blockIdx.x / n_ranks * BN;  // a cluster's blocks are consecutive in x
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int steps = K / BK / n_ranks;  // this rank's K run, from k_begin
  const int k_begin = rank * steps * BK;

  if (tid == 0) {
    prefetch_map(&x_map);
    prefetch_map(&w_map);
  }
  const int li = *li_ptr;  // one word, the same for every thread of the grid
  if (li < 0 || li >= n_layers) {  // no layer to read: rank 0 writes the tile as NaN
    if (rank == 0)
      for (int e = tid; e < BM * BN; e += THREADS) {
        const int r = e / BN;
        if (m0 + r < M) out[(long long)(m0 + r) * N + n0 + e % BN] = __float2bfloat16(NAN);
      }
    return;  // every rank leaves here, before any copy or cluster barrier
  }

  // step's x and weight tiles into its stage, counted on the stage's barrier
  const CUtensorMap *xm = &x_map, *wm = &w_map;
  auto issue = [=](int step) {
    const int s = step % STAGES, k0 = k_begin + step * BK;
    const uint32_t bar = bars + 8 * s, xs = ring + s * S::stage;
    mbar_expect(bar, S::stage);
    tma_2d(xs, xm, bar, k0, m0);
    tma_3d(xs + S::x_bytes, wm, bar, k0, n0, li);
  };
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(bars + 8 * s, 1);
    mbar_init_fence();
    for (int step = 0; step < STAGES && step < steps; ++step) issue(step);
  }
  __syncthreads();  // the barriers are initialised for every thread
  // every rank must have started before another writes to its shared
  // memory: arrive now, wait before the first write
  if (n_ranks > 1) cluster.barrier_arrive();

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int s = step % STAGES;
    mbar_wait(bars + 8 * s, (step / STAGES) & 1);
    const uint32_t xs = ring + s * S::stage;
    const uint64_t da = sw128_desc(xs), db = sw128_desc(xs + S::x_bytes);
    pin(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) Wgmma<BN>::ss(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    if (step + STAGES < steps) {  // stage s takes step + STAGES once its products are done
      wgmma_wait<0>();
      __syncthreads();
      if (tid == 0) issue(step + STAGES);
    }
  }
  wgmma_wait<0>();
  pin(acc);

  // acc[4j + 2h + e] is row 16 warp + g + 8h, column 8j + 2t + e of the tile
  if (n_ranks == 1) {  // the whole K: write the tile
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + hh * 8;
        if (m0 + r < M)
          store2(out + (long long)(m0 + r) * N + n0 + j * 8 + t * 2, acc[4 * j + 2 * hh],
                 acc[4 * j + 2 * hh + 1]);
      }
    return;
  }

  // K split: ranks sum their partial tiles in rank order through the
  // owners' shared memory (hopper::cluster_reduce), each owner writes its share
  cluster.barrier_wait();  // every rank has started: its slots may be written
  float* slots = reinterpret_cast<float*>(smem + S::slots);
  cluster_reduce<BM, BN, MAX_CLUSTER>(acc, true, 0, slots, [&](int e, float4 sum) {
    const int r = e / BN;
    if (m0 + r < M) {
      __nv_bfloat16* dst = out + (long long)(m0 + r) * N + n0 + e % BN;
      store2(dst, sum.x, sum.y);
      store2(dst + 2, sum.z, sum.w);
    }
  });
}

template <int BN>
int launch(const void* x, long long x_rs, const void* w, const void* li, int n_layers, void* out,
           int M, int N, int K, int n_split, cudaStream_t stream) {
  constexpr int smem = Smem<BN>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(indexed_linear_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  CUtensorMap x_map, w_map;
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)x_rs * 2};
  const cuuint32_t x_box[2] = {BK, BM};
  const cuuint64_t w_dims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)n_layers};
  const cuuint64_t w_strides[2] = {(cuuint64_t)K * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t w_box[3] = {BK, BN, 1};
  if (!encode_bf16(&x_map, x, 2, x_dims, x_strides, x_box) ||
      !encode_bf16(&w_map, w, 3, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / BN * n_split, (M + BM - 1) / BM);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = n_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = n_split > 1 ? 1 : 0;  // a grid without a cluster attribute: clusters of 1
  cudaError_t e = cudaLaunchKernelEx(&cfg, indexed_linear_kernel<BN>, x_map, w_map,
                                     static_cast<const int*>(li), n_layers,
                                     static_cast<__nv_bfloat16*>(out), M, N, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 (M, K) with row stride x_rs (elements, a multiple of 8; 16-byte
// aligned); w: bf16 (n_layers, N, K) contiguous; li: int32 on the device;
// out: bf16 (M, N) contiguous.  K and N multiples of 128; block_n (the
// column tile) 16, 32 or 64; k_split (the cluster size) 1..8, dividing
// K / 64.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int indexed_linear_bf16(const void* x, long long x_rs, const void* w, const void* li,
                                   int n_layers, void* out, int M, int N, int K, int block_n,
                                   int k_split, void* stream) {
  if (K % 128 || N % 128 || M <= 0 || n_layers <= 0 || k_split < 1 || k_split > MAX_CLUSTER ||
      (K / BK) % k_split || x_rs % 8 || reinterpret_cast<uintptr_t>(x) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (block_n) {
    case 16:
      return launch<16>(x, x_rs, w, li, n_layers, out, M, N, K, k_split, s);
    case 32:
      return launch<32>(x, x_rs, w, li, n_layers, out, M, N, K, k_split, s);
    case 64:
      return launch<64>(x, x_rs, w, li, n_layers, out, M, N, K, k_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
