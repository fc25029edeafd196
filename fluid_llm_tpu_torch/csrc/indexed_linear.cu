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
// Design (Hopper: TMA, mbarriers, wgmma, a thread-block cluster):
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

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 64;        // rows of a block tile: wgmma's M
constexpr int THREADS = 128;  // one warpgroup
constexpr int BK = 64;        // K step: 64 bf16 = one 128-byte swizzled row, 4 x k16
constexpr int MAX_STAGES = 16;
constexpr int MAX_CLUSTER = 8;
constexpr int TILE_ALIGN = 1024;  // a 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have (H100)

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory descriptor of a K-major tile in the 128-byte
// swizzle (rows of 64 bf16, 8-row groups 1024 bytes apart); a k16 step
// further along K starts 32 bytes later
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x BN f32, in the warpgroup's accumulator layout) += A (64 x 16) B^T
// (BN x 16), both K-major in shared memory
template <int BN>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma<16>(float (&d)[8], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,\n"
      "%8, %9, %10, %11, %12, %13, %14, %15,\n"
      "%16, %17, %18, %19, %20, %21, %22, %23,\n"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

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
  unsigned char* const smem =
      smem_raw + ((TILE_ALIGN - smem_addr(smem_raw) % TILE_ALIGN) % TILE_ALIGN);
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
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&x_map))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&w_map))
                 : "memory");
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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
    for (int kk = 0; kk < BK / 16; ++kk) wgmma<BN>(acc, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
    if (step + STAGES < steps) {  // stage s takes step + STAGES once its products are done
      wgmma_wait_all();
      __syncthreads();
      if (tid == 0) issue(step + STAGES);
    }
  }
  wgmma_wait_all();
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

  // rank o owns elements [o * share, (o + 1) * share) of the tile (row-major
  // BM x BN); every rank writes its partial sums of them into slot `rank`
  // of the owner's shared memory, one cluster barrier, then each owner sums
  // its slots in rank order (no atomics: deterministic) and writes them
  const int share = ((BM * BN + n_ranks - 1) / n_ranks + 3) / 4 * 4;
  float* slots = reinterpret_cast<float*>(smem + S::slots);
  cluster.barrier_wait();  // every rank has started
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int e = (warp * 16 + g + hh * 8) * BN + j * 8 + t * 2;
      const int owner = e / share;
      *reinterpret_cast<float2*>(cluster.map_shared_rank(slots, owner) + rank * share + e -
                                 owner * share) =
          make_float2(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  cluster.sync();  // every rank's partial sums are in their owners' slots
  const int mine = min(share, BM * BN - rank * share);
  for (int i = tid * 4; i < mine; i += THREADS * 4) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < n_ranks) {
        const float4 v = *reinterpret_cast<const float4*>(slots + k * share + i);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    const int e = rank * share + i, r = e / BN;
    if (m0 + r < M) {
      __nv_bfloat16* dst = out + (long long)(m0 + r) * N + n0 + e % BN;
      store2(dst, sum.x, sum.y);
      store2(dst + 2, sum.z, sum.w);
    }
  }
}

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tiled bf16 map with 128-byte swizzle; rows past the tensor read as zeros.
bool encode(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (!encode(&x_map, x, 2, x_dims, x_strides, x_box) ||
      !encode(&w_map, w, 3, w_dims, w_strides, w_box))
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
