// int8-weight matmul, w8a8 and w8a16, forward only.
//
// Replaces the TPU kernels fluid_llm_tpu/ops/quant_matmul.py:_kernel_w8a8
// and :_kernel (w8a16), both launched by _qmm_2d: a (M/BM, N/BN, K/BK)
// Pallas grid with the K loop innermost, accumulating in VMEM scratch.  On
// the TPU the w8a8 activations were quantised and the scales applied by
// XLA outside the kernel; here one launch does all three.
//
// Semantics (ops/quant_matmul.int8_matmul_ref, exactly):
//   x: bf16 (M, K), row stride x_rs; q: int8 (N, K) contiguous (the
//   nn.Linear orientation); scale: f32 (N,); bias: f32 (N,) or null;
//   out: bf16 (M, N) contiguous.
//   w8a8:  sx[m] = absmax_k |x[m, k]| / 127 (1 where 0), f32, divided;
//          xq = clamp(rint(x / sx), -127, 127)  (round half to even);
//          acc = sum_k xq * q  (int32, exact);
//          y = bf16((float(acc) * sx[m]) * scale[n])
//   w8a16: acc = sum_k x * bf16(q)  (bf16 products, f32 sums);
//          y = bf16(acc * scale[n])
//   then, where there is a bias, out = bf16(y + bf16(bias[n])), as the
//   JAX _linear adds it after the cast.
//
// w8a8.  What bounds it on an H100 (3.35 TB/s, 1,979 int8 TOP/s): at the
// streaming step (M 60) a 768 x 768 linear is 0.59 MB of int8 weights
// (>= 0.18 us of HBM) for 2 x 60 operations a byte, far below the 295 a
// byte where the tensor cores would bound it; the call is too small to
// reach either, so its launch, the chain of its absmax, quantisation and
// K loop, and the number of blocks that stream the weight bound it.
// Design: out (M, N) = x q^T with x's 64-row token tile as wgmma's M and
// a BN-row tile of q (BN 32, 64, 128 or 256) as its N, both int8 and
// K-major in shared memory (the only layout wgmma takes for 8-bit
// operands): two consumer warpgroups each take half the columns, wgmma
// m64n(BN/2)k32 s32.s8.s8, exact int32 sums in registers.
// - Copies: one warp issues TMA tensor copies of q's (BN, 128) tiles,
//   untouched, in the 128-byte swizzle, into a ring of up to 8 stages on
//   full and empty mbarriers; the first stages are in flight while the
//   consumer warpgroups quantise x.
// - x: both warpgroups take each row's absmax over the block's K run
//   (16-byte loads; x is a few hundred KB and sits in L2; bf16 maxima, two
//   at a time, exact), then quantise the run once (from the same registers
//   where the run is one batch of loads, at most four K steps; else read
//   again), each 16 bf16 to 16 int8 written in the 128-byte swizzle, so the
//   int8 tile reads as a TMA copy would have written it; fence.proxy.async
//   before the first product makes those writes visible to wgmma.  A run
//   deeper than the tile's 16 steps (128 KB) goes in segments, each
//   quantised and then multiplied.
// - Split K across a thread-block cluster (up to 8 blocks, each a run of
//   whole 128-deep K steps) where the column tiles alone leave most SMs
//   idle: each rank stores its partial row maxima into every rank's shared
//   memory with st.async, counted on that rank's mbarrier, which is all a
//   rank waits for (a maximum is exact in any order; a cluster barrier
//   armed at the start says every rank has started), and their int32
//   partial tiles summed in rank order (hopper::cluster_reduce; exact).
// - Epilogue: bf16((float(acc) * sx[m]) * scale[n]), then + bf16(bias), the
//   twin's order, as 4-byte pairs.
//   ops/quant_matmul.w8a8_plan picks (BN, K split) per shape, read from the
//   plans chip_smoke.py times at phase 3's nine shapes.
//   What holds it back at 60 rows (PERF.md): its chain of x loads, row
//   maxima, their exchange and the quantisation before the first product,
//   which w8a16 does not have (a sweep with each part left out: the
//   quantisation ~1.4 us, the exchange's waits ~1 us; launch, copies and
//   barriers alone ~5.4 us, where w8a16 takes ~6.5 in all).
//
// w8a16.  What bounds it on an H100 (989 bf16 TFLOP/s, 3.35 TB/s): at the
// exact rollout (M 661) a step's linears are 112 G operations, so the
// tensor cores bound it (>= 3.2 us at (661, 3072, 768)); at the sliced last
// block's 60 rows the weight bytes do (0.59 MB of int8 at 768 x 768, >=
// 0.18 us), and a 60-row call is really a chain of memory latencies over
// its K loop.  The tensor cores take two bf16 operands and wgmma reads
// only its A operand from registers, so the int8 weight, which has to be
// converted, takes the A position: the kernel computes out^T (N, M) =
// W (N, K) x^T, the weight's rows the product's 64-row M tile and the
// tokens its N tile (BT 64, 128, 136 or 224: 661 rows are 5 tiles of 136).
// - Copies: one warp issues TMA tensor copies into a ring of 128-deep K
//   steps, with a full and an empty mbarrier a stage: the weight tile as
//   int8 (128-byte rows: half the bytes of a bf16 copy) and the x tile as
//   bf16 (two BT x 64 boxes, through a 2-D map with x's row stride, so
//   column slices are read in place; rows past M read as zeros), all in
//   the 128-byte swizzle.  The ring takes as many steps as fit ~110 KB
//   where two stages do (two blocks share an SM), else ~200 KB, at most 8;
//   copies of the next steps are in flight while a step's products run.
// - Conversion: the consumer warpgroup reads each row's 16-byte k16 chunk
//   (the swizzle puts a warp's 8 rows on distinct banks), picks its
//   fragment's bytes (k 2t, 2t + 1, 2t + 8, 2t + 9) with one byte permute,
//   and turns each int8 into bf16 by placing its biased byte in the
//   mantissa of 2^23 and subtracting 2^23 + 128 (exact for every int8; no
//   float conversion per element).  The fragment goes to wgmma m64nBTk16
//   with A from registers and B (x) through a shared-memory descriptor;
//   step k + 1's fragment is converted while step k's products run.
// - Epilogue: times the row's scale (read while the copies run), rounded
//   to bf16, plus bf16(bias), staged through shared memory and written
//   transposed into out (M, N) as whole rows of the block's columns.
// - Split K across a thread-block cluster (up to 8 blocks), summed in rank
//   order through distributed shared memory (hopper::cluster_reduce, shared
//   with the indexed linear; deterministic, no atomics).
//   ops/quant_matmul.plan picks (BT, K split) per shape, read from the
//   plans chip_smoke.py times at the main path's six shapes.
//   What holds it back there (PERF.md): the sweeps' times follow
//   the number of K steps and of blocks, and a grid that fills two
//   blocks an SM, more than the products or the L2 bytes (128-deep steps
//   ran 14-23 % faster than 64-deep ones at 661 rows; 661 rows in 5 tiles
//   of 136, 240 blocks, beat 4 of 176; x multicast across a cluster and a
//   second warpgroup sharing x, both tried and taken out, did not pay):
//   each step's copy, barrier and conversion chain, and each block's
//   start and epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

// ---- w8a8 on wgmma: x quantised into shared memory, int8 x int8 -> int32

constexpr int Q8_ROWS = 64;          // token rows of a block: wgmma's M
constexpr int Q8_BK = 128;           // K step: 128 int8 of x and of q (a 128-byte row)
constexpr int Q8_WG = 2;             // consumer warpgroups: quantise x, multiply half the columns each
constexpr int Q8_CONSUMERS = 128 * Q8_WG;
constexpr int Q8_THREADS = Q8_CONSUMERS + 32;  // + the warp that issues the copies
constexpr int Q8_MAX_CLUSTER = 8;
constexpr int Q8_MAX_STAGES = 8;
constexpr int Q8_BATCH = 8;          // 16-column chunks a thread loads before using any
constexpr int Q8_TILE_STEPS = 16;    // K steps the int8 x tile holds at most

// The shared memory of a block of BN columns whose x tile holds `run` K
// steps: the int8 x tile (run steps of 64 x 128, each 1024-aligned), the
// ring of q tiles, the split's slots, a full and an empty mbarrier a
// stage and the maxima's mbarrier, the ranks' row maxima, the rows'
// maxima, scales and reciprocals, the alignment's slack.
template <int BN>
struct Q8Smem {
  static constexpr int x_step = Q8_ROWS * Q8_BK;
  static constexpr int q_stage = BN * Q8_BK;  // a multiple of 1024: tiles stay aligned
  static constexpr int slot_bytes = 4 * (Q8_ROWS * BN + 4 * Q8_MAX_CLUSTER);
  __host__ __device__ static int ring(int run) { return run * x_step; }
  __host__ __device__ static int bars(int run, int stages, bool split) {
    return ring(run) + stages * q_stage + (split ? slot_bytes : 0);
  }
  __host__ __device__ static int rows(int run, int stages, bool split) {
    return bars(run, stages, split) + 16 * stages + 8;
  }
  __host__ __device__ static int bytes(int run, int stages, bool split) {
    return rows(run, stages, split) + 4 * Q8_ROWS * (Q8_MAX_CLUSTER + 3) + TILE_ALIGN;
  }
};

template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<16> {
  static __device__ __forceinline__ void ss(int (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<32> {
  static __device__ __forceinline__ void ss(int (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void ss(int (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void ss(int (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31,\n"
        "%32, %33, %34, %35, %36, %37, %38, %39,\n"
        "%40, %41, %42, %43, %44, %45, %46, %47,\n"
        "%48, %49, %50, %51, %52, %53, %54, %55,\n"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
          "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
          "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

// 16 bytes at p if ok, else zeros (rows past M, K past its end contract to 0)
__device__ __forceinline__ uint4 ld128(const void* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// The epilogue of one (row, column pair): y in f32 -> bf16, plus the bias.
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, const float* bias, int n, float y0,
                                           float y1) {
  __nv_bfloat16 o0 = __float2bfloat16(y0), o1 = __float2bfloat16(y1);
  if (bias != nullptr) {
    o0 = __float2bfloat16(__bfloat162float(o0) + __bfloat162float(__float2bfloat16(bias[n])));
    o1 = __float2bfloat16(__bfloat162float(o1) + __bfloat162float(__float2bfloat16(bias[n + 1])));
  }
  __nv_bfloat162 pair;
  pair.x = o0;
  pair.y = o1;
  *reinterpret_cast<__nv_bfloat162*>(out) = pair;
}

// this rank's K run of x rows m0.. as (row, 16-column chunk) items, item i =
// tid + Q8_CONSUMERS * (u + Q8_BATCH * round): loads of a batch in flight together
__device__ __forceinline__ void load_chunks(const __nv_bfloat16* x, long long x_rs, int m0, int M,
                                            int k_begin, int chunks, int i0, uint4 (&v)[Q8_BATCH][2]) {
#pragma unroll
  for (int u = 0; u < Q8_BATCH; ++u) {
    const int i = i0 + threadIdx.x + Q8_CONSUMERS * u, r = i / chunks, c = i % chunks;
    const bool ok = r < Q8_ROWS && m0 + r < M;
    const __nv_bfloat16* p = x + (long long)(m0 + r) * x_rs + k_begin + 16 * c;
    v[u][0] = ld128(p, ok);
    v[u][1] = ld128(p + 8, ok);
  }
}

// rank's shared::cluster address of the local shared-memory address addr
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// an asynchronous store of v at addr (shared::cluster), counted as 4 bytes
// on the mbarrier bar of the same block
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::
                   "r"(addr), "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}

// max |x| of 16 bf16, exact: bf16 maxima of the magnitudes, two at a time
__device__ __forceinline__ float absmax16(const uint4 (&v)[2]) {
  const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
  __nv_bfloat162 m = __habs2(*reinterpret_cast<const __nv_bfloat162*>(&w[0]));
#pragma unroll
  for (int i = 1; i < 8; ++i) m = __hmax2(m, __habs2(*reinterpret_cast<const __nv_bfloat162*>(&w[i])));
  return fmaxf(__bfloat162float(m.x), __bfloat162float(m.y));
}

// 16 bf16 quantised with the row's scale s: rint(v / s), half to even, as
// 16 int8.  The quotient of the IEEE division when ``exact``; otherwise
// v * inv (inv = 1/s rounded), within 2e-5 of it for |v / s| <= 127, so it
// rounds to the same integer unless it lies within 1e-4 of a half, which
// sets ``tie`` (the caller redoes the chunk dividing).  Adding 1.5 * 2^23
// rounds to an integer in the low mantissa bits; |v / s| <= 127 (s is the
// row's absmax / 127), so no clipping is needed.
__device__ __forceinline__ uint4 quant16(const uint4 (&v)[2], float s, float inv, bool exact,
                                         bool& tie) {
  const uint32_t w[8] = {v[0].x, v[0].y, v[0].z, v[0].w, v[1].x, v[1].y, v[1].z, v[1].w};
  uint32_t out[4];
  float off = 0.f;  // the largest |y - rint(y)|
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int r[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[2 * q + e]));
      const float y[2] = {exact ? __fdiv_rn(f.x, s) : __fmul_rn(f.x, inv),
                          exact ? __fdiv_rn(f.y, s) : __fmul_rn(f.y, inv)};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float t = __fadd_rn(y[h], 12582912.f);
        r[2 * e + h] = __float_as_int(t) - 0x4B400000;
        off = fmaxf(off, fabsf(__fsub_rn(y[h], __fsub_rn(t, 12582912.f))));
      }
    }
    out[q] = __byte_perm(__byte_perm(r[0], r[1], 0x0040), __byte_perm(r[2], r[3], 0x0040), 0x5410);
  }
  tie |= off > 0.4999f;
  return make_uint4(out[0], out[1], out[2], out[3]);
}

template <int BN>
__global__ void __launch_bounds__(Q8_THREADS)
qmm_w8a8_kernel(const __grid_constant__ CUtensorMap q_map, const __nv_bfloat16* __restrict__ x,
                long long x_rs, const float* __restrict__ scale, const float* __restrict__ bias,
                __nv_bfloat16* __restrict__ out, int M, int N, int K, int run, int stages) {
  using S = Q8Smem<BN>;
  constexpr int PRODUCER = Q8_CONSUMERS / 32;  // the copies' warp
  constexpr int HALF = BN / 2;                 // columns of each consumer warpgroup
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  // a cluster splits K: rank r multiplies K steps [r T / n, (r + 1) T / n)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)cluster.num_blocks();
  const bool split = n_ranks > 1;
  if (split) cluster.barrier_arrive();  // waited for before the first remote write
  const int total = K / Q8_BK, s_begin = rank * total / n_ranks;
  const int steps = (rank + 1) * total / n_ranks - s_begin, k_begin = s_begin * Q8_BK;
  const uint32_t xs = smem_addr(smem), ring = xs + S::ring(run);
  int* const slots = reinterpret_cast<int*>(smem + S::ring(run) + stages * S::q_stage);
  const uint32_t full = xs + S::bars(run, stages, split), empty = full + 8 * stages;
  const uint32_t max_bar = empty + 8 * stages;  // the ranks' maxima have arrived
  float* const maxima = reinterpret_cast<float*>(smem + S::rows(run, stages, split));
  float* const row_max = maxima + Q8_MAX_CLUSTER * Q8_ROWS;  // this rank's, as ints
  float* const sx = row_max + Q8_ROWS;  // each row's scale, then its reciprocal
  float* const inv = sx + Q8_ROWS;

  const int n0 = blockIdx.x / n_ranks * BN;  // weight rows: output columns
  const int m0 = blockIdx.y * Q8_ROWS;       // tokens: output rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp / 4;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, Q8_CONSUMERS / 32);  // each consumer warp's lane 0
    }
    mbar_init(max_bar, 1);
    if (split) mbar_expect(max_bar, n_ranks * Q8_ROWS * 4);  // every rank's 64 maxima
    mbar_init_fence();
  }
  if (tid < Q8_ROWS) row_max[tid] = 0.f;
  __syncthreads();

  int acc[HALF / 2];
#pragma unroll
  for (int i = 0; i < HALF / 2; ++i) acc[i] = 0;
  if (warp == PRODUCER) {
    auto issue = [&](int step) {
      const int s = step % stages, round = step / stages;
      if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
      mbar_expect(full + 8 * s, S::q_stage);
      tma_2d(ring + s * S::q_stage, &q_map, full + 8 * s, k_begin + step * Q8_BK, n0);
    };
    // the stages that need no wait go before the ranks' exchange of maxima
    const int first = steps < stages ? steps : stages;
    if (lane == 0) {
      prefetch_map(&q_map);
      for (int step = 0; step < first; ++step) issue(step);
    }
    if (split) cluster.barrier_wait();
    if (lane == 0)
      for (int step = first; step < steps; ++step) issue(step);
  } else {
    int chunks = steps * (Q8_BK / 16);  // 16-column chunks of a row's K run
    int items = Q8_ROWS * chunks;
    // the run in one batch of loads (at most 4 K steps): the quantisation
    // reads these registers
    const bool held = items <= Q8_CONSUMERS * Q8_BATCH;
    uint4 v[Q8_BATCH][2];
    // 1. each row's absmax over this rank's K run: a row's chunks sit on 8
    //    (or more) neighbouring lanes, reduced by shuffles, then an integer
    //    maximum (|x| as an int orders like the float; exact in any order)
    for (int i0 = 0; i0 < items; i0 += Q8_CONSUMERS * Q8_BATCH) {
      load_chunks(x, x_rs, m0, M, k_begin, chunks, i0, v);
#pragma unroll
      for (int u = 0; u < Q8_BATCH; ++u) {
        const int i = i0 + tid + Q8_CONSUMERS * u;
        float a = absmax16(v[u]);  // 0 past the run
#pragma unroll
        for (int o = 1; o < 8; o <<= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
        if (i < items && lane % 8 == 0)
          atomicMax(reinterpret_cast<int*>(row_max) + i / chunks, __float_as_int(a));
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(Q8_CONSUMERS) : "memory");
    if (split) {  // every rank's maxima to every rank (no cluster-wide barrier)
      cluster.barrier_wait();  // every rank has started: its max_bar is set up
      if (tid < Q8_ROWS)
        for (int k = 0; k < n_ranks; ++k)
          st_async(map_rank(smem_addr(maxima + rank * Q8_ROWS + tid), k), row_max[tid],
                   map_rank(max_bar, k));
    }
    if (tid < Q8_ROWS) {
      if (split) mbar_wait(max_bar, 0);  // the n_ranks x 64 maxima are here
      float a = row_max[tid];
#pragma unroll
      for (int k = 0; k < Q8_MAX_CLUSTER; ++k)
        if (split && k < n_ranks) a = fmaxf(a, maxima[k * Q8_ROWS + tid]);
      const float s = a > 0.f ? __fdiv_rn(a, 127.f) : 1.f;
      sx[tid] = s;
      inv[tid] = __frcp_rn(s);
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(Q8_CONSUMERS) : "memory");
    // 2. the K run in segments of at most `run` steps (the tile), each
    //    quantised once into the int8 tile in the 128-byte swizzle (chunk c
    //    of row r at step c / 8, 16-byte column (c % 8) ^ (r % 8)), 3. then
    //    multiplied, each step's products retired before the next (none in
    //    flight across the loop edge)
    for (int seg0 = 0; seg0 < steps; seg0 += run) {
      const int seg = steps - seg0 < run ? steps - seg0 : run;
      const int k0 = k_begin + seg0 * Q8_BK;
      chunks = seg * (Q8_BK / 16);
      items = Q8_ROWS * chunks;
      if (seg0 > 0) asm volatile("bar.sync 1, %0;\n" ::"n"(Q8_CONSUMERS) : "memory");
      for (int i0 = 0; i0 < items; i0 += Q8_CONSUMERS * Q8_BATCH) {
        if (!held) load_chunks(x, x_rs, m0, M, k0, chunks, i0, v);
#pragma unroll
        for (int u = 0; u < Q8_BATCH; ++u) {
          const int i = i0 + tid + Q8_CONSUMERS * u, r = i / chunks, c = i % chunks;
          if (i >= items) continue;
          bool tie = false;
          uint4 qv = quant16(v[u], sx[r], inv[r], false, tie);
          if (tie) qv = quant16(v[u], sx[r], inv[r], true, tie);  // rare: dividing
          *reinterpret_cast<uint4*>(smem + (c / 8) * S::x_step + r * Q8_BK +
                                    (((c % 8) ^ (r & 7)) << 4)) = qv;
        }
      }
      fence_proxy_async();
      asm volatile("bar.sync 1, %0;\n" ::"n"(Q8_CONSUMERS) : "memory");
      for (int step = seg0; step < seg0 + seg; ++step) {
        const int s = step % stages;
        mbar_wait(full + 8 * s, (step / stages) & 1);
        // this warpgroup's columns: q rows wg * HALF.. of the stage
        const uint32_t xa = xs + (step - seg0) * S::x_step;
        const uint32_t qb = ring + s * S::q_stage + wg * HALF * Q8_BK;
        pin(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < Q8_BK / 32; ++kk)
          WgmmaS8<HALF>::ss(acc, sw128_desc(xa) + 2 * kk, sw128_desc(qb) + 2 * kk);
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }
  }

  if (!split) {
    if (warp == PRODUCER) return;
    // acc[4j + 2hh + e] is row 16 (warp % 4) + g + 8hh, column wg HALF + 8j + 2t + e
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < HALF / 8; ++j) {
      const int n = n0 + wg * HALF + j * 8 + t * 2;
      if (n >= N) continue;
      const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = (warp % 4) * 16 + g + hh * 8;
        if (m0 + r >= M) continue;
        const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hh]), sx[r]), s0);
        const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * hh + 1]), sx[r]), s1);
        store_pair(out + (long long)(m0 + r) * N + n, bias, n, y0, y1);
      }
    }
    return;
  }
  // K split: the slots have a region of their own and every rank has
  // started, so the ranks' partial tiles go straight to their owners and
  // are summed there in rank order.  The two warpgroups' column halves are
  // rows 0..63 and 64..127 of a (128, HALF) tile.
  cluster_reduce<2 * Q8_ROWS, HALF, Q8_MAX_CLUSTER>(
      acc, warp < PRODUCER, wg * Q8_ROWS, slots, [&](int e, int4 sum) {
        const int vr = e / HALF, r = vr % Q8_ROWS, n = n0 + vr / Q8_ROWS * HALF + e % HALF;
        if (m0 + r >= M || n >= N) return;
        const int v[4] = {sum.x, sum.y, sum.z, sum.w};
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          y[i] = __fmul_rn(__fmul_rn(__int2float_rn(v[i]), sx[r]), scale[n + i]);
        __nv_bfloat16* o = out + (long long)(m0 + r) * N + n;
        store_pair(o, bias, n, y[0], y[1]);
        store_pair(o + 2, bias, n + 2, y[2], y[3]);
      });
}

template <int BN>
int launch_w8a8(const void* x, long long x_rs, const void* q, const void* scale, const void* bias,
                void* out, int M, int N, int K, int k_split, cudaStream_t stream) {
  using S = Q8Smem<BN>;
  static bool attr_set = false;  // the most any call may take
  if (int e = allow_smem(qmm_w8a8_kernel<BN>, SMEM_MAX, attr_set)) return e;
  const int total = K / Q8_BK, steps = (total + k_split - 1) / k_split;  // the longest run
  const bool split = k_split > 1;
  // the x tile's steps: the run, at most Q8_TILE_STEPS, fewer where two
  // stages of q (or the run's one) would not fit beside it
  const int want = steps < 2 ? steps : 2;
  int run = steps < Q8_TILE_STEPS ? steps : Q8_TILE_STEPS;
  while (run > 1 && S::bytes(run, want, split) > SMEM_MAX) --run;
  // as many stages as fit, up to the longest run and Q8_MAX_STAGES
  int stages = (SMEM_MAX - S::bytes(run, 0, split)) / S::q_stage;
  stages = stages < steps ? stages : steps;
  stages = stages < Q8_MAX_STAGES ? stages : Q8_MAX_STAGES;
  if (stages < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {Q8_BK, BN};
  if (!encode(&q_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2, dims, strides, box,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + BN - 1) / BN * k_split, (M + Q8_ROWS - 1) / Q8_ROWS);
  cfg.blockDim = dim3(Q8_THREADS);
  cfg.dynamicSmemBytes = S::bytes(run, stages, split);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = split ? 1 : 0;
  cudaError_t e = cudaLaunchKernelEx(&cfg, qmm_w8a8_kernel<BN>, q_map,
                                     static_cast<const __nv_bfloat16*>(x), x_rs,
                                     static_cast<const float*>(scale),
                                     static_cast<const float*>(bias),
                                     static_cast<__nv_bfloat16*>(out), M, N, K, run, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- w8a16 on wgmma: out^T = W x^T, the int8 weight converted in registers

constexpr int W_BK = 128;       // K step: 128 int8 of W (a 128-byte row), 128 bf16 of x
constexpr int W_KK = W_BK / 16;  // k16 products a step
constexpr int W_MAX_CLUSTER = 8;
constexpr int W_MAX_STAGES = 8;

// A block of one consumer warpgroup (64 weight rows) and one warp that
// issues the copies.
template <int BT>
struct W16Smem {
  static constexpr int rows = 64;                   // weight rows: output columns
  static constexpr int consumers = 128;
  static constexpr int threads = consumers + 32;
  static constexpr int w_bytes = rows * W_BK;       // int8, 128-byte rows
  static constexpr int x_box = BT * 128;            // 64 bf16 columns of the x tile
  static constexpr int stage = w_bytes + 2 * x_box;  // a multiple of 1024: tiles stay aligned
  // a block takes half an SM's shared memory (two share an SM) where two
  // stages fit in it, else most of it
  static constexpr int budget = 2 * stage <= 110 * 1024 ? 110 * 1024 : 200 * 1024;
  static constexpr int max_stages = budget / stage < W_MAX_STAGES ? budget / stage : W_MAX_STAGES;
  static constexpr int old = rows + 4;  // bf16 row stride of the staged output (conflict-free)
  static constexpr int out_bytes = 2 * BT * old;
  static constexpr int slot_bytes = 4 * (rows * BT + 4 * W_MAX_CLUSTER);
  // the ring, which the staged output or the split's slots reuse, then a
  // full and an empty mbarrier a stage, then the alignment's slack
  __host__ __device__ static int ring_bytes(int stages, bool split) {
    const int ring = stages * stage, after = split ? slot_bytes : out_bytes;
    return after > ring ? after : ring;
  }
  __host__ __device__ static int bytes(int stages, bool split) {
    return ring_bytes(stages, split) + 16 * stages + TILE_ALIGN;
  }
};

// four int8 (the bytes of w) to four bf16, exactly: each byte, biased by
// 128 to [1, 255], becomes the low mantissa bits of 2^23 (an f32 2^23 + u),
// 2^23 + 128 is subtracted, and the f32 result, a whole number of at most 8
// bits, is its bf16 truncation.  lo holds bytes 0, 1; hi bytes 2, 3.
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// y = bf16(acc * scale), then + bf16(bias) where there is one (b is that
// bf16 as f32): the twin's epilogue, element by element
__device__ __forceinline__ __nv_bfloat16 w16_out(float acc, float s, float b, bool has_bias) {
  const __nv_bfloat16 y = __float2bfloat16(__fmul_rn(acc, s));
  return has_bias ? __float2bfloat16(__bfloat162float(y) + b) : y;
}

template <int BT>
__global__ void __launch_bounds__(W16Smem<BT>::threads)
qmm_w8a16_kernel(const __grid_constant__ CUtensorMap w_map,
                 const __grid_constant__ CUtensorMap x_map, const float* __restrict__ scale,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N,
                 int K, int stages) {
  using S = W16Smem<BT>;
  constexpr int R = BT / 2;  // accumulators a thread: 64 x BT over the warpgroup's 128 threads
  constexpr int PRODUCER = S::consumers / 32;  // the copies' warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t ring = smem_addr(smem);
  // a cluster splits K: rank r sums K run r of the tile
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)cluster.num_blocks();
  const bool split = n_ranks > 1;
  const uint32_t full = ring + S::ring_bytes(stages, split), empty = full + 8 * stages;

  const int n0 = blockIdx.x / n_ranks * S::rows;  // weight rows: output columns
  const int m0 = blockIdx.y * BT;                 // tokens: output rows
  const int steps = K / W_BK / n_ranks;           // this rank's K run, from k_begin
  const int k_begin = rank * steps * W_BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // a consumer's weight rows r0 and r0 + 8 of the tile
  const bool has_bias = bias != nullptr;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, S::consumers / 32);  // each consumer warp's lane 0
    }
    mbar_init_fence();
  }
  // the epilogue's scale and bias of this thread's rows, read while the
  // copies run (a row past N reads nothing)
  float sc[2] = {0.f, 0.f}, bs[2] = {0.f, 0.f};
  if (warp < PRODUCER && !split)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int n = n0 + r0 + 8 * hh;
      if (n < N) {
        sc[hh] = scale[n];
        if (has_bias) bs[hh] = __bfloat162float(__float2bfloat16(bias[n]));
      }
    }
  __syncthreads();

  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  if (warp == PRODUCER) {
    if (lane == 0) {
      prefetch_map(&w_map);
      prefetch_map(&x_map);
      for (int step = 0; step < steps; ++step) {
        const int s = step % stages, round = step / stages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t dst = ring + s * S::stage, bar = full + 8 * s;
        mbar_expect(bar, S::stage);
        tma_2d(dst, &w_map, bar, k_begin + step * W_BK, n0);
        for (int h = 0; h < 2; ++h)  // the x tile's two 64-column boxes
          tma_2d(dst + S::w_bytes + h * S::x_box, &x_map, bar, k_begin + step * W_BK + 64 * h,
                 m0);
      }
    }
  } else {  // the products
    // the 128-byte swizzle moves 16-byte chunk c of row r to c ^ (r & 7)
    const int sw = r0 & 7;
    const uint32_t sel = (t & 1) ? 0x7632u : 0x5410u;
    // step's A fragments: rows r0, r0 + 8; k 2t, 2t + 1, 2t + 8, 2t + 9 of
    // each k16 chunk, in bf16
    auto convert = [&](int step, uint32_t(&f)[W_KK][4]) {
      const int s = step % stages;
      mbar_wait(full + 8 * s, (step / stages) & 1);
      const unsigned char* wt = smem + s * S::stage;
#pragma unroll
      for (int kk = 0; kk < W_KK; ++kk) {
        const uint4 c0 = *reinterpret_cast<const uint4*>(wt + r0 * W_BK + ((kk ^ sw) << 4));
        const uint4 c1 = *reinterpret_cast<const uint4*>(wt + (r0 + 8) * W_BK + ((kk ^ sw) << 4));
        const uint32_t w0 = __byte_perm(t & 2 ? c0.y : c0.x, t & 2 ? c0.w : c0.z, sel);
        const uint32_t w1 = __byte_perm(t & 2 ? c1.y : c1.x, t & 2 ? c1.w : c1.z, sel);
        int8x4_to_bf16(w0, f[kk][0], f[kk][2]);
        int8x4_to_bf16(w1, f[kk][1], f[kk][3]);
      }
    };
    auto multiply = [&](int step, uint32_t(&f)[W_KK][4]) {
      const uint32_t xs = ring + (step % stages) * S::stage + S::w_bytes;
      pin(acc);
#pragma unroll
      for (int kk = 0; kk < W_KK; ++kk) pin(f[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_KK; ++kk)
        Wgmma<BT>::template rs<0>(acc, f[kk], sw128_desc(xs + (kk / 4) * S::x_box) + 2 * (kk % 4));
      wgmma_commit();
    };
    // the products done: the fragments' registers and the stage are free
    auto retire = [&](int step, uint32_t(&f)[W_KK][4]) {
      wgmma_wait<0>();
      pin(acc);
#pragma unroll
      for (int kk = 0; kk < W_KK; ++kk) pin(f[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * (step % stages));
    };
    // two fragment sets in turns: step + 1's fragment is converted while
    // step's products run
    uint32_t fa[W_KK][4], fb[W_KK][4];
    convert(0, fa);
    for (int step = 0; step < steps; step += 2) {
      multiply(step, fa);
      if (step + 1 < steps) convert(step + 1, fb);
      retire(step, fa);
      if (step + 1 < steps) {
        multiply(step + 1, fb);
        if (step + 2 < steps) convert(step + 2, fa);
        retire(step + 1, fb);
      }
    }
  }

  if (!split) {
    if (warp == PRODUCER) return;
    // the tile through shared memory (the ring is free once every consumer
    // warp's products are done), transposed: BT token rows of S::rows columns
    asm volatile("bar.sync 1, %0;\n" ::"n"(S::consumers) : "memory");
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int j = 0; j < BT / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          st[(j * 8 + t * 2 + e) * S::old + r0 + 8 * hh] =
              w16_out(acc[4 * j + 2 * hh + e], sc[hh], bs[hh], has_bias);
    asm volatile("bar.sync 1, %0;\n" ::"n"(S::consumers) : "memory");
    // 8-byte pieces of the token rows; N % 16 == 0, so a piece is whole
    const int cols = min(S::rows, N - n0);
    for (int i = tid; i < BT * (S::rows / 4); i += S::consumers) {
      const int c = i / (S::rows / 4), r = (i % (S::rows / 4)) * 4;
      if (m0 + c < M && r < cols)
        *reinterpret_cast<uint2*>(out + (long long)(m0 + c) * N + n0 + r) =
            *reinterpret_cast<const uint2*>(st + c * S::old + r);
    }
    return;
  }

  // K split: every rank has used its ring before any rank's slots (which
  // reuse the ring) are written; then the ranks' partial tiles are summed
  // in rank order and each owner writes its share
  cluster.sync();
  cluster_reduce<S::rows, BT, W_MAX_CLUSTER>(
      acc, warp < PRODUCER, 0, reinterpret_cast<float*>(smem),
      [&](int e, float4 sum) {
        const int r = e / BT, c = e % BT, n = n0 + r;
        if (n >= N) return;
        const float s = scale[n];
        const float b = has_bias ? __bfloat162float(__float2bfloat16(bias[n])) : 0.f;
        const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (m0 + c + i < M) out[(long long)(m0 + c + i) * N + n] = w16_out(v[i], s, b, has_bias);
      });
}

template <int BT>
int launch_w8a16(const void* x, long long x_rs, const void* q, const void* scale,
                 const void* bias, void* out, int M, int N, int K, int k_split,
                 cudaStream_t stream) {
  using S = W16Smem<BT>;
  const int w_tiles = (N + S::rows - 1) / S::rows;
  static bool attr_set = false;
  if (!attr_set) {  // the most any call of this tile takes
    const int most = S::bytes(S::max_stages, true);
    cudaError_t e = cudaFuncSetAttribute(qmm_w8a16_kernel<BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int steps = K / W_BK / k_split;
  const int stages = steps < S::max_stages ? steps : S::max_stages;
  CUtensorMap w_map, x_map;
  const cuuint64_t w_dims[2] = {(cuuint64_t)K, (cuuint64_t)N};
  const cuuint64_t w_strides[1] = {(cuuint64_t)K};
  const cuuint32_t w_box[2] = {W_BK, S::rows};
  const cuuint64_t x_dims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t x_strides[1] = {(cuuint64_t)x_rs * 2};
  const cuuint32_t x_box[2] = {64, BT};
  if (!encode(&w_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2, w_dims, w_strides, w_box,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_bf16(&x_map, x, 2, x_dims, x_strides, x_box))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(w_tiles * k_split, (M + BT - 1) / BT);
  cfg.blockDim = dim3(S::threads);
  cfg.dynamicSmemBytes = S::bytes(stages, k_split > 1);
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = k_split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = k_split > 1 ? 1 : 0;  // a grid without a cluster attribute: clusters of 1
  cudaError_t e = cudaLaunchKernelEx(&cfg, qmm_w8a16_kernel<BT>, w_map, x_map,
                                     static_cast<const float*>(scale),
                                     static_cast<const float*>(bias),
                                     static_cast<__nv_bfloat16*>(out), M, N, K, stages);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int launch_w8a16_tile(int token_tile, const void* x, long long x_rs, const void* q,
                      const void* scale, const void* bias, void* out, int M, int N, int K,
                      int k_split, cudaStream_t s) {
  switch (token_tile) {
    case 64:
      return launch_w8a16<64>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    case 128:
      return launch_w8a16<128>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    case 136:
      return launch_w8a16<136>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    case 224:
      return launch_w8a16<224>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: bf16 (M, K) with row stride x_rs (elements, a multiple of 8; 16-byte
// aligned); q: int8 (N, K) contiguous, 16-byte aligned; scale: f32 (N,);
// bias: f32 (N,) or null; out: bf16 (M, N) contiguous.  K a multiple of
// 128, N of 16.  The launch plan: n_tile (q rows, output columns, a block)
// 32, 64, 128 or 256; k_split (the cluster size) 1..8, at most K / 128.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int quant_matmul_w8a8(const void* x, long long x_rs, const void* q, const void* scale,
                                 const void* bias, void* out, int M, int N, int K, int n_tile,
                                 int k_split, void* stream) {
  if (K % 128 || N % 16 || M <= 0 || k_split < 1 || k_split > Q8_MAX_CLUSTER ||
      k_split > K / Q8_BK || x_rs % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_tile) {
    case 32:
      return launch_w8a8<32>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    case 64:
      return launch_w8a8<64>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    case 128:
      return launch_w8a8<128>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    case 256:
      return launch_w8a8<256>(x, x_rs, q, scale, bias, out, M, N, K, k_split, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The same arguments for w8a16, and its launch plan: token_tile (the
// product's N tile, tokens) 64, 128, 136 or 224; k_split (the cluster
// size) 1..8, dividing K / 128.  q 16-byte aligned.
extern "C" int quant_matmul_w8a16(const void* x, long long x_rs, const void* q, const void* scale,
                                  const void* bias, void* out, int M, int N, int K,
                                  int token_tile, int k_split, void* stream) {
  if (K % 128 || N % 16 || M <= 0 || k_split < 1 || k_split > W_MAX_CLUSTER ||
      (K / W_BK) % k_split || x_rs % 8 ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  return launch_w8a16_tile(token_tile, x, x_rs, q, scale, bias, out, M, N, K, k_split,
                           static_cast<cudaStream_t>(stream));
}
