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
// reach either, so its launch and the latency of its K loop bound it.
// Design: a block computes a BM 64 x BN output tile with mma.sync m16n8k32
// s8 on tiles staged in shared memory, rows padded by 16 bytes so the
// fragment loads hit 32 distinct banks.  BN is 16 where one row tile
// covers M (the decode: N 768 gives 48 blocks for 132 SMs, where 64 would
// give 12) and 64 where 64 still gives at least one block per SM (the
// 661-row rollout: a quarter of the activation tile's re-reads and of its
// quantisation; on an H100 there 64 took 0.3-0.4x the time of 16).  It
// first takes each row's absmax over all K (the activations are a few
// hundred KB and sit in L2), then quantises the activation tile on its way
// into shared memory and applies both scales in the epilogue: one launch
// per linear, where the TPU path took three (quantise, kernel, rescale) on
// a step that is already launch bound.  A tile is 256 bytes deep, all its
// 16-byte loads are issued before any is used, and the absmax pass keeps a
// warp's rows' loads in flight together.  Every block quantises the whole
// activation tile of its rows, so blocks have 16 warps: all quantise, the
// first 4 multiply.
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

constexpr int BM = 64;        // w8a8: rows of a block tile, 4 mma warps x 16
constexpr int THREADS8 = 512;  // w8a8: 16 warps quantise, the first 4 multiply
constexpr int SMS = 132;      // H100 SXM
constexpr int BK8 = 256;      // w8a8 K step: 8 x k32
constexpr int LD8 = BK8 + 16;   // bytes per shared row (68 words: conflict-free)
constexpr int A_LOADS8 = BM * BK8 / 8 / THREADS8;   // 16-byte loads per thread

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes at p if ok, else zeros (rows past M, K past its end contract to 0)
__device__ __forceinline__ uint4 ld128(const void* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// round(q) half to even, clipped to [-127, 127], as the low byte of an
// int: adding 1.5 * 2^23 rounds q to an integer in the low mantissa bits
// (|q| < 2^22), one add in place of rint and a float-to-int conversion
__device__ __forceinline__ uint32_t int8_byte(float q) {
  const int r = __float_as_int(__fadd_rn(q, 12582912.f)) - 0x4B400000;
  return static_cast<uint32_t>(max(-127, min(127, r))) & 0xffu;
}

// 8 bf16 (16 bytes) quantised with the row's scale s: round(v / s) with
// the quotient of the IEEE division, packed into 8 bytes.  ``exact``
// divides; otherwise v * inv (inv = 1/s rounded) stands in for the
// quotient: within 2e-5 of it for |v / s| <= 127, so it rounds to the same
// integer unless it lies within 1e-4 of a half, which sets ``tie``.  The
// fast form has no branch, so the unrolled tile load keeps its
// instruction-level parallelism; the caller redoes a chunk with ``exact``
// only where ``tie`` was set.
__device__ __forceinline__ uint2 quant8(const uint4& v, float s, float inv, bool exact,
                                        bool& tie) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    float y0, y1;
    if (exact) {
      y0 = __fdiv_rn(f.x, s);
      y1 = __fdiv_rn(f.y, s);
    } else {
      y0 = __fmul_rn(f.x, inv);
      y1 = __fmul_rn(f.y, inv);
      tie |= (fabsf(y0 - floorf(y0) - 0.5f) < 1e-4f) | (fabsf(y1 - floorf(y1) - 0.5f) < 1e-4f);
    }
    w[j / 2] |= (int8_byte(y0) << (16 * (j % 2))) | (int8_byte(y1) << (16 * (j % 2) + 8));
  }
  return make_uint2(w[0], w[1]);
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

template <int BN>
__global__ void __launch_bounds__(THREADS8)
qmm_w8a8_kernel(const __nv_bfloat16* __restrict__ x, long long x_rs,
                const int8_t* __restrict__ q, const float* __restrict__ scale,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N,
                int K) {
  constexpr int NT = BN / 8;  // n8 tiles of each mma warp
  constexpr int B_LOADS = (BN * BK8 / 16 + THREADS8 - 1) / THREADS8;
  constexpr int ROWS = BM / (THREADS8 / 32);  // absmax rows of each warp
  __shared__ __align__(16) int8_t sa[BM * LD8];
  __shared__ __align__(16) int8_t sb[BN * LD8];
  __shared__ float ssx[BM], sinv[BM];  // each row's scale and its reciprocal

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // each row's activation scale: absmax over all of K, a warp's rows'
  // loads in flight together
  {
    float amax[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) amax[i] = 0.f;
    const int r0 = m0 + warp * ROWS;
    for (int k = lane * 8; k < K; k += 32 * 8) {
      uint4 v[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) v[i] = ld128(x + (long long)(r0 + i) * x_rs + k, r0 + i < M);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          amax[i] = fmaxf(amax[i], fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float a = amax[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      if (lane == 0) {
        const float sx = a > 0.f ? __fdiv_rn(a, 127.f) : 1.f;
        ssx[warp * ROWS + i] = sx;
        sinv[warp * ROWS + i] = __frcp_rn(sx);
      }
    }
  }
  __syncthreads();

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK8) {
    // every global load of the tile first (16-byte vectors), then the
    // stores: the activation quantised (8 bf16 in, 8 int8 out)
    uint4 va[A_LOADS8], vb[B_LOADS];
#pragma unroll
    for (int i = 0; i < A_LOADS8; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 8), kc = (c % (BK8 / 8)) * 8;
      va[i] = ld128(x + (long long)(m0 + r) * x_rs + k0 + kc, m0 + r < M && k0 + kc < K);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 16), kc = (c % (BK8 / 16)) * 16;
      if (c < BN * BK8 / 16)
        vb[i] = ld128(q + (long long)(n0 + r) * K + k0 + kc, k0 + kc < K);
    }
    bool tie = false;
#pragma unroll
    for (int i = 0; i < A_LOADS8; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 8), kc = (c % (BK8 / 8)) * 8;
      *reinterpret_cast<uint2*>(sa + r * LD8 + kc) = quant8(va[i], ssx[r], sinv[r], false, tie);
    }
    if (tie) {  // rare: this thread's chunks again, dividing
      for (int i = 0; i < A_LOADS8; ++i) {
        const int c = tid + i * THREADS8, r = c / (BK8 / 8), kc = (c % (BK8 / 8)) * 8;
        *reinterpret_cast<uint2*>(sa + r * LD8 + kc) = quant8(va[i], ssx[r], sinv[r], true, tie);
      }
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 16), kc = (c % (BK8 / 16)) * 16;
      if (c < BN * BK8 / 16) *reinterpret_cast<uint4*>(sb + r * LD8 + kc) = vb[i];
    }
    __syncthreads();
    if (warp < BM / 16) {
#pragma unroll
      for (int kk = 0; kk < BK8; kk += 32) {
        const int8_t* ar = sa + (warp * 16 + g) * LD8 + kk + t * 4;
        const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * LD8), ld32(ar + 16),
                               ld32(ar + 8 * LD8 + 16)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* br = sb + (j * 8 + g) * LD8 + kk + t * 4;
          const uint32_t b[2] = {ld32(br), ld32(br + 16)};
          mma_s8(acc[j], a, b);
        }
      }
    }
    __syncthreads();
  }
  if (warp >= BM / 16) return;

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + t * 2;
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + hh * 8;
      if (m0 + r >= M) continue;
      const float sx = ssx[r];
      const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * hh]), sx), s0);
      const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * hh + 1]), sx), s1);
      store_pair(out + (long long)(m0 + r) * N + n, bias, n, y0, y1);
    }
  }
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

// BN 64 where that still gives one block per SM, else 16 (see the header)
bool wide(int M, int N) {
  const int m_tiles = (M + BM - 1) / BM;
  return N % 64 == 0 && m_tiles * (N / 64) >= SMS;
}

template <typename Kernel>
int launch(Kernel kernel, int bn, int threads, const void* x, long long x_rs, const void* q,
           const void* scale, const void* bias, void* out, int M, int N, int K,
           cudaStream_t stream) {
  dim3 grid(N / bn, (M + BM - 1) / BM);
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_rs, static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 (M, K) with row stride x_rs (elements, a multiple of 8; 16-byte
// aligned); q: int8 (N, K) contiguous; scale: f32 (N,); bias: f32 (N,) or
// null; out: bf16 (M, N) contiguous.  K a multiple of 128, N of 16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int quant_matmul_w8a8(const void* x, long long x_rs, const void* q, const void* scale,
                                 const void* bias, void* out, int M, int N, int K, void* stream) {
  if (K % 128 || N % 16 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(M, N))
    return launch(qmm_w8a8_kernel<64>, 64, THREADS8, x, x_rs, q, scale, bias, out, M, N, K, s);
  return launch(qmm_w8a8_kernel<16>, 16, THREADS8, x, x_rs, q, scale, bias, out, M, N, K, s);
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
