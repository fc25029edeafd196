// Backward of the causal, key-valid attention: dq, and dk/dv, flash-2 style.
//
// Replaces the TPU kernels fluid_llm_tpu/ops/flash_attention.py:_dq_kernel
// and :_dkv_kernel, both launched by _flash_backward (Pallas, grid
// (batch*heads, q-blocks, k-blocks) with the sum carried in VMEM scratch
// across the sequential k/q grid axis).  The forward that writes lse is
// flash_attention_fwd in exact_attention.cu.
//
// Math (s_ij = scale * q_i.k_j; allowed = causal AND key-valid, diagonal
// always on; lse_i and delta_i = dO_i.O_i per query row):
//   p_ij  = allowed ? exp(s_ij - lse_i) : 0
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j     (keys up to the diagonal)
//   dk_j  = scale * sum_i ds_ij q_i     (queries from the diagonal down)
//   dv_j  =         sum_i p_ij dO_i
// p and ds are rounded to bf16 once each, as tensor-core operands; every
// sum is f32.  Invalid keys still get dk/dv from their own row: the forced
// diagonal.
//
// Layout: q/k/v/dO are (bs, L, H*hd) bf16 read in place through row strides
// (training hands q, k and v over as column slices of the projections);
// dq/dk/dv are written the same way; lse and delta are f32 (bs, H, L), so a
// tile's statistics are one contiguous run.  Rows and keys at or past L are
// masked out of p and never written.
//
// What bounds it on an H100: dq is three products per (query tile, key
// tile) pair, dk/dv four.  At the training geometry (bs 8, L 601, H 12,
// hd 64) that is ~6.7 and ~8.9 GFLOP (7 and 9 us at 989 TFLOP/s) over ~37
// and ~45 MB (11 and 13 us at 3.35 TB/s): bytes bound on paper.  In
// practice each 64-row tile step is a chain (copy, two products, the
// elementwise p/ds, one or two more products), so the time is the issue of
// that chain over ~5 300 tile steps a kernel and how well the blocks of
// one SM overlap their chains.
//
// Design (Hopper: TMA, mbarriers, wgmma; csrc/hopper.cuh):
// - Two kernels, one per TPU kernel, no atomics: dq, dk and dv are each
//   written once by one block, so every call repeats bit for bit.
// - dk/dv: a block takes 64 keys of one (batch, head), one consumer
//   warpgroup.  Its K and V tiles come once by TMA; a producer warp
//   streams Q and dO 64-row tiles from the causal frontier down, with the
//   tile's lse and delta, through a ring of two stages on full/empty
//   mbarriers.  Each step is four wgmma products and no score touches
//   shared memory:
//     S^T = K Q^T (A: K, B: Q, both K-major from shared memory) -> P^T in
//     registers (mask, exp2, bf16); dV += P^T dO (A: P^T from registers,
//     B: dO MN-major); dP^T = V dO^T (K-major) -> dS^T = P^T (dP^T - delta)
//     in registers; dK += dS^T Q (A: registers, B: Q MN-major).
//   The accumulator layout of a m64n64 product is the A fragment of the
//   next, so P and dS go from one product to the next without a store.
// - dq: a block takes 64 query rows, one consumer warpgroup; Q, dO, lse and
//   delta come once; K and V 64-key tiles (with the keys' validity as a
//   bit mask) stream up to the diagonal through the same kind of ring.
//   S = Q K^T and dP = dO V^T run together; dS in registers; dQ += dS K
//   (B: K MN-major).
// - Blocks of the longest causal walks start first (the last query tiles
//   for dq, the first key tiles for dk/dv), so the short walks fill the
//   tail.  The epilogue stages the bf16 result through the block's own (no
//   longer read) resident tiles and writes 16-byte rows.
// - Every product of a tile step is issued and waited for inside the step:
//   issuing the next tile's S and dP under this tile's last products puts
//   an in-flight product across the loop edge, and ptxas then serialises
//   every wgmma of the kernel (warning C7518), which cost more than the
//   overlap won.  The warpgroups of the SM's blocks (two an SM up to head
//   dim 64) overlap each other's chains instead.  The mask is bitwise
//   logic: a short-circuit one branches per element.
// - 64 rows a block and a ring of two are fixed: in a sweep at the
//   training geometry, 128-row blocks (two consumer warpgroups sharing each
//   streamed tile) lost by 3-30 % and rings of 3 and 4 stages moved the
//   time by no more than the spread between calls.
// - Head dim 32 reads 64-column boxes (the next head's columns, or zeros
//   past the last head) and contracts over its own 32 only; the extra
//   output columns are never written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;
using namespace hopper::tile64;

namespace {

constexpr int T = 64;      // rows of a tile: queries or keys
constexpr int STAGES = 2;  // depth of the ring of streamed tiles
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory from a 1024-byte aligned base: the block's two resident
// 64-row tiles, the ring (two streamed tiles a stage), `STAT_BYTES` a stage
// of per-row data, then the mbarriers (the resident tiles', and a full and
// an empty one a stage).
template <int HD, int STAT_BYTES>
struct Smem {
  static constexpr int tile = n_boxes<HD>() * BOX;
  static constexpr int a = 0;             // Q (dq) or K (dk/dv)
  static constexpr int b = a + tile;      // dO (dq) or V (dk/dv)
  static constexpr int ring = b + tile;
  static constexpr int stage = 2 * tile;  // K, V (dq) or Q, dO (dk/dv)
  static constexpr int stats = ring + STAGES * stage;
  static constexpr int bars = stats + STAGES * STAT_BYTES;
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + TILE_ALIGN;
};

// the calling thread is done with the ring stage `item` has (every consumer
// thread arrives: no branch while a product may be in flight)
__device__ __forceinline__ void release(uint32_t empty, int item) {
  mbar_arrive(empty + 8 * (item % STAGES));
}

// ---------------------------------------------------------------- dk/dv

// a stage's statistics: lse * log2(e) and delta of its 64 query rows
template <int HD>
using DkvSmem = Smem<HD, 2 * T * 4>;

template <int HD>
__global__ void __launch_bounds__(128 + 32, HD <= 64 ? 2 : 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ valid,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int L,
                 long long dk_rs, long long dv_rs, float scale) {
  using S = DkvSmem<HD>;
  constexpr int NB = n_boxes<HD>();
  constexpr int CONSUMERS = 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t kv_bar = base + S::bars, full = kv_bar + 8, empty = full + 8 * STAGES;
  float* const stats = reinterpret_cast<float*>(smem + S::stats);

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int k0 = blockIdx.z * T;  // the first key tiles walk the most queries: first
  const int qt0 = blockIdx.z;     // the first query tile that sees a key of the block
  const int n_items = (L + T - 1) / T - qt0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long bh = (long long)b * H + h;

  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);          // the copy warp's lanes, lane 0 with the bytes
      mbar_init(empty + 8 * s, CONSUMERS);  // every consumer thread
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the copies
    const int row0 = b * L, col0 = h * HD;
    if (lane == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      prefetch_map(&do_map);
      mbar_expect(kv_bar, 2 * S::tile);
      for (int c = 0; c < NB; ++c) {
        tma_2d(base + S::a + c * BOX, &k_map, kv_bar, col0 + 64 * c, row0 + k0);
        tma_2d(base + S::b + c * BOX, &v_map, kv_bar, col0 + 64 * c, row0 + k0);
      }
    }
    for (int item = 0; item < n_items; ++item) {
      const int s = item % STAGES, round = item / STAGES, q0 = (qt0 + item) * T;
      if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
      float* st = stats + s * 2 * T;
      for (int e = lane; e < T; e += 32) {
        const int i = q0 + e;
        st[e] = i < L ? lse[bh * L + i] * LOG2E : 0.f;
        st[T + e] = i < L ? delta[bh * L + i] : 0.f;
      }
      __syncwarp();
      const uint32_t bar = full + 8 * s;
      if (lane == 0) {
        const uint32_t dst = base + S::ring + s * S::stage;
        mbar_expect(bar, S::stage);
        for (int c = 0; c < NB; ++c) {
          tma_2d(dst + c * BOX, &q_map, bar, col0 + 64 * c, row0 + q0);
          tma_2d(dst + S::tile + c * BOX, &do_map, bar, col0 + 64 * c, row0 + q0);
        }
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  // the products: S^T, P^T, dP^T and dS^T have the block's keys as rows and
  // the stage's queries as columns
  const int g = lane >> 2, t = lane & 3;
  const int j0 = k0 + warp * 16 + g;  // this thread's keys j0 and j0 + 8
  int kvalid[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    kvalid[hh] = j0 + 8 * hh < L ? valid[(long long)b * L + j0 + 8 * hh] : 0;
  const float scale2 = scale * LOG2E;  // exp(x) = exp2(x log2 e)
  const uint32_t k_tile = base + S::a, v_tile = base + S::b;
  float dk_acc[NB][32], dv_acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[c][i] = dv_acc[c][i] = 0.f;
  mbar_wait(kv_bar, 0);

  for (int item = 0; item < n_items; ++item) {
    const int s = item % STAGES, q0 = (qt0 + item) * T;
    mbar_wait(full + 8 * s, (item / STAGES) & 1);
    const uint32_t q_tile = base + S::ring + s * S::stage, do_tile = q_tile + S::tile;
    const float* st = stats + s * 2 * T;
    float sc[32], dp[32];
    product_ss<HD>(sc, k_tile, q_tile);   // S^T = K Q^T
    product_ss<HD>(dp, v_tile, do_tile);  // dP^T = V dO^T
    wgmma_wait<1>();
    pin(sc);
    // sc[4jj + 2hh + e] is key j0 + 8hh, query q0 + 8jj + 2t + e
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * jj + 2 * t);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * jj + 2 * hh + e, qi = q0 + 8 * jj + 2 * t + e, kj = j0 + 8 * hh;
          // bitwise: no branch per element
          const bool ok = (qi < L) & (kj <= qi) & ((kvalid[hh] != 0) | (kj == qi));
          sc[i] = ok ? exp2f(fmaf(sc[i], scale2, -(e ? l2.y : l2.x))) : 0.f;
        }
    }
    // P^T's A fragments, k16 step kk (queries 16kk ..): accumulators 8kk .. 8kk + 7
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    product_rs<NB>(dv_acc, pa, do_tile);  // dV += P^T dO
    wgmma_wait<1>();                      // dP^T has landed (dV may still run)
    pin(dp);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 d0 = *reinterpret_cast<const float2*>(st + T + 16 * kk + 2 * t);
      const float2 d1 = *reinterpret_cast<const float2*>(st + T + 16 * kk + 8 + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float2 d = r < 2 ? d0 : d1;
        da[kk][r] = pack_bf16(sc[i] * (dp[i] - d.x), sc[i + 1] * (dp[i + 1] - d.y));
      }
    }
    product_rs<NB>(dk_acc, da, q_tile);  // dK += dS^T Q
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NB; ++c) {
      pin(dk_acc[c]);
      pin(dv_acc[c]);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pin(pa[kk]);
      pin(da[kk]);
    }
    release(empty, item);
  }

  const long long row0 = (long long)b * L;
  store_tile<HD>(dk_acc, scale, smem + S::a, dk + row0 * dk_rs + h * HD, dk_rs, k0, L);
  store_tile<HD>(dv_acc, 1.f, smem + S::b, dv + row0 * dv_rs + h * HD, dv_rs, k0, L);
}

// ------------------------------------------------------------------- dq

// a stage's key validity: 64 bits
template <int HD>
using DqSmem = Smem<HD, 8>;

template <int HD>
__global__ void __launch_bounds__(128 + 32, HD <= 64 ? 2 : 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap v_map,
                const __grid_constant__ CUtensorMap do_map, const float* __restrict__ lse,
                const float* __restrict__ delta, const int* __restrict__ valid,
                __nv_bfloat16* __restrict__ dq, int L, long long dq_rs, float scale) {
  using S = DqSmem<HD>;
  constexpr int NB = n_boxes<HD>();
  constexpr int CONSUMERS = 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t q_bar = base + S::bars, full = q_bar + 8, empty = full + 8 * STAGES;
  uint32_t* const masks = reinterpret_cast<uint32_t*>(smem + S::stats);

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T;  // the last queries walk the most keys: first
  const int n_kt = (min(q0 + T, L) - 1) / T + 1;    // key tiles up to the block's last query
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the copies
    const int row0 = b * L, col0 = h * HD;
    if (lane == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      prefetch_map(&do_map);
      mbar_expect(q_bar, 2 * S::tile);
      for (int c = 0; c < NB; ++c) {
        tma_2d(base + S::a + c * BOX, &q_map, q_bar, col0 + 64 * c, row0 + q0);
        tma_2d(base + S::b + c * BOX, &do_map, q_bar, col0 + 64 * c, row0 + q0);
      }
    }
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES, round = kt / STAGES, k0 = kt * T;
      if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
      const int j = k0 + lane;
      const uint32_t lo = __ballot_sync(0xffffffffu, j < L && valid[row0 + j] != 0);
      const uint32_t hi = __ballot_sync(0xffffffffu, j + 32 < L && valid[row0 + j + 32] != 0);
      const uint32_t bar = full + 8 * s;
      if (lane == 0) {
        masks[2 * s] = lo;
        masks[2 * s + 1] = hi;
        const uint32_t dst = base + S::ring + s * S::stage;
        mbar_expect(bar, S::stage);
        for (int c = 0; c < NB; ++c) {
          tma_2d(dst + c * BOX, &k_map, bar, col0 + 64 * c, row0 + k0);
          tma_2d(dst + S::tile + c * BOX, &v_map, bar, col0 + 64 * c, row0 + k0);
        }
      } else {
        mbar_arrive(bar);
      }
    }
    return;
  }

  // the products: the block's query rows as rows, the stage's keys as columns
  const int g = lane >> 2, t = lane & 3;
  const int i0 = q0 + warp * 16 + g;  // this thread's rows i0 and i0 + 8
  const long long bh = (long long)b * H + h;
  float lse2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = i0 + 8 * hh;
    lse2[hh] = i < L ? lse[bh * L + i] * LOG2E : 0.f;
    dl[hh] = i < L ? delta[bh * L + i] : 0.f;
  }
  const float scale2 = scale * LOG2E;
  const uint32_t q_tile = base + S::a, do_tile = base + S::b;
  float acc[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES, k0 = kt * T;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t k_tile = base + S::ring + s * S::stage, v_tile = k_tile + S::tile;
    float sc[32], dp[32];
    product_ss<HD>(sc, q_tile, k_tile);   // S = Q K^T
    product_ss<HD>(dp, do_tile, v_tile);  // dP = dO V^T
    const uint32_t lo = masks[2 * s], hi = masks[2 * s + 1];
    wgmma_wait<1>();
    pin(sc);
    // sc[4jj + 2hh + e] is row i0 + 8hh, key k0 + 8jj + 2t + e
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * t + (i & 1);
      const bool bit = (((i >> 2) < 4 ? lo : hi) >> (c & 31)) & 1u;
      const int row = i0 + 8 * hh, col = k0 + c;
      // bitwise: no branch per element; rows past L are computed, never
      // written, and touch no other row
      const bool ok = (row < L) & (col <= row) & (bit | (col == row));
      sc[i] = ok ? exp2f(fmaf(sc[i], scale2, -lse2[hh])) : 0.f;
    }
    wgmma_wait<0>();
    pin(dp);
    // dS's A fragments, k16 step kk (keys 16kk ..): accumulators 8kk .. 8kk + 7
    uint32_t da[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r;
        const float d = dl[r & 1];
        da[kk][r] = pack_bf16(sc[i] * (dp[i] - d), sc[i + 1] * (dp[i + 1] - d));
      }
    product_rs<NB>(acc, da, k_tile);  // dQ += dS K
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NB; ++c) pin(acc[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(da[kk]);
    release(empty, kt);
  }

  store_tile<HD>(acc, scale, smem + S::a, dq + (long long)b * L * dq_rs + h * HD, dq_rs, q0, L);
}

// ----------------------------------------------------------------- launch

template <int HD>
int launch_dq(const CUtensorMap (&maps)[4], const void* lse, const void* delta, const void* valid,
              void* dq, int bs, int L, int n_heads, long long dq_rs, float scale,
              cudaStream_t stream) {
  using S = DqSmem<HD>;
  static bool attr_set = false;
  if (int e = allow_smem(flash_dq_kernel<HD>, S::bytes, attr_set)) return e;
  dim3 grid(n_heads, bs, (L + T - 1) / T);
  flash_dq_kernel<HD><<<grid, 128 + 32, S::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(valid),
      static_cast<__nv_bfloat16*>(dq), L, dq_rs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const CUtensorMap (&maps)[4], const void* lse, const void* delta,
               const void* valid, void* dk, void* dv, int bs, int L, int n_heads,
               long long dk_rs, long long dv_rs, float scale, cudaStream_t stream) {
  using S = DkvSmem<HD>;
  static bool attr_set = false;
  if (int e = allow_smem(flash_dkv_kernel<HD>, S::bytes, attr_set)) return e;
  dim3 grid(n_heads, bs, (L + T - 1) / T);
  flash_dkv_kernel<HD><<<grid, 128 + 32, S::bytes, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(valid),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), L, dk_rs, dv_rs, scale);
  return (int)cudaGetLastError();
}

bool shape_ok(int bs, int L, int n_heads) { return bs >= 1 && L >= 1 && n_heads >= 1; }

}  // namespace

// q/k/v/dout/dq: bf16 (bs, L, n_heads*head_dim), head_dim 32, 64 or 128,
// with row strides *_rs (elements, multiples of 8; pointers 16-byte
// aligned); lse and delta: f32 (bs, n_heads, L); valid: int32 (bs, L).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* valid,
                                  void* dq, int bs, int L, int n_heads, int head_dim,
                                  long long q_rs, long long k_rs, long long v_rs,
                                  long long do_rs, long long dq_rs, float scale, void* stream) {
  if (!shape_ok(bs, L, n_heads)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* const ptrs[4] = {q, k, v, dout};
  const long long strides[4] = {q_rs, k_rs, v_rs, do_rs};
  if (!encode_row_maps(maps, ptrs, strides, bs, L, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dq<32>(maps, lse, delta, valid, dq, bs, L, n_heads, dq_rs, scale, s);
    case 64:
      return launch_dq<64>(maps, lse, delta, valid, dq, bs, L, n_heads, dq_rs, scale, s);
    case 128:
      return launch_dq<128>(maps, lse, delta, valid, dq, bs, L, n_heads, dq_rs, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As flash_attention_dq, writing dk and dv (bf16, row strides dk_rs, dv_rs).
extern "C" int flash_attention_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, const void* valid,
                                   void* dk, void* dv, int bs, int L, int n_heads, int head_dim,
                                   long long q_rs, long long k_rs, long long v_rs,
                                   long long do_rs, long long dk_rs, long long dv_rs,
                                   float scale, void* stream) {
  if (!shape_ok(bs, L, n_heads)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* const ptrs[4] = {q, k, v, dout};
  const long long strides[4] = {q_rs, k_rs, v_rs, do_rs};
  if (!encode_row_maps(maps, ptrs, strides, bs, L, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dkv<32>(maps, lse, delta, valid, dk, dv, bs, L, n_heads, dk_rs, dv_rs, scale,
                            s);
    case 64:
      return launch_dkv<64>(maps, lse, delta, valid, dk, dv, bs, L, n_heads, dk_rs, dv_rs, scale,
                            s);
    case 128:
      return launch_dkv<128>(maps, lse, delta, valid, dk, dv, bs, L, n_heads, dk_rs, dv_rs, scale,
                             s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
