// Causal, key-valid multi-head attention over PACKED q/k/v, forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/exact_attention.py:_kernel
// (Pallas, one program per (batch, 128-lane head group), whole-L VMEM tiles)
// through exact_attention_fwd, and the training forward
// fluid_llm_tpu/ops/flash_attention.py:_fwd_kernel through
// flash_attention_fwd: the same kernel, which then also writes each row's
// logsumexp lse[b, h, i] = m_i + log(l_i) (natural log, f32, (bs, H, L))
// for the backward kernels in flash_attention.cu.  The mask of both TPU
// kernels is the same (flash_attention.py:_mask == backbone.make_masks).
//
// Semantics (backbone.make_masks, exactly):
//   allowed[i, j] = (j <= i && valid[j]) || j == i     (forced diagonal)
//   out[i] = sum_j softmax_j(q_i . k_j * scale | allowed) v_j
// Rounding: the scores, the running max m and sum l are f32; the
// UNNORMALISED p = exp(s - m) is rounded to bf16 as the PV product's A
// operand, l is summed in f32 from the unrounded p, and the f32 sum of PV
// is divided by l once at the end, then rounded to bf16.  Neither TPU
// kernel rounds there: the Pallas exact kernel casts the normalised p
// (exact_attention.py:75-80), the Pallas flash forward runs PV in f32.  A
// bf16 p carries a relative error of at most 2^-9 per element, whichever
// of the two it is rounded from, so the output's relative L2 error against
// the plain twins (which round the normalised p) stays a few 1e-3, inside
// the stated 1e-2; lse does not see the rounding at all.
//
// Layout: q/k/v/out are (bs, L, H*hd) bf16 with a row stride per tensor, so
// the three column slices of one fused qkv projection are read in place:
// element (b, t, h, d) sits at (b*L + t)*row_stride + h*hd + d.  No
// transpose to (bs, H, L, hd) is ever made.
//
// What bounds it on an H100: at the rollout geometry (L 661, H 12, hd 64,
// bs 1) the causal layer is ~2 x 2 x 12 x 661^2 / 2 x 64 ~= 0.67 GFLOP over
// ~3 MB (0.7 us of tensor-core work, 1.2 us of bytes), at the training
// step's (bs 8, L 601) ~4.4 GFLOP over ~30 MB (9 us of bytes): both far
// below what a launch and one block's chain of tile steps take.  So the
// time is the chain of 64-key tile steps a block walks (up to 11 at the
// rollout, one block an SM) and, at the training shape, how well the SM's
// blocks overlap their chains (960 blocks, ~5 300 tile steps).
//
// Design (Hopper: TMA, mbarriers, wgmma; csrc/hopper.cuh), after the dq
// kernel of flash_attention.cu:
// - A block takes 64 query rows of one (batch, head): one consumer
//   warpgroup and one producer warp.  The producer copies the block's Q
//   tile once, then streams 64-key K and V tiles from key 0 up to the
//   block's last query row by TMA (2-D maps over (bs * L, H * hd) with each
//   tensor's row stride, 64 x 64 boxes in the 128-byte swizzle) through a
//   ring of two stages on full/empty mbarriers, with each key tile's
//   validity as a 64-bit mask beside the copy.  Key tiles past the
//   diagonal are never read.
// - Each key tile step is all in registers: S = Q K^T by wgmma (m64n64,
//   both operands K-major from shared memory); the mask in bitwise logic
//   (a short-circuit mask branches per element); the row max across the
//   four threads of a row by two shuffles; O and l rescaled in registers;
//   p = exp2(s - m) (scores pre-multiplied by scale * log2 e) rounded to
//   bf16 straight into the A fragment of O += P V, a wgmma with V as an
//   MN-major B.  No score, probability or accumulator touches shared
//   memory.  The quad's partial row sums are joined once, at the end.
// - The step's two products are issued and waited for one after the other
//   (an in-flight product across the loop edge makes ptxas serialise every
//   wgmma of the kernel, warning C7518); the SM's blocks overlap each
//   other's chains.  Issuing the next tile's Q K^T before this tile's P V
//   and running its softmax under P V, within the step, measured 0-25 %
//   slower on an H100 80GB HBM3 (700 W) at every shape tried, the rollout's
//   one block an SM included.
// - Blocks of the last query tiles, which walk the most keys, start first.
//   The epilogue divides by l, stages the bf16 rows through the block's Q
//   tile (no longer read) and writes 16-byte rows, none at or past L.
// - Head dim 32 reads 64-column boxes (the next head's columns, or zeros
//   past the last head) and contracts over its own 32 only; the extra
//   output columns are never written.
// - No atomics: every output element is written once by one block, so
//   every call repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace hopper;
using namespace hopper::tile64;

namespace {

constexpr int T = 64;      // rows of a tile: queries or keys
constexpr int STAGES = 2;  // depth of the ring of streamed K/V tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory from a 1024-byte aligned base: the Q tile, the ring (a K
// and a V tile a stage), a stage's 64-bit key mask, then the mbarriers
// (Q's, and a full and an empty one a stage).
template <int HD>
struct ExactSmem {
  static constexpr int tile = n_boxes<HD>() * BOX;
  static constexpr int q = 0;
  static constexpr int ring = q + tile;
  static constexpr int stage = 2 * tile;
  static constexpr int masks = ring + STAGES * stage;
  static constexpr int bars = masks + 8 * STAGES;
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + TILE_ALIGN;
};

// One key tile's online softmax on the scores sc (64 x 64, m64n64 layout:
// sc[4jj + 2hh + e] is row i0 + 8hh, key k0 + 8jj + 2t + e): masked, in the
// exp2 domain; m, l (this thread's part) and the rescale alpha of each of
// the thread's two rows updated; sc becomes the unrounded p.  A row that
// has seen no allowed key yet keeps m = -inf, p = 0 and l = 0 (exp2 is
// never taken of -inf - -inf).
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int i0, int k0, int t,
                                             uint32_t lo, uint32_t hi, float scale2) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1, c = 8 * (i >> 2) + 2 * t + (i & 1);
    const bool bit = (((i >> 2) < 4 ? lo : hi) >> (c & 31)) & 1u;
    const int row = i0 + 8 * hh, col = k0 + c;
    // bitwise: no branch per element; rows past L are computed (their
    // diagonal keeps them finite), never written, and touch no other row
    const bool ok = (col <= row) & (bit | (col == row));
    sc[i] = ok ? sc[i] * scale2 : -INFINITY;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
  float mu[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    mu[hh] = mx[hh] == -INFINITY ? 0.f : mx[hh];
    alpha[hh] = exp2f(m[hh] - mu[hh]);
    m[hh] = mx[hh];
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = exp2f(sc[i] - mu[(i >> 1) & 1]);
    ps[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
}

template <int NB>
__device__ __forceinline__ void rescale(float (&o)[NB][32], const float (&alpha)[2]) {
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] *= alpha[(i >> 1) & 1];
}

// p's A fragments, k16 step kk (keys 16kk ..): accumulators 8kk .. 8kk + 7
__device__ __forceinline__ void pack_p(uint32_t (&pa)[4][4], const float (&sc)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
}

template <int HD>
__global__ void __launch_bounds__(128 + 32, HD <= 64 ? 3 : 2)
exact_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const int* __restrict__ valid,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L,
                       long long o_rs, float scale) {
  using S = ExactSmem<HD>;
  constexpr int NB = n_boxes<HD>();
  constexpr int CONSUMERS = 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t q_bar = base + S::bars, full = q_bar + 8, empty = full + 8 * STAGES;
  uint32_t* const masks = reinterpret_cast<uint32_t*>(smem + S::masks);

  const int h = blockIdx.x, b = blockIdx.y, H = gridDim.x;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T;  // the last queries walk the most keys: first
  const int n_kt = (min(q0 + T, L) - 1) / T + 1;    // key tiles up to the block's last query
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_bar, 1);
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
      mbar_expect(q_bar, S::tile);
      for (int c = 0; c < NB; ++c)
        tma_2d(base + S::q + c * BOX, &q_map, q_bar, col0 + 64 * c, row0 + q0);
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
  const float scale2 = scale * LOG2E;  // exp(x) = exp2(x log2 e)
  const uint32_t q_tile = base + S::q;
  float o[NB][32];
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
  float sc[32];
  uint32_t pa[4][4];
  mbar_wait(q_bar, 0);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    const uint32_t k_tile = base + S::ring + s * S::stage;
    product_ss<HD>(sc, q_tile, k_tile);  // S = Q K^T
    const uint32_t lo = masks[2 * s], hi = masks[2 * s + 1];
    wgmma_wait<0>();
    pin(sc);
    softmax_tile(sc, m, l, alpha, i0, kt * T, t, lo, hi, scale2);
    rescale<NB>(o, alpha);
    pack_p(pa, sc);
    product_rs<NB>(o, pa, k_tile + S::tile);  // O += P V
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < NB; ++c) pin(o[c]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) pin(pa[kk]);
    mbar_arrive(empty + 8 * s);  // every consumer thread: the stage may be refilled
  }

  // every row has its diagonal, so l > 0
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = 1.f / l[hh];
  }
  if (lse != nullptr && t == 0) {
    const long long bh = (long long)b * H + h;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (i0 + 8 * hh < L) lse[bh * L + i0 + 8 * hh] = m[hh] * LN2 + logf(l[hh]);
  }
  rescale<NB>(o, inv);
  store_tile<HD>(o, 1.f, smem + S::q, out + (long long)b * L * o_rs + h * HD, o_rs, q0, L);
}

template <int HD>
int launch(const CUtensorMap (&maps)[3], const void* valid, void* out, void* lse, int bs, int L,
           int n_heads, long long o_rs, float scale, cudaStream_t stream) {
  using S = ExactSmem<HD>;
  static bool attr_set = false;
  if (int e = allow_smem(exact_attention_kernel<HD>, S::bytes, attr_set)) return e;
  dim3 grid(n_heads, bs, (L + T - 1) / T);
  exact_attention_kernel<HD><<<grid, 128 + 32, S::bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const int*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), L, o_rs, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* valid, void* out, void* lse,
             int bs, int L, int n_heads, int head_dim, long long q_rs, long long k_rs,
             long long v_rs, long long o_rs, float scale, void* stream) {
  if (bs < 1 || L < 1 || n_heads < 1) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* const ptrs[3] = {q, k, v};
  const long long strides[3] = {q_rs, k_rs, v_rs};
  if (!encode_row_maps(maps, ptrs, strides, bs, L, n_heads, head_dim))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(maps, valid, out, lse, bs, L, n_heads, o_rs, scale, s);
    case 64:
      return launch<64>(maps, valid, out, lse, bs, L, n_heads, o_rs, scale, s);
    case 128:
      return launch<128>(maps, valid, out, lse, bs, L, n_heads, o_rs, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out: bf16 (bs, L, n_heads*head_dim), head_dim 32, 64 or 128, with
// row strides *_rs (elements, multiples of 8; pointers 16-byte aligned);
// valid: int32 (bs, L).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int exact_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int bs, int L, int n_heads, int head_dim,
                                   long long q_rs, long long k_rs, long long v_rs,
                                   long long o_rs, float scale, void* stream) {
  return dispatch(q, k, v, valid, out, nullptr, bs, L, n_heads, head_dim, q_rs, k_rs, v_rs, o_rs,
                  scale, stream);
}

// As exact_attention_fwd, and also writes lse: f32 (bs, n_heads, L), each
// row's logsumexp of its scaled, masked scores (natural log).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, void* lse, int bs, int L, int n_heads,
                                   int head_dim, long long q_rs, long long k_rs, long long v_rs,
                                   long long o_rs, float scale, void* stream) {
  return dispatch(q, k, v, valid, out, lse, bs, L, n_heads, head_dim, q_rs, k_rs, v_rs, o_rs,
                  scale, stream);
}
