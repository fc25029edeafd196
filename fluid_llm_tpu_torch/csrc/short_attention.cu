// Causal, key-valid attention for short sequences (L <= 1536), forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/short_attention.py:_kernel,
// launched by _call: one Pallas program per (batch*head, 128-query block)
// with the whole K/V of the head and the block's (128, L) f32 score matrix
// in VMEM, an exact softmax (row max, exp, row sum, divide), p cast to the
// value dtype, then P.V.  Only attn_impl="short" reaches it.
//
// Semantics (ops/short_attention.short_attention_ref):
//   allowed[i, j] = (j <= i && valid[j]) || j == i     (forced diagonal)
//   s[i, j] = (q_i . k_j) * scale  in f32
//   p[i, j] = bf16(exp(s - max_j s) / sum_j exp(s - max_j s))  over allowed j, else 0
//   out[i] = bf16(sum_j p[i, j] v_j)  (f32 sums)
// Rows of invalid queries keep their diagonal, so they stay finite; their
// outputs are not read by the model.
//
// Layout: q/k/v/out are (bs, L, H*hd) bf16 with a row stride per tensor,
// so the column slices of a fused qkv projection are read in place.
//
// What bounds it on an H100 (3.35 TB/s, 989 bf16 TFLOP/s): at the training
// step (bs 8, L 601, H 12, hd 64) the call moves ~29.5 MB of q/k/v/out for
// ~4.4 GFLOP of causal products: bytes bound (~9 us); at the rollout's
// (1, 661, 768) ~4 MB: ~1.2 us.  The TPU layout does not fit Hopper: a
// (128, L) f32 score tile is 338 KB at L 661 and 786 KB at L 1536,
// against 227 KB of shared memory a block.  The first port kept 16 query
// rows' scores in shared memory instead, so every 16-row tile streamed its
// head's K and V again (3 648 blocks at the training shape), through one
// buffer with no copy in flight during a product.
//
// Design (Hopper: TMA, mbarriers, wgmma):
// - A block takes 64 query rows of one (batch, head) per consumer
//   warpgroup (1 or 2: ops/short_attention.plan), so K and V are read
//   once for 64 or 128 rows; both warpgroups read the same K/V stages.
//   One more warp issues TMA tensor copies (2-D maps over (bs * L, H * hd)
//   with each tensor's row stride, 64 x 64 boxes in the 128-byte swizzle):
//   the block's q tile once, then 64-key tiles of K and V into a ring of 4
//   stages on mbarriers (a full and an empty barrier a stage), so copies
//   run ahead of the products.  Key tiles end at the block's last query:
//   the causal triangle beyond it is never read.
// - No score row is kept.  Two passes over the keys instead:
//   1. statistics: S = Q K^T by wgmma m64n64k16 (Q and K from shared
//      memory), masked, the row max m and the row sum l of exp(s - m)
//      kept in registers (l rescaled when m rises; the max is exact);
//   2. output: S recomputed for each key tile, p = bf16(exp(s - m) / l)
//      formed in registers (zero where the mask disallows) straight into
//      wgmma's A fragment, O += P V by wgmma with V from shared memory as
//      an MN-major B, f32 sums in registers, one bf16 store at the end.
//   That keeps the TPU kernel's rounding point (p normalised, then cast)
//   for the price of a second Q K^T (~2.2 GFLOP at the training shape).
// - Blocks of the last query tiles, which walk the most keys, start first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_tiles.cuh"
#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr int MAX_TOKENS = 1536;
constexpr int KT = 64;          // keys a tile
constexpr int QT = 64;          // query rows of a consumer warpgroup
constexpr int BOX = 64 * 64 * 2;  // one 64-row x 64-column bf16 box: 8 KB
constexpr int STAGES = 4;

// Shared memory from a 1024-byte aligned base: the q tiles of the block's
// warpgroups, the ring (a K tile and a V tile a stage), the keys'
// validity, then the mbarriers (q, and a full and an empty one a stage).
template <int HD, int WG>
struct ShortSmem {
  static constexpr int boxes = HD / 64;  // 64-column boxes of a row tile
  static constexpr int q = 0;
  static constexpr int ring = q + WG * boxes * BOX;
  static constexpr int kv = boxes * BOX;  // a K or a V tile
  static constexpr int stage = 2 * kv;
  static constexpr int valid = ring + STAGES * stage;
  static constexpr int bars = valid + 4 * MAX_TOKENS;
  static constexpr int bytes = bars + 8 * (1 + 2 * STAGES) + TILE_ALIGN;
};

template <int HD, int WG>
__global__ void __launch_bounds__(WG * 128 + 32)
short_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map, const int* __restrict__ valid,
                       __nv_bfloat16* __restrict__ out, int L, long long o_rs, float scale) {
  using S = ShortSmem<HD, WG>;
  constexpr int CONSUMERS = WG * 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = aligned_smem(smem_raw);
  const uint32_t base = smem_addr(smem);
  const uint32_t q_bar = base + S::bars, full = q_bar + 8, empty = full + 8 * STAGES;
  int* sval = reinterpret_cast<int*>(smem + S::valid);

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * QT * WG;  // the longest key walks first
  const int q_last = min(q0 + QT * WG, L) - 1;
  const int n_kt = q_last / KT + 1;  // key tiles up to the block's last query
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS / 32);  // each consumer warp's lane 0
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the copies
    if (lane == 0) {
      prefetch_map(&q_map);
      prefetch_map(&k_map);
      prefetch_map(&v_map);
      const int row0 = b * L, col0 = h * HD;
      mbar_expect(q_bar, WG * S::boxes * BOX);
      for (int w = 0; w < WG; ++w)
        for (int c = 0; c < S::boxes; ++c)
          tma_2d(base + S::q + (w * S::boxes + c) * BOX, &q_map, q_bar, col0 + 64 * c,
                 row0 + q0 + QT * w);
      // pass 1 reads the K tiles, pass 2 the K and V tiles again
      for (int item = 0; item < 2 * n_kt; ++item) {
        const int s = item % STAGES, round = item / STAGES, kt = item % n_kt;
        const bool with_v = item >= n_kt;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t dst = base + S::ring + s * S::stage, bar = full + 8 * s;
        mbar_expect(bar, with_v ? S::stage : S::kv);
        for (int c = 0; c < S::boxes; ++c) {
          tma_2d(dst + c * BOX, &k_map, bar, col0 + 64 * c, row0 + kt * KT);
          if (with_v) tma_2d(dst + S::kv + c * BOX, &v_map, bar, col0 + 64 * c, row0 + kt * KT);
        }
      }
    }
    return;
  }

  // the products: warpgroup wg takes query rows q0 + 64 wg ..
  for (int j = tid; j < n_kt * KT; j += CONSUMERS)
    sval[j] = j < L ? valid[(long long)b * L + j] : 0;
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
  const int wg = warp / 4, g = lane >> 2, t = lane & 3;
  const int wg_q0 = q0 + QT * wg;
  const int wg_kt = min(wg_q0 + QT - 1, L - 1) / KT;  // this warpgroup's last key tile
  const int i0 = wg_q0 + (warp % 4) * 16 + g;         // this thread's rows i0 and i0 + 8
  const float scale2 = scale * 1.4426950408889634f;   // exp(x) = exp2(x log2 e)
  const uint32_t q_tile = base + S::q + wg * S::boxes * BOX;
  mbar_wait(q_bar, 0);

  // S = Q K^T of the key tile in ring stage s
  float sc[32];
  auto scores = [&](int s) {
    const uint32_t k_tile = base + S::ring + s * S::stage;
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    pin(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      Wgmma<64>::ss(sc, sw128_desc(q_tile + (kk / 4) * BOX) + 2 * (kk % 4),
                    sw128_desc(k_tile + (kk / 4) * BOX) + 2 * (kk % 4));
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
  };
  // score i of the tile at key k0, scaled to the exp2 domain, or -inf where masked
  auto masked = [&](int i, int k0) {
    const int row = i0 + 8 * ((i >> 1) & 1), col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
    return attn::allowed(row, col, sval[col]) ? sc[i] * scale2 : -INFINITY;
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  };

  // 1. the row max m and the row sum l (this thread's part of it)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full + 8 * s, (kt / STAGES) & 1);
    if (kt <= wg_kt) {
      scores(s);
      float x[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) x[i] = masked(i, kt * KT);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == hh) mx = fmaxf(mx, x[i]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        if (mx == -INFINITY) continue;  // nothing allowed yet in this row
        float sum = m[hh] == -INFINITY ? 0.f : l[hh] * exp2f(m[hh] - mx);
#pragma unroll
        for (int i = 0; i < 32; ++i)
          if (((i >> 1) & 1) == hh) sum += exp2f(x[i] - mx);
        m[hh] = mx;
        l[hh] = sum;
      }
    }
    release(s);
  }
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    // a row past L may see no key of the block: p = 0 there, and never stored
    inv[hh] = l[hh] > 0.f ? 1.f / l[hh] : 0.f;
    if (m[hh] == -INFINITY) m[hh] = 0.f;
  }

  // 2. p = bf16(exp(s - m) / l), O += P V
  float o[S::boxes][32];
#pragma unroll
  for (int c = 0; c < S::boxes; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int item = n_kt + kt, s = item % STAGES;
    mbar_wait(full + 8 * s, (item / STAGES) & 1);
    if (kt <= wg_kt) {
      scores(s);
      // p's A fragments, k16 step kk: keys 16kk + 2t (+1), 16kk + 8 + 2t (+1)
      // of rows i0 and i0 + 8 are accumulators 8kk .. 8kk + 7
      uint32_t p[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, hh = r & 1;
          const float x0 = masked(i, kt * KT), x1 = masked(i + 1, kt * KT);
          const __nv_bfloat162 pr = __floats2bfloat162_rn(exp2f(x0 - m[hh]) * inv[hh],
                                                          exp2f(x1 - m[hh]) * inv[hh]);
          p[kk][r] = *reinterpret_cast<const uint32_t*>(&pr);
        }
      const uint32_t v_tile = base + S::ring + s * S::stage + S::kv;
#pragma unroll
      for (int c = 0; c < S::boxes; ++c) pin(o[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int c = 0; c < S::boxes; ++c)
          Wgmma<64>::rs<1>(o[c], p[kk], sw128_mn_desc(v_tile + c * BOX + kk * 2048));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int c = 0; c < S::boxes; ++c) pin(o[c]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) pin(p[kk]);
    }
    release(s);
  }

  // o[c][4j + 2hh + e] is row i0 + 8hh, column 64c + 8j + 2t + e
  __nv_bfloat16* ob = out + (long long)b * L * o_rs + h * HD;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = i0 + 8 * hh;
    if (row >= L) continue;
#pragma unroll
    for (int c = 0; c < S::boxes; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row * o_rs + 64 * c + 8 * j + 2 * t) =
            __floats2bfloat162_rn(o[c][4 * j + 2 * hh], o[c][4 * j + 2 * hh + 1]);
  }
}

template <int HD, int WG>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int bs, int L,
           int n_heads, long long q_rs, long long k_rs, long long v_rs, long long o_rs,
           float scale, cudaStream_t stream) {
  using S = ShortSmem<HD, WG>;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(short_attention_kernel<HD, WG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  // (bs * L rows, H * hd columns) with each tensor's row stride; 64 x 64 boxes
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const long long strides[3] = {q_rs, k_rs, v_rs};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)n_heads * HD, (cuuint64_t)bs * L};
    const cuuint64_t rs[1] = {(cuuint64_t)strides[i] * 2};
    const cuuint32_t box[2] = {64, 64};
    if (!encode_bf16(&maps[i], ptrs[i], 2, dims, rs, box)) return (int)cudaErrorInvalidValue;
  }
  dim3 grid(n_heads, bs, (L + QT * WG - 1) / (QT * WG));
  short_attention_kernel<HD, WG><<<grid, WG * 128 + 32, S::bytes, stream>>>(
      maps[0], maps[1], maps[2], static_cast<const int*>(valid),
      static_cast<__nv_bfloat16*>(out), L, o_rs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out: bf16 (bs, L, n_heads*head_dim) with row strides *_rs
// (elements, multiples of 8; pointers 16-byte aligned); valid: int32
// (bs, L).  1 <= L <= 1536; head_dim 64 or 128; q_rows (query rows a
// block: 64 or 128, ops/short_attention.plan).  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int bs, int L, int n_heads, int head_dim,
                                   long long q_rs, long long k_rs, long long v_rs, long long o_rs,
                                   float scale, int q_rows, void* stream) {
  if (L < 1 || L > MAX_TOKENS || bs < 1 || n_heads < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int key = head_dim * 1000 + q_rows;
  switch (key) {
    case 64064:
      return launch<64, 1>(q, k, v, valid, out, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    case 64128:
      return launch<64, 2>(q, k, v, valid, out, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    case 128064:
      return launch<128, 1>(q, k, v, valid, out, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    case 128128:
      return launch<128, 2>(q, k, v, valid, out, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
