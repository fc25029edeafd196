// Causal, key-valid attention for short sequences (L <= 1536), forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/short_attention.py:_kernel,
// launched by _call: one Pallas program per (batch*head, 128-query block)
// with the whole K/V of the head and the block's (128, L) f32 score matrix
// in VMEM, an exact softmax (row max, exp, row sum, divide), p cast to the
// value dtype, then P.V.  Only attn_impl="short" reaches it.
//
// Semantics (ops/short_attention.short_attention_ref, exactly):
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
// (1, 661, 768) ~4 MB: ~1.2 us.  Neither is reachable by this design,
// which re-reads K/V from L2 for every query tile.
//
// Design.  The TPU layout does not fit Hopper: a (128, L) f32 score tile is
// 338 KB at L 661 and 786 KB at L 1536, against 227 KB of shared memory a
// block, and K and V alone are 393 KB at L 1536.  So a block takes 16
// query rows of one (batch, head) and keeps only their f32 score rows in
// shared memory (16 x 1544 x 4 = 99 KB at L 1536), streaming K and V
// through one 64-key tile:
//   1. S = Q K^T on the tensor cores (WMMA bf16, f32 accumulation), key
//      tiles only up to the block's last query (the causal triangle beyond
//      is skipped, not computed), each of the 4 warps 16 of a tile's keys;
//   2. the exact softmax of each row by one warp in f32: max, sum, then
//      p = exp(s - max) / sum rounded to bf16 and written in place over
//      the row's own f32 scores (a bf16 entry j overlays f32 entry j/2,
//      which the warp has read by then), zeros past the diagonal;
//   3. O = P V on the tensor cores, V streamed through the same tile, each
//      warp 16 (hd 64) or 32 (hd 128) output columns, then one bf16 store.
// That is the TPU kernel's order (max, exp, divide, cast, P.V), not the
// online softmax of the exact-window kernel.  Blocks start with the last
// query tiles, which walk the most keys.  No wgmma, TMA or K/V reuse
// across query tiles yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "attention_tiles.cuh"

using namespace nvcuda;
using namespace attn;

namespace {

constexpr int SQ = 16;              // query rows per block
constexpr int ROWS = SQ / WARPS;    // softmax rows of each warp
constexpr int MAX_TOKENS = 1536;

// round128 for sizes known only at run time, on the host and the device
__host__ __device__ constexpr size_t pad128(size_t n) { return (n + 127) / 128 * 128; }

// Shared memory: the q tile, one K/V tile, the f32 output tile, the keys'
// validity, then 16 f32 score rows of kmax + 8 (p overlays them as bf16).
template <int HD>
struct ShortLayout {
  static constexpr int QLD = qld<HD>();
  static constexpr int OLD = HD + 4;
  static constexpr size_t q = 0;
  static constexpr size_t kv = q + round128(sizeof(__nv_bfloat16) * SQ * QLD);
  static constexpr size_t o = kv + round128(sizeof(__nv_bfloat16) * BK * QLD);
  static constexpr size_t valid = o + round128(sizeof(float) * SQ * OLD);
  __host__ __device__ static size_t s(int kmax) { return valid + pad128(sizeof(int) * kmax); }
  __host__ __device__ static size_t bytes(int kmax) {
    return s(kmax) + pad128(sizeof(float) * SQ * (kmax + 8));
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
short_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                       __nv_bfloat16* __restrict__ out, int L, long long q_rs, long long k_rs,
                       long long v_rs, long long o_rs, float scale) {
  using Lay = ShortLayout<HD>;
  constexpr int QLD = Lay::QLD;
  constexpr int OLD = Lay::OLD;
  constexpr int NF = HD / 16 / WARPS;  // output column fragments of each warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int kmax = (L + BK - 1) / BK * BK;
  const int SLD = kmax + 8;  // f32 score row stride; p rows are 2 * SLD bf16
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + Lay::q);
  __nv_bfloat16* skv = reinterpret_cast<__nv_bfloat16*>(smem + Lay::kv);
  float* so = reinterpret_cast<float*>(smem + Lay::o);
  int* sval = reinterpret_cast<int*>(smem + Lay::valid);
  float* ss = reinterpret_cast<float*>(smem + Lay::s(kmax));
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(ss);

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest key walks first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * SQ;
  const int n_keys = min((q0 + SQ + BK - 1) / BK * BK, kmax);  // key tiles up to the last query

  const __nv_bfloat16* qb = q + (long long)b * L * q_rs + h * HD;
  const __nv_bfloat16* kb = k + (long long)b * L * k_rs + h * HD;
  const __nv_bfloat16* vb = v + (long long)b * L * v_rs + h * HD;
  const int* validb = valid + (long long)b * L;

  for (int c = tid; c < SQ * HD / 8; c += THREADS) {
    const int r = c / (HD / 8), cc = (c % (HD / 8)) * 8, t = q0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < L) val = *reinterpret_cast<const uint4*>(qb + (long long)t * q_rs + cc);
    *reinterpret_cast<uint4*>(sq + r * QLD + cc) = val;
  }
  for (int j = tid; j < n_keys; j += THREADS) sval[j] = j < L ? validb[j] : 0;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) wmma::load_matrix_sync(qf[kk], sq + kk * 16, QLD);

  // 1. raw scores Q K^T; warp w takes keys w*16.. of each tile
  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    load_tile<HD>(skv, kb, k_rs, k0, L);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, skv + warp * 16 * QLD + kk * 16, QLD);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(ss + k0 + warp * 16, acc, SLD, wmma::mem_row_major);
    __syncthreads();  // the K tile is overwritten next
  }

  // 2. exact softmax of each row, p in bf16 over the row's own scores
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = warp * ROWS + rr;
    const int i = q0 + r;
    const float* srow = ss + r * SLD;
    __nv_bfloat16* prow = sp + r * 2 * SLD;
    float m = -INFINITY;
    for (int j = lane; j < n_keys; j += 32)
      if (allowed(i, j, sval[j])) m = fmaxf(m, srow[j] * scale);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n_keys; j += 32)
      if (allowed(i, j, sval[j])) l += __expf(srow[j] * scale - m);
    l = warp_sum(l);
    // entry j of p overlays bytes 2j.. of the row: f32 entries j/2 .. read
    // in this pass or an earlier one, never a later one
    for (int j0 = 0; j0 < n_keys; j0 += 32) {
      const int j = j0 + lane;
      const float s = srow[j];
      const bool a = allowed(i, j, sval[j]);
      __syncwarp();
      prow[j] = __float2bfloat16(a ? __expf(s * scale - m) / l : 0.f);
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. O = P V; warp w takes output columns w*16*NF ..
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(oacc[f], 0.f);
  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    load_tile<HD>(skv, vb, v_rs, k0, L);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, sp + k0 + kk * 16, 2 * SLD);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, skv + kk * 16 * QLD + (warp * NF + f) * 16, QLD);
        wmma::mma_sync(oacc[f], pf, vf, oacc[f]);
      }
    }
    __syncthreads();  // the V tile is overwritten next
  }
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(so + (warp * NF + f) * 16, oacc[f], OLD, wmma::mem_row_major);
  __syncthreads();

  __nv_bfloat16* ob = out + (long long)b * L * o_rs + h * HD;
  for (int e = tid; e < SQ * HD; e += THREADS) {
    const int r = e / HD, t = q0 + r;
    if (t < L) ob[(long long)t * o_rs + e % HD] = __float2bfloat16(so[r * OLD + e % HD]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int bs, int L,
           int n_heads, long long q_rs, long long k_rs, long long v_rs, long long o_rs,
           float scale, cudaStream_t stream) {
  using Lay = ShortLayout<HD>;
  static bool attr_set = false;
  if (!attr_set) {  // the largest block any L takes
    cudaError_t e = cudaFuncSetAttribute(short_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Lay::bytes(MAX_TOKENS));
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int kmax = (L + BK - 1) / BK * BK;
  dim3 grid((L + SQ - 1) / SQ, n_heads, bs);
  short_attention_kernel<HD><<<grid, THREADS, Lay::bytes(kmax), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
      static_cast<__nv_bfloat16*>(out), L, q_rs, k_rs, v_rs, o_rs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/out: bf16 (bs, L, n_heads*head_dim) with row strides *_rs
// (elements, multiples of 8; pointers 16-byte aligned); valid: int32
// (bs, L).  1 <= L <= 1536; head_dim 64 or 128.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int short_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int bs, int L, int n_heads, int head_dim,
                                   long long q_rs, long long k_rs, long long v_rs, long long o_rs,
                                   float scale, void* stream) {
  if (L < 1 || L > MAX_TOKENS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch<64>(q, k, v, valid, out, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    case 128:
      return launch<128>(q, k, v, valid, out, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
