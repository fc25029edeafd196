// Causal, key-valid multi-head attention over PACKED q/k/v, forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/exact_attention.py:_kernel
// (Pallas, one program per (batch, 128-lane head group), whole-L VMEM tiles)
// through exact_attention_fwd, and the training forward
// fluid_llm_tpu/ops/flash_attention.py:_fwd_kernel through
// flash_attention_fwd: the same tile loop, which then also writes each
// row's logsumexp lse[b, h, i] = m_i + log(l_i) (f32, (bs, H, L)) for the
// backward kernels in flash_attention.cu.  The mask of both TPU kernels is
// the same (flash_attention.py:_mask == backbone.make_masks).
//
// Semantics (backbone.make_masks, exactly):
//   allowed[i, j] = (j <= i && valid[j]) || j == i     (forced diagonal)
//   out[i] = sum_j softmax_j(q_i . k_j * scale | allowed) v_j
// with the scores and softmax statistics in f32 and p rounded to bf16 before
// the PV product, as the Pallas kernel does (exact_attention.py:80).
//
// Layout: q/k/v/out are (bs, L, H*hd) bf16 with a row stride per tensor, so
// the three column slices of one fused qkv projection are read in place:
// element (b, t, h, d) sits at (b*L + t)*row_stride + h*hd + d.  No
// transpose to (bs, H, L, hd) is ever made.
//
// What bounds it on an H100: at the rollout geometry (L 661, H 12, hd 64,
// bs 1) the whole layer is ~2 x 12 x 661^2 / 2 x 64 x 2 ~= 0.67 GFLOP and
// ~3 MB of q/k/v -- far too little to fill the card either way, so the
// kernel is latency/occupancy bound: 11 query tiles x 12 heads = 132
// blocks, one per SM, and the last query tile walks 11 key tiles in series.
// Design: grid (query tile, head, batch); a block holds 64 query rows and
// walks the 64-key tiles only up to the diagonal (the causal triangle is
// skipped, not masked), with an online softmax (row max / row sum in f32)
// and the f32 accumulator in shared memory.  Q.K^T and P.V run on the
// tensor cores through WMMA (mma.sync) bf16 fragments; each of the 4 warps
// owns 16 query rows, so the softmax and the rescale of its accumulator
// rows need only warp-level synchronisation.  wgmma/TMA and a split over
// key tiles to balance the triangle are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "attention_tiles.cuh"

using namespace nvcuda;
using namespace attn;

namespace {

template <int HD>
struct Layout {
  static constexpr int QLD = qld<HD>();
  static constexpr int OLD = HD + 4;  // f32 accumulator row stride
  static constexpr size_t q = 0;
  static constexpr size_t k = q + round128(sizeof(__nv_bfloat16) * BQ * QLD);
  static constexpr size_t v = k + round128(sizeof(__nv_bfloat16) * BK * QLD);
  static constexpr size_t s = v + round128(sizeof(__nv_bfloat16) * BK * QLD);
  static constexpr size_t p = s + round128(sizeof(float) * BQ * SLD);
  static constexpr size_t o = p + round128(sizeof(__nv_bfloat16) * BQ * PLD);
  static constexpr size_t m = o + round128(sizeof(float) * BQ * OLD);
  static constexpr size_t l = m + round128(sizeof(float) * BQ);
  static constexpr size_t alpha = l + round128(sizeof(float) * BQ);
  static constexpr size_t kvalid = alpha + round128(sizeof(float) * BQ);
  static constexpr size_t bytes = kvalid + round128(sizeof(int) * BK);
};

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
exact_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L,
                       long long q_rs, long long k_rs, long long v_rs, long long o_rs,
                       float scale) {
  using Lay = Layout<HD>;
  constexpr int QLD = Lay::QLD;
  constexpr int OLD = Lay::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + Lay::q);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + Lay::k);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + Lay::v);
  float* ss = reinterpret_cast<float*>(smem + Lay::s);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + Lay::p);
  float* so = reinterpret_cast<float*>(smem + Lay::o);
  float* sm = reinterpret_cast<float*>(smem + Lay::m);
  float* sl = reinterpret_cast<float*>(smem + Lay::l);
  float* salpha = reinterpret_cast<float*>(smem + Lay::alpha);
  int* skv = reinterpret_cast<int*>(smem + Lay::kvalid);

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = qt * BQ;

  const __nv_bfloat16* qb = q + (long long)b * L * q_rs + h * HD;
  const __nv_bfloat16* kb = k + (long long)b * L * k_rs + h * HD;
  const __nv_bfloat16* vb = v + (long long)b * L * v_rs + h * HD;
  const int* validb = valid + (long long)b * L;

  load_tile<HD>(sq, qb, q_rs, q0, L);
  for (int i = tid; i < BQ * OLD; i += THREADS) so[i] = 0.f;
  if (tid < BQ) {
    sm[tid] = -INFINITY;
    sl[tid] = 0.f;
  }
  __syncthreads();

  // this warp's 16 query rows stay in registers as A fragments
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sq + warp * 16 * QLD + kk * 16, QLD);

  float* s_w = ss + warp * 16 * SLD;
  __nv_bfloat16* p_w = sp + warp * 16 * PLD;
  float* o_w = so + warp * 16 * OLD;

  for (int kt = 0; kt <= qt; ++kt) {  // key tiles up to the diagonal only
    const int k0 = kt * BK;
    load_tile<HD>(sk, kb, k_rs, k0, L);
    load_tile<HD>(sv, vb, v_rs, k0, L);
    if (tid < BK) skv[tid] = (k0 + tid < L) ? validb[k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T over this warp's rows: 16 x 64 f32
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sk + n * 16 * QLD + kk * 16, QLD);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(s_w + n * 16, acc, SLD, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: each lane takes 2 of the tile's 64 keys per row
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int i = q0 + row;
      const int j0 = k0 + lane;
      const int j1 = j0 + 32;
      const float s0 = s_w[r * SLD + lane] * scale;
      const float s1 = s_w[r * SLD + lane + 32] * scale;
      const bool a0 = allowed(i, j0, skv[lane]);
      const bool a1 = allowed(i, j1, skv[lane + 32]);
      const float tile_max = warp_max(fmaxf(a0 ? s0 : -INFINITY, a1 ? s1 : -INFINITY));
      const float m_old = sm[row];
      const float m_new = fmaxf(m_old, tile_max);
      const float p0 = a0 ? __expf(s0 - m_new) : 0.f;
      const float p1 = a1 ? __expf(s1 - m_new) : 0.f;
      const float psum = warp_sum(p0 + p1);
      p_w[r * PLD + lane] = __float2bfloat16(p0);
      p_w[r * PLD + lane + 32] = __float2bfloat16(p1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = (m_old == -INFINITY) ? 0.f : __expf(m_old - m_new);
        sm[row] = m_new;
        sl[row] = sl[row] * alpha + psum;
        salpha[row] = alpha;
      }
    }
    __syncwarp();

    // rescale this warp's accumulator rows, then O += P V on the tensor cores
    for (int e = lane; e < 16 * HD; e += 32) {
      const int r = e / HD;
      o_w[r * OLD + e % HD] *= salpha[warp * 16 + r];
    }
    __syncwarp();
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_w + n * 16, OLD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, p_w + kk * 16, PLD);
        wmma::load_matrix_sync(vf, sv + kk * 16 * QLD + n * 16, QLD);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(o_w + n * 16, acc, OLD, wmma::mem_row_major);
    }
    __syncthreads();  // K/V tiles are overwritten next
  }

  __nv_bfloat16* ob = out + (long long)b * L * o_rs + h * HD;
  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD;
    const int t = q0 + r;
    if (t < L) ob[(long long)t * o_rs + e % HD] = __float2bfloat16(so[r * OLD + e % HD] / sl[r]);
  }
  // every row has its diagonal, so l > 0 and the logsumexp is finite
  if (lse != nullptr && tid < BQ && q0 + tid < L)
    lse[((long long)b * gridDim.y + h) * L + q0 + tid] = sm[tid] + logf(sl[tid]);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, void* lse,
           int bs, int L, int n_heads, long long q_rs, long long k_rs, long long v_rs, long long o_rs,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(exact_attention_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((L + BQ - 1) / BQ, n_heads, bs);
  exact_attention_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), L, q_rs, k_rs, v_rs, o_rs, scale);
  return (int)cudaGetLastError();
}

int dispatch(const void* q, const void* k, const void* v, const void* valid, void* out, void* lse,
             int bs, int L, int n_heads, int head_dim, long long q_rs, long long k_rs,
             long long v_rs, long long o_rs, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, valid, out, lse, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    case 64:
      return launch<64>(q, k, v, valid, out, lse, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale, s);
    case 128:
      return launch<128>(q, k, v, valid, out, lse, bs, L, n_heads, q_rs, k_rs, v_rs, o_rs, scale,
                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/k/v/out: bf16 (bs, L, n_heads*head_dim) with row strides *_rs (elements,
// multiples of 8; pointers 16-byte aligned); valid: int32 (bs, L).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int exact_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, int bs, int L, int n_heads, int head_dim,
                                   long long q_rs, long long k_rs, long long v_rs,
                                   long long o_rs, float scale, void* stream) {
  return dispatch(q, k, v, valid, out, nullptr, bs, L, n_heads, head_dim, q_rs, k_rs, v_rs, o_rs,
                  scale, stream);
}

// As exact_attention_fwd, and also writes lse: f32 (bs, n_heads, L), each
// row's logsumexp of its scaled, masked scores.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, const void* valid,
                                   void* out, void* lse, int bs, int L, int n_heads,
                                   int head_dim, long long q_rs, long long k_rs, long long v_rs,
                                   long long o_rs, float scale, void* stream) {
  return dispatch(q, k, v, valid, out, lse, bs, L, n_heads, head_dim, q_rs, k_rs, v_rs, o_rs,
                  scale, stream);
}
