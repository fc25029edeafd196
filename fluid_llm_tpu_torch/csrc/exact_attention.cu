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
__global__ void __launch_bounds__(THREADS)
exact_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const int* __restrict__ valid,
                       __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int L,
                       long long q_rs, long long k_rs, long long v_rs, long long o_rs,
                       float scale) {
  constexpr int OLD = FwdLayout<HD>::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<HD> sh(smem);
  int* skv = sh.extra;  // the key tile's validity

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int q0 = qt * BQ;

  const __nv_bfloat16* qb = q + (long long)b * L * q_rs + h * HD;
  const __nv_bfloat16* kb = k + (long long)b * L * k_rs + h * HD;
  const __nv_bfloat16* vb = v + (long long)b * L * v_rs + h * HD;
  const int* validb = valid + (long long)b * L;

  load_tile<HD>(sh.q, qb, q_rs, q0, L);
  __syncthreads();
  QFrag<HD> qf[HD / 16];  // this warp's 16 query rows stay in registers
  fwd_begin<HD>(sh, qf);
  __syncthreads();

  for (int kt = 0; kt <= qt; ++kt) {  // key tiles up to the diagonal only
    const int k0 = kt * BK;
    load_tile<HD>(sh.k, kb, k_rs, k0, L);
    load_tile<HD>(sh.v, vb, v_rs, k0, L);
    if (tid < BK) skv[tid] = (k0 + tid < L) ? validb[k0 + tid] : 0;
    __syncthreads();
    fwd_tile<HD>(sh, qf, scale,
                 [&](int row, int col) { return allowed(q0 + row, k0 + col, skv[col]); });
    __syncthreads();  // K/V tiles are overwritten next
  }

  __nv_bfloat16* ob = out + (long long)b * L * o_rs + h * HD;
  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD;
    const int t = q0 + r;
    if (t < L) ob[(long long)t * o_rs + e % HD] = __float2bfloat16(sh.o[r * OLD + e % HD] / sh.l[r]);
  }
  // every row has its diagonal, so l > 0 and the logsumexp is finite
  if (lse != nullptr && tid < BQ && q0 + tid < L)
    lse[((long long)b * gridDim.y + h) * L + q0 + tid] = sh.m[tid] + logf(sh.l[tid]);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, void* lse,
           int bs, int L, int n_heads, long long q_rs, long long k_rs, long long v_rs, long long o_rs,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdLayout<HD>::bytes;
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
