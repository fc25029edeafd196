// Backward of the causal, key-valid attention: dq, and dk/dv, flash-2 style.
//
// Replaces the TPU kernels fluid_llm_tpu/ops/flash_attention.py:_dq_kernel
// and :_dkv_kernel (Pallas, grid (batch*heads, q-blocks, k-blocks) with the
// sum carried in VMEM scratch across the sequential k/q grid axis).  The
// forward that writes lse is flash_attention_fwd in exact_attention.cu.
//
// Math (s_ij = scale * q_i.k_j; allowed = causal AND key-valid, diagonal
// always on; lse_i and delta_i = dO_i.O_i per query row):
//   p_ij  = allowed ? exp(s_ij - lse_i) : 0
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij * (dp_ij - delta_i)
//   dq_i  = scale * sum_j ds_ij k_j     (keys up to the diagonal)
//   dk_j  = scale * sum_i ds_ij q_i     (queries from the diagonal down)
//   dv_j  =         sum_i p_ij dO_i
// Invalid keys still get dk/dv from their own row: the forced diagonal.
//
// Layout: q/k/v/dO are (bs, L, H*hd) bf16 read in place through row strides
// (as in the forward); dq/dk/dv are written the same way; lse is f32
// (bs, H, L) and delta f32 (bs, L, H).  Rows and keys at or past L are
// zero-filled on load, masked out of p, and never written.
//
// What bounds it on an H100: at the training geometry (bs 8, L 601, H 12,
// hd 64) one layer's backward is ~4 x 2 x 8 x 12 x 601^2 / 2 x 64 ~= 8.9
// GFLOP over ~37 MB, i.e. tensor-core bound in principle, but at WMMA
// (mma.sync) rates and 960 blocks of 4 warps it is latency bound in
// practice.  Design: the TPU kernels' sequential grid axis becomes a loop
// inside the block.  dq: one block per (64-query tile, head, batch) walks
// the key tiles up to the diagonal; dk/dv: one block per (64-key tile,
// head, batch) walks the query tiles from the diagonal down.  Each warp
// owns 16 rows of its block's tile: the dk/dv kernel computes S^T = K Q^T
// and dP^T = V dO^T so that a warp's rows are its own keys, and neither
// kernel needs more than warp synchronisation between its products.  All
// products run on the tensor cores in bf16 with f32 accumulators; p and ds
// are rounded to bf16 once, as their A operands.  Accumulators stay in
// registers (WMMA fragments) across the loop; nothing is atomic.
// wgmma/TMA and software pipelining are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "attention_tiles.cuh"

using namespace nvcuda;
using namespace attn;

namespace {

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// Shared memory of both kernels: two row tiles of the block's own side (a,
// b: Q and dO for dq; K and V for dk/dv), two tiles walked in the loop (c,
// d), two f32 product tiles, two bf16 operand tiles, per-row statistics and
// key validity, and an f32 staging tile for the result.
template <int HD>
struct Layout {
  static constexpr int QLD = qld<HD>();
  static constexpr int OLD = HD + 4;
  static constexpr size_t tile = round128(sizeof(__nv_bfloat16) * 64 * QLD);
  static constexpr size_t a = 0;
  static constexpr size_t b = a + tile;
  static constexpr size_t c = b + tile;
  static constexpr size_t d = c + tile;
  static constexpr size_t s = d + tile;
  static constexpr size_t dp = s + round128(sizeof(float) * 64 * SLD);
  static constexpr size_t p = dp + round128(sizeof(float) * 64 * SLD);
  static constexpr size_t ds = p + round128(sizeof(__nv_bfloat16) * 64 * PLD);
  static constexpr size_t lse = ds + round128(sizeof(__nv_bfloat16) * 64 * PLD);
  static constexpr size_t delta = lse + round128(sizeof(float) * 64);
  static constexpr size_t kvalid = delta + round128(sizeof(float) * 64);
  static constexpr size_t out = kvalid + round128(sizeof(int) * 64);
  static constexpr size_t bytes = out + round128(sizeof(float) * 64 * OLD);
};

// dst (16 x 64 f32, row stride SLD) = rows(A) . rows(B)^T over HD, where A
// is held as HD/16 fragments and B is a (64, HD) bf16 tile in shared memory.
template <int HD>
__device__ __forceinline__ void rows_dot_tile(float* dst, const FragA* af,
                                              const __nv_bfloat16* tile) {
  constexpr int QLD = qld<HD>();
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, tile + n * 16 * QLD + kk * 16, QLD);
      wmma::mma_sync(acc, af[kk], bf, acc);
    }
    wmma::store_matrix_sync(dst + n * 16, acc, SLD, wmma::mem_row_major);
  }
}

// acc (16 x HD, HD/16 fragments) += op (16 x 64 bf16, row stride PLD) . tile
// (64 x HD bf16 in shared memory).
template <int HD>
__device__ __forceinline__ void accumulate(FragC* acc, const __nv_bfloat16* op,
                                           const __nv_bfloat16* tile) {
  constexpr int QLD = qld<HD>();
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    FragA af;
    wmma::load_matrix_sync(af, op + kk * 16, PLD);
#pragma unroll
    for (int n = 0; n < HD / 16; ++n) {
      FragBRow bf;
      wmma::load_matrix_sync(bf, tile + kk * 16 * QLD + n * 16, QLD);
      wmma::mma_sync(acc[n], af, bf, acc[n]);
    }
  }
}

// Write a block's 64 x HD f32 fragments, times `mul`, as bf16 rows t0.. of
// dst (row stride rs), skipping rows at or past L.
template <int HD>
__device__ __forceinline__ void store_rows(const FragC* acc, float* stage, float mul,
                                           __nv_bfloat16* dst, long long rs, int t0, int L) {
  constexpr int OLD = HD + 4;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int n = 0; n < HD / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * OLD + n * 16, acc[n], OLD, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * HD; e += THREADS) {
    const int r = e / HD;
    const int t = t0 + r;
    if (t < L) dst[(long long)t * rs + e % HD] = __float2bfloat16(stage[r * OLD + e % HD] * mul);
  }
  __syncthreads();
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ valid, __nv_bfloat16* __restrict__ dq, int L,
                long long q_rs, long long k_rs, long long v_rs, long long do_rs,
                long long dq_rs, float scale) {
  using Lay = Layout<HD>;
  constexpr int QLD = Lay::QLD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + Lay::a);
  __nv_bfloat16* sdo = reinterpret_cast<__nv_bfloat16*>(smem + Lay::b);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + Lay::c);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + Lay::d);
  float* ss = reinterpret_cast<float*>(smem + Lay::s);
  float* sdp = reinterpret_cast<float*>(smem + Lay::dp);
  __nv_bfloat16* sds = reinterpret_cast<__nv_bfloat16*>(smem + Lay::ds);
  float* slse = reinterpret_cast<float*>(smem + Lay::lse);
  float* sdelta = reinterpret_cast<float*>(smem + Lay::delta);
  int* skv = reinterpret_cast<int*>(smem + Lay::kvalid);
  float* sout = reinterpret_cast<float*>(smem + Lay::out);

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = qt * BQ;
  const long long row0 = (long long)b * L;

  load_tile<HD>(sq, q + row0 * q_rs + h * HD, q_rs, q0, L);
  load_tile<HD>(sdo, dout + row0 * do_rs + h * HD, do_rs, q0, L);
  if (tid < BQ) {
    const int i = q0 + tid;
    slse[tid] = i < L ? lse[((long long)b * H + h) * L + i] : 0.f;
    sdelta[tid] = i < L ? delta[(row0 + i) * H + h] : 0.f;
  }
  __syncthreads();

  FragA qf[HD / 16], dof[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], sq + warp * 16 * QLD + kk * 16, QLD);
    wmma::load_matrix_sync(dof[kk], sdo + warp * 16 * QLD + kk * 16, QLD);
  }
  FragC acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  float* s_w = ss + warp * 16 * SLD;
  float* dp_w = sdp + warp * 16 * SLD;
  __nv_bfloat16* ds_w = sds + warp * 16 * PLD;

  for (int kt = 0; kt <= qt; ++kt) {  // key tiles up to the diagonal
    const int k0 = kt * BK;
    load_tile<HD>(sk, k + row0 * k_rs + h * HD, k_rs, k0, L);
    load_tile<HD>(sv, v + row0 * v_rs + h * HD, v_rs, k0, L);
    if (tid < BK) skv[tid] = (k0 + tid < L) ? valid[row0 + k0 + tid] : 0;
    __syncthreads();

    rows_dot_tile<HD>(s_w, qf, sk);    // S  = Q K^T    (this warp's 16 rows)
    rows_dot_tile<HD>(dp_w, dof, sv);  // dP = dO V^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int row = warp * 16 + r;
      const int i = q0 + row;
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int c = lane + 32 * part;
        const bool ok = i < L && allowed(i, k0 + c, skv[c]);
        const float p = ok ? __expf(s_w[r * SLD + c] * scale - slse[row]) : 0.f;
        ds_w[r * PLD + c] = __float2bfloat16(p * (dp_w[r * SLD + c] - sdelta[row]));
      }
    }
    __syncwarp();
    accumulate<HD>(acc, ds_w, sk);  // dQ += dS K
    __syncthreads();  // K/V tiles are overwritten next
  }
  store_rows<HD>(acc, sout, scale, dq + row0 * dq_rs + h * HD, dq_rs, q0, L);
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ valid, __nv_bfloat16* __restrict__ dk,
                 __nv_bfloat16* __restrict__ dv, int L, long long q_rs, long long k_rs,
                 long long v_rs, long long do_rs, long long dk_rs, long long dv_rs,
                 float scale) {
  using Lay = Layout<HD>;
  constexpr int QLD = Lay::QLD;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + Lay::a);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + Lay::b);
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + Lay::c);
  __nv_bfloat16* sdo = reinterpret_cast<__nv_bfloat16*>(smem + Lay::d);
  float* ss = reinterpret_cast<float*>(smem + Lay::s);
  float* sdp = reinterpret_cast<float*>(smem + Lay::dp);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + Lay::p);
  __nv_bfloat16* sds = reinterpret_cast<__nv_bfloat16*>(smem + Lay::ds);
  float* slse = reinterpret_cast<float*>(smem + Lay::lse);
  float* sdelta = reinterpret_cast<float*>(smem + Lay::delta);
  int* skv = reinterpret_cast<int*>(smem + Lay::kvalid);
  float* sout = reinterpret_cast<float*>(smem + Lay::out);

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = kt * BK;
  const int nq = (L + BQ - 1) / BQ;
  const long long row0 = (long long)b * L;

  load_tile<HD>(sk, k + row0 * k_rs + h * HD, k_rs, k0, L);
  load_tile<HD>(sv, v + row0 * v_rs + h * HD, v_rs, k0, L);
  if (tid < BK) skv[tid] = (k0 + tid < L) ? valid[row0 + k0 + tid] : 0;
  __syncthreads();

  FragA kf[HD / 16], vf[HD / 16];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], sk + warp * 16 * QLD + kk * 16, QLD);
    wmma::load_matrix_sync(vf[kk], sv + warp * 16 * QLD + kk * 16, QLD);
  }
  FragC dk_acc[HD / 16], dv_acc[HD / 16];
#pragma unroll
  for (int n = 0; n < HD / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  float* s_w = ss + warp * 16 * SLD;    // S^T: this warp's 16 keys x 64 queries
  float* dp_w = sdp + warp * 16 * SLD;  // dP^T
  __nv_bfloat16* p_w = sp + warp * 16 * PLD;
  __nv_bfloat16* ds_w = sds + warp * 16 * PLD;

  for (int qt = kt; qt < nq; ++qt) {  // query tiles from the diagonal down
    const int q0 = qt * BQ;
    load_tile<HD>(sq, q + row0 * q_rs + h * HD, q_rs, q0, L);
    load_tile<HD>(sdo, dout + row0 * do_rs + h * HD, do_rs, q0, L);
    if (tid < BQ) {
      const int i = q0 + tid;
      slse[tid] = i < L ? lse[((long long)b * H + h) * L + i] : 0.f;
      sdelta[tid] = i < L ? delta[(row0 + i) * H + h] : 0.f;
    }
    __syncthreads();

    rows_dot_tile<HD>(s_w, kf, sq);    // S^T  = K Q^T
    rows_dot_tile<HD>(dp_w, vf, sdo);  // dP^T = V dO^T
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      const int j = k0 + warp * 16 + r;
      const int kv = skv[warp * 16 + r];
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const int c = lane + 32 * part;
        const int i = q0 + c;
        const bool ok = i < L && allowed(i, j, kv);
        const float p = ok ? __expf(s_w[r * SLD + c] * scale - slse[c]) : 0.f;
        p_w[r * PLD + c] = __float2bfloat16(p);
        ds_w[r * PLD + c] = __float2bfloat16(p * (dp_w[r * SLD + c] - sdelta[c]));
      }
    }
    __syncwarp();
    accumulate<HD>(dv_acc, p_w, sdo);  // dV += P^T dO
    accumulate<HD>(dk_acc, ds_w, sq);  // dK += dS^T Q
    __syncthreads();  // Q/dO tiles are overwritten next
  }
  store_rows<HD>(dk_acc, sout, scale, dk + row0 * dk_rs + h * HD, dk_rs, k0, L);
  store_rows<HD>(dv_acc, sout, 1.f, dv + row0 * dv_rs + h * HD, dv_rs, k0, L);
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

template <int HD>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, const void* valid, void* dq, int bs, int L, int n_heads,
              long long q_rs, long long k_rs, long long v_rs, long long do_rs, long long dq_rs,
              float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::bytes;
  static bool attr_set = false;
  if (int e = set_smem(flash_dq_kernel<HD>, smem, attr_set)) return e;
  dim3 grid((L + BQ - 1) / BQ, n_heads, bs);
  flash_dq_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(valid), static_cast<__nv_bfloat16*>(dq), L, q_rs, k_rs, v_rs,
      do_rs, dq_rs, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* valid, void* dk, void* dv, int bs, int L,
               int n_heads, long long q_rs, long long k_rs, long long v_rs, long long do_rs,
               long long dk_rs, long long dv_rs, float scale, cudaStream_t stream) {
  constexpr size_t smem = Layout<HD>::bytes;
  static bool attr_set = false;
  if (int e = set_smem(flash_dkv_kernel<HD>, smem, attr_set)) return e;
  dim3 grid((L + BK - 1) / BK, n_heads, bs);
  flash_dkv_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(valid), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), L, q_rs, k_rs, v_rs, do_rs, dk_rs, dv_rs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q/k/v/dout/dq: bf16 (bs, L, n_heads*head_dim) with row strides *_rs
// (elements, multiples of 8; pointers 16-byte aligned); lse: f32 (bs,
// n_heads, L); delta: f32 (bs, L, n_heads); valid: int32 (bs, L).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* valid,
                                  void* dq, int bs, int L, int n_heads, int head_dim,
                                  long long q_rs, long long k_rs, long long v_rs,
                                  long long do_rs, long long dq_rs, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dq<32>(q, k, v, dout, lse, delta, valid, dq, bs, L, n_heads, q_rs, k_rs, v_rs,
                           do_rs, dq_rs, scale, s);
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, valid, dq, bs, L, n_heads, q_rs, k_rs, v_rs,
                           do_rs, dq_rs, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, valid, dq, bs, L, n_heads, q_rs, k_rs,
                            v_rs, do_rs, dq_rs, scale, s);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_dkv<32>(q, k, v, dout, lse, delta, valid, dk, dv, bs, L, n_heads, q_rs, k_rs,
                            v_rs, do_rs, dk_rs, dv_rs, scale, s);
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, valid, dk, dv, bs, L, n_heads, q_rs, k_rs,
                            v_rs, do_rs, dk_rs, dv_rs, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, valid, dk, dv, bs, L, n_heads, q_rs,
                             k_rs, v_rs, do_rs, dk_rs, dv_rs, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
