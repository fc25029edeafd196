// Tile geometry and helpers of the WMMA (mma.sync) online-softmax forward,
// which decode_attention.cu runs (new queries against the streaming slab
// cache); short_attention.cu takes only its mask rule, `allowed`.  The
// exact-window and flash forward (exact_attention.cu) run on TMA and wgmma
// instead (hopper.cuh).
//
// q/k/v/dO are (bs, L, H*hd) bf16 with a row stride per tensor: element
// (b, t, h, d) sits at (b*L + t)*row_stride + h*hd + d.  A block works on
// 64-row tiles with 4 warps of 16 rows each; tiles are staged in shared
// memory with a padded row stride (no bank conflicts for WMMA loads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

namespace attn {

constexpr int BQ = 64;           // query rows per tile
constexpr int BK = 64;           // keys per tile
constexpr int WARPS = BQ / 16;   // each warp owns 16 rows of a tile
constexpr int THREADS = WARPS * 32;
constexpr int SLD = BK + 8;      // f32 score tile row stride (elements)
constexpr int PLD = BK + 8;      // bf16 probability tile row stride

template <int HD>
__host__ __device__ constexpr int qld() { return HD + 8; }  // bf16 q/k/v/dO tile row stride

constexpr size_t round128(size_t n) { return (n + 127) / 128 * 128; }

// Copy 64 rows of HD bf16 (16 bytes per thread-step) starting at row t0 into
// a shared tile, zero-filling rows at or past L.
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int t0, int L) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH;
    const int cc = (c % CH) * 8;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < L) val = *reinterpret_cast<const uint4*>(src + (long long)t * row_stride + cc);
    *reinterpret_cast<uint4*>(dst + r * qld<HD>() + cc) = val;
  }
}

// The attention mask of backbone.make_masks and flash_attention._mask:
// causal AND key-valid, with the diagonal always allowed.
__device__ __forceinline__ bool allowed(int i, int j, int key_valid) {
  return j <= i && (key_valid != 0 || j == i);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared memory of the online-softmax forward (the decode kernel):
// the q, k and v tiles, the f32 score tile, the bf16 probability tile, the
// f32 accumulator, and per query row its running max m, sum l and the
// rescale alpha of the last tile; then `extra` bytes for the caller's
// per-key data (validity or positions).
template <int HD>
struct FwdLayout {
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
  static constexpr size_t extra = alpha + round128(sizeof(float) * BQ);
  static constexpr size_t bytes = extra + round128(sizeof(int) * BK);
};

// Pointers into FwdLayout's shared memory.
template <int HD>
struct FwdSmem {
  __nv_bfloat16 *q, *k, *v, *p;
  float *s, *o, *m, *l, *alpha;
  int* extra;
  __device__ explicit FwdSmem(unsigned char* base) {
    using Lay = FwdLayout<HD>;
    q = reinterpret_cast<__nv_bfloat16*>(base + Lay::q);
    k = reinterpret_cast<__nv_bfloat16*>(base + Lay::k);
    v = reinterpret_cast<__nv_bfloat16*>(base + Lay::v);
    s = reinterpret_cast<float*>(base + Lay::s);
    p = reinterpret_cast<__nv_bfloat16*>(base + Lay::p);
    o = reinterpret_cast<float*>(base + Lay::o);
    m = reinterpret_cast<float*>(base + Lay::m);
    l = reinterpret_cast<float*>(base + Lay::l);
    alpha = reinterpret_cast<float*>(base + Lay::alpha);
    extra = reinterpret_cast<int*>(base + Lay::extra);
  }
};

template <int HD>
using QFrag = nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                                     nvcuda::wmma::row_major>;

// Before the tile loop: the q tile is in shared memory (load_tile) and
// synchronised.  Zeroes the accumulator and the row statistics, then loads
// this warp's 16 query rows as A fragments; the caller synchronises after.
template <int HD>
__device__ __forceinline__ void fwd_begin(const FwdSmem<HD>& sh, QFrag<HD> (&qf)[HD / 16]) {
  using Lay = FwdLayout<HD>;
  for (int i = threadIdx.x; i < BQ * Lay::OLD / 4; i += THREADS)
    reinterpret_cast<float4*>(sh.o)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (threadIdx.x < BQ) {
    sh.m[threadIdx.x] = -INFINITY;
    sh.l[threadIdx.x] = 0.f;
  }
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    nvcuda::wmma::load_matrix_sync(qf[kk], sh.q + warp * 16 * Lay::QLD + kk * 16, Lay::QLD);
}

// One 64-key tile of the online-softmax forward, for the calling warp's 16
// query rows (tile rows warp*16 ..), in three stages: fwd_scores, S = Q K^T
// on the tensor cores; fwd_softmax, the masked online softmax in f32
// (allowed(row, col) over tile rows and the tile's key columns), p rounded
// to bf16; fwd_pv, O = alpha O + P V.  A row with no allowed key in the
// tile keeps its m, l and accumulator (p is 0 and exp is never taken of a
// masked score, so no NaN).  The K/V tiles must be in shared memory and
// synchronised; the caller synchronises before overwriting them.
template <int HD>
__device__ __forceinline__ void fwd_scores(const FwdSmem<HD>& sh, const QFrag<HD> (&qf)[HD / 16]) {
  namespace wmma = nvcuda::wmma;
  constexpr int QLD = FwdLayout<HD>::QLD;
  float* s_w = sh.s + threadIdx.x / 32 * 16 * SLD;
  // S = Q K^T over this warp's rows: 16 x 64 f32
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
      wmma::load_matrix_sync(kf, sh.k + n * 16 * QLD + kk * 16, QLD);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(s_w + n * 16, acc, SLD, wmma::mem_row_major);
  }
  __syncwarp();
}

// The online softmax with the warp's 16 rows at once: lanes 2r and 2r + 1
// take row r's keys 0..31 and 32..63, one shuffle joins them (a row at a
// time would cost 16 x 2 chains of 5 dependent shuffles a tile).  Each lane
// walks its 32 columns from its own offset, so the 32 lanes read 32
// distinct banks.
template <int HD, class Allowed>
__device__ __forceinline__ void fwd_softmax(const FwdSmem<HD>& sh, float scale, Allowed is_allowed) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane >> 1, half = lane & 1, row = warp * 16 + r;
  const int rot = r + 16 * half;
  const float* srow = sh.s + row * SLD;
  __nv_bfloat16* prow = sh.p + row * PLD;
  // the lane's 32 scores and their mask in registers, every load first
  float sc[32];
  unsigned ok = 0u;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const int col = ((c + rot) & 31) + 32 * half;
    sc[c] = srow[col] * scale;
    ok |= is_allowed(row, col) ? 1u << c : 0u;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 32; ++c)
    if (ok >> c & 1u) mx = fmaxf(mx, sc[c]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float m_old = sh.m[row];
  const float m_new = fmaxf(m_old, mx);
  float psum = 0.f;
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    const float p = (ok >> c & 1u) ? __expf(sc[c] - m_new) : 0.f;
    psum += p;
    prow[((c + rot) & 31) + 32 * half] = __float2bfloat16(p);
  }
  psum += __shfl_xor_sync(0xffffffffu, psum, 1);
  __syncwarp();  // both lanes of the row have read m_old
  if (half == 0) {
    const float alpha = (m_old == -INFINITY) ? 0.f : __expf(m_old - m_new);
    sh.m[row] = m_new;
    sh.l[row] = sh.l[row] * alpha + psum;
    sh.alpha[row] = alpha;
  }
  __syncwarp();
}

template <int HD>
__device__ __forceinline__ void fwd_pv(const FwdSmem<HD>& sh) {
  namespace wmma = nvcuda::wmma;
  using Lay = FwdLayout<HD>;
  constexpr int QLD = Lay::QLD;
  constexpr int OLD = Lay::OLD;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* p_w = sh.p + warp * 16 * PLD;
  float* o_w = sh.o + warp * 16 * OLD;
  // rescale this warp's accumulator rows (every load before any store, so
  // they overlap), then O += P V on the tensor cores
  constexpr int V = 16 * HD / 4 / 32;  // float4s of the warp's 16 rows a lane
  float4 o4[V];
  float a4[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = (lane + i * 32) * 4;
    o4[i] = *reinterpret_cast<const float4*>(o_w + e / HD * OLD + e % HD);
    a4[i] = sh.alpha[warp * 16 + e / HD];
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int e = (lane + i * 32) * 4;
    *reinterpret_cast<float4*>(o_w + e / HD * OLD + e % HD) =
        make_float4(o4[i].x * a4[i], o4[i].y * a4[i], o4[i].z * a4[i], o4[i].w * a4[i]);
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
      wmma::load_matrix_sync(vf, sh.v + kk * 16 * QLD + n * 16, QLD);
      wmma::mma_sync(acc, pf, vf, acc);
    }
    wmma::store_matrix_sync(o_w + n * 16, acc, OLD, wmma::mem_row_major);
  }
}

template <int HD, class Allowed>
__device__ __forceinline__ void fwd_tile(const FwdSmem<HD>& sh, const QFrag<HD> (&qf)[HD / 16],
                                         float scale, Allowed is_allowed) {
  fwd_scores<HD>(sh, qf);
  fwd_softmax<HD>(sh, scale, is_allowed);
  fwd_pv<HD>(sh);
}

}  // namespace attn
