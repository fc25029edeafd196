// Decode attention over the streaming slab KV cache, forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/decode_attention.py:_kernel
// (slab_decode: Pallas, one program per (batch, 128-lane head group), the
// whole layer's slab buffer VMEM-resident, one masked softmax per head).
//
// Semantics (ops/decode_attention.slab_decode_ref, exactly):
//   allowed[i, j] = key_pos[j] <= q0 + i
//   out[i] = sum_j softmax_j(q_i . k_j * scale | allowed) v_j
// with the scores and softmax statistics in f32 and p rounded to bf16
// before the PV product.  key_pos holds each key's absolute position in
// slab order (ring slots, then the sink slot) and INT32_MAX for slab pad
// rows and unwritten slots; q0 (device int32) is the first query's
// position, the queries being consecutive.  Causality therefore comes from
// positions alone, never from slot order: after the ring wraps, slot order
// and position order differ.
//
// Layout: q/out are (bs, P, H*hd) bf16, q with a row stride (a column slice
// of the fused qkv projection is read in place).  The caches are the
// stacked (n_layers, bs, slots, P̂, H*hd) buffers of
// backbone.init_streaming_cache, contiguous: layer li, batch b, key j =
// slot*P̂ + row sits at row ((li*bs + b)*slots*P̂ + j) of H*hd columns, so
// the kernel reads layer li in place through that offset -- no per-layer
// slice, no copy, no head relayout.  Full heads only (no grouped-query
// repeat), as the TPU kernel's gate.
//
// What bounds it on an H100: at the flagship streaming step (bs 1, P 60,
// H 12, hd 64, 11 slots x 64 rows = 704 keys) one layer reads ~2.2 MB of
// K/V and does ~2 x 12 x 64 x 704 x 64 x 2 ~= 0.14 GFLOP: microseconds of
// either, so the launch is latency bound: what counts is how many SMs work
// at once and how many dependent memory round trips each block waits on.
//
// Design (split-KV decoding):
// - Grid (key split, head, query tile x batch).  Each split owns a
//   contiguous run of 64-key tiles (ops/decode_attention.split_plan picks
//   the run length so the grid fills a wave, no split empty): at the
//   flagship shape one tile a split, 11 x 12 = 132 blocks.
// - A split walks its tiles with the online softmax of attention_tiles.cuh
//   (WMMA bf16 Q.K^T and P.V, f32 statistics,
//   the softmax two lanes a row, all 16 rows of a warp at once),
//   first asking, with one __syncthreads_or, whether any query of the block
//   may see any key of the tile: a tile no query may see (an unwritten ring
//   slot, every ring slot during the prefill) is never loaded, and a split
//   that sees none returns m = -inf, l = 0 at once.  The q tile's copy
//   flies while the first visible tile is looked for; with more than one
//   tile a split, the next visible tile's K/V copy (cp.async, a second
//   buffer) flies while the current one is computed.
// - The combine runs in the same launch: each split leaves its
//   unnormalised f32 O (64 x hd) and its m, l rows in scratch from the
//   wrapper, then takes a ticket (one atomicAdd per block on a counter the
//   wrapper allocated once).  The block that draws the last ticket resets
//   the counter to 0 (so the next launch, or a CUDA-graph replay, finds it
//   ready: no memset) and sums the splits in split order, rescaled to the
//   largest m, so the result does not depend on which block came last.
//   A thread-block cluster over the splits would have needed 11 blocks (a
//   non-portable cluster size) and a split count that divides the grid;
//   the ticket takes any split count.  One split writes the output itself.
// What is left: each block still pays its load round trips in series (q
// and the first K/V tile, then the partials' write, the ticket, the
// combine's reads from L2), and the WMMA tiles go through shared memory.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tiles.cuh"

using namespace attn;

// Asynchronous 16-byte copies from global to shared memory (cp.async).
namespace cpa {

// Copy 16 bytes from src to the shared dst; with ok false, write 16 zero
// bytes and read nothing (src must still be a valid address to form).
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

// Close the group of copies started since the last commit (an empty group is
// fine: the waits below count groups).
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's newest groups are still in flight;
// the caller then synchronises the block before reading the copies.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cpa

namespace {

// the combine keeps the splits' statistics ((2 x splits + 1) x 64 f32) in
// the score tile, their indices in the key-position row, and compacts
// them with one warp's ballot
constexpr int MAX_SPLITS = 32;

// The online-softmax layout of attention_tiles.cuh plus a second K/V tile
// and key-position row: the next visible tile's copy lands there while the
// current tile is computed.
template <int HD>
struct DecodeLayout {
  using Fwd = FwdLayout<HD>;
  static constexpr size_t kv = round128(sizeof(__nv_bfloat16) * BK * Fwd::QLD);
  static constexpr size_t k2 = Fwd::bytes;
  static constexpr size_t v2 = k2 + kv;
  static constexpr size_t pos2 = v2 + kv;
  static constexpr size_t bytes = pos2 + round128(sizeof(int) * BK);
};

// load_tile's contract with cp.async: 64 rows of HD bf16 from row t0 into a
// shared tile, rows at or past L zero-filled; the caller commits and waits.
template <int HD>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int t0, int L) {
  constexpr int CH = HD / 8;
  for (int c = threadIdx.x; c < 64 * CH; c += THREADS) {
    const int r = c / CH, cc = (c % CH) * 8, t = t0 + r;
    cpa::copy16(dst + r * qld<HD>() + cc, src + (long long)(t < L ? t : 0) * row_stride + cc,
                t < L);
  }
}

// The first key tile at or after k0 and before k_end that some query of the
// block may see (a key position <= qmax), its positions left in skp; k_end
// if there is none.  Every thread returns the same tile.
__device__ __forceinline__ int next_visible(int k0, int k_end, const int* __restrict__ key_pos,
                                            int n_keys, int qmax, int* skp) {
  for (; k0 < k_end; k0 += BK) {
    const int j = k0 + threadIdx.x;
    const int kp = (threadIdx.x < BK && j < n_keys) ? key_pos[j] : INT_MAX;
    if (threadIdx.x < BK) skp[threadIdx.x] = kp;
    if (__syncthreads_or(kp <= qmax)) return k0;  // a barrier too: skp is visible after it
  }
  return k_end;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
slab_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc, const int* __restrict__ key_pos,
                   const int* __restrict__ q0_ptr, __nv_bfloat16* __restrict__ out,
                   float* __restrict__ part_o, float* __restrict__ part_ml, int* tickets, int bs,
                   int P, int n_keys, int li, long long q_rs, int kv_rs, float scale,
                   int split_keys) {
  constexpr int OLD = FwdLayout<HD>::OLD;
  constexpr int CPT = BQ * HD / 4 / THREADS;  // float4 chunks of the 64 x HD tile a thread moves
  using Lay = DecodeLayout<HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int is_last;
  const FwdSmem<HD> sh(smem);

  const int split = blockIdx.x, n_splits = gridDim.x;
  const int h = blockIdx.y, n_heads = gridDim.y;
  const int q_tiles = (P + BQ - 1) / BQ;
  const int b = blockIdx.z / q_tiles;
  const int i0 = (blockIdx.z % q_tiles) * BQ;  // first query row of the tile
  const int tid = threadIdx.x;
  const int q0 = *q0_ptr + i0;                 // its absolute position
  const int qmax = q0 + min(BQ, P - i0) - 1;   // the tile's last query position

  const long long cache_off = ((long long)li * bs + b) * n_keys * kv_rs + h * HD;
  const __nv_bfloat16* qb = q + (long long)b * P * q_rs + h * HD;
  const __nv_bfloat16* kb = kc + cache_off;
  const __nv_bfloat16* vb = vc + cache_off;
  const int k_end = min(n_keys, (split + 1) * split_keys);

  // the q tile's copy flies while the split's first visible key tile is found
  copy_tile<HD>(sh.q, qb, q_rs, i0, P);
  cpa::commit();
  int cur = next_visible(split * split_keys, k_end, key_pos, n_keys, qmax, sh.extra);
  const bool empty = cur == k_end;
  if (!empty) {
    copy_tile<HD>(sh.k, kb, kv_rs, cur, n_keys);
    copy_tile<HD>(sh.v, vb, kv_rs, cur, n_keys);
    cpa::commit();
    cpa::wait<1>();  // q has landed; the first K/V tile may still fly
    __syncthreads();
    QFrag<HD> qf[HD / 16];  // this warp's 16 query rows stay in registers
    fwd_begin<HD>(sh, qf);
    __syncthreads();
    for (int nb = 0; cur < k_end; nb ^= 1) {
      // buffer nb holds tile cur (in flight); buffer nb ^ 1 takes the next
      __nv_bfloat16* k2 = reinterpret_cast<__nv_bfloat16*>(smem + Lay::k2);
      __nv_bfloat16* v2 = reinterpret_cast<__nv_bfloat16*>(smem + Lay::v2);
      int* pos2 = reinterpret_cast<int*>(smem + Lay::pos2);
      FwdSmem<HD> now = sh, next = sh;
      now.k = nb ? k2 : sh.k;
      now.v = nb ? v2 : sh.v;
      now.extra = nb ? pos2 : sh.extra;
      next.k = nb ? sh.k : k2;
      next.v = nb ? sh.v : v2;
      next.extra = nb ? sh.extra : pos2;
      const int nxt = next_visible(cur + BK, k_end, key_pos, n_keys, qmax, next.extra);
      if (nxt < k_end) {
        copy_tile<HD>(next.k, kb, kv_rs, nxt, n_keys);
        copy_tile<HD>(next.v, vb, kv_rs, nxt, n_keys);
      }
      cpa::commit();
      cpa::wait<1>();  // tile cur has landed; tile nxt may still fly
      __syncthreads();
      const int* skp = now.extra;
      fwd_scores<HD>(now, qf);
      fwd_softmax<HD>(now, scale, [&](int row, int col) { return skp[col] <= q0 + row; });
      fwd_pv<HD>(now);
      __syncthreads();  // buffer nb is overwritten next
      cur = nxt;
    }
  } else {
    cpa::wait<0>();  // the q copy lands before the block leaves
    if (tid < BQ) {
      sh.m[tid] = -INFINITY;
      sh.l[tid] = 0.f;
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + (long long)b * P * HD * n_heads + h * HD;
  const long long o_rs = (long long)HD * n_heads;
  // 4 values of row r from column d, normalised by l, to the output
  // (every query sees at least its own key in the cache; a row that sees
  // none, not produced by the streaming path, is written as zeros)
  auto store4 = [&](int r, int d, float4 v, float l) {
    if (i0 + r >= P) return;
    const bool seen = l > 0.f;
    __nv_bfloat162 lo = __floats2bfloat162_rn(seen ? v.x / l : 0.f, seen ? v.y / l : 0.f);
    __nv_bfloat162 hi = __floats2bfloat162_rn(seen ? v.z / l : 0.f, seen ? v.w / l : 0.f);
    uint2 pack;
    pack.x = *reinterpret_cast<uint32_t*>(&lo);
    pack.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(ob + (long long)(i0 + r) * o_rs + d) = pack;
  };

  if (n_splits == 1) {  // every key in this block: normalise and write
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int e = (tid + j * THREADS) * 4, r = e / HD, d = e % HD;
      const float l = sh.l[r];  // 0 in an empty block: its accumulator is never read
      store4(r, d, l > 0.f ? *reinterpret_cast<const float4*>(sh.o + r * OLD + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f), l);
    }
    return;
  }

  // this split's partial: unnormalised O (zeros if it saw nothing), m, l
  const long long group = (long long)blockIdx.z * n_heads + h;
  float* po = part_o + (group * n_splits + split) * BQ * HD;
  float* pml = part_ml + (group * n_splits + split) * 2 * BQ;
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int e = (tid + j * THREADS) * 4, r = e / HD, d = e % HD;
    *reinterpret_cast<float4*>(po + e) = empty ? make_float4(0.f, 0.f, 0.f, 0.f)
                                               : *reinterpret_cast<const float4*>(sh.o + r * OLD + d);
  }
  if (tid < BQ) {
    pml[tid] = sh.m[tid];
    pml[BQ + tid] = sh.l[tid];
  }
  __threadfence();  // the partial is visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(tickets + group, 1);
    is_last = ticket == n_splits - 1;
    if (is_last) tickets[group] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last block combines the splits in split order: per row the weight
  // w_s = exp(m_s - max m), then sum w_s O_s / sum w_s l_s
  float* stat = sh.s;     // the splits' (m, l) rows, m turned into w_s; then each row's sum
  int* used = sh.extra;   // the splits with a weight in some row, in split order; their count last
  const float* ml = part_ml + group * n_splits * 2 * BQ;
#pragma unroll 4
  for (int e = tid; e < n_splits * 2 * BQ; e += THREADS) stat[e] = __ldcg(ml + e);
  for (int s = tid; s < n_splits; s += THREADS) used[s] = 0;
  __syncthreads();
  if (tid < BQ) {  // one row a thread, the splits' statistics in registers
    float ms[MAX_SPLITS], ls[MAX_SPLITS];
    float m = -INFINITY;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < n_splits) {
        ms[s] = stat[s * 2 * BQ + tid];
        ls[s] = stat[s * 2 * BQ + BQ + tid];
        m = fmaxf(m, ms[s]);
      }
    float l = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_SPLITS; ++s)
      if (s < n_splits) {
        const float w = ms[s] == -INFINITY ? 0.f : __expf(ms[s] - m);
        stat[s * 2 * BQ + tid] = w;
        l += w * ls[s];
        if (w > 0.f) used[s] = 1;
      }
    stat[n_splits * 2 * BQ + tid] = l;
  }
  __syncthreads();
  if (tid < 32) {  // compact the used splits, keeping their order (MAX_SPLITS <= 32)
    const bool u = tid < n_splits && used[tid];
    const unsigned ballot = __ballot_sync(0xffffffffu, u);
    __syncwarp();
    if (u) used[__popc(ballot & ((1u << tid) - 1u))] = tid;
    if (tid == 0) used[MAX_SPLITS] = __popc(ballot);
  }
  __syncthreads();
  // U used splits a round, CPT float4 loads each in flight per thread
  constexpr int U = CPT >= 16 ? 1 : 16 / CPT;
  const int n_used = used[MAX_SPLITS];
  const float* pg = part_o + group * n_splits * BQ * HD;
  float4 acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int u0 = 0; u0 < n_used; u0 += U) {
    float4 v[U][CPT];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        v[u][j] = u0 + u < n_used
                      ? __ldcg(reinterpret_cast<const float4*>(
                            pg + (long long)used[u0 + u] * BQ * HD + (tid + j * THREADS) * 4))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u0 + u >= n_used) break;
      const float* w_s = stat + used[u0 + u] * 2 * BQ;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float w = w_s[(tid + j * THREADS) * 4 / HD];
        acc[j].x += w * v[u][j].x;
        acc[j].y += w * v[u][j].y;
        acc[j].z += w * v[u][j].z;
        acc[j].w += w * v[u][j].w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int e = (tid + j * THREADS) * 4, r = e / HD;
    store4(r, e % HD, acc[j], stat[n_splits * 2 * BQ + r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* key_pos, const void* q0,
           void* out, void* part_o, void* part_ml, void* tickets, int bs, int P, int n_heads,
           int n_keys, int li, long long q_rs, int kv_rs, float scale, int n_splits,
           int split_keys, cudaStream_t stream) {
  constexpr size_t smem = DecodeLayout<HD>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(slab_decode_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid(n_splits, n_heads, bs * ((P + BQ - 1) / BQ));
  slab_decode_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(key_pos),
      static_cast<const int*>(q0), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_o), static_cast<float*>(part_ml), static_cast<int*>(tickets), bs,
      P, n_keys, li, q_rs, kv_rs, scale, split_keys);
  return (int)cudaGetLastError();
}

}  // namespace

// q: bf16 (bs, P, n_heads*head_dim), row stride q_rs (elements, a multiple
// of 8; 16-byte aligned); k/v: the contiguous bf16 caches (n_layers, bs,
// slots, P̂, kv_rs) with n_keys = slots*P̂ and kv_rs = n_heads*head_dim;
// key_pos: int32, at least n_keys entries; q0: int32 scalar on the device;
// out: bf16 (bs, P, n_heads*head_dim), contiguous.  The keys are cut into
// n_splits runs of split_keys (a multiple of 64), none empty; with more
// than one split, part_o (f32, groups x n_splits x 64 x head_dim), part_ml
// (f32, groups x n_splits x 2 x 64) and tickets (int32, groups, zero before
// the first launch; every launch leaves them zero) hold the partials, with
// groups = bs x query tiles x n_heads.  Returns cudaGetLastError() after
// the launch (0 on success).
extern "C" int slab_decode_attention(const void* q, const void* k, const void* v,
                                     const void* key_pos, const void* q0, void* out,
                                     void* part_o, void* part_ml, void* tickets, int bs, int P,
                                     int n_heads, int head_dim, int n_keys, int li,
                                     long long q_rs, int kv_rs, float scale, int n_splits,
                                     int split_keys, void* stream) {
  if (n_splits < 1 || n_splits > MAX_SPLITS || split_keys <= 0 || split_keys % BK ||
      (long long)n_splits * split_keys < n_keys || (long long)(n_splits - 1) * split_keys >= n_keys ||
      (n_splits > 1 && (part_o == nullptr || part_ml == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, key_pos, q0, out, part_o, part_ml, tickets, bs, P, n_heads,
                        n_keys, li, q_rs, kv_rs, scale, n_splits, split_keys, s);
    case 64:
      return launch<64>(q, k, v, key_pos, q0, out, part_o, part_ml, tickets, bs, P, n_heads,
                        n_keys, li, q_rs, kv_rs, scale, n_splits, split_keys, s);
    case 128:
      return launch<128>(q, k, v, key_pos, q0, out, part_o, part_ml, tickets, bs, P, n_heads,
                         n_keys, li, q_rs, kv_rs, scale, n_splits, split_keys, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
