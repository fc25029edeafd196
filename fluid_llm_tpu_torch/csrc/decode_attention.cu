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
// either, so the launch is latency bound, and one block per (query tile,
// head) gives only 12 blocks for 132 SMs.  Design: grid (query tile, head,
// batch); each block walks the 64-key tiles (one slab each at P̂ 64) with
// the online softmax of the exact-window kernel (attention_tiles.cuh:
// WMMA bf16 Q.K^T and P.V, f32 statistics), and first asks, with one
// __syncthreads_or, whether any query of the block may see any key of the
// tile: a tile no query may see (an unwritten ring slot, every ring slot
// during the prefill) is skipped without loading it.  A tile that is
// masked only for some rows leaves those rows' statistics unchanged, so
// masked tiles before the first visible one cannot produce NaN.  Splitting
// the keys across blocks (and a combine pass) is the step that would fill
// the card; it is later work.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include "attention_tiles.cuh"

using namespace attn;

namespace {

template <int HD>
__global__ void __launch_bounds__(THREADS)
slab_decode_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc, const int* __restrict__ key_pos,
                   const int* __restrict__ q0_ptr, __nv_bfloat16* __restrict__ out, int P,
                   int n_keys, int li, long long q_rs, int kv_rs, float scale) {
  constexpr int OLD = FwdLayout<HD>::OLD;
  extern __shared__ __align__(128) unsigned char smem[];
  const FwdSmem<HD> sh(smem);
  int* skp = sh.extra;  // the key tile's positions

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int i0 = qt * BQ;                  // first query row of the tile
  const int q0 = *q0_ptr + i0;             // its absolute position
  const int qmax = q0 + min(BQ, P - i0) - 1;  // the tile's last query position

  const long long cache_off = ((long long)li * gridDim.z + b) * n_keys * kv_rs + h * HD;
  const __nv_bfloat16* qb = q + (long long)b * P * q_rs + h * HD;
  const __nv_bfloat16* kb = kc + cache_off;
  const __nv_bfloat16* vb = vc + cache_off;

  load_tile<HD>(sh.q, qb, q_rs, i0, P);
  __syncthreads();
  QFrag<HD> qf[HD / 16];  // this warp's 16 query rows stay in registers
  fwd_begin<HD>(sh, qf);
  __syncthreads();

  for (int k0 = 0; k0 < n_keys; k0 += BK) {
    const int kp = (tid < BK && k0 + tid < n_keys) ? key_pos[k0 + tid] : INT_MAX;
    if (tid < BK) skp[tid] = kp;
    // a barrier too: skp is visible after it, and the previous tile's reads
    // of the K/V tiles are done
    if (!__syncthreads_or(kp <= qmax)) continue;  // no query sees this tile
    load_tile<HD>(sh.k, kb, kv_rs, k0, n_keys);
    load_tile<HD>(sh.v, vb, kv_rs, k0, n_keys);
    __syncthreads();
    fwd_tile<HD>(sh, qf, scale, [&](int row, int col) { return skp[col] <= q0 + row; });
    __syncthreads();  // K/V tiles and positions are overwritten next
  }

  __nv_bfloat16* ob = out + (long long)b * P * HD * gridDim.y + h * HD;
  const long long o_rs = (long long)HD * gridDim.y;
  for (int e = tid; e < BQ * HD; e += THREADS) {
    const int r = e / HD;
    const int i = i0 + r;
    // every query sees at least its own key in the cache; a row that sees
    // none (not produced by the streaming path) is written as zeros
    if (i < P) {
      const float l = sh.l[r];
      ob[(long long)i * o_rs + e % HD] =
          __float2bfloat16(l > 0.f ? sh.o[r * OLD + e % HD] / l : 0.f);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* key_pos, const void* q0,
           void* out, int bs, int P, int n_heads, int n_keys, int li, long long q_rs, int kv_rs,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = FwdLayout<HD>::bytes;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(slab_decode_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  dim3 grid((P + BQ - 1) / BQ, n_heads, bs);
  slab_decode_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(key_pos),
      static_cast<const int*>(q0), static_cast<__nv_bfloat16*>(out), P, n_keys, li, q_rs, kv_rs,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: bf16 (bs, P, n_heads*head_dim), row stride q_rs (elements, a multiple
// of 8; 16-byte aligned); k/v: the contiguous bf16 caches (n_layers, bs,
// slots, P̂, kv_rs) with n_keys = slots*P̂ and kv_rs = n_heads*head_dim;
// key_pos: int32, at least n_keys entries; q0: int32 scalar on the device;
// out: bf16 (bs, P, n_heads*head_dim), contiguous.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int slab_decode_attention(const void* q, const void* k, const void* v,
                                     const void* key_pos, const void* q0, void* out, int bs,
                                     int P, int n_heads, int head_dim, int n_keys, int li,
                                     long long q_rs, int kv_rs, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(q, k, v, key_pos, q0, out, bs, P, n_heads, n_keys, li, q_rs, kv_rs, scale,
                        s);
    case 64:
      return launch<64>(q, k, v, key_pos, q0, out, bs, P, n_heads, n_keys, li, q_rs, kv_rs, scale,
                        s);
    case 128:
      return launch<128>(q, k, v, key_pos, q0, out, bs, P, n_heads, n_keys, li, q_rs, kv_rs,
                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
