// Tile geometry and helpers shared by the attention kernels
// (exact_attention.cu: forward, with or without the row logsumexp;
// flash_attention.cu: the dq and dk/dv backward kernels).
//
// q/k/v/dO are (bs, L, H*hd) bf16 with a row stride per tensor: element
// (b, t, h, d) sits at (b*L + t)*row_stride + h*hd + d.  A block works on
// 64-row tiles with 4 warps of 16 rows each; tiles are staged in shared
// memory with a padded row stride (no bank conflicts for WMMA loads).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace attn
