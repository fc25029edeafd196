// Indexed linear: y = x @ w[li]^T from a stacked weight, forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/indexed_linear.py:_kernel,
// launched by _call: a Pallas grid over N blocks whose weight BlockSpec
// reads the layer index as a scalar prefetch, so only layer li's blocks
// leave HBM and no slice is copied first.  The stacked streaming scan
// (backbone.apply_streaming over backbone.stack_layers) runs every
// backbone linear through it.
//
// Semantics (ops/indexed_linear.indexed_linear_ref, without the bias):
//   x: bf16 (M, K), row stride x_rs; w: bf16 (n_layers, N, K) contiguous
//   (the nn.Linear orientation, layer-major); li: int32 on the device;
//   out: bf16 (M, N) contiguous,
//   out[m, n] = bf16(sum_k x[m, k] * w[li, n, k])  (f32 sums).
// The layer index is read by the kernel from device memory, as the TPU
// kernel reads its scalar prefetch: the host never learns it, so a step
// that keeps its layer counter on the device needs no synchronisation.  An
// index outside [0, n_layers) reads nothing and writes NaN.
//
// What bounds it on an H100 (3.35 TB/s, 989 bf16 TFLOP/s): at the
// streaming step (M 60) a layer's (768, 2304) qkv weight is 3.5 MB read
// for 2 x 60 operations a weight, 60 operations a byte, far below the 295
// a byte where the tensor cores would bound it: bytes bound (>= 1.1 us),
// and at these sizes bound in practice by the launch and the latency of
// the K loop.
//
// Design: the tile of the w8a16 kernel (quant_matmul.cu) without the int8
// conversion.  A block computes a 64-row x BN output tile, 4 warps of 16
// rows each, with mma.sync m16n8k16 bf16 (f32 accumulation) on tiles
// staged in shared memory, rows padded by 16 bytes so the fragment loads
// hit 32 distinct banks; rows past M load as zeros and are not stored.
// BN is 16: at the streaming step's 60 rows wider tiles would leave SMs
// idle (N 768 gives 48 blocks of 16 columns for 132 SMs, 12 of 64).  Each
// K step issues all its 16-byte loads before any is used.  The
// layer offset li*N*K is a 64-bit product: it passes 2^31 for a stacked
// LLaMA-7B weight.  No wgmma, TMA, split-K or multi-stage pipeline yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of a block tile: 4 warps x 16
constexpr int BN = 16;        // columns of a block tile: 2 x n8
constexpr int THREADS = 128;
constexpr int BK = 128;       // K step: 8 x k16
constexpr int LD = BK + 8;    // bf16 per shared row (68 words: conflict-free)
constexpr int A_LOADS = BM * BK / 8 / THREADS;  // 16-byte loads per thread: 8
constexpr int B_LOADS = BN * BK / 8 / THREADS;  // 2

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes at p if ok, else zeros (rows past M contract to 0)
__device__ __forceinline__ uint4 ld128(const void* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

__global__ void __launch_bounds__(THREADS)
indexed_linear_kernel(const __nv_bfloat16* __restrict__ x, long long x_rs,
                      const __nv_bfloat16* __restrict__ w, const int* __restrict__ li_ptr,
                      int n_layers, __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  constexpr int NT = BN / 8;  // n8 tiles of each warp
  __shared__ __align__(16) __nv_bfloat16 sa[BM * LD];
  __shared__ __align__(16) __nv_bfloat16 sb[BN * LD];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int li = *li_ptr;  // one word, the same for every thread of the grid

  if (li < 0 || li >= n_layers) {  // no layer to read: the tile is NaN
    for (int e = tid; e < BM * BN; e += THREADS) {
      const int r = e / BN;
      if (m0 + r < M) out[(long long)(m0 + r) * N + n0 + e % BN] = __float2bfloat16(NAN);
    }
    return;
  }
  const __nv_bfloat16* wl = w + (long long)li * N * K;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // every global load of the tile first (16-byte vectors), then the stores
    uint4 va[A_LOADS], vb[B_LOADS];
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      va[i] = ld128(x + (long long)(m0 + r) * x_rs + k0 + kc, m0 + r < M);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      vb[i] = ld128(wl + (long long)(n0 + r) * K + k0 + kc, true);
    }
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(sa + r * LD + kc) = va[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(sb + r * LD + kc) = vb[i];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      const __nv_bfloat16* ar = sa + (warp * 16 + g) * LD + kk + t * 2;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * LD), ld32(ar + 8), ld32(ar + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* br = sb + (j * 8 + g) * LD + kk + t * 2;
        const uint32_t b[2] = {ld32(br), ld32(br + 8)};
        mma_bf16(acc[j], a, b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + t * 2;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + hh * 8;
      if (m0 + r >= M) continue;
      __nv_bfloat162 pair;
      pair.x = __float2bfloat16(acc[j][2 * hh]);
      pair.y = __float2bfloat16(acc[j][2 * hh + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(m0 + r) * N + n) = pair;
    }
  }
}

}  // namespace

// x: bf16 (M, K) with row stride x_rs (elements, a multiple of 8; 16-byte
// aligned); w: bf16 (n_layers, N, K) contiguous; li: int32 on the device;
// out: bf16 (M, N) contiguous.  K and N multiples of 128.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int indexed_linear_bf16(const void* x, long long x_rs, const void* w, const void* li,
                                   int n_layers, void* out, int M, int N, int K, void* stream) {
  if (K % 128 || N % 128 || M <= 0 || n_layers <= 0) return (int)cudaErrorInvalidValue;
  dim3 grid(N / BN, (M + BM - 1) / BM);
  indexed_linear_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), x_rs, static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(li), n_layers, static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}
