// int8-weight matmul, w8a8 and w8a16, forward only.
//
// Replaces the TPU kernels fluid_llm_tpu/ops/quant_matmul.py:_kernel_w8a8
// and :_kernel (w8a16), both launched by _qmm_2d: a (M/BM, N/BN, K/BK)
// Pallas grid with the K loop innermost, accumulating in VMEM scratch.  On
// the TPU the w8a8 activations were quantised and the scales applied by
// XLA outside the kernel; here one launch does all three.
//
// Semantics (ops/quant_matmul.int8_matmul_ref, exactly):
//   x: bf16 (M, K), row stride x_rs; q: int8 (N, K) contiguous (the
//   nn.Linear orientation); scale: f32 (N,); bias: f32 (N,) or null;
//   out: bf16 (M, N) contiguous.
//   w8a8:  sx[m] = absmax_k |x[m, k]| / 127 (1 where 0), f32, divided;
//          xq = clamp(rint(x / sx), -127, 127)  (round half to even);
//          acc = sum_k xq * q  (int32, exact);
//          y = bf16((float(acc) * sx[m]) * scale[n])
//   w8a16: acc = sum_k x * bf16(q)  (bf16 products, f32 sums);
//          y = bf16(acc * scale[n])
//   then, where there is a bias, out = bf16(y + bf16(bias[n])), as the
//   JAX _linear adds it after the cast.
//
// What bounds it on an H100 (3.35 TB/s, 1,979 int8 TOP/s, 989 bf16
// TFLOP/s): at the streaming step (M 60) a 768 x 768 linear is 0.59 MB of
// int8 weights (>= 0.18 us of HBM) for 2 x 60 operations a byte, far below
// the 295 a byte where the tensor cores would bound it; the call is too
// small to reach either, so its launch and the latency of its K loop bound
// it.  At the exact rollout (M 661) a step's linears are 112 G operations:
// tensor-core bound (>= 57 us in int8, >= 113 us in bf16 products).
//
// Design: a block computes a BM 64 x BN output tile, 4 warps of 16 rows
// each, with mma.sync (m16n8k32 s8 for w8a8, m16n8k16 bf16 for w8a16) on
// tiles staged in shared memory, rows padded by 16 bytes so the fragment
// loads hit 32 distinct banks.  BN is 16 where one row tile covers M (the
// decode: N 768 gives 48 blocks for 132 SMs, where 64 would give 12) and
// 64 where 64 still gives at least one block per SM (the 661-row rollout:
// a quarter of the activation tile's re-reads and, in w8a8, of its
// quantisation; on an H100 there 64 took 0.3-0.4x the time of 16 in w8a8, and
// in w8a16 0.6x at N 3072 and 1.07x at N 768).  w8a8 first takes each row's
// absmax over all K (the activations are a few hundred KB and sit in L2),
// then quantises the activation tile on its way into shared memory and
// applies both scales in the epilogue: one launch per linear, where the
// TPU path took three (quantise, kernel, rescale) on a step that is already
// launch bound.  w8a16 converts the int8 weight tile to bf16 on its way
// into shared memory.  At these sizes a call is a chain of dependent
// memory latencies, so the chain is kept short: a tile is 256 bytes deep
// (w8a8: K 256; w8a16: K 128), all its 16-byte loads are issued before any
// is used, and the absmax pass keeps a warp's rows' loads in flight
// together.  Every w8a8 block quantises the whole activation tile of its
// rows, so w8a8 blocks have 16 warps: all quantise, the first 4 multiply.
// No wgmma, TMA or multi-stage pipeline yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows of a block tile: 4 mma warps x 16
constexpr int THREADS = 128;  // w8a16
constexpr int THREADS8 = 512;  // w8a8: 16 warps quantise, the first 4 multiply
constexpr int SMS = 132;      // H100 SXM
constexpr int BK8 = 256;      // w8a8 K step: 8 x k32
constexpr int LD8 = BK8 + 16;   // bytes per shared row (68 words: conflict-free)
constexpr int BK16 = 128;     // w8a16 K step: 8 x k16
constexpr int LD16 = BK16 + 8;  // bf16 per shared row (68 words)
constexpr int A_LOADS8 = BM * BK8 / 8 / THREADS8;   // 16-byte loads per thread
constexpr int A_LOADS16 = BM * BK16 / 8 / THREADS;

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes at p if ok, else zeros (rows past M, K past its end contract to 0)
__device__ __forceinline__ uint4 ld128(const void* p, bool ok) {
  return ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
}

// round(q) half to even, clipped to [-127, 127], as the low byte of an
// int: adding 1.5 * 2^23 rounds q to an integer in the low mantissa bits
// (|q| < 2^22), one add in place of rint and a float-to-int conversion
__device__ __forceinline__ uint32_t int8_byte(float q) {
  const int r = __float_as_int(__fadd_rn(q, 12582912.f)) - 0x4B400000;
  return static_cast<uint32_t>(max(-127, min(127, r))) & 0xffu;
}

// 8 bf16 (16 bytes) quantised with the row's scale s: round(v / s) with
// the quotient of the IEEE division, packed into 8 bytes.  ``exact``
// divides; otherwise v * inv (inv = 1/s rounded) stands in for the
// quotient: within 2e-5 of it for |v / s| <= 127, so it rounds to the same
// integer unless it lies within 1e-4 of a half, which sets ``tie``.  The
// fast form has no branch, so the unrolled tile load keeps its
// instruction-level parallelism; the caller redoes a chunk with ``exact``
// only where ``tie`` was set.
__device__ __forceinline__ uint2 quant8(const uint4& v, float s, float inv, bool exact,
                                        bool& tie) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    float y0, y1;
    if (exact) {
      y0 = __fdiv_rn(f.x, s);
      y1 = __fdiv_rn(f.y, s);
    } else {
      y0 = __fmul_rn(f.x, inv);
      y1 = __fmul_rn(f.y, inv);
      tie |= (fabsf(y0 - floorf(y0) - 0.5f) < 1e-4f) | (fabsf(y1 - floorf(y1) - 0.5f) < 1e-4f);
    }
    w[j / 2] |= (int8_byte(y0) << (16 * (j % 2))) | (int8_byte(y1) << (16 * (j % 2) + 8));
  }
  return make_uint2(w[0], w[1]);
}

// The epilogue of one (row, column pair): y in f32 -> bf16, plus the bias.
__device__ __forceinline__ void store_pair(__nv_bfloat16* out, const float* bias, int n, float y0,
                                           float y1) {
  __nv_bfloat16 o0 = __float2bfloat16(y0), o1 = __float2bfloat16(y1);
  if (bias != nullptr) {
    o0 = __float2bfloat16(__bfloat162float(o0) + __bfloat162float(__float2bfloat16(bias[n])));
    o1 = __float2bfloat16(__bfloat162float(o1) + __bfloat162float(__float2bfloat16(bias[n + 1])));
  }
  __nv_bfloat162 pair;
  pair.x = o0;
  pair.y = o1;
  *reinterpret_cast<__nv_bfloat162*>(out) = pair;
}

template <int BN>
__global__ void __launch_bounds__(THREADS8)
qmm_w8a8_kernel(const __nv_bfloat16* __restrict__ x, long long x_rs,
                const int8_t* __restrict__ q, const float* __restrict__ scale,
                const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N,
                int K) {
  constexpr int NT = BN / 8;  // n8 tiles of each mma warp
  constexpr int B_LOADS = (BN * BK8 / 16 + THREADS8 - 1) / THREADS8;
  constexpr int ROWS = BM / (THREADS8 / 32);  // absmax rows of each warp
  __shared__ __align__(16) int8_t sa[BM * LD8];
  __shared__ __align__(16) int8_t sb[BN * LD8];
  __shared__ float ssx[BM], sinv[BM];  // each row's scale and its reciprocal

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // each row's activation scale: absmax over all of K, a warp's rows'
  // loads in flight together
  {
    float amax[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) amax[i] = 0.f;
    const int r0 = m0 + warp * ROWS;
    for (int k = lane * 8; k < K; k += 32 * 8) {
      uint4 v[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) v[i] = ld128(x + (long long)(r0 + i) * x_rs + k, r0 + i < M);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          amax[i] = fmaxf(amax[i], fmaxf(fabsf(f.x), fabsf(f.y)));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float a = amax[i];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a = fmaxf(a, __shfl_xor_sync(0xffffffffu, a, o));
      if (lane == 0) {
        const float sx = a > 0.f ? __fdiv_rn(a, 127.f) : 1.f;
        ssx[warp * ROWS + i] = sx;
        sinv[warp * ROWS + i] = __frcp_rn(sx);
      }
    }
  }
  __syncthreads();

  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK8) {
    // every global load of the tile first (16-byte vectors), then the
    // stores: the activation quantised (8 bf16 in, 8 int8 out)
    uint4 va[A_LOADS8], vb[B_LOADS];
#pragma unroll
    for (int i = 0; i < A_LOADS8; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 8), kc = (c % (BK8 / 8)) * 8;
      va[i] = ld128(x + (long long)(m0 + r) * x_rs + k0 + kc, m0 + r < M && k0 + kc < K);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 16), kc = (c % (BK8 / 16)) * 16;
      if (c < BN * BK8 / 16)
        vb[i] = ld128(q + (long long)(n0 + r) * K + k0 + kc, k0 + kc < K);
    }
    bool tie = false;
#pragma unroll
    for (int i = 0; i < A_LOADS8; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 8), kc = (c % (BK8 / 8)) * 8;
      *reinterpret_cast<uint2*>(sa + r * LD8 + kc) = quant8(va[i], ssx[r], sinv[r], false, tie);
    }
    if (tie) {  // rare: this thread's chunks again, dividing
      for (int i = 0; i < A_LOADS8; ++i) {
        const int c = tid + i * THREADS8, r = c / (BK8 / 8), kc = (c % (BK8 / 8)) * 8;
        *reinterpret_cast<uint2*>(sa + r * LD8 + kc) = quant8(va[i], ssx[r], sinv[r], true, tie);
      }
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS8, r = c / (BK8 / 16), kc = (c % (BK8 / 16)) * 16;
      if (c < BN * BK8 / 16) *reinterpret_cast<uint4*>(sb + r * LD8 + kc) = vb[i];
    }
    __syncthreads();
    if (warp < BM / 16) {
#pragma unroll
      for (int kk = 0; kk < BK8; kk += 32) {
        const int8_t* ar = sa + (warp * 16 + g) * LD8 + kk + t * 4;
        const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * LD8), ld32(ar + 16),
                               ld32(ar + 8 * LD8 + 16)};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int8_t* br = sb + (j * 8 + g) * LD8 + kk + t * 4;
          const uint32_t b[2] = {ld32(br), ld32(br + 16)};
          mma_s8(acc[j], a, b);
        }
      }
    }
    __syncthreads();
  }
  if (warp >= BM / 16) return;

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + t * 2;
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + hh * 8;
      if (m0 + r >= M) continue;
      const float sx = ssx[r];
      const float y0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * hh]), sx), s0);
      const float y1 = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][2 * hh + 1]), sx), s1);
      store_pair(out + (long long)(m0 + r) * N + n, bias, n, y0, y1);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
qmm_w8a16_kernel(const __nv_bfloat16* __restrict__ x, long long x_rs,
                 const int8_t* __restrict__ q, const float* __restrict__ scale,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N,
                 int K) {
  constexpr int NT = BN / 8;
  constexpr int B_LOADS = (BN * BK16 / 16 + THREADS - 1) / THREADS;
  __shared__ __align__(16) __nv_bfloat16 sa[BM * LD16];
  __shared__ __align__(16) __nv_bfloat16 sb[BN * LD16];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK16) {
    // every global load of the tile first, then the stores: the weight
    // converted to bf16 (16 int8 in, 16 bf16 out; exact, |q| <= 127)
    uint4 va[A_LOADS16], vb[B_LOADS];
#pragma unroll
    for (int i = 0; i < A_LOADS16; ++i) {
      const int c = tid + i * THREADS, r = c / (BK16 / 8), kc = (c % (BK16 / 8)) * 8;
      va[i] = ld128(x + (long long)(m0 + r) * x_rs + k0 + kc, m0 + r < M && k0 + kc < K);
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK16 / 16), kc = (c % (BK16 / 16)) * 16;
      if (c < BN * BK16 / 16)
        vb[i] = ld128(q + (long long)(n0 + r) * K + k0 + kc, k0 + kc < K);
    }
#pragma unroll
    for (int i = 0; i < A_LOADS16; ++i) {
      const int c = tid + i * THREADS, r = c / (BK16 / 8), kc = (c % (BK16 / 8)) * 8;
      *reinterpret_cast<uint4*>(sa + r * LD16 + kc) = va[i];
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int c = tid + i * THREADS, r = c / (BK16 / 16), kc = (c % (BK16 / 16)) * 16;
      if (c < BN * BK16 / 16) {
        const int8_t* b8 = reinterpret_cast<const int8_t*>(&vb[i]);
        __align__(16) __nv_bfloat16 w[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = __float2bfloat16(static_cast<float>(b8[j]));
        uint4* dst = reinterpret_cast<uint4*>(sb + r * LD16 + kc);
        dst[0] = reinterpret_cast<const uint4*>(w)[0];
        dst[1] = reinterpret_cast<const uint4*>(w)[1];
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      const __nv_bfloat16* ar = sa + (warp * 16 + g) * LD16 + kk + t * 2;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * LD16), ld32(ar + 8), ld32(ar + 8 * LD16 + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* br = sb + (j * 8 + g) * LD16 + kk + t * 2;
        const uint32_t b[2] = {ld32(br), ld32(br + 8)};
        mma_bf16(acc[j], a, b);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + j * 8 + t * 2;
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + g + hh * 8;
      if (m0 + r >= M) continue;
      store_pair(out + (long long)(m0 + r) * N + n, bias, n, __fmul_rn(acc[j][2 * hh], s0),
                 __fmul_rn(acc[j][2 * hh + 1], s1));
    }
  }
}

// BN 64 where that still gives one block per SM, else 16 (see the header)
bool wide(int M, int N) {
  const int m_tiles = (M + BM - 1) / BM;
  return N % 64 == 0 && m_tiles * (N / 64) >= SMS;
}

template <typename Kernel>
int launch(Kernel kernel, int bn, int threads, const void* x, long long x_rs, const void* q,
           const void* scale, const void* bias, void* out, int M, int N, int K,
           cudaStream_t stream) {
  dim3 grid(N / bn, (M + BM - 1) / BM);
  kernel<<<grid, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), x_rs, static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// x: bf16 (M, K) with row stride x_rs (elements, a multiple of 8; 16-byte
// aligned); q: int8 (N, K) contiguous; scale: f32 (N,); bias: f32 (N,) or
// null; out: bf16 (M, N) contiguous.  K a multiple of 128, N of 16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int quant_matmul_w8a8(const void* x, long long x_rs, const void* q, const void* scale,
                                 const void* bias, void* out, int M, int N, int K, void* stream) {
  if (K % 128 || N % 16 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(M, N))
    return launch(qmm_w8a8_kernel<64>, 64, THREADS8, x, x_rs, q, scale, bias, out, M, N, K, s);
  return launch(qmm_w8a8_kernel<16>, 16, THREADS8, x, x_rs, q, scale, bias, out, M, N, K, s);
}

extern "C" int quant_matmul_w8a16(const void* x, long long x_rs, const void* q, const void* scale,
                                  const void* bias, void* out, int M, int N, int K, void* stream) {
  if (K % 128 || N % 16 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide(M, N))
    return launch(qmm_w8a16_kernel<64>, 64, THREADS, x, x_rs, q, scale, bias, out, M, N, K, s);
  return launch(qmm_w8a16_kernel<16>, 16, THREADS, x, x_rs, q, scale, bias, out, M, N, K, s);
}
