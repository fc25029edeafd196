// Five-slot grid GATv2 attention (the MLPGNN decoder's core), forward only.
//
// Replaces the TPU kernel fluid_llm_tpu/ops/grid_gnn_pallas.py:_fwd_kernel
// (Pallas, one channels-first frame per program, F-chunked phases).
//
// Per frame b, pixel p = (x, y) and head h, with slots s in
// {self, -x, +x, -y, +y} and v_s = xl[n_s(p)] (a C-vector):
//   u_s   = leaky_relu(xr[p] + v_s, 0.2)
//   logit = u_s . att[h]        (slots off the grid edge are masked out)
//   a     = softmax_s(logit)
//   out   = sum_s a_s v_s
// Everything after the loads is f32; the result is rounded once on store.
//
// Layout: the public channels-last (Bf, X, Y, H*C), X the axis of -x/+x,
// exactly as ops/grid_gnn.py passes it.  No channels-first transpose.
//
// What bounds it on an H100: it is pure elementwise/stencil work, ~12 flops
// per loaded element, so memory bound -- one read of xl and xr and one
// write of out is the floor (~4.4 MB per conv at the rollout's
// (1, 240, 64, 48) bf16).  Design: one thread per (frame, pixel, head),
// heads then Y fastest, so a warp walks neighbouring pixels of one row and
// its loads of xl/xr cover contiguous memory; the 4 neighbour reads and
// the second pass over the slots hit L1.  Channels are read 16 bytes at a
// time when C allows it.  No intermediate ever reaches device memory.
// With bs 1 the grid is only 15,360 threads, so latency, not bandwidth,
// sets the time; splitting C across a thread group is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG_SLOPE = 0.2f;
constexpr int THREADS = 256;

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VEC == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else {
    out[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  if constexpr (VEC == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h2[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
    out[0] = __bfloat162float(p[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    p[0] = in[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* in) {
  if constexpr (VEC == 8) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h2[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    p[0] = __float2bfloat16(in[0]);
  }
}

// VEC: channels per load, 16 bytes (8 bf16 / 4 f32) when C and the pointers
// allow it, else 1.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
grid_slot_attention_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                           const float* __restrict__ att, T* __restrict__ out, int Bf, int X,
                           int Y, int H, int C) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long total = (long long)Bf * X * Y * H;
  if (idx >= total) return;
  const int h = (int)(idx % H);
  const long long pix = idx / H;  // (b * X + x) * Y + y
  const int y = (int)(pix % Y);
  const int x = (int)((pix / Y) % X);
  const long long F = (long long)H * C;
  const long long off = pix * F + (long long)h * C;

  const long long nb[5] = {0, -(long long)Y * F, (long long)Y * F, -F, F};
  const bool ok[5] = {true, x > 0, x < X - 1, y > 0, y < Y - 1};
  const T* xlp = xl + off;
  const T* xrp = xr + off;
  const float* a = att + (long long)h * C;

  float logit[5];
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    float acc = 0.f;
    if (ok[s]) {
      const T* vp = xlp + nb[s];
      for (int c = 0; c < C; c += VEC) {
        float r[VEC], vv[VEC];
        load_vec<VEC>(xrp + c, r);
        load_vec<VEC>(vp + c, vv);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float u = r[i] + vv[i];
          acc += (u > 0.f ? u : NEG_SLOPE * u) * a[c + i];
        }
      }
      m = fmaxf(m, acc);
    }
    logit[s] = acc;
  }
  float w[5];
  float denom = 0.f;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    w[s] = ok[s] ? __expf(logit[s] - m) : 0.f;
    denom += w[s];
  }
  const float inv = 1.f / denom;

  for (int c = 0; c < C; c += VEC) {
    float o[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = 0.f;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (!ok[s]) continue;
      float vv[VEC];
      load_vec<VEC>(xlp + nb[s] + c, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] += w[s] * vv[i];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] *= inv;
    store_vec<VEC>(out + off + c, o);
  }
}

template <typename T, int VEC>
int launch(const void* xl, const void* xr, const void* att, void* out, int Bf, int X, int Y,
           int H, int C, cudaStream_t stream) {
  const long long total = (long long)Bf * X * Y * H;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  grid_slot_attention_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(xl), static_cast<const T*>(xr), static_cast<const float*>(att),
      static_cast<T*>(out), Bf, X, Y, H, C);
  return (int)cudaGetLastError();
}

}  // namespace

// xl/xr/out: (Bf, X, Y, H*C) contiguous, bf16 (is_bf16 = 1) or f32 (0);
// att: f32 (H, C).  vectorized = 1 when C is a multiple of 16 bytes' worth
// of elements and every pointer is 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int grid_slot_attention_fwd(const void* xl, const void* xr, const void* att, void* out,
                                       int Bf, int X, int Y, int H, int C, int is_bf16,
                                       int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Bf * (long long)X * Y * H == 0) return 0;
  if (is_bf16) {
    return vectorized ? launch<__nv_bfloat16, 8>(xl, xr, att, out, Bf, X, Y, H, C, s)
                      : launch<__nv_bfloat16, 1>(xl, xr, att, out, Bf, X, Y, H, C, s);
  }
  return vectorized ? launch<float, 4>(xl, xr, att, out, Bf, X, Y, H, C, s)
                    : launch<float, 1>(xl, xr, att, out, Bf, X, Y, H, C, s);
}
