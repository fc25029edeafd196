// Five-slot grid GATv2 attention (the MLPGNN decoder's core), forward and
// backward.
//
// Replaces the TPU kernels fluid_llm_tpu/ops/grid_gnn_pallas.py:_fwd_kernel
// and :_bwd_kernel (Pallas, one channels-first frame per program,
// F-chunked phases).
//
// Per frame b, pixel p = (x, y) and head h, with slots s in
// {self, -x, +x, -y, +y} and v_s = xl[n_s(p)] (a C-vector):
//   u_s   = xr[p] + v_s,  e_s = leaky_relu(u_s, 0.2)
//   logit = e_s . att[h]        (slots off the grid edge are masked out)
//   a     = softmax_s(logit)
//   out   = sum_s a_s v_s
// Everything after the loads is f32; the result is rounded once on store.
//
// Backward (g = dL/dout; grid_gnn_pallas.py:17-21), with lrelu'(u) = 1 for
// u > 0 and 0.2 otherwise (0.2 at u == 0, as the TPU kernel's `u > 0` test):
//   dlogit_s = a_s (g[p].v_s - sum_t a_t g[p].v_t)
//   dxr[p]   = sum_s dlogit_s att * lrelu'(u_s)
//   dxl[q]   = sum over (p, s) with n_s(p) = q of
//              a_s(p) g[p] + dlogit_s(p) att * lrelu'(u_s(p))
//   datt     = sum over frames, pixels and slots of dlogit_s e_s
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
//
// The backward is four launches, all gathers (no atomics, deterministic):
//   1. stats: per (pixel, head) alpha_s and dlogit_s (f32 scratch,
//      (Bf, X, Y, H, 5), zero for masked slots), and dxr;
//   2. dxl: per (pixel q, head), gather from the <= 5 pixels p whose slot
//      s reads q (p = q - shift_s), using their alpha_s and dlogit_s;
//   3. datt partials: each block sums dlogit_s e_s over its range of
//      pixels for every channel, lanes reduced in a fixed order;
//   4. datt: the block partials summed in block order.
// At the training shapes (80 frames of 240 x 64, C 48) the floor is the
// reads of xl, xr and g and the writes of dxl, dxr: ~8 passes over a
// (Bf, X, Y, F) tensor, ~25 MB each in bf16.

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


// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
grid_slot_bwd_stats_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                           const float* __restrict__ att, const T* __restrict__ g,
                           float* __restrict__ alpha, float* __restrict__ dlogit,
                           T* __restrict__ dxr, int Bf, int X, int Y, int H, int C) {
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
  const T* gp = g + off;
  const float* a = att + (long long)h * C;

  float logit[5], gv[5];
  float m = -INFINITY;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    float acc = 0.f, accg = 0.f;
    if (ok[s]) {
      const T* vp = xlp + nb[s];
      for (int c = 0; c < C; c += VEC) {
        float r[VEC], vv[VEC], gg[VEC];
        load_vec<VEC>(xrp + c, r);
        load_vec<VEC>(vp + c, vv);
        load_vec<VEC>(gp + c, gg);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float u = r[i] + vv[i];
          acc += (u > 0.f ? u : NEG_SLOPE * u) * a[c + i];
          accg += gg[i] * vv[i];
        }
      }
      m = fmaxf(m, acc);
    }
    logit[s] = acc;
    gv[s] = accg;
  }
  float w[5];
  float denom = 0.f;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    w[s] = ok[s] ? __expf(logit[s] - m) : 0.f;
    denom += w[s];
  }
  float gbar = 0.f;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    w[s] /= denom;  // alpha_s, 0 for masked slots
    gbar += w[s] * gv[s];
  }
  float dl[5];
  float* ap = alpha + idx * 5;
  float* dp = dlogit + idx * 5;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    dl[s] = w[s] * (gv[s] - gbar);
    ap[s] = w[s];
    dp[s] = dl[s];
  }

  for (int c = 0; c < C; c += VEC) {
    float r[VEC], o[VEC];
    load_vec<VEC>(xrp + c, r);
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = 0.f;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (!ok[s]) continue;
      float vv[VEC];
      load_vec<VEC>(xlp + nb[s] + c, vv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] += dl[s] * (r[i] + vv[i] > 0.f ? 1.f : NEG_SLOPE);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] *= a[c + i];
    store_vec<VEC>(dxr + off + c, o);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
grid_slot_bwd_dxl_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                         const float* __restrict__ att, const T* __restrict__ g,
                         const float* __restrict__ alpha, const float* __restrict__ dlogit,
                         T* __restrict__ dxl, int Bf, int X, int Y, int H, int C) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long total = (long long)Bf * X * Y * H;
  if (idx >= total) return;
  const int h = (int)(idx % H);
  const long long q = idx / H;  // this thread's pixel: the neighbour being read
  const int y = (int)(q % Y);
  const int x = (int)((q / Y) % X);
  const long long F = (long long)H * C;
  const long long off = q * F + (long long)h * C;

  // slot s of pixel p reads q = p + shift_s, so q receives from p = q - shift_s
  const long long src[5] = {0, Y, -(long long)Y, 1, -1};  // p - q, in pixels
  const bool ok[5] = {true, x < X - 1, x > 0, y < Y - 1, y > 0};
  float A[5], D[5];
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const long long st = ((q + src[s]) * H + h) * 5 + s;
    A[s] = ok[s] ? alpha[st] : 0.f;
    D[s] = ok[s] ? dlogit[st] : 0.f;
  }
  const float* a = att + (long long)h * C;

  for (int c = 0; c < C; c += VEC) {
    float l[VEC], o[VEC];
    load_vec<VEC>(xl + off + c, l);
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = 0.f;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (!ok[s]) continue;
      const long long poff = off + src[s] * F;
      float r[VEC], gg[VEC];
      load_vec<VEC>(xr + poff + c, r);
      load_vec<VEC>(g + poff + c, gg);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o[i] += A[s] * gg[i] + D[s] * a[c + i] * (r[i] + l[i] > 0.f ? 1.f : NEG_SLOPE);
    }
    store_vec<VEC>(dxl + off + c, o);
  }
}

// One block per range of `pix_per_block` pixels; thread t sums channel
// f = t % F over the pixels lane, lane + lanes, ... of its range (lane =
// t / F, lanes = THREADS / F), then the first F threads add the lanes up
// in lane order.  Needs F <= THREADS.
template <typename T>
__global__ void __launch_bounds__(THREADS)
grid_slot_bwd_datt_partial_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                                  const float* __restrict__ dlogit, float* __restrict__ partial,
                                  long long n_pix, int X, int Y, int H, int C,
                                  int pix_per_block) {
  __shared__ float red[THREADS];
  const int F = H * C;
  const int lanes = THREADS / F;
  const int t = threadIdx.x;
  const int f = t % F;
  const int lane = t / F;
  const int h = f / C;
  float acc = 0.f;
  if (lane < lanes) {
    const long long p0 = (long long)blockIdx.x * pix_per_block;
    const long long p1 = min(n_pix, p0 + pix_per_block);
    const long long nb[5] = {0, -(long long)Y, Y, -1, 1};
    for (long long pix = p0 + lane; pix < p1; pix += lanes) {
      const int y = (int)(pix % Y);
      const int x = (int)((pix / Y) % X);
      const bool ok[5] = {true, x > 0, x < X - 1, y > 0, y < Y - 1};
      float r;
      load_vec<1>(xr + pix * F + f, &r);
      const float* dl = dlogit + (pix * H + h) * 5;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        if (!ok[s]) continue;
        float v;
        load_vec<1>(xl + (pix + nb[s]) * F + f, &v);
        const float u = r + v;
        acc += dl[s] * (u > 0.f ? u : NEG_SLOPE * u);
      }
    }
  }
  red[t] = acc;
  __syncthreads();
  if (t < F) {
    float sum = 0.f;
    for (int l = 0; l < lanes; ++l) sum += red[l * F + t];
    partial[(long long)blockIdx.x * F + t] = sum;
  }
}

__global__ void grid_slot_bwd_datt_reduce_kernel(const float* __restrict__ partial,
                                                 float* __restrict__ datt, int n_blocks, int F) {
  const int f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  float sum = 0.f;
  for (int b = 0; b < n_blocks; ++b) sum += partial[(long long)b * F + f];
  datt[f] = sum;
}

template <typename T, int VEC>
int launch_bwd(const void* xl, const void* xr, const void* att, const void* g, void* dxl,
               void* dxr, void* datt, void* alpha, void* dlogit, void* partial, int Bf, int X,
               int Y, int H, int C, int pix_per_block, cudaStream_t stream) {
  const long long total = (long long)Bf * X * Y * H;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  const T* xl_ = static_cast<const T*>(xl);
  const T* xr_ = static_cast<const T*>(xr);
  const T* g_ = static_cast<const T*>(g);
  const float* att_ = static_cast<const float*>(att);
  float* alpha_ = static_cast<float*>(alpha);
  float* dlogit_ = static_cast<float*>(dlogit);
  grid_slot_bwd_stats_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
      xl_, xr_, att_, g_, alpha_, dlogit_, static_cast<T*>(dxr), Bf, X, Y, H, C);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  grid_slot_bwd_dxl_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
      xl_, xr_, att_, g_, alpha_, dlogit_, static_cast<T*>(dxl), Bf, X, Y, H, C);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const long long n_pix = (long long)Bf * X * Y;
  const int n_blocks = (int)((n_pix + pix_per_block - 1) / pix_per_block);
  grid_slot_bwd_datt_partial_kernel<T><<<n_blocks, THREADS, 0, stream>>>(
      xl_, xr_, dlogit_, static_cast<float*>(partial), n_pix, X, Y, H, C, pix_per_block);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  const int F = H * C;
  grid_slot_bwd_datt_reduce_kernel<<<(F + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(datt), n_blocks, F);
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

// Backward of grid_slot_attention_fwd.  xl/xr/g/dxl/dxr: (Bf, X, Y, H*C)
// contiguous, bf16 (is_bf16 = 1) or f32 (0); att: f32 (H, C); datt: f32
// (H, C), summed over frames.  Scratch, f32: alpha and dlogit (Bf, X, Y, H,
// 5); partial (ceil(Bf*X*Y / pix_per_block), H*C).  Needs H*C <= 256.
// vectorized as for the forward.  Four launches; returns the first
// cudaGetLastError() that is not 0 (0 on success).
extern "C" int grid_slot_attention_bwd(const void* xl, const void* xr, const void* att,
                                       const void* g, void* dxl, void* dxr, void* datt,
                                       void* alpha, void* dlogit, void* partial, int Bf, int X,
                                       int Y, int H, int C, int pix_per_block, int is_bf16,
                                       int vectorized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H * C > THREADS || pix_per_block <= 0) return (int)cudaErrorInvalidValue;
  if (Bf * (long long)X * Y * H == 0) return 0;
  if (is_bf16) {
    return vectorized
               ? launch_bwd<__nv_bfloat16, 8>(xl, xr, att, g, dxl, dxr, datt, alpha, dlogit,
                                              partial, Bf, X, Y, H, C, pix_per_block, s)
               : launch_bwd<__nv_bfloat16, 1>(xl, xr, att, g, dxl, dxr, datt, alpha, dlogit,
                                              partial, Bf, X, Y, H, C, pix_per_block, s);
  }
  return vectorized ? launch_bwd<float, 4>(xl, xr, att, g, dxl, dxr, datt, alpha, dlogit,
                                           partial, Bf, X, Y, H, C, pix_per_block, s)
                    : launch_bwd<float, 1>(xl, xr, att, g, dxl, dxr, datt, alpha, dlogit,
                                           partial, Bf, X, Y, H, C, pix_per_block, s);
}
