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
// The backward reads xl, xr and g and writes dxl and dxr: five passes over
// a (Bf, X, Y, F) tensor, 118 MB each in bf16 at the training shape (80
// frames of 240 x 64, F 48), 590 MB in all, >= 0.176 ms at 3.35 TB/s; its
// ~70 f32 operations per element (>= 0.06 ms at 67 TFLOP/s) stay below that.
// Design: two launches, no atomics, no scratch of alpha/dlogit in HBM.
// 1. One block owns a strip of STRIP x-rows of one frame (and a tile of
//    columns, the whole row where it fits) and walks it row by row.  A
//    row's Y*F values are one contiguous run, so a producer warp copies
//    "units" -- unit j holds xl row x0 - 2 + j and xr and g row x0 - 3 + j
//    (xl rows x0 - 2 .. x1 + 1, xr and g rows x0 - 1 .. x1) -- with TMA bulk
//    copies (plain copies by its lanes where a run does not start and end on
//    16 bytes) into a ring of units on full/empty mbarriers.  A step reads
//    units j - 2 .. j only, so a ring of 5 keeps two units in flight.  At
//    step j, with unit j in shared memory, the consumer threads (256, or
//    fewer where a row has less work)
//    a. compute alpha and dlogit of row i = x0 - 3 + j (every 5-slot
//       softmax reads xl rows i - 1 .. i + 1 and xr, g of row i) into a
//       three-row ring in shared memory, and, for the strip's own rows,
//       write that row's dxr and add dlogit_s * e_s into each thread's
//       datt partial (registers);
//    b. write dxl of row i - 1, gathered from the stats of its +-x rows and
//       its +-y neighbours (rows i - 2 .. i of the ring) and xr, g of those
//       pixels.
//    Only the halo stat rows x0 - 1 and x1 (and the halo columns of a
//    column tile) are computed twice, by the two blocks that share them.
//    A pixel's C channels are split across `group` threads (chunks of 4
//    channels, interleaved), its dot products summed by xor shuffles
//    (the same bits in every thread of the group).  A slot off the grid
//    reads a pixel of zeros, so the channel loops have no branch.
// 2. datt: each block sums its threads' partials in pixel-slot order into
//    one row of `partial`; a second launch sums those rows, each thread a
//    stride of blocks in order, then a fixed tree: the same bits every run.
// What holds it back (PERF.md): issue, not bytes.  The three channel loops
// (logits, dxr and datt, dxl) take ~110 instructions an element at two
// blocks an SM (96 registers, ~106 KB of shared memory each), and their
// time adds to the copies' rather than hiding them: leaving out each loop
// saved 0.12-0.16 ms of the 0.55, the copies alone took 0.15.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

using namespace hopper;

namespace {

constexpr float NEG_SLOPE = 0.2f;
constexpr int THREADS = 256;

// VEC consecutive channels to / from f32: 8 or 4 bf16 (16 or 8 bytes), 4
// f32 (16 bytes), or one
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
  } else if constexpr (VEC == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x;
    out[1] = a.y;
    out[2] = b.x;
    out[3] = b.y;
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
  } else if constexpr (VEC == 4) {
    uint2 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
    h2[0] = __floats2bfloat162_rn(in[0], in[1]);
    h2[1] = __floats2bfloat162_rn(in[2], in[3]);
    *reinterpret_cast<uint2*>(p) = raw;
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
// backward: one walk down a strip of rows, then datt's reduction
// ---------------------------------------------------------------------------

constexpr int STRIP = 30;         // x-rows a block owns
constexpr int BWD_THREADS = 256;  // consumers at most; one more warp issues the copies
constexpr int STAT_RING = 3;      // rows of alpha/dlogit kept: i - 2 .. i at a step
constexpr int LIVE_UNITS = 3;     // units a step reads: j - 2 .. j
constexpr int DATT_THREADS = 256;
constexpr int SLOTS = 5;

// The backward's shared memory: the ring of `stages` units (3 row buffers
// of ytile + 4 pixels each: xl, xr, g; pixel y0 - 2 of a buffer at `pad`
// bytes, which puts pixel y0 on 16 bytes), which datt's per-thread partials
// reuse at the end; the alpha/dlogit ring (3 rows of ytile + 2 pixels x H
// x 10 f32); att (f32); a pixel of zeros, which masked slots read in place
// of a neighbour off the grid; a full and an empty mbarrier a unit; 128
// bytes of alignment slack.  ops/grid_gnn_fused.bwd_smem computes the same.
struct BwdSmem {
  int pad, buf, unit, ring, stats, att, zero, bytes;
  __host__ __device__ BwdSmem(int ytile, int stages, int H, int C, int group, int elem) {
    const int F = H * C;
    pad = (16 - 2 * F * elem % 16) % 16;
    buf = (pad + (ytile + 4) * F * elem + 15) / 16 * 16;
    unit = 3 * buf;
    const int red = BWD_THREADS / (H * group) * F * 4;
    ring = stages * unit > red ? stages * unit : red;
    stats = (STAT_RING * (ytile + 2) * H * 2 * SLOTS * 4 + 15) / 16 * 16;
    att = (F * 4 + 15) / 16 * 16;
    zero = (F * elem + 15) / 16 * 16;
    bytes = ring + stats + att + zero + 16 * stages + 128;
  }
};

template <typename T, int VEC, int NC>
__global__ void __launch_bounds__(BWD_THREADS + 32, 2)
grid_slot_bwd_kernel(const T* __restrict__ xl, const T* __restrict__ xr,
                     const float* __restrict__ att, const T* __restrict__ g, T* __restrict__ dxl,
                     T* __restrict__ dxr, float* __restrict__ partial, int X, int Y, int H, int C,
                     int ytile, int stages, int group, int nt, int bulk) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* const smem = smem_raw + (128 - smem_addr(smem_raw) % 128) % 128;
  const BwdSmem L(ytile, stages, H, C, group, (int)sizeof(T));
  const int F = H * C, ch = C / VEC, HG = H * group, PT = nt / HG;
  const int n_strips = (X + STRIP - 1) / STRIP, n_yt = (Y + ytile - 1) / ytile;
  const int ty = blockIdx.x % n_yt;
  const long long frame = (long long)(blockIdx.x / n_yt / n_strips) * X;  // row (b, 0)
  const int x0 = blockIdx.x / n_yt % n_strips * STRIP, x1 = min(x0 + STRIP, X);
  const int y0 = ty * ytile, y1 = min(y0 + ytile, Y);
  const int n_units = x1 - x0 + 4;  // rows x0 - 2 .. x1 + 1
  unsigned char* const ring = smem;
  float* const stats = reinterpret_cast<float*>(smem + L.ring);
  float* const att_s = reinterpret_cast<float*>(smem + L.ring + L.stats);
  T* const zero = reinterpret_cast<T*>(smem + L.ring + L.stats + L.att);
  const uint32_t full = smem_addr(smem) + L.ring + L.stats + L.att + L.zero;
  const uint32_t empty = full + 8 * stages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, bulk ? 1 : 32);  // the copies' lane 0, or every lane
      mbar_init(empty + 8 * s, 1);             // consumer 0, after a step's last barrier
    }
    mbar_init_fence();
  }
  for (int f = tid; f < F; f += blockDim.x) {
    const float z = 0.f;
    att_s[f] = att[f];
    store_vec<1>(zero + f, &z);
  }
  __syncthreads();

  // row buffers of unit j (xl row x0 - 2 + j; xr, g row x0 - 3 + j): pixel y
  // at (y - y0 + 2) * F
  auto row_buf = [&](int j, int which) {
    return reinterpret_cast<T*>(ring + (j % stages) * L.unit + which * L.buf + L.pad);
  };

  if (warp == nt / 32) {  // the copies
    if (bulk && lane != 0) return;
    const int ll = max(y0 - 2, 0), lh = min(y1 + 2, Y), rl = max(y0 - 1, 0), rh = min(y1 + 1, Y);
    for (int j = 0; j < n_units; ++j) {
      const int s = j % stages, round = j / stages, r = x0 - 2 + j;
      if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
      const bool has_l = r >= 0 && r < X, has_rg = r - 1 >= 0 && r - 1 < X && j >= 2;
      const long long row = (frame + r) * Y;  // pixel (b, r, 0)
      const int nl = has_l ? (lh - ll) * F : 0, nr = has_rg ? (rh - rl) * F : 0;
      T* const dl = row_buf(j, 0) + (ll - y0 + 2) * F;
      T* const dr = row_buf(j, 1) + (rl - y0 + 2) * F;
      T* const dg = row_buf(j, 2) + (rl - y0 + 2) * F;
      if (bulk) {
        const int bytes = (nl + 2 * nr) * (int)sizeof(T);
        if (bytes == 0) {
          mbar_arrive(full + 8 * s);
          continue;
        }
        mbar_expect(full + 8 * s, bytes);
        if (nl) bulk_copy(smem_addr(dl), xl + (row + ll) * F, nl * (int)sizeof(T), full + 8 * s);
        if (nr) {  // row r - 1
          bulk_copy(smem_addr(dr), xr + (row - Y + rl) * F, nr * (int)sizeof(T), full + 8 * s);
          bulk_copy(smem_addr(dg), g + (row - Y + rl) * F, nr * (int)sizeof(T), full + 8 * s);
        }
      } else {
        for (int e = lane; e < nl; e += 32) dl[e] = xl[(row + ll) * F + e];
        for (int e = lane; e < nr; e += 32) {
          dr[e] = xr[(row - Y + rl) * F + e];
          dg[e] = g[(row - Y + rl) * F + e];
        }
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  // consumer tid: pixel slot ps of a pass, head h, channel chunks sub + group k
  const int ps = tid / HG, h = tid / group % H, sub = tid % group;
  const bool active = tid < PT * HG;
  const int ncw = ytile + 2;  // stat columns y0 - 1 .. y1
  float dacc[NC][VEC];
#pragma unroll
  for (int k = 0; k < NC; ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) dacc[k][e] = 0.f;
  // alpha_s at [s], dlogit_s at [SLOTS + s] of stat row i, column y
  auto stat = [&](int i, int y) {
    return stats + (((i - x0 + 1) % STAT_RING) * ncw + (y - y0 + 1)) * H * 2 * SLOTS +
           h * 2 * SLOTS;
  };

  for (int j = 0; j < n_units; ++j) {
    mbar_wait(full + 8 * (j % stages), (j / stages) & 1);
    const int i = x0 - 3 + j;  // the stat row of this step
    if (j >= 2 && i >= 0 && i < X) {
      const bool own_row = i >= x0 && i < x1;
      const T* const L0 = row_buf(j - 1, 0);
      const T* const Ln[3] = {row_buf(j - 2, 0), L0, row_buf(j, 0)};  // xl rows i - 1 .. i + 1
      const T* const R0 = row_buf(j, 1);  // xr and g of row i
      const T* const G0 = row_buf(j, 2);
      const int sy0 = max(y0 - 1, 0), sy1 = min(y1 + 1, Y);
      for (int base = sy0; base < sy1; base += PT) {
        const int y = base + ps, yi = y - y0 + 2;
        const bool ok = active && y < sy1;
        // slot s of pixel (i, y) reads xl at (i, y) + shift_s; a slot off
        // the grid reads the zero pixel (its logit is masked, its gv is 0)
        const bool vs[SLOTS] = {true, i > 0, i < X - 1, y > 0, y < Y - 1};
        const T* const nb[SLOTS] = {L0 + yi * F, vs[1] ? Ln[0] + yi * F : zero,
                                    vs[2] ? Ln[2] + yi * F : zero,
                                    vs[3] ? L0 + (yi - 1) * F : zero,
                                    vs[4] ? L0 + (yi + 1) * F : zero};
        float lg[SLOTS], gv[SLOTS];
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) lg[q] = gv[q] = 0.f;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int c = sub + group * k;
          if (!ok || c >= ch) continue;
          const int off = h * C + c * VEC;
          float r[VEC], gg[VEC], a[VEC], v[SLOTS][VEC];
          load_vec<VEC>(R0 + yi * F + off, r);
          load_vec<VEC>(G0 + yi * F + off, gg);
          load_vec<VEC>(att_s + off, a);
#pragma unroll
          for (int q = 0; q < SLOTS; ++q) load_vec<VEC>(nb[q] + off, v[q]);
#pragma unroll
          for (int q = 0; q < SLOTS; ++q)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const float u = r[e] + v[q][e];
              lg[q] += fmaxf(u, NEG_SLOPE * u) * a[e];  // leaky_relu(u, 0.2)
              gv[q] += gg[e] * v[q][e];
            }
        }
        for (int o = 1; o < group; o <<= 1)
#pragma unroll
          for (int q = 0; q < SLOTS; ++q) {
            lg[q] += __shfl_xor_sync(0xffffffffu, lg[q], o);
            gv[q] += __shfl_xor_sync(0xffffffffu, gv[q], o);
          }
        if (!ok) continue;
        float m = -INFINITY;
#pragma unroll
        for (int q = 0; q < SLOTS; ++q)
          if (vs[q]) m = fmaxf(m, lg[q]);
        float w[SLOTS], denom = 0.f;
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) {
          w[q] = vs[q] ? __expf(lg[q] - m) : 0.f;
          denom += w[q];
        }
        const float inv = __frcp_rn(denom);
        float gbar = 0.f;
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) {
          w[q] *= inv;  // alpha_s, 0 for masked slots
          gbar += w[q] * gv[q];
        }
        float dl[SLOTS], dl_neg[SLOTS];  // dlogit_s, and times lrelu' where u <= 0
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) {
          dl[q] = w[q] * (gv[q] - gbar);
          dl_neg[q] = NEG_SLOPE * dl[q];
        }
        if (sub == 0) {
          float* const sp = stat(i, y);
#pragma unroll
          for (int q = 0; q < SLOTS; ++q) {
            sp[q] = w[q];
            sp[SLOTS + q] = dl[q];
          }
        }
        if (!own_row || y < y0 || y >= y1) continue;
        // dxr of an own pixel, and its share of datt
        T* const out = dxr + ((frame + i) * Y + y) * F;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int c = sub + group * k;
          if (c >= ch) continue;
          const int off = h * C + c * VEC;
          float r[VEC], o[VEC], a[VEC], v[SLOTS][VEC];
          load_vec<VEC>(R0 + yi * F + off, r);
          load_vec<VEC>(att_s + off, a);
#pragma unroll
          for (int q = 0; q < SLOTS; ++q) load_vec<VEC>(nb[q] + off, v[q]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = 0.f;
#pragma unroll
          for (int q = 0; q < SLOTS; ++q)  // masked slots: dlogit 0
#pragma unroll
            for (int e = 0; e < VEC; ++e) {  // d = dlogit_s lrelu'(u): dxr += d, datt += d u
              const float u = r[e] + v[q][e], d = u > 0.f ? dl[q] : dl_neg[q];
              o[e] += d;
              dacc[k][e] += d * u;
            }
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] *= a[e];
          store_vec<VEC>(out + off, o);
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");  // row i's stats written
    if (j >= 4) {  // dxl of row q = i - 1, an own row
      const int q = i - 1;
      // source slot s: the pixel p = (q, y) - shift_s whose slot s reads
      // (q, y): its unit and stat row (s 0, 3, 4: row q; 1: q + 1; 2: q - 1)
      const T* const Rs[3] = {row_buf(j - 2, 1), row_buf(j - 1, 1), row_buf(j, 1)};
      const T* const Gs[3] = {row_buf(j - 2, 2), row_buf(j - 1, 2), row_buf(j, 2)};
      const T* const Lq = row_buf(j - 2, 0);
      for (int base = y0; base < y1; base += PT) {
        const int y = base + ps, yi = y - y0 + 2;
        if (!active || y >= y1) continue;
        const int drow[SLOTS] = {1, 2, 0, 1, 1};  // index into Rs/Gs: rows q - 1, q, q + 1
        const int dcol[SLOTS] = {0, 0, 0, 1, -1};
        const bool vs[SLOTS] = {true, q + 1 < X, q > 0, y + 1 < Y, y > 0};
        float A[SLOTS], D[SLOTS], D_neg[SLOTS];
        const T* rp[SLOTS];  // xr and g of source s (the zero pixel off the grid)
        const T* gp[SLOTS];
#pragma unroll
        for (int s = 0; s < SLOTS; ++s) {
          A[s] = D[s] = 0.f;
          rp[s] = gp[s] = zero;
          if (vs[s]) {
            const float* sp = stat(q - 1 + drow[s], y + dcol[s]);
            A[s] = sp[s];
            D[s] = sp[SLOTS + s];
            rp[s] = Rs[drow[s]] + (yi + dcol[s]) * F;
            gp[s] = Gs[drow[s]] + (yi + dcol[s]) * F;
          }
          D_neg[s] = NEG_SLOPE * D[s];
        }
        T* const out = dxl + ((frame + q) * Y + y) * F;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int c = sub + group * k;
          if (c >= ch) continue;
          const int off = h * C + c * VEC;
          // o = sum A g, dd = sum dlogit lrelu'(u)
          float l[VEC], o[VEC], dd[VEC], a[VEC], rr[SLOTS][VEC], gg[SLOTS][VEC];
          load_vec<VEC>(Lq + yi * F + off, l);
          load_vec<VEC>(att_s + off, a);
#pragma unroll
          for (int s = 0; s < SLOTS; ++s) {
            load_vec<VEC>(rp[s] + off, rr[s]);
            load_vec<VEC>(gp[s] + off, gg[s]);
          }
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] = dd[e] = 0.f;
#pragma unroll
          for (int s = 0; s < SLOTS; ++s)
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              o[e] += A[s] * gg[s][e];
              dd[e] += rr[s][e] + l[e] > 0.f ? D[s] : D_neg[s];
            }
#pragma unroll
          for (int e = 0; e < VEC; ++e) o[e] += dd[e] * a[e];
          store_vec<VEC>(out + off, o);
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");  // the step's reads done
    if (j >= 2 && tid == 0) mbar_arrive(empty + 8 * ((j - 2) % stages));
  }

  // datt: the threads' partials (the ring is free) summed in pixel-slot order
  float* const red = reinterpret_cast<float*>(ring);
  if (active)
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const int c = sub + group * k;
      if (c >= ch) continue;
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[ps * F + h * C + c * VEC + e] = dacc[k][e];
    }
  asm volatile("bar.sync 1, %0;\n" ::"r"(nt) : "memory");
  for (int f = tid; f < F; f += nt) {
    float sum = 0.f;
    for (int p = 0; p < PT; ++p) sum += red[p * F + f];
    partial[(long long)blockIdx.x * F + f] = sum;
  }
}

// datt[f] = the blocks' partials: thread t sums blocks t, t + 256, ... in
// order, then a fixed tree over the threads
__global__ void __launch_bounds__(DATT_THREADS)
grid_slot_bwd_datt_kernel(const float* __restrict__ partial, float* __restrict__ datt,
                          int n_blocks, int F) {
  __shared__ float red[DATT_THREADS];
  const int f = blockIdx.x, t = threadIdx.x;
  float sum = 0.f;
  for (int b = t; b < n_blocks; b += DATT_THREADS) sum += partial[(long long)b * F + f];
  red[t] = sum;
  __syncthreads();
  for (int w = DATT_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) red[t] += red[t + w];
    __syncthreads();
  }
  if (t == 0) datt[f] = red[0];
}

template <typename T, int VEC, int NC>
int launch_bwd(const void* xl, const void* xr, const void* att, const void* g, void* dxl,
               void* dxr, void* datt, void* partial, int Bf, int X, int Y, int H, int C,
               int ytile, int stages, int group, cudaStream_t stream) {
  const int F = H * C;
  const BwdSmem L(ytile, stages, H, C, group, (int)sizeof(T));
  static bool attr_set = false;
  if (int e = allow_smem(grid_slot_bwd_kernel<T, VEC, NC>, SMEM_MAX, attr_set)) return e;
  if (L.bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // TMA bulk copies where every row run starts and ends on 16 bytes: whole
  // rows of Y * F elements, or column tiles of F-element pixels
  const bool bulk = (ytile >= Y ? (long long)Y * F * sizeof(T) % 16 == 0
                                : F * sizeof(T) % 16 == 0) &&
                    reinterpret_cast<uintptr_t>(xl) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(xr) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0;
  // consumers: enough for a row's pixels x heads x group, in whole warps
  const int want = ((ytile + 2) * H * group + 31) / 32 * 32;
  const int nt = want < BWD_THREADS ? want : BWD_THREADS;
  const long long n_blocks =
      (long long)Bf * ((X + STRIP - 1) / STRIP) * ((Y + ytile - 1) / ytile);
  if (n_blocks > 0) {
    grid_slot_bwd_kernel<T, VEC, NC><<<(unsigned)n_blocks, nt + 32, L.bytes, stream>>>(
        static_cast<const T*>(xl), static_cast<const T*>(xr), static_cast<const float*>(att),
        static_cast<const T*>(g), static_cast<T*>(dxl), static_cast<T*>(dxr),
        static_cast<float*>(partial), X, Y, H, C, ytile, stages, group, nt, bulk ? 1 : 0);
    if (cudaError_t e = cudaGetLastError()) return (int)e;
  }
  grid_slot_bwd_datt_kernel<<<F, DATT_THREADS, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(datt), (int)n_blocks, F);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_bwd_nc(int nc, const void* xl, const void* xr, const void* att, const void* g,
                  void* dxl, void* dxr, void* datt, void* partial, int Bf, int X, int Y, int H,
                  int C, int ytile, int stages, int group, cudaStream_t s) {
  if (nc <= 3)
    return launch_bwd<T, VEC, 3>(xl, xr, att, g, dxl, dxr, datt, partial, Bf, X, Y, H, C, ytile,
                                 stages, group, s);
  if (nc <= 4)
    return launch_bwd<T, VEC, 4>(xl, xr, att, g, dxl, dxr, datt, partial, Bf, X, Y, H, C, ytile,
                                 stages, group, s);
  if (nc <= 8)
    return launch_bwd<T, VEC, 8>(xl, xr, att, g, dxl, dxr, datt, partial, Bf, X, Y, H, C, ytile,
                                 stages, group, s);
  return (int)cudaErrorInvalidValue;
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
// (H, C), summed over frames; partial: f32 (blocks, H*C), blocks = Bf *
// ceil(X / 16) * ceil(Y / ytile).  The plan (ops/grid_gnn_fused.bwd_plan):
// ytile columns a block, a ring of `stages` (> 3) row units, `group`
// threads a (pixel, head) (a power of two <= 32).  Needs H*C <= 256.  Two
// launches; returns the first cudaGetLastError() that is not 0 (0 on
// success).
extern "C" int grid_slot_attention_bwd(const void* xl, const void* xr, const void* att,
                                       const void* g, void* dxl, void* dxr, void* datt,
                                       void* partial, int Bf, int X, int Y, int H, int C,
                                       int ytile, int stages, int group, int is_bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H <= 0 || C <= 0 || H * C > 256 || ytile <= 0 || stages <= LIVE_UNITS || group <= 0 ||
      group > 32 || (group & (group - 1)) || BWD_THREADS / (H * group) < 1)
    return (int)cudaErrorInvalidValue;
  const int vec = C % 4 == 0 ? 4 : 1, nc = (C / vec + group - 1) / group;
  if (is_bf16)
    return vec == 4 ? launch_bwd_nc<__nv_bfloat16, 4>(nc, xl, xr, att, g, dxl, dxr, datt, partial,
                                                      Bf, X, Y, H, C, ytile, stages, group, s)
                    : launch_bwd_nc<__nv_bfloat16, 1>(nc, xl, xr, att, g, dxl, dxr, datt, partial,
                                                      Bf, X, Y, H, C, ytile, stages, group, s);
  return vec == 4 ? launch_bwd_nc<float, 4>(nc, xl, xr, att, g, dxl, dxr, datt, partial, Bf, X, Y,
                                            H, C, ytile, stages, group, s)
                  : launch_bwd_nc<float, 1>(nc, xl, xr, att, g, dxl, dxr, datt, partial, Bf, X, Y,
                                            H, C, ytile, stages, group, s);
}
