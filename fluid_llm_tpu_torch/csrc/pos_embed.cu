// The learned positions' add, out = h + ((x[ix] + y[iy]) + t[it]), and its
// gradient, in f32.
//
// Replaces no TPU kernel: the JAX package leaves the three gathers and the
// scatter-adds of their transpose to XLA (fluid_llm_tpu/models/
// embeddings.py, pos_embed).  On the card autograd through the plain
// indexing (ops/pos_embed.pos_embed_ref) runs three gathers and three adds
// forward and, backward, one index_put_(accumulate=True) a table: a sort of
// the ids, then one warp a run of equal ids and column slab, walking the
// run row after row.  The training step has R = 64 x 11 x 60 = 42 240 token
// rows at d 768 and only 15 + 4 + 11 = 30 distinct ids, so ~180 warps
// walk runs of up to 10 560 rows, and the gradient is read three times.
//
// Semantics (ops/pos_embed.pos_embed_ref, exactly forward):
//   out[r] = h[r] + ((x[ids[r][0]] + y[ids[r][1]]) + t[ids[r][2]])
//   dx[i]  = sum of g[r] over the rows r with ids[r][0] == i (dy, dt alike)
// ids: int64 (R, 3); a negative id counts from its table's end, as Python's
// indexing; an id outside [-n, n) stops the kernel with a device-side
// assert, as the twin's index kernel does on the card.
//
// What bounds them on an H100: bytes.  Forward, h read and out written
// once (2 x 129.8 MB at the training shape) and the tables (92 KB) from
// L2: ~0.08 ms at 3.35 TB/s.  Backward, the gradient read once (129.8 MB,
// ~0.04 ms) and the table gradients (92 KB) written once; the chunks'
// partial sums add a few MB more through L2.
// Design:
// - forward: one pass, FWD_ELEMS vectors a thread (16 bytes where d % 4 ==
//   0 and every pointer lies on 16 bytes, else one float), every load of
//   the thread in flight before its first store; the tables through the
//   read-only cache, h streamed (evict first).  The adds keep the twin's
//   order, so the result is the twin's bit for bit.
// - backward, pass 1 (pos_embed_grad_chunk_kernel): the parallelism is
//   over rows, not over distinct ids.  Block (chunk, slab) takes a chunk
//   of consecutive rows and a slab of `width` vector columns; thread j owns
//   column j of the slab in an accumulator of (nx + ny + nt) table rows x
//   width vectors in shared memory, so no two threads share a column and
//   no atomics are needed.  The block stages its rows' ids, ID_TILE rows at
//   a time, as accumulator rows; each thread keeps ROWS_AHEAD gradient
//   loads in flight and adds each row into its three table rows, rows in
//   ascending order.  The block writes its accumulator as the chunk's
//   partial sums.
// - backward, pass 2 (pos_embed_grad_sum_kernel): each table element is
//   the sum of its chunks' partials in chunk order from 0, written straight
//   into the table's gradient.  Both passes have a fixed order: the result
//   repeats bit for bit, and ops/pos_embed.grad_walk spells it out.
// - the plan (ops/pos_embed.grad_plan): the slab narrows until the
//   accumulator fits its shared-memory budget; the chunks are as many as
//   fill the card's SMs once.  dh is the incoming gradient itself.

#include <assert.h>
#include <cuda_runtime.h>

namespace {

constexpr int FWD_THREADS = 256;
constexpr int FWD_ELEMS = 4;      // vectors a forward thread moves
constexpr int ROWS_AHEAD = 8;     // gradient rows a pass-1 thread has in flight
constexpr int ID_TILE = 128;      // rows whose ids a pass-1 block stages at once
constexpr int WIDTH_MAX = 1024;   // pass-1 threads a block at most
constexpr int SUM_THREADS = 128;  // pass-2 threads a block
constexpr int SUM_AHEAD = 16;     // partials a pass-2 thread has in flight
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have (H100)

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static float zero() { return 0.f; }
  __device__ static float add(float a, float b) { return a + b; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float4 add(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

// an id's row in its table of n rows, as Python's indexing
__device__ __forceinline__ int table_row(long long id, int n) {
  if (id < 0) id += n;
  assert(id >= 0 && id < n);
  return (int)id;
}

// R * nv vectors of h (nv = d / VEC a row); thread i of block b moves
// vectors b * FWD_THREADS * FWD_ELEMS + i + k * FWD_THREADS
template <int VEC>
__global__ void __launch_bounds__(FWD_THREADS)
pos_embed_fwd_kernel(const typename Vec<VEC>::T* __restrict__ h,
                     const typename Vec<VEC>::T* __restrict__ x,
                     const typename Vec<VEC>::T* __restrict__ y,
                     const typename Vec<VEC>::T* __restrict__ t,
                     const long long* __restrict__ ids, typename Vec<VEC>::T* __restrict__ out,
                     long long n_vec, int nv, int nx, int ny, int nt) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const long long base = (long long)blockIdx.x * FWD_THREADS * FWD_ELEMS + threadIdx.x;
  T hv[FWD_ELEMS], a[FWD_ELEMS], b[FWD_ELEMS], c[FWD_ELEMS];
#pragma unroll
  for (int k = 0; k < FWD_ELEMS; ++k) {
    const long long i = base + (long long)k * FWD_THREADS;
    if (i < n_vec) {
      const long long r = i / nv;
      const int col = (int)(i - r * nv);
      const long long* id = ids + 3 * r;
      a[k] = __ldg(x + (long long)table_row(__ldg(id), nx) * nv + col);
      b[k] = __ldg(y + (long long)table_row(__ldg(id + 1), ny) * nv + col);
      c[k] = __ldg(t + (long long)table_row(__ldg(id + 2), nt) * nv + col);
      hv[k] = __ldcs(h + i);
    }
  }
#pragma unroll
  for (int k = 0; k < FWD_ELEMS; ++k) {
    const long long i = base + (long long)k * FWD_THREADS;
    if (i < n_vec) out[i] = V::add(hv[k], V::add(V::add(a[k], b[k]), c[k]));
  }
}

// Pass 1: block (chunk, slab) sums rows [chunk * rows, (chunk + 1) * rows)
// of g (R, nv vectors) into its accumulator rows and writes them to
// partial[chunk] (n_tab, nv vectors); blockDim.x == width.
template <int VEC>
__global__ void pos_embed_grad_chunk_kernel(const typename Vec<VEC>::T* __restrict__ g,
                                            const long long* __restrict__ ids,
                                            typename Vec<VEC>::T* __restrict__ partial, int R,
                                            int nv, int rows, int nx, int ny, int nt) {
  using V = Vec<VEC>;
  using T = typename V::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int width = blockDim.x, n_tab = nx + ny + nt, j = threadIdx.x;
  T* acc = reinterpret_cast<T*>(smem);                  // [n_tab][width]
  int* s_row = reinterpret_cast<int*>(acc + n_tab * width);  // [ID_TILE][3], in T
  const int col = blockIdx.y * width + j;
  const bool active = col < nv;
  for (int k = 0; k < n_tab; ++k) acc[k * width + j] = V::zero();
  const int r0 = blockIdx.x * rows, r1 = min(R, r0 + rows);
  for (int tile = r0; tile < r1; tile += ID_TILE) {
    const int n = min(ID_TILE, r1 - tile);
    __syncthreads();  // the previous tile's rows are added
    for (int i = j; i < 3 * n; i += width) {
      const int axis = i % 3;
      const int len = axis == 0 ? nx : axis == 1 ? ny : nt;
      const int first = axis == 0 ? 0 : axis == 1 ? nx : nx + ny;
      s_row[i] = (first + table_row(ids[3LL * tile + i], len)) * width;
    }
    __syncthreads();
    if (!active) continue;
    const T* gp = g + (long long)tile * nv + col;
    for (int u0 = 0; u0 < n; u0 += ROWS_AHEAD) {
      T v[ROWS_AHEAD];
#pragma unroll
      for (int u = 0; u < ROWS_AHEAD; ++u)
        if (u0 + u < n) v[u] = __ldcs(gp + (long long)(u0 + u) * nv);
#pragma unroll
      for (int u = 0; u < ROWS_AHEAD; ++u) {
        if (u0 + u >= n) break;
#pragma unroll
        for (int axis = 0; axis < 3; ++axis) {
          T* a = acc + s_row[3 * (u0 + u) + axis] + j;
          *a = V::add(*a, v[u]);
        }
      }
    }
  }
  if (!active) return;
  T* dst = partial + (long long)blockIdx.x * n_tab * nv + col;
  for (int k = 0; k < n_tab; ++k) dst[(long long)k * nv] = acc[k * width + j];
}

// Pass 2: thread (row k of the n_tab table rows, vector column) sums the
// chunks' partials in chunk order from 0 into its table's gradient.
template <int VEC>
__global__ void __launch_bounds__(SUM_THREADS)
pos_embed_grad_sum_kernel(const typename Vec<VEC>::T* __restrict__ partial,
                          typename Vec<VEC>::T* __restrict__ dx,
                          typename Vec<VEC>::T* __restrict__ dy,
                          typename Vec<VEC>::T* __restrict__ dt, int chunks, int nv, int nx,
                          int ny, int nt) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int n_tab = nx + ny + nt;
  const int i = blockIdx.x * SUM_THREADS + threadIdx.x;
  if (i >= n_tab * nv) return;
  const int k = i / nv, col = i - k * nv;
  const T* p = partial + (long long)k * nv + col;
  const long long step = (long long)n_tab * nv;
  T s = V::zero();
  for (int c0 = 0; c0 < chunks; c0 += SUM_AHEAD) {
    T v[SUM_AHEAD];
#pragma unroll
    for (int u = 0; u < SUM_AHEAD; ++u)
      if (c0 + u < chunks) v[u] = __ldcs(p + (c0 + u) * step);
#pragma unroll
    for (int u = 0; u < SUM_AHEAD; ++u)
      if (c0 + u < chunks) s = V::add(s, v[u]);
  }
  T* dst = k < nx ? dx + (long long)k * nv : k < nx + ny ? dy + (long long)(k - nx) * nv
                                                          : dt + (long long)(k - nx - ny) * nv;
  dst[col] = s;
}

template <int VEC>
int fwd(const void* h, const void* x, const void* y, const void* t, const void* ids, void* out,
        long long R, int d, int nx, int ny, int nt, cudaStream_t s) {
  using T = typename Vec<VEC>::T;
  const int nv = d / VEC;
  const long long n_vec = R * nv;
  const long long per = (long long)FWD_THREADS * FWD_ELEMS;
  pos_embed_fwd_kernel<VEC><<<(unsigned)((n_vec + per - 1) / per), FWD_THREADS, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(t), static_cast<const long long*>(ids), static_cast<T*>(out), n_vec,
      nv, nx, ny, nt);
  return (int)cudaGetLastError();
}

template <int VEC>
int grad(const void* g, const void* ids, void* partial, void* dx, void* dy, void* dt, int R,
         int d, int nx, int ny, int nt, int width, int rows, cudaStream_t s) {
  using T = typename Vec<VEC>::T;
  const int nv = d / VEC, n_tab = nx + ny + nt;
  const size_t smem = (size_t)n_tab * width * sizeof(T) + ID_TILE * 3 * sizeof(int);
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(pos_embed_grad_chunk_kernel<VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int chunks = (R + rows - 1) / rows, slabs = (nv + width - 1) / width;
  pos_embed_grad_chunk_kernel<VEC><<<dim3(chunks, slabs), width, smem, s>>>(
      static_cast<const T*>(g), static_cast<const long long*>(ids), static_cast<T*>(partial), R,
      nv, rows, nx, ny, nt);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_out = n_tab * nv;
  pos_embed_grad_sum_kernel<VEC><<<(n_out + SUM_THREADS - 1) / SUM_THREADS, SUM_THREADS, 0, s>>>(
      static_cast<const T*>(partial), static_cast<T*>(dx), static_cast<T*>(dy),
      static_cast<T*>(dt), chunks, nv, nx, ny, nt);
  return (int)cudaGetLastError();
}

}  // namespace

// h, out: f32 (R, d) contiguous; x, y, t: f32 (nx, d), (ny, d), (nt, d)
// contiguous; ids: int64 (R, 3) contiguous.  vec: 4 where d % 4 == 0 and
// every pointer lies on 16 bytes, else 1.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int pos_embed_fwd(const void* h, const void* x, const void* y, const void* t,
                             const void* ids, void* out, long long R, int d, int nx, int ny,
                             int nt, int vec, void* stream) {
  if (d <= 0 || nx <= 0 || ny <= 0 || nt <= 0 || (vec != 1 && vec != 4) || d % vec)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? fwd<4>(h, x, y, t, ids, out, R, d, nx, ny, nt, s)
                  : fwd<1>(h, x, y, t, ids, out, R, d, nx, ny, nt, s);
}

// g: f32 (R, d) contiguous; ids: int64 (R, 3) contiguous; partial: f32
// (ceil(R / rows), nx + ny + nt, d) scratch; dx, dy, dt: f32 (nx, d),
// (ny, d), (nt, d), every element written.  The plan
// (ops/pos_embed.grad_plan): `width` vectors a slab (1 to WIDTH_MAX, the
// threads of a pass-1 block), `rows` rows a chunk.  vec as for the
// forward (g, partial and the three outputs).  Two launches.
extern "C" int pos_embed_grad(const void* g, const void* ids, void* partial, void* dx, void* dy,
                              void* dt, int R, int d, int nx, int ny, int nt, int vec, int width,
                              int rows, void* stream) {
  if (d <= 0 || nx <= 0 || ny <= 0 || nt <= 0 || (vec != 1 && vec != 4) || d % vec ||
      width < 1 || width > WIDTH_MAX || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec == 4 ? grad<4>(g, ids, partial, dx, dy, dt, R, d, nx, ny, nt, width, rows, s)
                  : grad<1>(g, ids, partial, dx, dy, dt, R, d, nx, ny, nt, width, rows, s);
}
