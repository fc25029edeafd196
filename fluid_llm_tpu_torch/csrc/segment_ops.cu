// Segment sum and row gather for mesh-graph message passing, f32.
//
// Replaces the TPU kernels fluid_llm_tpu/ops/segment_sum_pallas.py:
// _scatter_kernel (reached through _scatter_call: edge rows summed into
// node rows) and _expand_kernel (through _expand_call: node rows copied out
// to edges).  On the TPU both are one-hot contractions on the MXU over a
// VMEM-resident window of node rows, with the f32 values split into three
// bf16 limbs; that design answers the TPU's serialized scatter and is not
// carried over.  Here they are what they compute: a sum and a copy.
//
// Semantics (ops/segment_ops.segment_sum_ref and gather_ref, exactly):
//   segment_sum:    out[r] = sum of values[e] over the edges e with id r, in
//                   ascending e; a row no edge names is 0
//   segment_gather: out[e] = nodes[id[e]], or 0 where id[e] is outside
//                   [0, n_rows)
// Ids are flat: batch element b's node i is row b * N + i, and an id
// outside its own element's [0, N) is -1 (ops/segment_ops.SegmentIndex).
//
// What bounds them on an H100: at the MeshGraphNet step (4 graphs of 3 529
// node rows and 20 480 edge rows, F 128) each call moves ~50 MB -- 42 MB
// of edge rows read or written once, 7 MB of node rows -- for one add per
// edge element, so bytes bound (~15 us at 3.35 TB/s).  At GAT's attention
// weights (F 1) a call moves 0.4 MB: only latency is left.  In both the
// time is set by the longest chain of dependent loads: each graph's ghost
// node row sums 132 padding edges (most rows 6), and the walk one edge at
// a time made its run a chain of two dependent loads an edge.
// Design:
// - the sum is deterministic and needs no atomics and no zero fill: the
//   wrapper sorts the ids once per id tensor (a stable sort, so each node's
//   edges stay in ascending order) into a CSR (row_ptr, perm); each output
//   element is one thread's f32 sum of its row's edges, added one at a time
//   in ascending edge order from 0, and written once.  Two calls on the
//   same inputs give the same bits (and those of the CPU's sequential
//   index_add_).  What changes with F is how the loads are issued, never
//   the order of the adds.
// - narrow rows (F < WIDE): a warp takes 32 consecutive (row, column)
//   slots, so the edges of its rows are one contiguous stretch of perm.  It
//   loads that stretch coalesced into shared memory, then the matching
//   values (LOADS loads a lane in flight together), and each lane adds its
//   own row's part from shared memory.  A stretch longer than the buffer
//   (CHUNK_EDGES edges, CHUNK_FLOATS values) is walked chunk after chunk.
//   The ghost row's chain is then that of any row: ~3 dependent loads.
// - wide rows (F >= WIDE): F / VEC threads a row, VEC columns each (F 128:
//   a warp a row; F 32: four rows a warp).  A row's run is walked in rounds
//   of ROUND edges: the round's perm entries were loaded with the previous
//   round's values, its ROUND value loads are all issued before the first
//   add, and the next round's value rows are prefetched into L2 meanwhile.
//   Rows whose run is longer than a round start first (the wrapper's
//   `order`: those rows, then the rest in row order), so the ghost rows'
//   17 rounds overlap the short rows instead of trailing them.
// - the value rows are read once: streaming loads (evict first).
// - the gather is a row copy: F / VEC threads per edge row, one id load
//   each (a broadcast within the row's threads), zero rows for id -1.
// VEC is 4 (16-byte loads and stores) where F % 4 == 0 and every pointer is
// 16-byte aligned, else 1 (F is 2 for mesh positions, 1 for the GAT
// attention weights).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;        // gather
constexpr int WIDE_THREADS = 128;   // sum over wide rows
constexpr int NARROW_THREADS = 64;  // sum over narrow rows: two warps a block
constexpr int WIDE = 32;            // F from which a row takes the wide walk
constexpr int ROUND = 8;            // a wide row's edges a round
constexpr int CHUNK_EDGES = 512;    // a narrow warp's staged edges ...
constexpr int CHUNK_FLOATS = 1024;  // ... and their values
constexpr int LOADS = 16;           // a narrow lane's staging loads in flight together

template <int VEC>
struct Vec;
template <>
struct Vec<1> {
  using T = float;
  __device__ static T zero() { return 0.f; }
  __device__ static T add(T a, T b) { return a + b; }
};
template <>
struct Vec<4> {
  using T = float4;
  __device__ static T zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static T add(T a, T b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
  }
};

// F < WIDE: thread t is slot (row t / F, column t % F); a warp's rows are
// the stretch [first, last] of consecutive rows.  FT > 0 fixes F at FT.
template <int FT>
__global__ void __launch_bounds__(NARROW_THREADS)
segment_sum_narrow_kernel(const float* __restrict__ values, const int* __restrict__ perm,
                          const int* __restrict__ row_ptr, float* __restrict__ out, int n_rows,
                          int F_) {
  const int F = FT > 0 ? FT : F_;
  __shared__ int s_perm[NARROW_THREADS / 32][CHUNK_EDGES];
  __shared__ float s_val[NARROW_THREADS / 32][CHUNK_FLOATS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long t0 = (long long)blockIdx.x * NARROW_THREADS + w * 32;  // the warp's first slot
  const long long first = t0 / F;
  if (first >= n_rows) return;  // the whole warp
  const long long last = min((t0 + 31) / F, (long long)n_rows - 1);
  const long long row = (t0 + lane) / F;
  const int c = (int)(t0 + lane - row * F);
  const bool mine = row < n_rows;
  const int s0 = row_ptr[first], s1 = row_ptr[last + 1];
  const int a = mine ? row_ptr[row] : 0, b = mine ? row_ptr[row + 1] : 0;
  const int per = min(CHUNK_EDGES, CHUNK_FLOATS / F);  // edges a chunk
  int* const sp = s_perm[w];
  float* const sv = s_val[w];
  float acc = 0.f;
  for (int cs = s0; cs < s1; cs += per) {
    const int n = min(per, s1 - cs), nf = n * F;
    for (int k0 = 0; k0 < n; k0 += 32 * LOADS) {  // the chunk's perm, coalesced
      int x[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int k = k0 + 32 * u + lane;
        x[u] = k < n ? perm[cs + k] : 0;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (k0 + 32 * u + lane < n) sp[k0 + 32 * u + lane] = x[u];
    }
    __syncwarp();
    for (int k0 = 0; k0 < nf; k0 += 32 * LOADS) {  // their values
      float x[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int k = k0 + 32 * u + lane;
        x[u] = k < nf ? __ldcs(values + (long long)sp[k / F] * F + k % F) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u)
        if (k0 + 32 * u + lane < nf) sv[k0 + 32 * u + lane] = x[u];
    }
    __syncwarp();
    const int j1 = min(b, cs + n);  // this lane's row's part of the chunk, ascending
    for (int j = max(a, cs); j < j1; ++j) acc += sv[(j - cs) * F + c];
    __syncwarp();  // the next chunk overwrites the buffers
  }
  if (mine) out[row * F + c] = acc;
}

// F >= WIDE: thread t takes VEC columns of row order[t / (F / VEC)].
template <int VEC>
__global__ void __launch_bounds__(WIDE_THREADS)
segment_sum_wide_kernel(const float* __restrict__ values, const int* __restrict__ perm,
                        const int* __restrict__ row_ptr, const int* __restrict__ order,
                        float* __restrict__ out, int n_rows, int F) {
  using V = Vec<VEC>;
  using T = typename V::T;
  const int lanes = F / VEC;
  const long long t = (long long)blockIdx.x * WIDE_THREADS + threadIdx.x;
  const long long slot = t / lanes;
  if (slot >= n_rows) return;
  const int c = (int)(t - slot * lanes);
  const long long row = order[slot];
  const int start = row_ptr[row], end = row_ptr[row + 1];
  int e[ROUND];
#pragma unroll
  for (int u = 0; u < ROUND; ++u) e[u] = start + u < end ? perm[start + u] : 0;
  T acc = V::zero();
  for (int j0 = start; j0 < end; j0 += ROUND) {
    int nxt[ROUND];  // the next round's edges
#pragma unroll
    for (int u = 0; u < ROUND; ++u) nxt[u] = j0 + ROUND + u < end ? perm[j0 + ROUND + u] : 0;
    T x[ROUND];
#pragma unroll
    for (int u = 0; u < ROUND; ++u)
      x[u] = j0 + u < end ? __ldcs(reinterpret_cast<const T*>(values + (long long)e[u] * F) + c)
                          : V::zero();
#pragma unroll
    for (int u = 0; u < ROUND; ++u)  // the next round's value rows on their way to L2
      if (j0 + ROUND + u < end)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(values + (long long)nxt[u] * F + c * VEC));
#pragma unroll
    for (int u = 0; u < ROUND; ++u)
      if (j0 + u < end) acc = V::add(acc, x[u]);
#pragma unroll
    for (int u = 0; u < ROUND; ++u) e[u] = nxt[u];
  }
  reinterpret_cast<T*>(out + row * F)[c] = acc;
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
segment_gather_kernel(const float* __restrict__ nodes, const int* __restrict__ ids,
                      float* __restrict__ out, long long M, int n_rows, int F) {
  using V = Vec<VEC>;
  const int lanes = F / VEC;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long e = t / lanes;
  if (e >= M) return;
  const int c = (int)(t - e * lanes);
  const int id = ids[e];
  typename V::T v = V::zero();
  if (id >= 0 && id < n_rows)
    v = reinterpret_cast<const typename V::T*>(nodes + (long long)id * F)[c];
  reinterpret_cast<typename V::T*>(out + e * F)[c] = v;
}

unsigned n_blocks(long long rows, int lanes, int threads = THREADS) {
  return (unsigned)((rows * lanes + threads - 1) / threads);
}

}  // namespace

// values: (M, F) f32 contiguous; perm: int32, the edge rows ordered by node
// (stable); row_ptr: int32 (n_rows + 1), node r's edges are
// perm[row_ptr[r] : row_ptr[r + 1]]; order: int32 (n_rows), a permutation
// of the rows, those with more than ROUND edges first (read where F >=
// WIDE); out: (n_rows, F) f32, every row written.  vectorized: F % 4 == 0
// and values/out 16-byte aligned.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int segment_sum_f32(const void* values, const void* perm, const void* row_ptr,
                               const void* order, void* out, int n_rows, int F, int vectorized,
                               void* stream) {
  if (F <= 0 || (vectorized && F % 4)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const int* p = static_cast<const int*>(perm);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ord = static_cast<const int*>(order);
  float* o = static_cast<float*>(out);
  if (F < WIDE) {
    const unsigned blocks = n_blocks(n_rows, F, NARROW_THREADS);
    if (F == 1)
      segment_sum_narrow_kernel<1><<<blocks, NARROW_THREADS, 0, s>>>(v, p, rp, o, n_rows, F);
    else
      segment_sum_narrow_kernel<0><<<blocks, NARROW_THREADS, 0, s>>>(v, p, rp, o, n_rows, F);
  } else if (vectorized) {
    segment_sum_wide_kernel<4><<<n_blocks(n_rows, F / 4, WIDE_THREADS), WIDE_THREADS, 0, s>>>(
        v, p, rp, ord, o, n_rows, F);
  } else {
    segment_sum_wide_kernel<1><<<n_blocks(n_rows, F, WIDE_THREADS), WIDE_THREADS, 0, s>>>(
        v, p, rp, ord, o, n_rows, F);
  }
  return (int)cudaGetLastError();
}

// nodes: (n_rows, F) f32 contiguous; ids: int32 (M,), -1 or outside
// [0, n_rows) for a zero row; out: (M, F) f32.  vectorized as above.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int segment_gather_f32(const void* nodes, const void* ids, void* out, long long M,
                                  int n_rows, int F, int vectorized, void* stream) {
  if (F <= 0 || (vectorized && F % 4)) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* n = static_cast<const float*>(nodes);
  const int* i = static_cast<const int*>(ids);
  float* o = static_cast<float*>(out);
  if (vectorized)
    segment_gather_kernel<4><<<n_blocks(M, F / 4), THREADS, 0, s>>>(n, i, o, M, n_rows, F);
  else
    segment_gather_kernel<1><<<n_blocks(M, F), THREADS, 0, s>>>(n, i, o, M, n_rows, F);
  return (int)cudaGetLastError();
}
