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
// edge element, so bytes bound (~15 us at 3.35 TB/s).  Design:
// - the sum is deterministic and needs no atomics and no zero fill: the
//   wrapper sorts the ids once per id tensor (a stable sort, so each node's
//   edges stay in ascending order) into a CSR (row_ptr, perm), and the
//   F / VEC threads of one node row walk that row's edges in order, each
//   adding VEC features in f32, and write the row once.  Two calls on the
//   same inputs give the same bits.
// - the gather is a row copy: F / VEC threads per edge row, one id load
//   each (a broadcast within the row's threads), zero rows for id -1.
// VEC is 4 (16-byte loads and stores) where F % 4 == 0 and every pointer is
// 16-byte aligned, else 1 (F is 2 for mesh positions, 1 for the GAT
// attention weights).  With F 128 a node row is one warp.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

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

template <int VEC>
__global__ void __launch_bounds__(THREADS)
segment_sum_kernel(const float* __restrict__ values, const int* __restrict__ perm,
                   const int* __restrict__ row_ptr, float* __restrict__ out, int n_rows,
                   int F) {
  using V = Vec<VEC>;
  const int lanes = F / VEC;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long row = t / lanes;
  if (row >= n_rows) return;
  const int c = (int)(t - row * lanes);
  typename V::T acc = V::zero();
  const int end = row_ptr[row + 1];
  for (int j = row_ptr[row]; j < end; ++j) {
    const long long e = perm[j];
    acc = V::add(acc, reinterpret_cast<const typename V::T*>(values + e * F)[c]);
  }
  reinterpret_cast<typename V::T*>(out + row * F)[c] = acc;
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

unsigned n_blocks(long long rows, int lanes) {
  return (unsigned)((rows * lanes + THREADS - 1) / THREADS);
}

}  // namespace

// values: (M, F) f32 contiguous; perm: int32, the edge rows ordered by node
// (stable); row_ptr: int32 (n_rows + 1), node r's edges are
// perm[row_ptr[r] : row_ptr[r + 1]]; out: (n_rows, F) f32, every row
// written.  vectorized: F % 4 == 0 and values/out 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int segment_sum_f32(const void* values, const void* perm, const void* row_ptr,
                               void* out, int n_rows, int F, int vectorized, void* stream) {
  if (F <= 0 || (vectorized && F % 4)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const int* p = static_cast<const int*>(perm);
  const int* rp = static_cast<const int*>(row_ptr);
  float* o = static_cast<float*>(out);
  if (vectorized)
    segment_sum_kernel<4><<<n_blocks(n_rows, F / 4), THREADS, 0, s>>>(v, p, rp, o, n_rows, F);
  else
    segment_sum_kernel<1><<<n_blocks(n_rows, F), THREADS, 0, s>>>(v, p, rp, o, n_rows, F);
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
