// Segment sum and row gather for mesh-graph message passing, f32 and bf16.
//
// Replaces the TPU kernels fluid_llm_tpu/ops/segment_sum_pallas.py:
// _scatter_kernel (reached through _scatter_call: edge rows summed into
// node rows) and _expand_kernel (through _expand_call: node rows copied out
// to edges).  On the TPU both are one-hot contractions on the MXU over a
// VMEM-resident window of node rows, with the f32 values split into three
// bf16 limbs; that design answers the TPU's serialized scatter and is not
// carried over.  Here they are what they compute: a sum and a copy.
//
// Element types: f32, and bf16 as the TPU kernels also take
// (segment_sum_pallas.py:79-82, one MXU pass with f32 accumulation; :204, a
// bf16 gather stays bf16).  One source templated on the element type: the
// bf16 sum adds each element's edges in f32, in the same order as the f32
// kernel, and rounds once (to nearest even) at the store; the bf16 gather
// copies bytes.  A thread's vector is 16 bytes where the rows allow: 4 f32
// or 8 bf16 elements.
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
// weights (F 1) and MGN's positions (F 2) a call moves under 1 MB: only
// latency is left.  The sum's time is set by the longest chain of
// dependent loads: each graph's ghost node row sums 132 padding edges
// (most rows 6), and the walk one edge at a time made its run a chain of
// two dependent loads an edge.  The gather's chain is an edge's id, then
// its row: a thread that loads one row has one load in flight.
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
// - bf16 rows of whole 16-byte vectors (F >= WIDE, F % 8 == 0) take a ring
//   of bulk copies instead (segment_sum_ring_kernel).  In the wide walk a
//   thread holds ROUND 16-byte loads, and a 16-byte vector is 8 bf16
//   elements against 4 f32: a bf16 row has half the threads and half the
//   bytes in flight of an f32 one, and the ghost rows' 17 rounds each wait
//   a load's latency.  In the ring the lanes of a warp ask the copy engine
//   for whole edge rows (cp.async.bulk into shared memory: 256 bytes at F
//   128, 1 KiB at F 512), K stream positions a stage, counted on the
//   stage's mbarrier, S stages a warp; the lanes add a stage in f32 out of
//   shared memory and hand it back.  A warp keeps S K edge rows in flight,
//   set by the plan (ops/segment_ops.sum_plan) and not by the element
//   width or the registers.  Three things the card showed (PERF.md):
//   many 256-byte copies keep the copy engine busier than fewer long ones,
//   so consecutive edge rows (a row's edges by senders, the ghost rows'
//   padding edges) go as one copy; the ghost rows' chain of loads
//   (order, row_ptr, perm, the copies) sets the end, so the first
//   LONG_BLOCKS rows of the long-first order each take a block whose W
//   rings are one ring of all their edges; and the perm entries of the
//   next CHUNKS * 32 stream positions are loaded ahead, not one chunk at a
//   time.  A warp takes R rows strided over the grid; rows wider than
//   RING_SLICE bytes are cut into slices, one task each.  The adds keep
//   the wide walk's order.
// - the gather is a row copy, zero rows for ids out of range, in VEC-wide
//   vectors: 4 (16 bytes) where F % 4 == 0 and both pointers are 16-byte
//   aligned, 2 (8 bytes) where F % 2 == 0 and they are 8-byte aligned, else
//   1; nv = F / VEC vectors a row.  Ids come in with coalesced streaming
//   loads.  Where a row is one vector (GAT's weights, F 1; MGN's positions,
//   F 2 in 8 bytes) a lane owns whole rows: a warp's tile is 32 * `depth`
//   edges, lane l's are l + 32 u, and their ids, then their rows, are all in
//   flight before the first store -- one warp instruction moves 32 rows.
//   Wider rows (F 128: one 512-byte row a warp instruction) take tiles of 32
//   edges, one id a lane, handed round by __shfl_sync; lane l takes the
//   tile's vector slots l + 32 t (edge s / nv, column s % nv, so a warp's
//   store writes 32 consecutive vectors) and issues `depth` row loads before
//   their stores: the id-then-row chain is paid once a tile, not once a
//   row.  The node table (7 MB) stays in L2: cached loads; the output is
//   stored with the default policy, since the next GEMM reads it.  Warps
//   walk the tiles grid-stride (ops/segment_ops.gather_plan: the depth, the
//   warps a block and the blocks: one tile a warp, the sweep's choice).
//   What holds it back (an H100 SXM at 700 W, the kernel with parts left
//   out; PERF.md): at F 128 the writes.  Ids and 42 MB of zero rows alone
//   take 0.0154 ms, Tensor.fill_ of the same output 0.0149, the gather
//   0.0204 against a bound of 0.0148: the row loads add ~5 us beside the
//   writes at every depth from 2 to 16 (within 0.002 ms).  At F 2 the
//   launch: fill_ of the 0.66 MB output takes 0.0018-0.0020 ms, the gather
//   0.0022-0.0024 (at F 1 0.0023-0.0025).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int GATHER_DEPTH = 16;    // a gathering lane's loads in flight at most
constexpr int WIDE_THREADS = 128;   // sum over wide rows
constexpr int NARROW_THREADS = 64;  // sum over narrow rows: two warps a block
constexpr int WIDE = 32;            // F from which a row takes the wide walk
constexpr int ROUND = 8;            // a wide row's edges a round
constexpr int CHUNK_EDGES = 512;    // a narrow warp's staged edges ...
constexpr int CHUNK_FLOATS = 1024;  // ... and their values (as f32)
constexpr int LOADS = 16;           // a narrow lane's staging loads in flight together
constexpr int RING_SLICE = 1024;    // bytes of a row one task of the bf16 ring covers at most
constexpr int RING_WARPS = 16;      // the bf16 ring's warps a block at most
constexpr int LONG_BLOCKS = 16;     // the bf16 ring's blocks of one long row each
constexpr int CHUNKS = 8;           // a ring warp's chunks of 32 copy sources fetched ahead
constexpr unsigned FULL = 0xffffffffu;

// The element types: their bits in memory, and the exact widening to f32
// and the one rounding back.
struct F32 {
  using Bits = float;
  __device__ static float to_f(float b) { return b; }
  __device__ static float from_f(float x) { return x; }
};
struct BF16 {
  using Bits = unsigned short;
  __device__ static float to_f(unsigned short b) { return __uint_as_float((unsigned)b << 16); }
  __device__ static unsigned short from_f(float x) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
};

// The register type of a load or store of BYTES bytes.
template <int BYTES>
struct Raw;
template <>
struct Raw<2> {
  using T = unsigned short;
};
template <>
struct Raw<4> {
  using T = unsigned int;
};
template <>
struct Raw<8> {
  using T = uint2;
};
template <>
struct Raw<16> {
  using T = uint4;
};

// VEC consecutive elements of one row, moved as one load or store.
template <class E, int VEC>
struct alignas(VEC * sizeof(typename E::Bits)) Pack {
  using Bits = typename E::Bits;
  using R = typename Raw<VEC * sizeof(Bits)>::T;
  Bits e[VEC];
  __device__ static Pack load_cs(const Bits* p) {  // read once: evict first
    Pack v;
    *reinterpret_cast<R*>(&v) = __ldcs(reinterpret_cast<const R*>(p));
    return v;
  }
  __device__ static Pack zero() {
    Pack v;
    *reinterpret_cast<R*>(&v) = R{};
    return v;
  }
  __device__ void store(Bits* p) const {
    *reinterpret_cast<R*>(p) = *reinterpret_cast<const R*>(this);
  }
};

// F < WIDE: thread t is slot (row t / F, column t % F); a warp's rows are
// the stretch [first, last] of consecutive rows.  FT > 0 fixes F at FT.
template <class E, int FT>
__global__ void __launch_bounds__(NARROW_THREADS)
segment_sum_narrow_kernel(const typename E::Bits* __restrict__ values, const int* __restrict__ perm,
                          const int* __restrict__ row_ptr, typename E::Bits* __restrict__ out,
                          int n_rows, int F_) {
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
    for (int k0 = 0; k0 < nf; k0 += 32 * LOADS) {  // their values, widened to f32
      float x[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int k = k0 + 32 * u + lane;
        x[u] = k < nf ? E::to_f(__ldcs(values + (long long)sp[k / F] * F + k % F)) : 0.f;
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
  if (mine) out[row * F + c] = E::from_f(acc);
}

// F >= WIDE: thread t takes VEC columns of row order[t / (F / VEC)].
template <class E, int VEC>
__global__ void __launch_bounds__(WIDE_THREADS)
segment_sum_wide_kernel(const typename E::Bits* __restrict__ values, const int* __restrict__ perm,
                        const int* __restrict__ row_ptr, const int* __restrict__ order,
                        typename E::Bits* __restrict__ out, int n_rows, int F) {
  using P = Pack<E, VEC>;
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
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int j0 = start; j0 < end; j0 += ROUND) {
    int nxt[ROUND];  // the next round's edges
#pragma unroll
    for (int u = 0; u < ROUND; ++u) nxt[u] = j0 + ROUND + u < end ? perm[j0 + ROUND + u] : 0;
    P x[ROUND];
#pragma unroll
    for (int u = 0; u < ROUND; ++u)
      x[u] = j0 + u < end ? P::load_cs(values + (long long)e[u] * F + c * VEC) : P::zero();
#pragma unroll
    for (int u = 0; u < ROUND; ++u)  // the next round's value rows on their way to L2
      if (j0 + ROUND + u < end)
        asm volatile("prefetch.global.L2 [%0];" ::"l"(values + (long long)nxt[u] * F + c * VEC));
#pragma unroll
    for (int u = 0; u < ROUND; ++u)
      if (j0 + u < end) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += E::to_f(x[u].e[k]);
      }
#pragma unroll
    for (int u = 0; u < ROUND; ++u) e[u] = nxt[u];
  }
  P o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.e[k] = E::from_f(acc[k]);
  o.store(out + row * F + c * VEC);
}

// PB bytes of a row (PB / 2 bf16 elements, two a word), as one shared-memory
// load or global store
template <int PB>
struct alignas(PB) Words {
  unsigned w[PB / 4];
};

// bf16 rows of whole 16-byte vectors, F >= WIDE: a ring of bulk copies.
// Task t is the slice of row order[t / slices] from byte (t % slices) *
// RING_SLICE.  Blocks 0 .. LONG_BLOCKS - 1 take tasks 0 .. LONG_BLOCKS -
// 1, the long rows (`order` starts with them), one each on the block's
// warp 0 with the block's W rings as one ring of W S stages: the whole run
// of a ghost row in flight at once.  In the other blocks warp g of the G
// takes tasks LONG_BLOCKS + g, LONG_BLOCKS + g + G, ... (at most R, one a
// lane's registers).  A warp's stream is its tasks' edges one after
// another; stage st of its ring holds stream positions K st .. K st + K -
// 1, each the edge row's slice, one bulk copy for each run of consecutive
// edge rows, counted on the stage's mbarrier (a long row's block stages 32
// positions where its ring allows).  A stage is refilled with stage st + S
// as soon as the warp has added it, so S K rows of the warp are in flight
// whatever the element width.  Lane l adds pieces l, l + 32, ... (JP of PB
// bytes) of each slice from shared memory in f32, the edges in stream
// order (UNROLL at a time where the task has them): each element's edges
// ascending from 0, rounded once at the store.  The copies' edge rows come
// from perm 32 stream positions at a time, a lane's entry each, fetched
// CHUNKS chunks ahead and handed to the copying lanes by shuffles.
template <int PB, int JP>
__global__ void __launch_bounds__(32 * RING_WARPS)
segment_sum_ring_kernel(const unsigned char* __restrict__ values, const int* __restrict__ perm,
                        const int* __restrict__ row_ptr, const int* __restrict__ order,
                        unsigned char* __restrict__ out, int n_rows, int F, int K, int S, int R,
                        int G) {
  constexpr int UNROLL = 4 / JP;  // edges loaded before their adds
  extern __shared__ __align__(16) unsigned char smem[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int RB = 2 * F, SB = min(RB, RING_SLICE), slices = (RB + SB - 1) / SB;
  const uint32_t bars0 = hopper::smem_addr(smem) + W * S * K * SB;
  long long first, stride;
  unsigned char* ring;
  uint32_t bars;
  if (blockIdx.x < LONG_BLOCKS) {  // a long row: the block's rings as one, stages of 32 if they fit
    if (w > 0) return;
    first = blockIdx.x, stride = 0, ring = smem, bars = bars0;
    S *= W;
    if (S * K % 32 == 0) S = S * K / 32, K = 32;
    R = 1;
  } else {
    const int g = (blockIdx.x - LONG_BLOCKS) * W + w;
    if (g >= G) return;  // the whole warp
    first = LONG_BLOCKS + g, stride = G, ring = smem + w * S * K * SB, bars = bars0 + 8 * S * w;
  }

  // lane k < R: task first + stride k (its row, its slice's first byte and
  // bytes, its first edge and edges); the warp's tasks are lanes 0 .. nt - 1
  const long long t = first + stride * lane;
  const bool has = lane < R && t < (long long)n_rows * slices;
  int row = 0, col = 0, bytes = 0, a = 0, len = 0;
  if (has) {
    row = order[t / slices];
    col = (int)(t % slices) * SB;
    bytes = min(SB, RB - col);
    a = row_ptr[row];
    len = row_ptr[row + 1] - a;
  }
  int end = len;  // the stream: task k's edges are positions off .. end - 1
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(FULL, end, d);
    if (lane >= d) end += v;
  }
  const int off = end - len, T = __shfl_sync(FULL, end, 31);
  const int nt = __popc(__ballot_sync(FULL, has));

  for (int i = lane; i < S; i += 32) hopper::mbar_init(bars + 8 * i, 1);
  hopper::mbar_init_fence();
  __syncwarp();

  // the task of stream position s < T: the last starting at or before it
  auto task_of = [&](int s) {
    int k = 0;
    if (nt <= 1) return k;
#pragma unroll
    for (int step = 16; step; step >>= 1)
      if (__shfl_sync(FULL, off, k + step) <= s) k += step;
    return k;
  };
  // chunk c: stream position 32 c + lane's edge row (-1 past T)
  auto fetch = [&](int c) {
    if (32 * c >= T) return -1;
    const int s = 32 * c + lane, k = task_of(s);
    const int ak = __shfl_sync(FULL, a, k), ok = __shfl_sync(FULL, off, k);
    return s < T ? perm[ak + s - ok] : -1;
  };
  int edge[CHUNKS], chunk = 0;  // chunks chunk .. chunk + CHUNKS - 1
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) edge[i] = fetch(i);
  // stage st's copies (K divides 32: a stage lies in one chunk)
  auto issue = [&](int st) {
    const int p0 = st * K;
    if (p0 >= T) return;
    while (p0 >> 5 > chunk) {
#pragma unroll
      for (int i = 0; i + 1 < CHUNKS; ++i) edge[i] = edge[i + 1];
      edge[CHUNKS - 1] = fetch(++chunk + CHUNKS - 1);
    }
    const int p = p0 + lane, e = __shfl_sync(FULL, edge[0], p & 31);
    int sb = 0, nb = RB;  // the slice's first byte and bytes
    if (slices > 1) {
      const int k = task_of(min(p, T - 1));
      sb = __shfl_sync(FULL, col, k), nb = __shfl_sync(FULL, bytes, k);
    }
    if (lane >= K || p >= T) nb = 0;
    const uint32_t bar = bars + 8 * (st % S);
    const int total = __reduce_add_sync(FULL, nb);
    // whole rows of consecutive edges are consecutive slots: one copy a run
    const int prev = __shfl_up_sync(FULL, e, 1);
    const unsigned heads = __ballot_sync(FULL, nb && (lane == 0 || slices > 1 || prev + 1 != e));
    const int n_copied = __popc(__ballot_sync(FULL, nb != 0));
    const unsigned later = heads & ~((2u << lane) - 1);  // the heads past this lane
    const int run = (later ? __ffs(later) - 1 : n_copied) - lane;
    if (lane == 0) hopper::mbar_expect(bar, total);
    __syncwarp();
    if (heads >> lane & 1) {  // after the warp's reads of the stage's last use
      hopper::fence_proxy_async();
      hopper::bulk_copy(hopper::smem_addr(ring + ((st % S) * K + lane) * SB),
                        values + (long long)e * RB + sb, nb * run, bar);
    }
  };

  float acc[JP][PB / 2];
#pragma unroll
  for (int j = 0; j < JP; ++j)
#pragma unroll
    for (int i = 0; i < PB / 2; ++i) acc[j][i] = 0.f;
  int k = 0, rem = __shfl_sync(FULL, len, 0), kb = __shfl_sync(FULL, bytes, 0);
  // store every finished task from k on (those with no edge as zeros)
  auto settle = [&]() {
    while (k < nt && rem == 0) {
      const int rk = __shfl_sync(FULL, row, k), ck = __shfl_sync(FULL, col, k);
      unsigned char* const dst = out + (long long)rk * RB + ck;
#pragma unroll
      for (int j = 0; j < JP; ++j) {
        const int p = lane + 32 * j;
        if (p * PB < kb) {
          Words<PB> o;
#pragma unroll
          for (int i = 0; i < PB / 4; ++i)
            o.w[i] = BF16::from_f(acc[j][2 * i]) | (unsigned)BF16::from_f(acc[j][2 * i + 1]) << 16;
          *reinterpret_cast<Words<PB>*>(dst + p * PB) = o;
        }
#pragma unroll
        for (int i = 0; i < PB / 2; ++i) acc[j][i] = 0.f;
      }
      ++k;
      rem = __shfl_sync(FULL, len, k & 31);
      kb = __shfl_sync(FULL, bytes, k & 31);
    }
  };
  // U edges of the stage from slot q on, all of task k: loaded, then added in order
  auto add = [&](const unsigned char* slot, auto n_edges) {
    constexpr int U = decltype(n_edges)::value;
    Words<PB> v[U][JP];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < JP; ++j)
        if ((lane + 32 * j) * PB < kb)
          v[u][j] = *reinterpret_cast<const Words<PB>*>(slot + u * SB + (lane + 32 * j) * PB);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < JP; ++j)
        if ((lane + 32 * j) * PB < kb) {
#pragma unroll
          for (int i = 0; i < PB / 4; ++i) {
            acc[j][2 * i] += __uint_as_float(v[u][j].w[i] << 16);
            acc[j][2 * i + 1] += __uint_as_float(v[u][j].w[i] & 0xffff0000u);
          }
        }
    rem -= U;
  };

  for (int st = 0; st < S; ++st) issue(st);
  settle();
  for (int st = 0; st * K < T; ++st) {
    hopper::mbar_wait(bars + 8 * (st % S), (st / S) & 1);
    const unsigned char* const stage = ring + (st % S) * K * SB;
    const int n = min(K, T - st * K);
    for (int q = 0; q < n;) {
      if (rem >= UNROLL && n - q >= UNROLL) {
        add(stage + q * SB, std::integral_constant<int, UNROLL>{});
        q += UNROLL;
      } else {
        add(stage + q * SB, std::integral_constant<int, 1>{});
        ++q;
      }
      settle();
    }
    __syncwarp();  // every lane's reads of the stage done: it may be refilled
    issue(st + S);
  }
}

// A copy of rows of nv vectors of BYTES bytes (any element type).
template <int BYTES, int DEPTH>
__global__ void segment_gather_kernel(const void* __restrict__ nodes, const int* __restrict__ ids,
                                      void* __restrict__ out, long long M, int n_rows, int nv) {
  using T = typename Raw<BYTES>::T;
  const T* const rows = static_cast<const T*>(nodes);
  T* const dst = static_cast<T*>(out);
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  long long tile = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (nv == 1) {  // lane l: edges e0 + l + 32 u, u < DEPTH
    for (; tile * 32 * DEPTH < M; tile += warps) {
      const long long e0 = tile * 32 * DEPTH + lane;
      int id[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) id[u] = e0 + 32 * u < M ? __ldcs(ids + e0 + 32 * u) : -1;
      T x[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)
        x[u] = (unsigned)id[u] < (unsigned)n_rows ? __ldg(rows + id[u]) : T{};
#pragma unroll
      for (int u = 0; u < DEPTH; ++u)
        if (e0 + 32 * u < M) dst[e0 + 32 * u] = x[u];
    }
    return;
  }
  // slot s = lane + 32 t of a tile: edge s / nv, column s % nv; s + 32 is
  // q32 edges and r32 columns further on
  const int q32 = 32 / nv, r32 = 32 % nv, u0 = lane / nv, c0 = lane % nv;
  for (; tile * 32 < M; tile += warps) {
    const long long e0 = tile * 32;
    const int n_e = (int)min(32LL, M - e0), n_slots = n_e * nv;
    const int my_id = lane < n_e ? __ldcs(ids + e0 + lane) : -1;
    T* const o = dst + e0 * nv;
    int u = u0, c = c0;
    for (int t0 = 0; t0 < nv; t0 += DEPTH) {
      T x[DEPTH];
#pragma unroll
      for (int k = 0; k < DEPTH; ++k) {
        const int id = __shfl_sync(0xffffffffu, my_id, u & 31);
        x[k] = lane + 32 * (t0 + k) < n_slots && (unsigned)id < (unsigned)n_rows
                   ? __ldg(rows + (long long)id * nv + c)
                   : T{};
        u += q32;
        c += r32;
        if (c >= nv) {
          c -= nv;
          ++u;
        }
      }
#pragma unroll
      for (int k = 0; k < DEPTH; ++k) {
        const int s = lane + 32 * (t0 + k);
        if (s < n_slots) o[s] = x[k];
      }
    }
  }
}

template <int BYTES, int DEPTH>
int run_gather(const void* n, const int* i, void* o, long long M, int n_rows, int nv, int warps,
               int blocks, cudaStream_t s) {
  segment_gather_kernel<BYTES, DEPTH><<<blocks, 32 * warps, 0, s>>>(n, i, o, M, n_rows, nv);
  return (int)cudaGetLastError();
}

template <int BYTES>
int launch_gather(const void* n, const int* i, void* o, long long M, int n_rows, int nv,
                  int depth, int warps, int blocks, cudaStream_t s) {
  if (depth == 1) return run_gather<BYTES, 1>(n, i, o, M, n_rows, nv, warps, blocks, s);
  if (depth == 2) return run_gather<BYTES, 2>(n, i, o, M, n_rows, nv, warps, blocks, s);
  if (depth == 4) return run_gather<BYTES, 4>(n, i, o, M, n_rows, nv, warps, blocks, s);
  if (depth == 8) return run_gather<BYTES, 8>(n, i, o, M, n_rows, nv, warps, blocks, s);
  if (depth == GATHER_DEPTH)
    return run_gather<BYTES, GATHER_DEPTH>(n, i, o, M, n_rows, nv, warps, blocks, s);
  return (int)cudaErrorInvalidValue;
}

unsigned n_blocks(long long rows, int lanes, int threads) {
  return (unsigned)((rows * lanes + threads - 1) / threads);
}

// The walks every element type shares: narrow rows (F < WIDE), and wide
// rows one element a thread where they are not whole 16-byte vectors.
template <class E>
void sum_scalar(const typename E::Bits* v, const int* p, const int* rp, const int* ord,
                typename E::Bits* o, int n_rows, int F, cudaStream_t s) {
  if (F >= WIDE)
    segment_sum_wide_kernel<E, 1><<<n_blocks(n_rows, F, WIDE_THREADS), WIDE_THREADS, 0, s>>>(
        v, p, rp, ord, o, n_rows, F);
  else if (F == 1)
    segment_sum_narrow_kernel<E, 1>
        <<<n_blocks(n_rows, F, NARROW_THREADS), NARROW_THREADS, 0, s>>>(v, p, rp, o, n_rows, F);
  else
    segment_sum_narrow_kernel<E, 0>
        <<<n_blocks(n_rows, F, NARROW_THREADS), NARROW_THREADS, 0, s>>>(v, p, rp, o, n_rows, F);
}

template <int PB, int JP>
int run_ring(const void* v, const int* p, const int* rp, const int* ord, void* o, int n_rows,
             int F, int K, int S, int R, int W, cudaStream_t s) {
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t e = cudaFuncSetAttribute(segment_sum_ring_kernel<PB, JP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         hopper::SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const int SB = min(2 * F, RING_SLICE);
  const long long tasks = (long long)n_rows * ((2 * F + SB - 1) / SB);
  const long long G = (max(tasks - LONG_BLOCKS, 0LL) + R - 1) / R;  // warps past the long blocks
  const long long smem = (long long)W * S * (K * SB + 8);
  if (G > INT_MAX || smem > hopper::SMEM_MAX) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(LONG_BLOCKS + (G + W - 1) / W);
  segment_sum_ring_kernel<PB, JP><<<blocks, 32 * W, smem, s>>>(
      static_cast<const unsigned char*>(v), p, rp, ord, static_cast<unsigned char*>(o), n_rows,
      F, K, S, R, (int)G);
  return (int)cudaGetLastError();
}

// size: bytes an element; vec: elements a vector (its bytes 16, 8, 4 or 2).
int gather(const void* nodes, const void* ids, void* out, long long M, int n_rows, int F,
           int size, int vec, int depth, int warps, int blocks, void* stream) {
  const int bytes = size * vec;
  if (F <= 0 || vec < 1 || F % vec || (bytes != 16 && bytes != 8 && bytes != 4 && bytes != 2) ||
      warps < 1 || warps > 32 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* i = static_cast<const int*>(ids);
  const int nv = F / vec;
  if (bytes == 16) return launch_gather<16>(nodes, i, out, M, n_rows, nv, depth, warps, blocks, s);
  if (bytes == 8) return launch_gather<8>(nodes, i, out, M, n_rows, nv, depth, warps, blocks, s);
  if (bytes == 4) return launch_gather<4>(nodes, i, out, M, n_rows, nv, depth, warps, blocks, s);
  return launch_gather<2>(nodes, i, out, M, n_rows, nv, depth, warps, blocks, s);
}

}  // namespace

// values: (M, F) contiguous; perm: int32, the edge rows ordered by node
// (stable); row_ptr: int32 (n_rows + 1), node r's edges are
// perm[row_ptr[r] : row_ptr[r + 1]]; order: int32 (n_rows), a permutation
// of the rows, those with more than ROUND edges first (read where F >=
// WIDE); out: (n_rows, F) of the values' type, every row written.
// vectorized: rows of whole 16-byte vectors (F % 4 == 0 in f32, F % 8 == 0
// in bf16) and values/out 16-byte aligned.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int segment_sum_f32(const void* values, const void* perm, const void* row_ptr,
                               const void* order, void* out, int n_rows, int F, int vectorized,
                               void* stream) {
  if (F <= 0 || (vectorized && F % 4)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(values);
  const int *p = static_cast<const int*>(perm), *rp = static_cast<const int*>(row_ptr),
            *ord = static_cast<const int*>(order);
  float* o = static_cast<float*>(out);
  if (F >= WIDE && vectorized)
    segment_sum_wide_kernel<F32, 4><<<n_blocks(n_rows, F / 4, WIDE_THREADS), WIDE_THREADS, 0, s>>>(
        v, p, rp, ord, o, n_rows, F);
  else
    sum_scalar<F32>(v, p, rp, ord, o, n_rows, F, s);
  return (int)cudaGetLastError();
}

// As segment_sum_f32 for bf16 values and output: each element an f32 sum
// in the same order, rounded once to bf16 (nearest even).  Vectorized rows
// of F >= WIDE take the ring of bulk copies with the plan
// (ops/segment_ops.sum_plan): K edge rows a stage (1, 2, 4, 8, 16 or 32),
// S stages a warp, R tasks a warp (1 to 32), W warps a block (1 to
// RING_WARPS); the plan's shared memory, W S (K min(2 F, RING_SLICE) + 8)
// bytes, at most hopper::SMEM_MAX.  Other rows ignore the plan.
extern "C" int segment_sum_bf16(const void* values, const void* perm, const void* row_ptr,
                                const void* order, void* out, int n_rows, int F, int vectorized,
                                int K, int S, int R, int W, void* stream) {
  if (F <= 0 || (vectorized && F % 8)) return (int)cudaErrorInvalidValue;
  if (n_rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int *p = static_cast<const int*>(perm), *rp = static_cast<const int*>(row_ptr),
            *ord = static_cast<const int*>(order);
  if (F >= WIDE && vectorized) {
    if (K < 1 || K > 32 || 32 % K || S < 1 || R < 1 || R > 32 || W < 1 || W > RING_WARPS)
      return (int)cudaErrorInvalidValue;
    const int RB = 2 * F;  // the lanes' pieces: 4, 8 or 16 bytes, two 16-byte ones past 512
    if (RB <= 128) return run_ring<4, 1>(values, p, rp, ord, out, n_rows, F, K, S, R, W, s);
    if (RB <= 256) return run_ring<8, 1>(values, p, rp, ord, out, n_rows, F, K, S, R, W, s);
    if (RB <= 512) return run_ring<16, 1>(values, p, rp, ord, out, n_rows, F, K, S, R, W, s);
    return run_ring<16, 2>(values, p, rp, ord, out, n_rows, F, K, S, R, W, s);
  }
  using Bits = BF16::Bits;
  sum_scalar<BF16>(static_cast<const Bits*>(values), p, rp, ord, static_cast<Bits*>(out), n_rows,
                   F, s);
  return (int)cudaGetLastError();
}


// nodes: (n_rows, F) contiguous; ids: int32 (M,), -1 or outside
// [0, n_rows) for a zero row; out: (M, F) of the nodes' type.  vec:
// elements a load, 4 or 2 f32 (8, 4 or 2 bf16) where F is a multiple and
// nodes and out lie on that many bytes, else 1.  The plan
// (ops/segment_ops.gather_plan): `depth` loads a lane keeps in flight (1,
// 2, 4, 8 or GATHER_DEPTH), `warps` a block (1 to 32), `blocks`.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int segment_gather_f32(const void* nodes, const void* ids, void* out, long long M,
                                  int n_rows, int F, int vec, int depth, int warps, int blocks,
                                  void* stream) {
  return gather(nodes, ids, out, M, n_rows, F, 4, vec, depth, warps, blocks, stream);
}

extern "C" int segment_gather_bf16(const void* nodes, const void* ids, void* out, long long M,
                                   int n_rows, int F, int vec, int depth, int warps, int blocks,
                                   void* stream) {
  return gather(nodes, ids, out, M, n_rows, F, 2, vec, depth, warps, blocks, stream);
}
