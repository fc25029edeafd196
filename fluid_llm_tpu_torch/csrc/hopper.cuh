// The Hopper pieces the TMA-and-wgmma kernels share (indexed_linear.cu,
// quant_matmul.cu, short_attention.cu, flash_attention.cu,
// exact_attention.cu, grid_slot_attention.cu's backward): shared-memory
// addresses, mbarriers, TMA tensor and bulk copies and the tensor maps they
// read, wgmma descriptors and products, the 64-row attention tiles'
// products and epilogue, and the split-K reduction across the blocks of a
// thread-block cluster.  Every kernel
// that includes it is built for sm_90a (wgmma exists only there).
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

namespace cg = cooperative_groups;

constexpr int TILE_ALIGN = 1024;  // a 128-byte swizzle repeats every 8 rows of 128 bytes
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may have (H100)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory's first TILE_ALIGN-aligned byte
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((TILE_ALIGN - smem_addr(raw) % TILE_ALIGN) % TILE_ALIGN);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the barriers' initialisation visible to the copy engine and the cluster
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// this thread's arrival, expecting `bytes` more from copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// one TMA tensor copy of a box at coordinates (c0 innermost, ...) into
// shared memory at dst, counted on the mbarrier bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// one TMA bulk copy of `bytes` contiguous bytes (a multiple of 16; both
// addresses 16-byte aligned) into shared memory at dst, counted on bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// makes this thread's ordinary writes to shared memory visible to the
// async proxy (wgmma's operand reads, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory descriptor of a tile in the 128-byte swizzle, rows
// of 128 bytes, 8-row groups 1024 bytes apart.  K-major (the rows run along
// K): a k16 step further along K starts 32 bytes later (+2).  MN-major (the
// rows run along M or N, one row a k): a k16 step starts 2048 bytes later
// (+128); the stride between 64-element column blocks is then never read,
// since every product here is at most 64 wide along that side.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(1024 >> 4) << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// asynchronous product reads or writes across the fence or the wait
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void pin(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void pin(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma m64nNk16, bf16 in, f32 sums in registers (64 x N over the
// warpgroup's 128 threads: d[4j + 2h + e] is row 16 warp + g + 8h, column
// 8j + 2t + e, for lane 4g + t).  ss: A and B from shared memory, both
// K-major.  rs<TB>: A from registers (a[0..3]: rows g and g + 8, columns
// 2t, 2t + 1 and 2t + 8, 2t + 9, as mma.sync's A fragment), B from shared
// memory, K-major (TB 0) or MN-major (TB 1).  Only the widths and forms a
// kernel here uses are written out.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31,\n"
        "%32, %33, %34, %35, %36, %37, %38, %39,\n"
        "%40, %41, %42, %43, %44, %45, %46, %47,\n"
        "%48, %49, %50, %51, %52, %53, %54, %55,\n"
        "%56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<136> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[68], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %73, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31,\n"
        "%32, %33, %34, %35, %36, %37, %38, %39,\n"
        "%40, %41, %42, %43, %44, %45, %46, %47,\n"
        "%48, %49, %50, %51, %52, %53, %54, %55,\n"
        "%56, %57, %58, %59, %60, %61, %62, %63,\n"
        "%64, %65, %66, %67}, "
        "{%68, %69, %70, %71}, %72, p, 1, 1, %74;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

template <>
struct Wgmma<224> {
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[112], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %117, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,\n"
        "%8, %9, %10, %11, %12, %13, %14, %15,\n"
        "%16, %17, %18, %19, %20, %21, %22, %23,\n"
        "%24, %25, %26, %27, %28, %29, %30, %31,\n"
        "%32, %33, %34, %35, %36, %37, %38, %39,\n"
        "%40, %41, %42, %43, %44, %45, %46, %47,\n"
        "%48, %49, %50, %51, %52, %53, %54, %55,\n"
        "%56, %57, %58, %59, %60, %61, %62, %63,\n"
        "%64, %65, %66, %67, %68, %69, %70, %71,\n"
        "%72, %73, %74, %75, %76, %77, %78, %79,\n"
        "%80, %81, %82, %83, %84, %85, %86, %87,\n"
        "%88, %89, %90, %91, %92, %93, %94, %95,\n"
        "%96, %97, %98, %99, %100, %101, %102, %103,\n"
        "%104, %105, %106, %107, %108, %109, %110, %111}, "
        "{%112, %113, %114, %115}, %116, p, 1, 1, %118;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
  }
};

// Two- and four-wide vectors of a partial sum's type (f32 or exact int32)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using x2 = float2;
  using x4 = float4;
};
template <>
struct Vec<int> {
  using x2 = int2;
  using x4 = int4;
};

// Split K across the blocks of a cluster: rank r holds partial sums of the
// whole BM x BN tile, of type T (float, or int for w8a8's exact sums).  Rank o owns elements [o * share, (o + 1) * share) of
// the tile (row-major); every rank writes its partial sums of them into
// slot `rank` of the owner's `slots` (distributed shared memory), one
// cluster barrier, then each owner sums its slots in rank order (no
// atomics: deterministic) and hands each 4 consecutive elements of a row
// to emit(element, Vec<T>::x4).  The caller makes sure that no rank still
// reads the shared memory that `slots` names when the writes begin.  A
// thread with has_acc holds acc, the warpgroup's 64 x BN rows from row0.
template <int BM, int BN, int MAX_CLUSTER, typename T, typename Emit>
__device__ __forceinline__ void cluster_reduce(const T (&acc)[BN / 2], bool has_acc, int row0,
                                               T* slots, Emit emit) {
  using V2 = typename Vec<T>::x2;
  using V4 = typename Vec<T>::x4;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), n_ranks = (int)cluster.num_blocks();
  const int share = ((BM * BN + n_ranks - 1) / n_ranks + 3) / 4 * 4;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  if (has_acc) {
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int e = (row0 + warp * 16 + g + hh * 8) * BN + j * 8 + t * 2;
        const int owner = e / share;
        *reinterpret_cast<V2*>(cluster.map_shared_rank(slots, owner) + rank * share + e -
                               owner * share) = V2{acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]};
      }
  }
  cluster.sync();  // every rank's partial sums are in their owners' slots
  const int mine = min(share, BM * BN - rank * share);
  for (int i = threadIdx.x * 4; i < mine; i += blockDim.x * 4) {
    V4 sum = V4{0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < n_ranks) {
        const V4 v = *reinterpret_cast<const V4*>(slots + k * share + i);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    emit(rank * share + i, sum);
  }
}

// Tiles of 64 rows of a (rows, H * hd) bf16 tensor, as the attention
// kernels read them (flash_attention.cu, exact_attention.cu): 64-column
// boxes in the 128-byte swizzle, one consumer warpgroup whose m64n64
// accumulators feed the next product's A fragments.
namespace tile64 {

constexpr int BOX = 64 * 64 * 2;  // one 64-row x 64-column bf16 box: 8 KB

// 64-column boxes of a row tile (head dim 32 takes one, half of it read)
template <int HD>
__host__ __device__ constexpr int n_boxes() {
  return HD <= 64 ? 1 : HD / 64;
}

// the consumer warpgroup's named barrier (0 is __syncthreads)
__device__ __forceinline__ void wg_sync() { asm volatile("bar.sync 1, 128;\n" ::: "memory"); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc[c] (64 x 64, m64n64 layout, c = 64-column box) += A (64 x 64 bf16
// fragments in registers) . the MN-major tile at `tile` (64 rows along K)
template <int NB>
__device__ __forceinline__ void product_rs(float (&acc)[NB][32], uint32_t (&a)[4][4],
                                           uint32_t tile) {
#pragma unroll
  for (int c = 0; c < NB; ++c) pin(acc[c]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) pin(a[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NB; ++c)
      Wgmma<64>::rs<1>(acc[c], a[kk], sw128_mn_desc(tile + c * BOX + kk * 2048));
  wgmma_commit();
}

// d (64 x 64) = A B^T over HD, A and B both K-major 64-row tiles; issued
// and committed as one group, not waited for
template <int HD>
__device__ __forceinline__ void product_ss(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  pin(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    Wgmma<64>::ss(d, sw128_desc(a + (kk / 4) * BOX) + 2 * (kk % 4),
                  sw128_desc(b + (kk / 4) * BOX) + 2 * (kk % 4));
  wgmma_commit();
}

// Write the warpgroup's 64 x HD f32 accumulator, times `mul`, as bf16 rows
// row0.. of dst (row stride rs, rows at or past `rows` skipped), staged in
// the 128-byte swizzle through `stage` (a tile of the block whose rows
// 16 w .. 16 w + 15 no product of warp w reads any more).
template <int HD>
__device__ __forceinline__ void store_tile(float (&acc)[n_boxes<HD>()][32], float mul,
                                           unsigned char* stage, __nv_bfloat16* dst, long long rs,
                                           int row0, int rows) {
  constexpr int NB = n_boxes<HD>();
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  // acc[c][4j + 2hh + e] is row 16 warp + g + 8hh, column 64c + 8j + 2t + e
#pragma unroll
  for (int c = 0; c < NB; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + 8 * hh;
        *reinterpret_cast<uint32_t*>(stage + c * BOX + r * 128 + ((j ^ (r & 7)) << 4) + 4 * t) =
            pack_bf16(acc[c][4 * j + 2 * hh] * mul, acc[c][4 * j + 2 * hh + 1] * mul);
      }
  wg_sync();
  for (int idx = threadIdx.x; idx < 64 * NB * 8; idx += 128) {
    const int r = idx / (NB * 8), c = idx / 8 % NB, cc = idx % 8;
    if (64 * c + 8 * cc >= HD || row0 + r >= rows) continue;
    *reinterpret_cast<uint4*>(dst + (long long)(row0 + r) * rs + 64 * c + 8 * cc) =
        *reinterpret_cast<const uint4*>(stage + c * BOX + r * 128 + ((cc ^ (r & 7)) << 4));
  }
}

}  // namespace tile64

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query (no link against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tiled map over `rank` dimensions (dims[0] contiguous; strides in bytes
// of dimensions 1..rank-1), boxes of `box`, in `swizzle`; elements past the
// tensor read as zeros.
inline bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base, int rank,
                   const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                   CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn != nullptr &&
         fn(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 map in the 128-byte swizzle
inline bool encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                        const cuuint64_t* strides, const cuuint32_t* box) {
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, rank, dims, strides, box,
                CU_TENSOR_MAP_SWIZZLE_128B);
}

// N tensors as (bs * L rows, H * hd columns) with each tensor's row stride
// (elements), 64 x 64 boxes in the 128-byte swizzle
template <int N>
bool encode_row_maps(CUtensorMap (&maps)[N], const void* const (&ptrs)[N],
                     const long long (&strides)[N], int bs, int L, int n_heads, int head_dim) {
  for (int i = 0; i < N; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)n_heads * head_dim, (cuuint64_t)bs * L};
    const cuuint64_t rs[1] = {(cuuint64_t)strides[i] * 2};
    const cuuint32_t box[2] = {64, 64};
    if (!encode_bf16(&maps[i], ptrs[i], 2, dims, rs, box)) return false;
  }
  return true;
}

// Once per kernel instance: allows it `bytes` of dynamic shared memory
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  done = true;
  return 0;
}

}  // namespace hopper
