// Hopper (sm_90a) building blocks shared by the TMA + wgmma kernels
// (flash_attention.cu, bin_kernels.cuh): mbarrier rings, TMA tile loads,
// shared-memory matrix descriptors for the 128-byte swizzle, warpgroup matrix
// multiply-accumulate (wgmma, bf16, f16, tf32 and s8) and register
// reallocation, and the host-side tensor-map encoder.
//
// Conventions:
// - every TMA tile has a 128-byte inner box (64 bf16 or f16, 32 f32 or 128
//   int8 values) and CU_TENSOR_MAP_SWIZZLE_128B, landing at a 1024-byte
//   aligned shared address, so wgmma reads it through a SW128 descriptor:
//   K-major (the contraction dim contiguous, rows 128 bytes apart, 8-row
//   groups 1024 bytes apart; a k16 bf16 or f16, k8 tf32 or k32 s8 step inside
//   the 128-byte row adds 32 bytes to the start address) or MN-major (bf16
//   only: the output dim contiguous; 8-deep k groups 1024 bytes apart, 64-wide
//   output chunks `lbo` bytes apart);
// - accumulator fragments follow PTX's m64nNk16 f32 layout (m64nNk32 s32 is
//   the same): in warp w of the warpgroup, lane l holds rows 16 w + l / 4
//   (+ 8) and columns 8 i + 2 (l % 4) (+ 1) in d[4 i .. 4 i + 3] (row, col),
//   (row, col + 1), (row + 8, col), (row + 8, col + 1); a register A operand
//   (k16) is the same layout packed to bf16 pairs: {d[8 j], d[8 j + 1]},
//   {d[8 j + 2], d[8 j + 3]}, {d[8 j + 4], d[8 j + 5]}, {d[8 j + 6],
//   d[8 j + 7]} for keys 16 j .. 16 j + 15;
// - a wait on an mbarrier that does not complete within ~5 s of SM clock traps,
//   so a protocol fault fails the launch instead of hanging the card.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes initialised barriers visible to the async (TMA) proxy; call once
// after the inits, before the block-wide barrier that publishes them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// `count` arrivals at once
__device__ __forceinline__ void mbar_arrive_cnt(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// blocks until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 10000000000LL) __trap();
  }
}

// ---- named barriers (id 0 is __syncthreads) ----

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- TMA ----

__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a box of shared memory (at 1024-byte aligned dst, laid out as tma_load
// writes it) to the tensor at the map's coordinates; out-of-range elements
// are not written. Completes in bulk groups: bulk_commit, then
// bulk_wait_read<0> (the shared memory may be reused) or bulk_wait<0>
// (the writes are done)
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- wgmma ----

// SW128 shared-memory matrix descriptor: start address, leading and stride
// byte offsets (K-major: lbo unused, pass 16; sbo = 1024 between 8-row groups)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N committed wgmma groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins accumulator registers at this point of the program, so the compiler
// moves no read or write of them across an asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// this thread's warpgroup index, broadcast from lane 0 so the compiler knows
// it is uniform across the warp: wgmma code under a branch on it is then not
// on a divergent path (which would make ptxas serialise the wgmma)
__device__ __forceinline__ int warpgroup_index() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
}

// setmaxnreg's split of a 384-thread block (one producer warpgroup at 24-40
// registers, two consumers at 232-240) needs the SM's register file to
// itself. A dynamic shared-memory request of at least this many bytes keeps a
// second block off the SM whatever registers ptxas assigns at launch: two
// would need more than the SM's 228 KB.
constexpr int ONE_BLOCK_SMEM = 116 * 1024;

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

#define SM90_ACC8(b)                                                                       \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
      "+f"(d[b + 6]), "+f"(d[b + 7])

// d (64 x N f32, the fragment layout above) += A (64 x 16 bf16) * B (16 x N
// bf16). ss: A and B from SW128 descriptors, A K-major; rs: A from registers.
// TB = 0: B K-major (N rows of 16 contiguous k); TB = 1: B MN-major.
// scale_d = 0 overwrites d instead of adding.
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
          SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
          SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<256> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
        : SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24),
          SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56),
          SM90_ACC8(64), SM90_ACC8(72), SM90_ACC8(80), SM90_ACC8(88),
          SM90_ACC8(96), SM90_ACC8(104), SM90_ACC8(112), SM90_ACC8(120)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

#undef SM90_ACC8

#define SM90_IACC8(b)                                                                      \
  "+r"(d[b + 0]), "+r"(d[b + 1]), "+r"(d[b + 2]), "+r"(d[b + 3]), "+r"(d[b + 4]), "+r"(d[b + 5]), \
      "+r"(d[b + 6]), "+r"(d[b + 7])

// d (64 x N s32, the fragment layout above) += A (64 x 32 s8) * B (32 x N
// s8), both from K-major SW128 descriptors (integer wgmma takes no
// transpose). The sum is exact. scale_d = 0 overwrites d instead of adding.
template <int N>
struct WgmmaS8;

template <>
struct WgmmaS8<64> {
  static __device__ __forceinline__ void ss(uint32_t (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : SM90_IACC8(0), SM90_IACC8(8), SM90_IACC8(16), SM90_IACC8(24)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<128> {
  static __device__ __forceinline__ void ss(uint32_t (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : SM90_IACC8(0), SM90_IACC8(8), SM90_IACC8(16), SM90_IACC8(24),
          SM90_IACC8(32), SM90_IACC8(40), SM90_IACC8(48), SM90_IACC8(56)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgmmaS8<256> {
  static __device__ __forceinline__ void ss(uint32_t (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : SM90_IACC8(0), SM90_IACC8(8), SM90_IACC8(16), SM90_IACC8(24),
          SM90_IACC8(32), SM90_IACC8(40), SM90_IACC8(48), SM90_IACC8(56),
          SM90_IACC8(64), SM90_IACC8(72), SM90_IACC8(80), SM90_IACC8(88),
          SM90_IACC8(96), SM90_IACC8(104), SM90_IACC8(112), SM90_IACC8(120)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

#undef SM90_IACC8

// d (64 x N f32) += A (64 x K) * B (K x N) with both operands from K-major
// SW128 descriptors, for the f16 operands of the bin kernels: WgmmaF16 (k16,
// products exact in f32). A k step is 32 bytes of each row, as for bf16.
// scale_d = 0 overwrites d instead of adding.
#define SM90_R32                                                                               \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define SM90_R64                                                                               \
  SM90_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
           "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define SM90_R128                                                                              \
  SM90_R64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
           "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "   \
           "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "    \
           "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, "      \
           "%123, %124, %125, %126, %127"
#define SM90_ACC8(b)                                                                       \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]), "+f"(d[b + 5]), \
      "+f"(d[b + 6]), "+f"(d[b + 7])
#define SM90_ACC32 SM90_ACC8(0), SM90_ACC8(8), SM90_ACC8(16), SM90_ACC8(24)
#define SM90_ACC64 SM90_ACC32, SM90_ACC8(32), SM90_ACC8(40), SM90_ACC8(48), SM90_ACC8(56)
#define SM90_ACC128                                                                          \
  SM90_ACC64, SM90_ACC8(64), SM90_ACC8(72), SM90_ACC8(80), SM90_ACC8(88), SM90_ACC8(96),     \
      SM90_ACC8(104), SM90_ACC8(112), SM90_ACC8(120)
// one specialisation: NAME<N>::ss with the accumulator of NR registers, the
// register list REGS, the descriptors as operands DA, DB and scale_d as SC
// (operand numbers as strings), the instruction INSTR and its trailing
// immediates TAIL
#define SM90_WGMMA_SS(NAME, N, NR, REGS, ACC, DA, DB, SC, INSTR, TAIL)                      \
  template <>                                                                                \
  struct NAME<N> {                                                                           \
    static __device__ __forceinline__ void ss(float (&d)[NR], uint64_t da, uint64_t db,     \
                                              int scale_d) {                                 \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n" INSTR " {" REGS "}, %" DA \
                   ", %" DB ", p" TAIL ";\n}\n"                                              \
                   : ACC                                                                     \
                   : "l"(da), "l"(db), "r"(scale_d));                                        \
    }                                                                                        \
  };

template <int N>
struct WgmmaF16;
SM90_WGMMA_SS(WgmmaF16, 64, 32, SM90_R32, SM90_ACC32, "32", "33", "34",
              "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16", ", 1, 1, 0, 0")
SM90_WGMMA_SS(WgmmaF16, 128, 64, SM90_R64, SM90_ACC64, "64", "65", "66",
              "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16", ", 1, 1, 0, 0")
SM90_WGMMA_SS(WgmmaF16, 256, 128, SM90_R128, SM90_ACC128, "128", "129", "130",
              "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16", ", 1, 1, 0, 0")

// WgmmaTF32RS<N>::rs: d (64 x N f32) += A (64 x 8) * B (8 x N) in tf32 (k8;
// the tensor cores multiply tf32, 10 fraction bits, so a caller that wants
// f32 products splits each operand into tf32 parts itself), B from a K-major
// SW128 descriptor (a k step is 32 bytes of each row) and A from registers,
// a[0..3] = (row r, k t), (r + 8, t), (r, t + 4), (r + 8, t + 4) for lane
// l = 4 (r % 8) + t of warp r / 16 (mma.m16n8k8's tf32 A layout), as
// ldmatrix_x4 below loads it
template <int N>
struct WgmmaTF32RS;
#define SM90_WGMMA_RS_TF32(N, NR, REGS, ACC, A0, A1, A2, A3, DB, SC)                         \
  template <>                                                                                \
  struct WgmmaTF32RS<N> {                                                                    \
    static __device__ __forceinline__ void rs(float (&d)[NR], const uint32_t (&a)[4],        \
                                              uint64_t db, int scale_d) {                    \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" SC ", 0;\n"                          \
                   "wgmma.mma_async.sync.aligned.m64n" #N "k8.f32.tf32.tf32 {" REGS "}, {%" A0 \
                   ", %" A1 ", %" A2 ", %" A3 "}, %" DB ", p, 1, 1;\n}\n"                      \
                   : ACC                                                                     \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));      \
    }                                                                                        \
  };
SM90_WGMMA_RS_TF32(64, 32, SM90_R32, SM90_ACC32, "32", "33", "34", "35", "36", "37")
SM90_WGMMA_RS_TF32(128, 64, SM90_R64, SM90_ACC64, "64", "65", "66", "67", "68", "69")
#undef SM90_WGMMA_RS_TF32

#undef SM90_WGMMA_SS
#undef SM90_ACC128
#undef SM90_ACC64
#undef SM90_ACC32
#undef SM90_ACC8
#undef SM90_R128
#undef SM90_R64
#undef SM90_R32

// x rounded to tf32 (10 fraction bits, to nearest, ties away), as f32 bits
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// four 8 x 8 b16 matrices from shared memory (ldmatrix .x4): lane l gives
// the address of row l % 8 of matrix l / 8 and gets word l % 4 of row l / 4
// of each matrix in r[0..3]; on 32-bit data, word t of row r is element t
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t saddr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr));
}

__device__ __forceinline__ void st_shared_b32(uint32_t saddr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(saddr), "r"(v) : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later reads
// by the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- host: tensor maps ----

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    const bool ok = err == cudaSuccess && q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// the current device's SM count (persistent grids), or 0
inline int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  return n;
}

// tensor map of `rank` dims (innermost first) of `dtype` elements (BFLOAT16,
// FLOAT16, FLOAT32 or UINT8), with byte strides of dims 1.. and a box whose
// inner extent is 128 bytes, 128-byte swizzle, out-of-range elements
// read as zero. Returns 0 or a cudaError_t.
inline int make_tma(CUtensorMap* map, CUtensorMapDataType dtype, const void* base, int rank,
                    const uint64_t* dims, const uint64_t* strides, const uint32_t* box) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], estride[5];
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    estride[i] = 1;
    if (i > 0) gstride[i - 1] = strides[i - 1];
  }
  CUresult r = fn(map, dtype, static_cast<cuuint32_t>(rank), const_cast<void*>(base), gdim, gstride,
                  bdim, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace sm90
