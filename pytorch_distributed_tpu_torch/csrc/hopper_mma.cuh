// Hopper (sm_90a) building blocks shared by the port's bf16 tensor-core
// kernels: 128-byte-swizzled shared tiles filled by 16-byte cp.async,
// warpgroup wgmma (m64nNk16 bf16, f32 accumulate) through shared-memory
// descriptors, and the conversion of an accumulator into register A
// fragments.  Included by every csrc/*.cu that uses them; ops/_build.py
// hashes every csrc/*.cuh into each library's name, so an edited header
// rebuilds every source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int WG_THREADS = 128;  // one warpgroup
constexpr int WG_ROWS = 64;      // wgmma's M: 16 rows per warp
constexpr float LOG2E = 1.4426950408889634f;

// Above 48 KB a CTA gets dynamic shared memory only after this opt-in; a
// launch without it is refused and shows only in cudaGetLastError.
template <typename K>
cudaError_t opt_in_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (of D/8) of row r in a tile of R rows.  The
// tile is D/64 blocks of 64 columns, each R rows of 128 bytes whose chunks
// are permuted by XOR with r mod 8: wgmma's 128-byte swizzle, for a tile
// that starts 1024-byte aligned.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes from global to shared; src_bytes 0 fills the chunk with zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group (the newest) is still in flight,
// then make this thread's copies visible to wgmma, which reads shared memory
// through the async proxy.
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until at most the two newest committed groups are still in flight,
// then fence as above.
__device__ __forceinline__ void cp_async_wait_2() {
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait for every committed group of this thread's copies, then fence them
// to the async proxy as above.
__device__ __forceinline__ void cp_async_wait_0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (each >> 4), layout type 1 in
// bits 62-63.  K-major (rows of the matrix along M or N, 16 deep along K in
// each 128-byte row): SBO is the stride of 8-row groups, LBO unused.
// MN-major (rows along K): LBO is the stride of 64-column blocks, SBO that
// of 8-row groups along K.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most the newest committed wgmma group is still in flight.
__device__ __forceinline__ void wg_wait_1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Keeps the compiler from moving other reads or writes of these registers
// across the asynchronous wgmma that writes them.
template <int N>
__device__ __forceinline__ void reg_fence(float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(c[j][e]) :: "memory");
}

// c[64 x 64] += A . B, A from registers (the warp's 16 rows as an m16n8k16
// A fragment), B from shared memory (MN-major descriptor, transposed).
__device__ __forceinline__ void wgmma_rs_n64(float (&c)[8][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// c[64 x 64] += A . B (c = A . B with scale_d 0), A from registers as above, B
// from shared memory (K-major descriptor).
__device__ __forceinline__ void wgmma_rs_kmajor_n64(float (&c)[8][4], const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// c[64 x 128] += A . B, A from registers (the warp's 16 rows as an m16n8k16
// A fragment), B from shared memory (MN-major descriptor, transposed).
__device__ __forceinline__ void wgmma_rs_n128(float (&c)[16][4], const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3]),
        "+f"(c[8][0]), "+f"(c[8][1]), "+f"(c[8][2]), "+f"(c[8][3]),
        "+f"(c[9][0]), "+f"(c[9][1]), "+f"(c[9][2]), "+f"(c[9][3]),
        "+f"(c[10][0]), "+f"(c[10][1]), "+f"(c[10][2]), "+f"(c[10][3]),
        "+f"(c[11][0]), "+f"(c[11][1]), "+f"(c[11][2]), "+f"(c[11][3]),
        "+f"(c[12][0]), "+f"(c[12][1]), "+f"(c[12][2]), "+f"(c[12][3]),
        "+f"(c[13][0]), "+f"(c[13][1]), "+f"(c[13][2]), "+f"(c[13][3]),
        "+f"(c[14][0]), "+f"(c[14][1]), "+f"(c[14][2]), "+f"(c[14][3]),
        "+f"(c[15][0]), "+f"(c[15][1]), "+f"(c[15][2]), "+f"(c[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&c)[N / 8][4], const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert(N == 64 || N == 128, "head dims are 64 or 128");
  if constexpr (N == 64) wgmma_rs_n64(c, a, db); else wgmma_rs_n128(c, a, db);
}

// c[64 x 32] (+)= A . B, both from shared memory; TA, TB: 0 K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32_t(float (&c)[4][4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// c[64 x 64] (+)= A . B, both from shared memory; TA, TB: 0 K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64_t(float (&c)[8][4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// c[64 x 128] (+)= A . B, both from shared memory; TA, TB: 0 K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128_t(float (&c)[16][4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3]),
        "+f"(c[8][0]), "+f"(c[8][1]), "+f"(c[8][2]), "+f"(c[8][3]),
        "+f"(c[9][0]), "+f"(c[9][1]), "+f"(c[9][2]), "+f"(c[9][3]),
        "+f"(c[10][0]), "+f"(c[10][1]), "+f"(c[10][2]), "+f"(c[10][3]),
        "+f"(c[11][0]), "+f"(c[11][1]), "+f"(c[11][2]), "+f"(c[11][3]),
        "+f"(c[12][0]), "+f"(c[12][1]), "+f"(c[12][2]), "+f"(c[12][3]),
        "+f"(c[13][0]), "+f"(c[13][1]), "+f"(c[13][2]), "+f"(c[13][3]),
        "+f"(c[14][0]), "+f"(c[14][1]), "+f"(c[14][2]), "+f"(c[14][3]),
        "+f"(c[15][0]), "+f"(c[15][1]), "+f"(c[15][2]), "+f"(c[15][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// c[64 x 256] (+)= A . B, both from shared memory; TA, TB: 0 K-major, 1 MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n256_t(float (&c)[32][4], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(c[0][0]), "+f"(c[0][1]), "+f"(c[0][2]), "+f"(c[0][3]),
        "+f"(c[1][0]), "+f"(c[1][1]), "+f"(c[1][2]), "+f"(c[1][3]),
        "+f"(c[2][0]), "+f"(c[2][1]), "+f"(c[2][2]), "+f"(c[2][3]),
        "+f"(c[3][0]), "+f"(c[3][1]), "+f"(c[3][2]), "+f"(c[3][3]),
        "+f"(c[4][0]), "+f"(c[4][1]), "+f"(c[4][2]), "+f"(c[4][3]),
        "+f"(c[5][0]), "+f"(c[5][1]), "+f"(c[5][2]), "+f"(c[5][3]),
        "+f"(c[6][0]), "+f"(c[6][1]), "+f"(c[6][2]), "+f"(c[6][3]),
        "+f"(c[7][0]), "+f"(c[7][1]), "+f"(c[7][2]), "+f"(c[7][3]),
        "+f"(c[8][0]), "+f"(c[8][1]), "+f"(c[8][2]), "+f"(c[8][3]),
        "+f"(c[9][0]), "+f"(c[9][1]), "+f"(c[9][2]), "+f"(c[9][3]),
        "+f"(c[10][0]), "+f"(c[10][1]), "+f"(c[10][2]), "+f"(c[10][3]),
        "+f"(c[11][0]), "+f"(c[11][1]), "+f"(c[11][2]), "+f"(c[11][3]),
        "+f"(c[12][0]), "+f"(c[12][1]), "+f"(c[12][2]), "+f"(c[12][3]),
        "+f"(c[13][0]), "+f"(c[13][1]), "+f"(c[13][2]), "+f"(c[13][3]),
        "+f"(c[14][0]), "+f"(c[14][1]), "+f"(c[14][2]), "+f"(c[14][3]),
        "+f"(c[15][0]), "+f"(c[15][1]), "+f"(c[15][2]), "+f"(c[15][3]),
        "+f"(c[16][0]), "+f"(c[16][1]), "+f"(c[16][2]), "+f"(c[16][3]),
        "+f"(c[17][0]), "+f"(c[17][1]), "+f"(c[17][2]), "+f"(c[17][3]),
        "+f"(c[18][0]), "+f"(c[18][1]), "+f"(c[18][2]), "+f"(c[18][3]),
        "+f"(c[19][0]), "+f"(c[19][1]), "+f"(c[19][2]), "+f"(c[19][3]),
        "+f"(c[20][0]), "+f"(c[20][1]), "+f"(c[20][2]), "+f"(c[20][3]),
        "+f"(c[21][0]), "+f"(c[21][1]), "+f"(c[21][2]), "+f"(c[21][3]),
        "+f"(c[22][0]), "+f"(c[22][1]), "+f"(c[22][2]), "+f"(c[22][3]),
        "+f"(c[23][0]), "+f"(c[23][1]), "+f"(c[23][2]), "+f"(c[23][3]),
        "+f"(c[24][0]), "+f"(c[24][1]), "+f"(c[24][2]), "+f"(c[24][3]),
        "+f"(c[25][0]), "+f"(c[25][1]), "+f"(c[25][2]), "+f"(c[25][3]),
        "+f"(c[26][0]), "+f"(c[26][1]), "+f"(c[26][2]), "+f"(c[26][3]),
        "+f"(c[27][0]), "+f"(c[27][1]), "+f"(c[27][2]), "+f"(c[27][3]),
        "+f"(c[28][0]), "+f"(c[28][1]), "+f"(c[28][2]), "+f"(c[28][3]),
        "+f"(c[29][0]), "+f"(c[29][1]), "+f"(c[29][2]), "+f"(c[29][3]),
        "+f"(c[30][0]), "+f"(c[30][1]), "+f"(c[30][2]), "+f"(c[30][3]),
        "+f"(c[31][0]), "+f"(c[31][1]), "+f"(c[31][2]), "+f"(c[31][3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}


// c[64 x N] (+)= A . B with both operands read by shared-memory descriptors,
// each K-major (0) or MN-major (1, transposed); scale_d 0 overwrites c.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss_tr(float (&c)[N / 8][4], uint64_t da, uint64_t db,
                                            int scale_d) {
  static_assert(N == 32 || N == 64 || N == 128 || N == 256, "tiles are 32 to 256 wide");
  if constexpr (N == 32) wgmma_ss_n32_t<TA, TB>(c, da, db, scale_d);
  else if constexpr (N == 64) wgmma_ss_n64_t<TA, TB>(c, da, db, scale_d);
  else if constexpr (N == 128) wgmma_ss_n128_t<TA, TB>(c, da, db, scale_d);
  else wgmma_ss_n256_t<TA, TB>(c, da, db, scale_d);
}

// Four 8 x 8 bf16 matrices from shared memory, lane l naming row l % 8 of
// matrix l / 8; .trans delivers each transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + R) of one (b, h) slice into a swizzled shared tile,
// 16 bytes per copy, by the CTA's NTH threads; rows at or past L are zero.
template <int D, int R, int NTH = WG_THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* __restrict__ src,
                                          int64_t stride_l, int row0, int L) {
  constexpr int CPR = D / 8;  // chunks per row
  static_assert(R * CPR % NTH == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int it = 0; it < R * CPR / NTH; ++it) {
    const int i = threadIdx.x + it * NTH;
    const int r = i / CPR, c = i % CPR;
    const bool in = row0 + r < L;
    cp_async16(dst + swz<R>(r, c), src + (in ? (int64_t)(row0 + r) * stride_l + c * 8 : 0),
               in ? 16 : 0);
  }
}

// c[64 x N] = X . U^T for tiles X [64 x D] and U [N x D] in shared memory,
// both K-major: s = q.k^T (K2) or s^T = k.q^T (K3).  Issued and committed;
// the caller waits.  In c[j] the thread holds rows 16w + g and 16w + g + 8
// (w its warp, g = lane / 4), columns 8j + 2(lane % 4) and the one after.
template <int D, int N>
__device__ __forceinline__ void mma_xut(float (&c)[N / 8][4], uint32_t sX, uint32_t sU) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t k_off = (kk & 3) * 32;  // 16 columns into a 128-byte row
    wgmma_ss_tr<N, 0, 0>(c, gmma_desc(sX + (kk >> 2) * (WG_ROWS * 128) + k_off, 16, 1024),
                         gmma_desc(sU + (kk >> 2) * (N * 128) + k_off, 16, 1024), 1);
  }
  wg_commit();
}

// acc[64 x D] += P . U for P [64 x BN] as the warps' bf16 A fragments (one
// per 16-deep step) and the tile U [BN x D] read MN-major (transposed).
// Issued and committed; the caller waits.
template <int D, int BN>
__device__ __forceinline__ void mma_pu(float (&acc)[D / 8][4], const uint32_t (&pa)[BN / 16][4],
                                       uint32_t sU) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk], gmma_desc(sU + kk * 16 * 128, BN * 128, 1024));
  wg_commit();
}

// The accumulators of two adjacent 8-column blocks are the A fragment of
// one 16-deep step: round them to bf16 pairs.
template <int BN>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[BN / 16][4], const float (&c)[BN / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    pa[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    pa[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    pa[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// The thread's share of a 64 x D accumulator into rows row[0] (g) and
// row[1] (g+8) of a contiguous [B, L, H, D] output; rows past L skipped.
template <int D>
__device__ __forceinline__ void store_acc(bf16* __restrict__ out, const float (&acc)[D / 8][4],
                                          const int (&row)[2], int b, int h, int H, int L,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= L) continue;
    bf16* orow = out + (((int64_t)b * L + row[i]) * H + h) * D + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) = pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// The CTA's shared memory, rounded up to the 1024-byte alignment of the
// 128-byte swizzle (the launch asks for 1024 bytes more than it uses).
__device__ __forceinline__ uint32_t aligned_smem(unsigned char* smem) {
  return (smem_u32(smem) + 1023) & ~1023u;
}

}  // namespace
