// Hopper warpgroup matrix multiply (`wgmma`) with operands in shared memory
// laid out in 128-byte swizzled panels, and its fences: the flash-attention
// kernels' products (flash_attention.cu).
//
// The layout: a tile of R rows x 128 bf16 columns is two panels of 64
// columns, each R rows of 128 bytes; 16-byte chunk c of row r of a panel
// sits at chunk c ^ (r % 8) of its row. Tiles start on 1,024-byte
// boundaries. That is the `wgmma` 128-byte swizzle, so a descriptor reads a
// tile as it is, and `ldmatrix` reads 8 rows of one chunk without bank
// conflicts:
//   * K-major operand (rows = M or N, columns = K): a 16-column step k of
//     the product starts at panel k / 4, byte 32 (k % 4) of its row 0;
//     8-row groups are 1,024 bytes apart (SBO).
//   * MN-major operand (rows = K, columns = N; transposed): a 16-row step
//     starts 2,048 bytes further in the first panel; the second panel (the
//     next 64 columns of N) is `R * 128` bytes on (LBO), 8-row groups
//     again 1,024 bytes apart.
// Accumulators: warp w of the warpgroup holds rows 16 w .. 16 w + 15 of a
// 64-row product, as `mma.sync` m16n8 holds a 16 x 8 tile: register
// 4 n + e is row (lane / 4) + 8 (e / 2), column 8 n + 2 (lane % 4) + e % 2.
// An A operand from registers is the `mma.sync` m16n8k16 A fragment of the
// warp's 16 rows.
#pragma once

#include <stdint.h>

namespace wg {

// byte offset of 16-byte chunk c (0..15) of row `row` of a `rows`-row tile
__device__ __forceinline__ uint32_t swz(int rows, int row, int c) {
  return (c >> 3) * rows * 128 + row * 128 + (((c & 7) ^ (row & 7)) << 4);
}

// a shared memory matrix descriptor, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand: 16-column step k of a `rows`-row tile at `tile`
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int k) {
  return desc(tile + (k >> 2) * rows * 128 + (k & 3) * 32, 16, 1024);
}

// MN-major operand: 16-row step k of a `rows`-row tile (N = 128 columns)
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int k) {
  return desc(tile + k * 2048, rows * 128, 1024);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared memory written by this thread's ordinary or cp.async stores,
// made visible to the products that read it through descriptors
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across a product
template <int N>
__device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A B, A (64 x 16) and B (16 x 64) in shared memory (descriptors),
// both K-major
__device__ __forceinline__ void ss_m64n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(0));
}

// d += A B, A (64 x 16) and B (16 x 32) in shared memory (descriptors),
// both K-major
__device__ __forceinline__ void ss_m64n32(float (&d)[16], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(1), "n"(0));
}

// d += A B, A (64 x 16) from registers (the mma.sync A fragment of each
// warp's 16 rows), B (16 x 128) in shared memory, MN-major
__device__ __forceinline__ void rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(1));
}

}  // namespace wg
