// f32 matrix products on the TF32 tensor cores with f32 accuracy (3xTF32),
// for the fused ideal layer (fused_layer.cu).
//
// Each f32 operand v is split in registers into two TF32 values,
//   hi = cvt.rna.tf32(v),  lo = cvt.rna.tf32(v - hi),
// (v - hi is exact in f32), so v = hi + lo up to 2^-22 |v|; the rounding
// is done with integer operations that give cvt.rna's bits on finite
// values. A product a * b is taken as a_lo * b_hi + a_hi * b_lo +
// a_hi * b_hi; the dropped lo * lo term is below 2^-22 |a b|. Every TF32
// product is exact in f32 (11-bit significands), and the tensor cores sum
// them into f32 accumulators. Per fragment the two small terms go in first
// and hi * hi last, so the large term meets an accumulator that already
// holds the corrections. Plain TF32
// (hi * hi alone) keeps about 2^-11 relative per product, far outside the
// ideal layer's rtol 1e-5; tests/test_torch_kernels.py emulates both.
//
// Fragments of mma.sync.m16n8k8 .tf32 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//                          a3 (g + 8, t + 4);
//   B (8 x 8, k by n):     b0 (t, g), b1 (t + 4, g);
//   C (16 x 8):            c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
//                          c3 (g + 8, 2t + 1).
// Loads take the operands from shared memory as f32: A from z[row][k] with a
// row stride of 4 mod 32 words, B from w[k][col] with a row stride of 8 mod
// 32 words; both put the 32 lanes' words in 32 distinct banks.
#pragma once

#include <cuda_runtime.h>

namespace tf32 {

struct Split {
  unsigned hi, lo;
};

// cvt.rna.tf32.f32 on finite v: half an ulp of TF32 added to the magnitude
// bits (ties away from zero), the 13 bits below TF32 cleared; two integer
// operations at the ALU's full rate.
__device__ __forceinline__ unsigned to_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ Split split(float v) {
  const unsigned hi = to_tf32(v);
  return {hi, to_tf32(__fsub_rn(v, __uint_as_float(hi)))};
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[m][n] += z[16 m .., k0 .. k0 + 8) . w[k0 .. k0 + 8)[8 n ..] for an
// kMt x kNt grid of m16 x n8 tiles: z points at the warp's first row and
// column k0, w at row k0 and the warp's first column.
template <int kMt, int kNt>
__device__ __forceinline__ void k8_step(const float* z, int zstride,
                                        const float* w, int wstride,
                                        float (&acc)[kMt][kNt][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned ahi[kMt][4], alo[kMt][4], bhi[kNt][2], blo[kNt][2];
#pragma unroll
  for (int m = 0; m < kMt; ++m) {
    const float* p = z + (16 * m + g) * zstride + t;
    const float v[4] = {p[0], p[8 * zstride], p[4], p[8 * zstride + 4]};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Split s = split(v[i]);
      ahi[m][i] = s.hi;
      alo[m][i] = s.lo;
    }
  }
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    const float* p = w + t * wstride + 8 * n + g;
    const Split s0 = split(p[0]), s1 = split(p[4 * wstride]);
    bhi[n][0] = s0.hi;
    blo[n][0] = s0.lo;
    bhi[n][1] = s1.hi;
    blo[n][1] = s1.lo;
  }
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int n = 0; n < kNt; ++n) mma(acc[m][n], alo[m], bhi[n][0], bhi[n][1]);
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int n = 0; n < kNt; ++n) mma(acc[m][n], ahi[m], blo[n][0], blo[n][1]);
#pragma unroll
  for (int m = 0; m < kMt; ++m)
#pragma unroll
    for (int n = 0; n < kNt; ++n) mma(acc[m][n], ahi[m], bhi[n][0], bhi[n][1]);
}

}  // namespace tf32
