// One crossbar tile of the bit-serial MVM on the int8 tensor cores, for both
// bit-accurate kernels: the fused quant layer (fused_layer.cu) and the
// standalone crossbar (crossbar_mvm.cu). Both apply the ADC of
// crossbar_tile.cuh to its partials.
//
// A warp "unit" owns 16 rows (one m16 tile; in the quant layer, of one sign)
// and kCols output columns, and keeps int32 accumulators for every input bit of the tile:
// acc[bit][j][4], j = n8 tile * kD + digit, 64 registers a lane. Per k-step
// of 32 rows it loads its A fragment of DAC-code bytes once from shared
// memory (4 words, the mma.m16n8k32 .row layout) and the B fragments of the
// conductance digits (2 words per n8 tile and digit, .col layout), then for
// each bit b forms the 0/1 plane in registers, (word >> b) & 0x01010101, and
// issues mma.sync.m16n8k32.s32.s8.s8.s32 against each B fragment.
//
// Operands in shared memory, both with a row stride of 16 bytes more than a
// multiple of 32 (the staged depth + 16), which puts the 32 lanes' words in
// 32 distinct banks:
//   codes[row][k]     DAC codes, u8;
//   digits[d][col][k] conductance digits, s8, k contiguous per column.
// k runs over the tile-padded depth: crossbar tile t holds rows
// [t * rpad, t * rpad + kt) with rpad = r rounded up to 32; the pad is 0.
//
// Digits. Integer codes with |code| <= 127: one s8 digit (kD = 1). Codes on
// the 1/8 grid (conductance noise) or beyond +-127 take two: 8 * code is an
// integer of magnitude <= 8 * 511, split as 32 * hi + lo with hi in
// [-128, 127] and lo in [0, 31] (kD = 2, digit 0 = hi).
//
// Exactness. The int32 sums are exact. The tile's partial for bit b is
// acc (kD = 1) or (32 * acc_hi + acc_lo) * 0.125f (kD = 2): an integer of
// magnitude <= r * 8 * max|code|, converted to f32 exactly while that is
// below 2^24 (the wrappers raise above it), and scaled by a power of two.
// The plain version's f32 matmul of the 0/1 plane against the codes is
// exact under the same limit in any order, so both give the same f32
// partial bit for bit, and the ADC (xbar::adc_shift_add) sees equal inputs.
#pragma once

#include <cuda_runtime.h>

#include "crossbar_tile.cuh"

namespace xmma {

constexpr int kRows = 16;     // rows of a row tile: one m16 tile
constexpr int kMaxBits = xbar::kMaxBits;

template <int kD>
struct Shape {
  static constexpr int kNt = kD == 1 ? 2 : 1;  // n8 tiles per unit
  static constexpr int kCols = 8 * kNt;        // output columns per unit
  static constexpr int kAcc = kNt * kD;        // accumulator tiles per bit
};

__device__ __forceinline__ unsigned lds32(const void* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[b][j] += plane_b(codes[0..16)[k]) . digits[d][col][k] over the
// ksteps k-steps of 32 from k0. codes: the unit's 16 code rows; digits: the
// unit's first column of digit 0; dstride: bytes from one digit to the next.
template <int kD>
__device__ __forceinline__ void tile_mma(
    const unsigned char* codes, const signed char* digits, int stride,
    int dstride, int k0, int ksteps, int nbits,
    int (&acc)[kMaxBits][Shape<kD>::kAcc][4]) {
  constexpr int kNt = Shape<kD>::kNt;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* a_lo = codes + g * stride + 4 * t;
  const unsigned char* a_hi = a_lo + 8 * stride;
  const signed char* bp = digits + g * stride + 4 * t;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = k0 + 32 * ks;
    const unsigned a0 = lds32(a_lo + k), a1 = lds32(a_hi + k);
    const unsigned a2 = lds32(a_lo + k + 16), a3 = lds32(a_hi + k + 16);
    unsigned b[kNt * kD][2];
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const signed char* p = bp + d * dstride + nt * 8 * stride + k;
        b[nt * kD + d][0] = lds32(p);
        b[nt * kD + d][1] = lds32(p + 16);
      }
    }
#pragma unroll
    for (int bit = 0; bit < kMaxBits; ++bit) {
      if (bit < nbits) {
        const unsigned m = 0x01010101u;
        const unsigned p0 = (a0 >> bit) & m, p1 = (a1 >> bit) & m;
        const unsigned p2 = (a2 >> bit) & m, p3 = (a3 >> bit) & m;
#pragma unroll
        for (int j = 0; j < kNt * kD; ++j)
          mma_s8(acc[bit][j], p0, p1, p2, p3, b[j][0], b[j][1]);
      }
    }
  }
}

// The tile's contribution to the unit's running sums, in the order of the
// plain version: per output, the ADC of each bit's partial shifted and added
// in bit order (xbar::adc_shift_add), then one rounded add across tiles.
// mvm[nt][e] is the output at row g + 8 (e >> 1), column nt * 8 + 2 t + (e & 1).
template <int kD>
__device__ __forceinline__ void tile_adc(
    const int (&acc)[kMaxBits][Shape<kD>::kAcc][4], int nbits, float fs,
    float lsb, float inv_lsb, float (&mvm)[Shape<kD>::kNt][4]) {
#pragma unroll
  for (int nt = 0; nt < Shape<kD>::kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float part[kMaxBits];
#pragma unroll
      for (int bit = 0; bit < kMaxBits; ++bit) {
        if constexpr (kD == 1) {
          part[bit] = __int2float_rn(acc[bit][nt][e]);
        } else {
          const int v = 32 * acc[bit][2 * nt][e] + acc[bit][2 * nt + 1][e];
          part[bit] = __fmul_rn(__int2float_rn(v), 0.125f);
        }
      }
      mvm[nt][e] = __fadd_rn(
          mvm[nt][e], xbar::adc_shift_add(part, nbits, fs, lsb, inv_lsb));
    }
  }
}

}  // namespace xmma
