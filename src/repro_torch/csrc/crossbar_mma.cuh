// One crossbar tile of the bit-serial MVM on the int8 tensor cores, for both
// bit-accurate kernels: the fused quant layer (fused_layer.cu) and the
// standalone crossbar (crossbar_mvm.cu). Both apply the ADC of
// crossbar_tile.cuh to its partials.
//
// A warp "unit" owns 16 rows (one m16 tile; in the quant layer, of one sign)
// and kCols output columns, and keeps int32 accumulators for the 8 bit
// planes of one pass (one byte of the DAC codes): acc[bit][j][4], 64
// registers a lane for one or two digits. Per k-step of 32 rows it loads
// its A fragment of DAC-code bytes once from shared memory (4 words, the
// mma.m16n8k32 .row layout) and the B fragments of the conductance digits
// (2 words per n8 tile and digit, .col layout), then for each bit b forms
// the 0/1 plane in registers, (word >> b) & 0x01010101, and issues
// mma.sync.m16n8k32.s32.s8.s8.s32 against each B fragment.
//
// Operands in shared memory, both with a row stride of 16 bytes more than a
// multiple of 32 (the staged depth + 16), which puts the 32 lanes' words in
// 32 distinct banks:
//   codes[row][k]     one byte of the DAC codes, u8;
//   digits[d][col][k] conductance digits, s8, k contiguous per column.
// k runs over the tile-padded depth: crossbar tile t holds rows
// [t * rpad, t * rpad + kt) with rpad = r rounded up to 32; the pad is 0.
//
// Digits. Integer codes with |code| <= 127: one s8 digit (kD = 1). Other
// codes (on the 1/8 grid under conductance noise, or beyond +-127) take D
// digits of 8 * code, an integer, in base kBase = 128, most significant
// first: 8 * code = sum_d kBase^(D - 1 - d) * digit[d], the lower digits in
// [0, 127] and the top one in [-128, 127], which holds |8 * code| < 2^(7 D).
// D = 2 (kD = 2) holds w_levels up to 2,047 (w_bits 12); D = 3 or 4 (kD = 3,
// the count given at run time) hold every code whose partials are exact in
// f32. With two digits the unit keeps one accumulator per digit and
// combines them at the ADC; with three or four it combines each k-step's
// products (independent MMAs, from 0) by Horner's rule, v = kBase * v +
// plane . digit[d], into one accumulator per bit, so that the registers do
// not grow with D.
//
// Exactness. The int32 sums are exact. The tile's partial for bit b is acc
// (kD = 1), (kBase * acc_hi + acc_lo) * 0.125f (kD = 2) or acc * 0.125f
// (kD = 3): an integer of magnitude <= r * 8 * max|code|, converted to f32
// exactly while that is below 2^24 (the wrappers raise above it), and
// scaled by a power of two. The plain version's f32 matmul of the 0/1 plane
// against the codes is exact under the same limit in any order, so both
// give the same f32 partial bit for bit, and the ADC (xbar::adc_shift_add)
// sees equal inputs.
#pragma once

#include <cuda_runtime.h>

#include "crossbar_tile.cuh"

namespace xmma {

constexpr int kRows = 16;     // rows of a row tile: one m16 tile
constexpr int kPlanes = xbar::kPlanes;
constexpr int kBase = 128;    // the base of the conductance digits
constexpr int kMaxDigits = 4;

// kD = 1 or 2 digits, or 3: three or four digits combined by Horner's rule.
template <int kD>
struct Shape {
  static constexpr int kNt = kD == 1 ? 2 : 1;  // n8 tiles per unit
  static constexpr int kCols = 8 * kNt;        // output columns per unit
  static constexpr int kAcc = kD == 3 ? kNt : kNt * kD;  // per bit
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

// Stages the conductance digits of columns [col0, col0 + bn) at depths
// [p0, p0 + pn) of the [ndig, n, kp] layout into ds[d][c][0, pn), a row
// stride of `stride` bytes, 16 bytes at a time (kp, p0 and pn multiples of
// 16); columns past n are 0. Every thread of the block calls it with its
// index and the block's thread count.
__device__ __forceinline__ void stage_digits(
    signed char* ds, const signed char* __restrict__ digits, int ndig, int n,
    int kp, int col0, int bn, int p0, int pn, int stride, int tid,
    int nthreads) {
  const int q16 = pn / 16;
  for (int e = tid; e < ndig * bn * q16; e += nthreads) {
    const int q = e % q16, dc = e / q16, c = dc % bn, d = dc / bn;
    int4 v = make_int4(0, 0, 0, 0);
    if (col0 + c < n)
      v = __ldg(reinterpret_cast<const int4*>(
                    digits + ((long long)d * n + col0 + c) * kp + p0) +
                q);
    *reinterpret_cast<int4*>(ds + dc * stride + 16 * q) = v;
  }
}

// acc[b][j] += plane_b(codes[0..16)[k]) . digits[d][col][k] over the
// ksteps k-steps of 32 from k0, for the nbits (<= 8) planes of one byte of
// the codes. codes: the unit's 16 code rows; digits: the unit's first
// column of digit 0; dstride: bytes from one digit to the next; ndig: the
// digit count where kD = 3 (3 or 4).
template <int kD>
__device__ __forceinline__ void tile_mma(
    const unsigned char* codes, const signed char* digits, int stride,
    int dstride, int k0, int ksteps, int nbits, int ndig,
    int (&acc)[kPlanes][Shape<kD>::kAcc][4]) {
  constexpr int kNt = Shape<kD>::kNt;
  constexpr int kB = kD == 3 ? kMaxDigits : kNt * kD;  // B fragments
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const unsigned char* a_lo = codes + g * stride + 4 * t;
  const unsigned char* a_hi = a_lo + 8 * stride;
  const signed char* bp = digits + g * stride + 4 * t;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int k = k0 + 32 * ks;
    const unsigned a0 = lds32(a_lo + k), a1 = lds32(a_hi + k);
    const unsigned a2 = lds32(a_lo + k + 16), a3 = lds32(a_hi + k + 16);
    unsigned b[kB][2];
    if constexpr (kD == 3) {
#pragma unroll
      for (int d = 0; d < kMaxDigits; ++d) {
        b[d][0] = b[d][1] = 0u;
        if (d < ndig) {
          const signed char* p = bp + d * dstride + k;
          b[d][0] = lds32(p);
          b[d][1] = lds32(p + 16);
        }
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
#pragma unroll
        for (int d = 0; d < kD; ++d) {
          const signed char* p = bp + d * dstride + nt * 8 * stride + k;
          b[nt * kD + d][0] = lds32(p);
          b[nt * kD + d][1] = lds32(p + 16);
        }
      }
    }
#pragma unroll
    for (int bit = 0; bit < kPlanes; ++bit) {
      if (bit < nbits) {
        const unsigned m = 0x01010101u;
        const unsigned p0 = (a0 >> bit) & m, p1 = (a1 >> bit) & m;
        const unsigned p2 = (a2 >> bit) & m, p3 = (a3 >> bit) & m;
        if constexpr (kD == 3) {  // independent products, then Horner
          int c[kMaxDigits][4];
#pragma unroll
          for (int d = 0; d < kMaxDigits; ++d) {
#pragma unroll
            for (int i = 0; i < 4; ++i) c[d][i] = 0;
            if (d < ndig) mma_s8(c[d], p0, p1, p2, p3, b[d][0], b[d][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            int v = c[0][i];
#pragma unroll
            for (int d = 1; d < kMaxDigits; ++d)
              if (d < ndig) v = v * kBase + c[d][i];
            acc[bit][0][i] += v;
          }
        } else {
#pragma unroll
          for (int j = 0; j < kNt * kD; ++j)
            mma_s8(acc[bit][j], p0, p1, p2, p3, b[j][0], b[j][1]);
        }
      }
    }
  }
}

// The f32 partial of bit `bit` at accumulator element (nt, e).
template <int kD>
__device__ __forceinline__ float partial(
    const int (&acc)[kPlanes][Shape<kD>::kAcc][4], int bit, int nt, int e) {
  if constexpr (kD == 1) {
    return __int2float_rn(acc[bit][nt][e]);
  } else if constexpr (kD == 2) {
    const int v = kBase * acc[bit][2 * nt][e] + acc[bit][2 * nt + 1][e];
    return __fmul_rn(__int2float_rn(v), 0.125f);
  } else {
    return __fmul_rn(__int2float_rn(acc[bit][nt][e]), 0.125f);
  }
}

// Pass `pass` of a tile: the ADC of its bits' partials, shifted and added
// in bit order into the tile's running sums tile[nt][e]
// (xbar::adc_shift_add). tile[nt][e] is the output at row g + 8 (e >> 1),
// column nt * 8 + 2 t + (e & 1) of the unit.
template <int kD>
__device__ __forceinline__ void pass_adc(
    const int (&acc)[kPlanes][Shape<kD>::kAcc][4], int nbits, int pass,
    float fs, float lsb, float inv_lsb, float (&tile)[Shape<kD>::kNt][4]) {
#pragma unroll
  for (int nt = 0; nt < Shape<kD>::kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float part[kPlanes];
#pragma unroll
      for (int bit = 0; bit < kPlanes; ++bit)
        part[bit] = partial<kD>(acc, bit, nt, e);
      tile[nt][e] = xbar::adc_shift_add(part, nbits, fs, lsb, inv_lsb, pass,
                                        tile[nt][e]);
    }
  }
}

// The tile's contribution to the unit's running sums where its codes fit
// one pass, in the order of the plain version: per output, the ADC of each
// bit's partial shifted and added in bit order, then one rounded add
// across tiles.
template <int kD>
__device__ __forceinline__ void tile_adc(
    const int (&acc)[kPlanes][Shape<kD>::kAcc][4], int nbits, float fs,
    float lsb, float inv_lsb, float (&mvm)[Shape<kD>::kNt][4]) {
#pragma unroll
  for (int nt = 0; nt < Shape<kD>::kNt; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float part[kPlanes];
#pragma unroll
      for (int bit = 0; bit < kPlanes; ++bit)
        part[bit] = partial<kD>(acc, bit, nt, e);
      mvm[nt][e] = __fadd_rn(
          mvm[nt][e], xbar::adc_shift_add(part, nbits, fs, lsb, inv_lsb));
    }
  }
}

}  // namespace xmma
