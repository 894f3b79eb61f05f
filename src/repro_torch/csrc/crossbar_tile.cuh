// The ADC of the bit-serial crossbar MVM, shared by both bit-accurate
// kernels: the fused quant layer (fused_layer.cu) and the standalone
// crossbar (crossbar_mvm.cu). Both run their bit-plane products on the int8
// tensor cores (crossbar_mma.cuh) and apply adc_shift_add to each crossbar
// tile's partials.
//
// Numerics. A bit-plane product sums 0/1 times conductance codes: integers,
// or multiples of 1/8 under conductance noise, exact in f32 while
// rows_per_xbar * 8 * max|code| < 2^24 (the wrappers raise above it), so
// every partial equals the plain version's matmul. The ADC clips,
// multiplies by the f32 reciprocal of its step (what XLA makes of the
// reference's division by the constant step), rounds half to even (rintf)
// and scales back by the step. Within a tile the ADC outputs are shifted and
// added in bit order with rounded operations (never an FMA): the plain
// loop's order, so the results agree bit for bit.
//
// Bit planes come in passes of kPlanes, one byte of the DAC codes each:
// pass g holds bits 8 g .. 8 g + 7. A tile's running sum is carried from
// one pass to the next, so codes wider than a byte (in_bits up to 30, the
// wrappers' limit) are shifted and added in the plain loop's bit order too.
#pragma once

#include <cuda_runtime.h>

namespace xbar {

constexpr int kPlanes = 8;    // bit planes of one pass: one byte of codes
constexpr int kMaxBits = 30;  // DAC codes of up to four bytes: 2^30 fits

__device__ __forceinline__ float adc(float partial, float fs, float lsb,
                                     float inv_lsb) {
  const float c = fminf(fmaxf(partial, -fs), fs);
  return __fmul_rn(rintf(__fmul_rn(c, inv_lsb)), lsb);
}

// The tile's running sum after pass `pass`: ADC of each of its bits'
// partials, shifted by 2^(8 pass + bit) and added in bit order to `tile`
// (0 before the first pass).
__device__ __forceinline__ float adc_shift_add(const float (&part)[kPlanes],
                                               int nbits, float fs, float lsb,
                                               float inv_lsb, int pass = 0,
                                               float tile = 0.f) {
#pragma unroll
  for (int bit = 0; bit < kPlanes; ++bit) {
    const int shift = kPlanes * pass + bit;
    if (shift < nbits) {
      tile = __fadd_rn(tile, __fmul_rn(adc(part[bit], fs, lsb, inv_lsb),
                                       (float)(1u << shift)));
    }
  }
  return tile;
}

}  // namespace xbar
