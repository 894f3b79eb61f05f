// One crossbar tile of the bit-serial MVM as f32 FMAs, for crossbar_kernel
// (crossbar_mvm.cu), and the ADC shared by both bit-accurate kernels: the
// fused quant layer (fused_layer.cu) runs its tile on the int8 tensor cores
// (crossbar_mma.cuh) and applies the same adc_shift_add.
//
// A block of kThreads threads owns kRows output rows and kCols output
// columns; thread t holds row t / 16 and columns t % 16 + 16 j, j < 4. Per
// crossbar tile of r rows the block's DAC codes sit in shared memory as
// bytes, codes[row * r + k], and the conductance codes are staged kStage
// rows at a time beside them.
//
// Numerics. A bit-plane product sums 0/1 times conductance codes: integers,
// or multiples of 1/8 under conductance noise, with |sum| <= r * 127 < 2^21,
// so every partial is exact in f32 in any order and equals the plain
// version's matmul. The ADC clips, multiplies by the f32 reciprocal of its
// step (what XLA makes of the reference's division by the constant step),
// rounds half to even (rintf) and scales back by the step. Within a tile the
// ADC outputs are shifted and added in bit order with rounded operations
// (never an FMA): the plain loop's order, so the results agree bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace xbar {

constexpr int kThreads = 256;  // threads per block
constexpr int kRows = 16;      // output rows per block (one per t / 16)
constexpr int kCols = 64;      // output columns per block (t % 16 + 16 j)
constexpr int kStage = 64;     // conductance rows staged per step
constexpr int kMaxBits = 8;    // DAC codes are kept as bytes

// Dynamic shared memory of a block: the staged conductance codes, then the
// byte codes of one r-row tile.
inline size_t smem_bytes(int r) {
  return sizeof(float) * kStage * kCols + (size_t)kRows * (size_t)r;
}

__device__ __forceinline__ float adc(float partial, float fs, float lsb,
                                     float inv_lsb) {
  const float c = fminf(fmaxf(partial, -fs), fs);
  return __fmul_rn(rintf(__fmul_rn(c, inv_lsb)), lsb);
}

// Bit-plane partial sums of one tile: rows [t0, t0 + kt) of wq ([*, h],
// row-major) against the codes in shared memory.
// part[j][b] += sum_k bit_b(codes[t / 16][k]) * wq[t0 + k][col_j].
// Starts with a barrier, so the caller's writes of the codes are seen.
__device__ __forceinline__ void tile_partials(
    const unsigned char* codes, int r, int kt, const float* __restrict__ wq,
    int h, int t0, int col0, float* ws_smem, int nbits,
    float (&part)[4][kMaxBits]) {
  float(*ws)[kCols] = reinterpret_cast<float(*)[kCols]>(ws_smem);
  const int t = threadIdx.x, tc = t % 16, tr = t / 16;
  for (int k0 = 0; k0 < kt; k0 += kStage) {
    __syncthreads();  // codes written / previous ws reads done
    for (int e = t; e < kStage * kCols; e += kThreads) {
      const int k = e / kCols, c = e % kCols;
      ws[k][c] = (k0 + k < kt && col0 + c < h)
                     ? wq[(long long)(t0 + k0 + k) * h + col0 + c]
                     : 0.f;
    }
    __syncthreads();
    const int kn = min(kStage, kt - k0);
    for (int k = 0; k < kn; ++k) {
      const unsigned code = codes[tr * r + k0 + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = ws[k][tc + 16 * j];
#pragma unroll
        for (int bit = 0; bit < kMaxBits; ++bit) {
          if (bit < nbits)
            part[j][bit] =
                fmaf((float)((code >> bit) & 1u), wv, part[j][bit]);
        }
      }
    }
  }
}

// The tile's contribution: ADC of each bit's partial, shifted and added in
// bit order.
__device__ __forceinline__ float adc_shift_add(const float (&part)[kMaxBits],
                                               int nbits, float fs, float lsb,
                                               float inv_lsb) {
  float tile = 0.f;
#pragma unroll
  for (int bit = 0; bit < kMaxBits; ++bit) {
    if (bit < nbits) {
      tile = __fadd_rn(tile, __fmul_rn(adc(part[bit], fs, lsb, inv_lsb),
                                       (float)(1u << bit)));
    }
  }
  return tile;
}

}  // namespace xbar
