// Bit-serial RRAM crossbar MVM of IMA-GNN on Hopper, on codes:
// out[m, n] = sum over rows_per_xbar K tiles (in order) of
//             sum over input bits b (in order) of
//             ADC(plane_b(xq[m, tile]) . wq[tile, n]) * 2^b
// in the integer domain (the caller rescales).
//
// Replaces the Pallas TPU kernel `crossbar_matmul_quantized` (body `_kernel`)
// in src/repro/kernels/crossbar_mvm/crossbar_mvm.py. The TPU grid walks
// (M/bm, N/bn, K/bk) with the K axis sequential, carrying the sum in the
// revisited output block, and needs every dimension padded to its block.
// Here a block owns kRows x kCols outputs and loops over the K tiles itself,
// in order; it masks ragged M, N and K, so nothing is padded.
//
// What bounds it on this card: bytes, by the read-once count. At the
// centralized collab layer-1 shape (M = 372,475, K = 496, N = 64) the int32
// codes are 739 MB against 189 G bit-plane operations, which int8 tensor
// cores would do in a third of the time the bytes take. This simple version
// does the bit-plane products as f32 FMAs on the CUDA cores instead (one FMA
// per bit, row and column: 2.8 ms at the f32 peak), so in practice it is
// bound by operations; an int8 tensor-core version is later work. What the
// design does: each int32 code is read from device memory once per block,
// kept as one byte in shared memory (in_bits <= 8), and the staged
// conductance codes are reused by the block's 16 rows. The ADC is shared with
// the fused quant layer (crossbar_tile.cuh), so both paths round alike and
// equal the plain version bit for bit.
#include <cuda_runtime.h>

#include "crossbar_tile.cuh"

namespace {

// Dynamic shared memory (xbar::smem_bytes(r)): the staged conductance
// codes, then the DAC codes of one crossbar tile as bytes, codes[kRows][r].
__global__ void __launch_bounds__(xbar::kThreads)
crossbar_kernel(const int* __restrict__ xq, const float* __restrict__ wq,
                float* __restrict__ out, long long m, int k, int n, int r,
                int nbits, float fs, float lsb, float inv_lsb) {
  using namespace xbar;
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* codes = reinterpret_cast<unsigned char*>(smem) +
                         sizeof(float) * kStage * kCols;
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tc = t % 16, tr = t / 16;  // outputs: row tr; cols tc+16j
  float acc[4] = {};                   // digital sum across tiles
  for (int t0 = 0; t0 < k; t0 += r) {
    const int kt = min(r, k - t0);  // rows of this crossbar tile within K
    for (int e = t; e < kRows * r; e += kThreads) {
      const int rr = e / r, kk = e % r;
      const long long row = row0 + rr;
      codes[rr * r + kk] =
          (row < m && kk < kt) ? (unsigned char)xq[row * k + t0 + kk] : 0;
    }
    float part[4][kMaxBits] = {};  // exact integer-domain partials
    tile_partials(codes, r, kt, wq, n, t0, col0, ws, nbits, part);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = __fadd_rn(acc[j],
                         adc_shift_add(part[j], nbits, fs, lsb, inv_lsb));
    __syncthreads();  // all reads of this tile's codes done
  }
  const long long row = row0 + tr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + tc + 16 * j;
    if (row < m && col < n) out[row * n + col] = acc[j];
  }
}

}  // namespace

extern "C" int crossbar_matmul_quantized_f32(
    const void* xq, const void* wq, void* out, long long m, int k, int n,
    int rows_per_xbar, int in_bits, float full_scale, float lsb,
    float inv_lsb, void* stream) {
  if (in_bits < 1 || in_bits > xbar::kMaxBits || rows_per_xbar < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = xbar::smem_bytes(rows_per_xbar);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        crossbar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((m + xbar::kRows - 1) / xbar::kRows),
                  (unsigned)((n + xbar::kCols - 1) / xbar::kCols));
  crossbar_kernel<<<grid, xbar::kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)xq, (const float*)wq, (float*)out, m, k, n, rows_per_xbar,
      in_bits, full_scale, lsb, inv_lsb);
  return (int)cudaGetLastError();
}
