// Aggregation core of IMA-GNN on Hopper: z[i, :] = sum_s w[i, s] * x[nbr[i, s], :].
//
// Replaces the Pallas TPU kernel `csr_aggregate` (and its body `_kernel`) in
// src/repro/kernels/csr_aggregate/csr_aggregate.py. The TPU version walks a
// sequential grid (node, F/bf, S) and carries the row sum in the revisited
// output block; here one block owns a tile of destination rows and a
// 128-wide slice of F, and each thread sums one column over s = 0..S-1
// inside the block, in slot order.
//
// What bounds it on this card: bytes. Every (row, slot) pair gathers one
// feature row of F floats (2 flops per 4 bytes read), so the kernel is far
// below the f32 ridge point and lives on memory bandwidth. The design keeps
// the loads coalesced along F (a warp reads 32 consecutive floats of one
// gathered row), reads each neighbour index and weight once per thread from
// L1, and writes z once.
//
// Numerics: one rounded multiply and one rounded add per slot
// (__fmul_rn/__fadd_rn, never contracted into an FMA), in slot order, so the
// result equals the plain PyTorch loop bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // F columns per block (one per thread in x)
constexpr int kRows = 4;    // destination rows per block (threads in y)

__global__ void csr_aggregate_kernel(const float* __restrict__ x,
                                     const int* __restrict__ nbr,
                                     const float* __restrict__ wts,
                                     float* __restrict__ out,
                                     long long nd, int s, int f) {
  const long long row = (long long)blockIdx.x * kRows + threadIdx.y;
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (row >= nd || col >= f) return;
  const int* nr = nbr + row * s;
  const float* wr = wts + row * s;
  float acc = 0.f;
  for (int k = 0; k < s; ++k) {
    const float xv = x[(long long)nr[k] * f + col];
    acc = __fadd_rn(acc, __fmul_rn(wr[k], xv));
  }
  out[row * f + col] = acc;
}

}  // namespace

extern "C" int csr_aggregate_f32(const void* x, const void* nbr,
                                 const void* wts, void* out, long long nd,
                                 int s, int f, void* stream) {
  const dim3 block(kCols, kRows);
  const dim3 grid((unsigned)((nd + kRows - 1) / kRows),
                  (unsigned)((f + kCols - 1) / kCols));
  csr_aggregate_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)nbr, (const float*)wts, (float*)out, nd, s,
      f);
  return (int)cudaGetLastError();
}
