// Aggregation core of IMA-GNN on Hopper: z[i, :] = sum_s w[i, s] * x[nbr[i, s], :].
//
// Replaces the Pallas TPU kernel `csr_aggregate` (and its body `_kernel`) in
// src/repro/kernels/csr_aggregate/csr_aggregate.py. The TPU version walks a
// sequential grid (node, F/bf, S) and carries the row sum in the revisited
// output block; here a warp (half a warp when F <= 64) owns one
// destination row and sums its slots in slot order itself
// (warp_gather.cuh).
//
// What bounds it on this card: bytes. Every live (row, slot) pair gathers
// one feature row of F floats (2 flops per 4 bytes read), far below the f32
// ridge point, and on the serving path most slots are padding (weight 0,
// index 0: 17 % of the collab sample's slots are live). The design: the
// row's group reads its slot table once, skips weight-0 slots, so padding
// costs no load, an L2 hit or an add per output element; loads each live
// source row as float4 (16 bytes a lane, neighbouring lanes on neighbouring
// addresses, through the read-only path) with two live slots' loads in
// flight; and writes z once as float4 with a streaming store. A scalar
// variant of the same loop, in the same slot order, takes F % 4 != 0 or
// unaligned operands.
//
// Launch choice: warps per block, 4, 8 (the default) or 16, a template
// parameter (tuning's AggregateConfig.warps). A row's sum is the same in
// any block, so every choice gives the same bits.
//
// Numerics: one rounded multiply and one rounded add per live slot
// (__fmul_rn/__fadd_rn, never contracted into an FMA), in slot order, from
// +0. A skipped weight-0 slot would add 0 * x = +-0, which changes no bit of
// a sum that starts at +0 (such a sum is never -0 under round to nearest),
// so for finite x the result equals the plain PyTorch loop bit for bit.
#include <cuda_runtime.h>

#include "warp_gather.cuh"

namespace {

// One destination row per kLanes lanes: 32 / kLanes rows per warp.
template <bool kVec, int kLanes, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
csr_aggregate_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                     const float* __restrict__ wts, float* __restrict__ out,
                     long long nd, int s, int f) {
  using T = typename gather::Unit<kVec>::T;
  const long long row =
      ((long long)blockIdx.x * 32 * kWarps + threadIdx.x) / kLanes;
  const long long warp_row0 =
      ((long long)blockIdx.x * 32 * kWarps + (threadIdx.x & ~31)) / kLanes;
  if (warp_row0 >= nd) return;  // uniform across the warp
  const bool active = row < nd;
  const long long r = active ? row : warp_row0;
  T* o = reinterpret_cast<T*>(out + r * f);
  gather::warp_rows<kVec, kLanes, true>(
      x, nbr + r * s, wts + r * s, s, f, active,
      [&](int c, const T& z) { __stcs(o + c, z); });
}

template <bool kVec, int kLanes, int kWarps>
void launch(const void* x, const void* nbr, const void* wts, void* out,
            long long nd, int s, int f, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = 32 * kWarps / kLanes;
  const dim3 grid((unsigned)((nd + kRowsPerBlock - 1) / kRowsPerBlock));
  csr_aggregate_kernel<kVec, kLanes, kWarps>
      <<<grid, 32 * kWarps, 0, stream>>>((const float*)x, (const int*)nbr,
                                         (const float*)wts, (float*)out, nd,
                                         s, f);
}

template <int kWarps>
void dispatch(bool vec, bool half, const void* x, const void* nbr,
              const void* wts, void* out, long long nd, int s, int f,
              cudaStream_t st) {
  if (vec)
    (half ? launch<true, 16, kWarps> : launch<true, 32, kWarps>)(
        x, nbr, wts, out, nd, s, f, st);
  else
    (half ? launch<false, 16, kWarps> : launch<false, 32, kWarps>)(
        x, nbr, wts, out, nd, s, f, st);
}

}  // namespace

extern "C" int csr_aggregate_f32(const void* x, const void* nbr,
                                 const void* wts, void* out, long long nd,
                                 int s, int f, int warps, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const bool vec = gather::vector_ok(f, x, out);
  const bool half = gather::lanes_for(f, vec) == 16;
  if (warps == 4)
    dispatch<4>(vec, half, x, nbr, wts, out, nd, s, f, st);
  else if (warps == 8)
    dispatch<8>(vec, half, x, nbr, wts, out, nd, s, f, st);
  else if (warps == 16)
    dispatch<16>(vec, half, x, nbr, wts, out, nd, s, f, st);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
