// Fused GNN layer of IMA-GNN on Hopper: aggregation and feature extraction
// in one kernel, with Z = A_hat @ X kept out of device memory.
//
// Replaces the three Pallas TPU kernels of
// src/repro/kernels/fused_layer/fused_layer.py:
//   fused_ideal_layer (body _fused_ideal_kernel)  -> fused_ideal_kernel
//   fused_zmax        (body _fused_zmax_kernel)   -> fused_zmax_kernel
//   fused_quant_layer (bodies _fused_quant_kernel
//                      and _bit_serial_mvm)       -> fused_quant_kernel
// The TPU grid (node, s) carries one z row in VMEM scratch from one step to
// the next. On Hopper blocks run in parallel and in no order, so one block
// owns a tile of destination rows and loops over s itself.
//
// All three share the gather z[i, c] = sum_s w[i, s] * x[nbr[i, s], c], done
// with one rounded multiply and one rounded add per slot, in slot order
// (never an FMA), so z equals the plain PyTorch loop bit for bit.
//
// What bounds them on this card:
//   * fused_zmax and fused_ideal_kernel: bytes. Each (row, slot) gathers a
//     feature row of F floats; Z @ W adds 2*F*H flops per row, which at
//     H = 64 is still below the f32 ridge point. Loads are coalesced along F
//     and z never leaves the SM: the ideal kernel stages a BM x KC tile of z
//     and the matching KC x HT tile of W in shared memory, and each thread
//     keeps a 2 x 4 block of outputs in registers.
//   * fused_quant_kernel: operations. Each row does 2 signs x in_bits
//     bit-plane products of F x H (0/1 times integer codes). This simple
//     version does them as f32 FMAs on the CUDA cores: the partials are sums
//     of 0/1 times codes that are multiples of 1/8 below 2^21, exact in f32
//     in any order, so it reproduces the reference's integer-domain ADC
//     inputs exactly. An int8 tensor-core version is later work. Codes are
//     kept as bytes in shared memory so a 512-row crossbar tile of 16 rows
//     and both signs takes 16 KB. The tile loop and the ADC are shared with
//     crossbar_mvm.cu (crossbar_tile.cuh).
//
// Numerics: DAC codes use IEEE division by the runtime scale (__fdiv_rn);
// the ADC multiplies by the f32 reciprocal of its constant step, as XLA
// computes the reference's division by that constant; both round with rintf
// (half to even, as jnp.round and torch.round do); the build has no
// --use_fast_math. The quant kernel sums each crossbar tile's shifted ADC
// outputs before adding it to the running sum, and rescales each sign pass
// by scale * w_scale before the subtraction: the rounding order of the
// composed oracle (crossbar_matmul_signed_ref), so the fused and composed
// bit-accurate layers agree bit for bit. That matters: an ADC step is
// hundreds of integer units wide, so one ulp of difference in a layer's
// output can move a DAC code of the next layer and its ADC output by a step.
#include <cuda_runtime.h>

#include "crossbar_tile.cuh"

namespace {

__device__ __forceinline__ float gather_z(const float* __restrict__ x,
                                          const int* __restrict__ nr,
                                          const float* __restrict__ wr, int s,
                                          int f, int col) {
  float acc = 0.f;
  for (int k = 0; k < s; ++k) {
    const float xv = x[(long long)nr[k] * f + col];
    acc = __fadd_rn(acc, __fmul_rn(wr[k], xv));
  }
  return acc;
}

// ------------------------------------------------------------------ zmax

constexpr int kZCols = 128;  // threads along F per row
constexpr int kZRows = 4;    // rows per block

__global__ void fused_zmax_kernel(const float* __restrict__ x,
                                  const int* __restrict__ nbr,
                                  const float* __restrict__ wts,
                                  float* __restrict__ out, long long nd,
                                  int s, int f) {
  __shared__ float red[kZRows][kZCols / 32][2];
  const long long row = (long long)blockIdx.x * kZRows + threadIdx.y;
  float pmax = 0.f, nmax = 0.f;
  if (row < nd) {
    const int* nr = nbr + row * s;
    const float* wr = wts + row * s;
    for (int col = threadIdx.x; col < f; col += kZCols) {
      const float z = gather_z(x, nr, wr, s, f, col);
      pmax = fmaxf(pmax, fmaxf(z, 0.f));
      nmax = fmaxf(nmax, fmaxf(-z, 0.f));
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, o));
    nmax = fmaxf(nmax, __shfl_xor_sync(0xffffffffu, nmax, o));
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[threadIdx.y][warp][0] = pmax;
    red[threadIdx.y][warp][1] = nmax;
  }
  __syncthreads();
  if (threadIdx.x == 0 && row < nd) {
    for (int w = 1; w < kZCols / 32; ++w) {
      pmax = fmaxf(pmax, red[threadIdx.y][w][0]);
      nmax = fmaxf(nmax, red[threadIdx.y][w][1]);
    }
    out[row * 2] = pmax;
    out[row * 2 + 1] = nmax;
  }
}

// ----------------------------------------------------------------- ideal

constexpr int kThreads = 256;
constexpr int kIBM = 32;  // destination rows per block
constexpr int kIKC = 64;  // F columns of z staged per step
constexpr int kHT = 64;   // output columns per block

__global__ void __launch_bounds__(kThreads)
fused_ideal_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                   const float* __restrict__ wts, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   long long nd, int s, int f, int h, int relu) {
  __shared__ float zs[kIBM][kIKC + 1];  // +1: rows fall in distinct banks
  __shared__ float ws[kIKC][kHT];
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kIBM;
  const int col0 = blockIdx.y * kHT;
  const int tc = t % 16, tr = t / 16;  // outputs: rows tr, tr+16; cols tc+16j
  float acc[2][4] = {};
  for (int k0 = 0; k0 < f; k0 += kIKC) {
    for (int e = t; e < kIBM * kIKC; e += kThreads) {
      const int r = e / kIKC, k = e % kIKC;
      const long long row = row0 + r;
      const int col = k0 + k;
      zs[r][k] = (row < nd && col < f)
                     ? gather_z(x, nbr + row * s, wts + row * s, s, f, col)
                     : 0.f;
    }
    for (int e = t; e < kIKC * kHT; e += kThreads) {
      const int k = e / kHT, c = e % kHT;
      ws[k][c] = (k0 + k < f && col0 + c < h)
                     ? w[(long long)(k0 + k) * h + col0 + c]
                     : 0.f;
    }
    __syncthreads();
    const int kn = min(kIKC, f - k0);
    for (int k = 0; k < kn; ++k) {
      const float z0 = zs[tr][k], z1 = zs[tr + 16][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float wv = ws[k][tc + 16 * j];
        acc[0][j] = fmaf(z0, wv, acc[0][j]);
        acc[1][j] = fmaf(z1, wv, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + tr + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tc + 16 * j;
      if (row < nd && col < h) {
        float v = __fadd_rn(acc[i][j], b[col]);
        out[row * h + col] = relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

// ----------------------------------------------------------------- quant

__device__ __forceinline__ unsigned char dac(float part, float scale,
                                             float levels) {
  return (unsigned char)fminf(fmaxf(rintf(__fdiv_rn(part, scale)), 0.f),
                              levels);
}

// Dynamic shared memory (xbar::smem_bytes(2, r)): the staged conductance
// codes, then the DAC codes of one crossbar tile as bytes,
// codes[sign][xbar::kRows][r].
__global__ void __launch_bounds__(xbar::kThreads)
fused_quant_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                   const float* __restrict__ wts,
                   const float* __restrict__ wq, const float* __restrict__ b,
                   const float* __restrict__ scales, float* __restrict__ out,
                   long long nd, int s, int f, int h, int r, int nbits,
                   float fs, float lsb, float inv_lsb, int relu) {
  using namespace xbar;
  extern __shared__ float4 smem[];
  float* ws = reinterpret_cast<float*>(smem);
  unsigned char* codes = reinterpret_cast<unsigned char*>(smem) +
                         sizeof(float) * kStage * kCols;
  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const int col0 = blockIdx.y * kCols;
  const int tc = t % 16, tr = t / 16;  // outputs: row tr; cols tc+16j
  const float sp = scales[0], sn = scales[1], w_scale = scales[2];
  const float levels = (float)((1 << nbits) - 1);
  float mvm[2][4] = {};  // shift-and-add accumulators per sign
  for (int t0 = 0; t0 < f; t0 += r) {
    const int kt = min(r, f - t0);  // rows of this crossbar tile within F
    for (int e = t; e < kRows * r; e += xbar::kThreads) {
      const int rr = e / r, k = e % r;
      const long long row = row0 + rr;
      const float z =
          (row < nd && k < kt)
              ? gather_z(x, nbr + row * s, wts + row * s, s, f, t0 + k)
              : 0.f;
      codes[rr * r + k] = dac(fmaxf(z, 0.f), sp, levels);
      codes[(kRows + rr) * r + k] = dac(fmaxf(-z, 0.f), sn, levels);
    }
    float part[2][4][kMaxBits] = {};  // exact integer-domain partials
    tile_partials<2>(codes, r, kt, wq, h, t0, col0, ws, nbits, part);
    // ADC per (tile, bit), shift-and-add into this tile's sum, then the
    // digital add across tiles: the order of the composed oracle
    // (crossbar_matmul_ref), so both paths round alike.
#pragma unroll
    for (int sg = 0; sg < 2; ++sg) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mvm[sg][j] = __fadd_rn(
            mvm[sg][j], adc_shift_add(part[sg][j], nbits, fs, lsb, inv_lsb));
    }
    __syncthreads();  // all reads of this tile's codes done
  }
  // rescale each pass by its DAC scale times the conductance scale, then
  // recombine the signs: mvm_pos*(sp*ws) - mvm_neg*(sn*ws) + b
  const float cp = __fmul_rn(sp, w_scale), cn = __fmul_rn(sn, w_scale);
  const long long row = row0 + tr;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = col0 + tc + 16 * j;
    if (row < nd && col < h) {
      const float acc =
          __fsub_rn(__fmul_rn(mvm[0][j], cp), __fmul_rn(mvm[1][j], cn));
      const float v = __fadd_rn(acc, b[col]);
      out[row * h + col] = relu ? fmaxf(v, 0.f) : v;
    }
  }
}

}  // namespace

extern "C" int fused_zmax_f32(const void* x, const void* nbr, const void* wts,
                              void* out, long long nd, int s, int f,
                              void* stream) {
  const dim3 block(kZCols, kZRows);
  const dim3 grid((unsigned)((nd + kZRows - 1) / kZRows));
  fused_zmax_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)nbr, (const float*)wts, (float*)out, nd, s,
      f);
  return (int)cudaGetLastError();
}

extern "C" int fused_ideal_layer_f32(const void* x, const void* nbr,
                                     const void* wts, const void* w,
                                     const void* b, void* out, long long nd,
                                     int s, int f, int h, int relu,
                                     void* stream) {
  const dim3 grid((unsigned)((nd + kIBM - 1) / kIBM),
                  (unsigned)((h + kHT - 1) / kHT));
  fused_ideal_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)nbr, (const float*)wts, (const float*)w,
      (const float*)b, (float*)out, nd, s, f, h, relu);
  return (int)cudaGetLastError();
}

extern "C" int fused_quant_layer_f32(const void* x, const void* nbr,
                                     const void* wts, const void* wq,
                                     const void* b, const void* scales,
                                     void* out, long long nd, int s, int f,
                                     int h, int rows_per_xbar, int in_bits,
                                     float full_scale, float lsb,
                                     float inv_lsb, int relu, void* stream) {
  if (in_bits < 1 || in_bits > xbar::kMaxBits || rows_per_xbar < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = xbar::smem_bytes(2, rows_per_xbar);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_quant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)((nd + xbar::kRows - 1) / xbar::kRows),
                  (unsigned)((h + xbar::kCols - 1) / xbar::kCols));
  fused_quant_kernel<<<grid, xbar::kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)nbr, (const float*)wts, (const float*)wq,
      (const float*)b, (const float*)scales, (float*)out, nd, s, f, h,
      rows_per_xbar, in_bits, full_scale, lsb, inv_lsb, relu);
  return (int)cudaGetLastError();
}
