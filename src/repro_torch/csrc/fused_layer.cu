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
// All three compute the gather z[i, c] = sum_s w[i, s] * x[nbr[i, s], c]
// with one rounded multiply and one rounded add per slot, in slot order
// (never an FMA), so z equals the plain PyTorch loop bit for bit. zmax and
// the ideal kernel still visit every slot, padding included; the quant
// kernel gathers with warp_gather.cuh, which skips weight-0 slots (the same
// bits for finite x: see that header).
//
// What bounds them on this card:
//   * fused_zmax and fused_ideal_kernel: bytes. Each (row, slot) gathers a
//     feature row of F floats; Z @ W adds 2*F*H flops per row, which at
//     H = 64 is still below the f32 ridge point. Loads are coalesced along F
//     and z never leaves the SM: the ideal kernel stages a BM x KC tile of z
//     and the matching KC x HT tile of W in shared memory, and each thread
//     keeps a 2 x 4 block of outputs in registers.
//   * fused_quant_kernel: bytes, by the read-once count; its 2 signs x
//     in_bits bit-plane products of F x H per row are int8 tensor-core work
//     (crossbar_mma.cuh) that the card could do in less time than it takes
//     to read x. In practice the MMA phase and the gather take the time, one
//     after the other. The design: the block's conductance digits sit in
//     shared memory as int8 for its whole life (a persistent grid of row
//     tiles); 32 lanes (16 at F <= 64) gather a row with float4 loads,
//     skipping padding slots, and write both signs' DAC codes as bytes
//     after one division per element; bit planes are made in registers from
//     the code bytes and fed to mma.sync m16n8k32 s8 with int32
//     accumulators, and two blocks share an SM.
//
// Exactness of the quant kernel: the int32 sums are exact, and the partial
// of each (tile, bit) is converted to f32 exactly while
// rows_per_xbar * 8 * w_levels < 2^24 (the wrapper raises above it), where
// the plain version's f32 matmul is exact too; both then apply the same ADC
// to the same f32 value (crossbar_mma.cuh).
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

#include <algorithm>

#include "crossbar_mma.cuh"
#include "warp_gather.cuh"

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

constexpr int kQWarps = 8;
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQMaxCols = 64;  // output columns per block, at most

// DAC code of z's non-zero sign pass: one IEEE division of |z| by that
// pass's scale, rounded half to even and clipped; the other pass's code is
// 0. The same codes as dividing max(z, 0) by sp and max(-z, 0) by sn.
__device__ __forceinline__ unsigned dac(float z, float sp, float sn,
                                        float levels) {
  return (unsigned)fminf(
      fmaxf(rintf(__fdiv_rn(fabsf(z), z > 0.f ? sp : sn)), 0.f), levels);
}

// Dynamic shared memory (quant_smem): the block's conductance digits
// ds[kD][bn][stride], both signs' DAC codes of one row tile
// codes[2][rows][stride], and the per-sign sums mv[2][rows][bn + 1];
// stride = kp + 16 bytes (crossbar_mma.cuh), rows = 16 * mt. Persistent: a
// block keeps its bn columns of digits for its whole life and walks row
// tiles of mt m16 tiles (mt > 1 where bn is narrow, so that every warp has
// a unit). A row is gathered by kLanes lanes (16 at F <= 64).
template <int kD, bool kVec, int kLanes>
__global__ void __launch_bounds__(kQThreads, 2)
fused_quant_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                   const float* __restrict__ wts,
                   const signed char* __restrict__ digits,
                   const float* __restrict__ b,
                   const float* __restrict__ scales, float* __restrict__ out,
                   long long nd, int s, int f, int h, int r, int rpad, int kp,
                   int bn, int mt, int nbits, float fs, float lsb,
                   float inv_lsb, int relu) {
  using S = xmma::Shape<kD>;
  using T = typename gather::Unit<kVec>::T;
  constexpr int kGroups = 32 / kLanes;  // rows a warp gathers at once
  const int rows = xmma::kRows * mt;  // rows of a row tile
  extern __shared__ int4 smem[];
  const int stride = kp + 16;
  signed char* ds = reinterpret_cast<signed char*>(smem);
  unsigned char* codes =
      reinterpret_cast<unsigned char*>(ds + kD * bn * stride);
  float* mv = reinterpret_cast<float*>(codes + 2 * rows * stride);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int col0 = blockIdx.y * bn;
  const int kp16 = kp / 16;
  for (int e = tid; e < kD * bn * kp16; e += kQThreads) {
    const int q = e % kp16, dc = e / kp16, c = dc % bn, d = dc / bn;
    int4 v = make_int4(0, 0, 0, 0);
    if (col0 + c < h)
      v = __ldg(reinterpret_cast<const int4*>(
                    digits + ((long long)d * h + col0 + c) * kp) + q);
    *reinterpret_cast<int4*>(ds + dc * stride + 16 * q) = v;
  }
  for (int e = tid; e < 2 * rows * stride / 16; e += kQThreads)
    reinterpret_cast<int4*>(codes)[e] = make_int4(0, 0, 0, 0);  // pads: 0
  const float sp = scales[0], sn = scales[1];
  const float cp = __fmul_rn(sp, scales[2]), cn = __fmul_rn(sn, scales[2]);
  const float levels = (float)((1 << nbits) - 1);
  const int ntiles = (f + r - 1) / r;
  const int ncg = bn / S::kCols;
  const int units = 2 * ncg * mt;  // (sign, column group, m16 tile)
  const int mstride = bn + 1;
  const long long row_tiles = (nd + rows - 1) / rows;
  __syncthreads();
  for (long long tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
    const long long row0 = tile * rows;
    // 1. z of each row by kLanes lanes, both signs' DAC codes as bytes at
    //    their tile-padded depth p = (k / r) * rpad + k % r.
    for (int rw = warp * kGroups; rw < rows; rw += kQWarps * kGroups) {
      const int rr = rw + lane / kLanes;
      const long long row = row0 + rr;
      const bool active = row < nd;
      unsigned char* cpos = codes + rr * stride;
      unsigned char* cneg = codes + (rows + rr) * stride;
      auto emit = [&](int c, const T& z) {
        if constexpr (kVec) {
          const int k = 4 * c, p = k / r * rpad + k % r;
          const float zs[4] = {z.x, z.y, z.z, z.w};
          unsigned wp = 0, wn = 0;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const unsigned q = dac(zs[i], sp, sn, levels);
            wp |= (zs[i] > 0.f ? q : 0u) << (8 * i);
            wn |= (zs[i] < 0.f ? q : 0u) << (8 * i);
          }
          *reinterpret_cast<unsigned*>(cpos + p) = wp;
          *reinterpret_cast<unsigned*>(cneg + p) = wn;
        } else {
          const int p = c / r * rpad + c % r;
          const unsigned q = dac(z, sp, sn, levels);
          cpos[p] = (unsigned char)(z > 0.f ? q : 0u);
          cneg[p] = (unsigned char)(z < 0.f ? q : 0u);
        }
      };
      const long long rs = (active ? row : 0) * s;
      gather::warp_rows<kVec, kLanes, false>(x, nbr + rs, wts + rs, s, f,
                                             active, emit);
      if (!active)  // past the last row: codes 0
        for (int c = lane % kLanes; c < f / gather::Unit<kVec>::kWidth;
             c += kLanes)
          emit(c, gather::zero<T>());
    }
    __syncthreads();
    // 2. bit-plane products on the int8 tensor cores; ADC per (tile, bit),
    //    shift and add in bit order, then the add across tiles, in order.
    for (int u = warp; u < units; u += kQWarps) {
      const int sg = u & 1, cg = (u >> 1) % ncg, m0 = (u >> 1) / ncg * 16;
      float mvm[S::kNt][4] = {};
      for (int t = 0; t < ntiles; ++t) {
        const int kt = min(r, f - t * r);
        int acc[xmma::kMaxBits][S::kAcc][4] = {};
        xmma::tile_mma<kD>(codes + (sg * rows + m0) * stride,
                           ds + cg * S::kCols * stride, stride, bn * stride,
                           t * rpad, (kt + 31) / 32, nbits, acc);
        xmma::tile_adc<kD>(acc, nbits, fs, lsb, inv_lsb, mvm);
      }
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int nt = 0; nt < S::kNt; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mv[(sg * rows + m0 + g + 8 * (e >> 1)) * mstride +
             cg * S::kCols + nt * 8 + 2 * tq + (e & 1)] = mvm[nt][e];
      }
    }
    __syncthreads();
    // 3. rescale each sign pass by its DAC scale times the conductance
    //    scale, then recombine: mvm_pos*(sp*ws) - mvm_neg*(sn*ws) + b
    for (int e = tid; e < rows * bn; e += kQThreads) {
      const int rr = e / bn, c = e % bn, col = col0 + c;
      const long long row = row0 + rr;
      if (row < nd && col < h) {
        const float acc = __fsub_rn(__fmul_rn(mv[rr * mstride + c], cp),
                                    __fmul_rn(mv[(rows + rr) * mstride + c],
                                              cn));
        const float v = __fadd_rn(acc, b[col]);
        out[row * h + col] = relu ? fmaxf(v, 0.f) : v;
      }
    }
  }
}

size_t quant_smem(int kd, int bn, int mt, int kp) {
  const size_t stride = (size_t)kp + 16, rows = (size_t)xmma::kRows * mt;
  return (size_t)kd * bn * stride + 2 * rows * stride +
         sizeof(float) * 2 * rows * (size_t)(bn + 1);
}

// Picks the block's column count (the widest multiple of the unit's
// columns, up to 64, whose shared memory fits), the m16 tiles per row tile
// (enough units for the 8 warps, at most 4) and a persistent grid of as
// many blocks as fit on the card at once. The digits grow with F: at the
// card's 227 KiB a block of the narrowest columns and one m16 tile holds a
// depth kp up to 4,768 (the wrapper's MAX_DEPTH); deeper, it fails here.
template <int kD, bool kVec, int kLanes>
int launch_quant(const float* x, const int* nbr, const float* wts,
                 const signed char* digits, const float* b,
                 const float* scales, float* out, long long nd, int s, int f,
                 int h, int r, int kp, int nbits, float fs, float lsb,
                 float inv_lsb, int relu, cudaStream_t stream) {
  constexpr int kCols = xmma::Shape<kD>::kCols;
  auto kernel = fused_quant_kernel<kD, kVec, kLanes>;
  int dev = 0, max_smem = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int bn = std::min(kQMaxCols, (h + kCols - 1) / kCols * kCols);
  int mt = std::max(1, std::min(4, kQWarps / (2 * (bn / kCols))));
  while (mt > 1 && quant_smem(kD, bn, mt, kp) > (size_t)max_smem) mt /= 2;
  while (quant_smem(kD, bn, mt, kp) > (size_t)max_smem && bn > kCols)
    bn = std::max(kCols, bn / 2 / kCols * kCols);
  const size_t smem = quant_smem(kD, bn, mt, kp);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kQThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ncol = (h + bn - 1) / bn;
  const long long row_tiles =
      (nd + xmma::kRows * mt - 1) / (xmma::kRows * mt);
  const long long nx = std::min<long long>(
      row_tiles, std::max<long long>(1, (long long)per_sm * sms / ncol));
  kernel<<<dim3((unsigned)nx, (unsigned)ncol), kQThreads, smem, stream>>>(
      x, nbr, wts, digits, b, scales, out, nd, s, f, h, r, (r + 31) / 32 * 32,
      kp, bn, mt, nbits, fs, lsb, inv_lsb, relu);
  return (int)cudaGetLastError();
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
                                     const void* wts, const void* digits,
                                     int ndigits, const void* b,
                                     const void* scales, void* out,
                                     long long nd, int s, int f, int h,
                                     int rows_per_xbar, int kp, int in_bits,
                                     float full_scale, float lsb,
                                     float inv_lsb, int relu, void* stream) {
  if (in_bits < 1 || in_bits > xbar::kMaxBits || rows_per_xbar < 1 ||
      kp % 32 != 0 || (ndigits != 1 && ndigits != 2))
    return (int)cudaErrorInvalidValue;
  const bool vec = gather::vector_ok(f, x, x) && rows_per_xbar % 4 == 0;
  const bool half = gather::lanes_for(f, vec) == 16;
  auto run = [&](auto launch) {
    return launch((const float*)x, (const int*)nbr, (const float*)wts,
                  (const signed char*)digits, (const float*)b,
                  (const float*)scales, (float*)out, nd, s, f, h,
                  rows_per_xbar, kp, in_bits, full_scale, lsb, inv_lsb, relu,
                  (cudaStream_t)stream);
  };
  if (ndigits == 1) {
    if (vec)
      return half ? run(launch_quant<1, true, 16>)
                  : run(launch_quant<1, true, 32>);
    return half ? run(launch_quant<1, false, 16>)
                : run(launch_quant<1, false, 32>);
  }
  if (vec)
    return half ? run(launch_quant<2, true, 16>)
                : run(launch_quant<2, true, 32>);
  return half ? run(launch_quant<2, false, 16>)
              : run(launch_quant<2, false, 32>);
}
