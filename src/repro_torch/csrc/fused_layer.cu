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
// the next. On Hopper blocks run in parallel and in no order, so a group of
// lanes owns a destination row and loops over its slots itself.
//
// All three gather z[i, c] = sum_s w[i, s] * x[nbr[i, s], c] with
// warp_gather.cuh: 32 lanes (16 at F <= 64) own a row, read its slot table
// once, skip weight-0 (padding) slots on a ballot and load each live source
// row as float4 (a scalar variant takes F % 4 != 0 or unaligned x). One
// rounded multiply and one rounded add per live slot, in slot order (never
// an FMA), so z equals the plain PyTorch loop bit for bit.
//
// What bounds them on this card, and what the designs do about it:
//   * fused_zmax: bytes (the gathered rows and the slot tables; its output
//     is 8 bytes a row). Rows go to groups of lanes as in csr_aggregate.cu;
//     each lane folds its columns into (max(z, 0), max(-z, 0)) as the
//     gather emits them, shuffles reduce the group, and one lane writes the
//     row's pair. fmaxf is order-free, so the result is the plain
//     version's bit for bit.
//   * fused_ideal_kernel: bytes, once its product runs on the tensor cores.
//     The product's 2 F H flops a row sit above the f32 CUDA cores' ridge
//     at H = 64 (23.6 GFLOP at layer 1 of collab: 0.35 ms at 67 TFLOP/s,
//     above the layer's 0.26 ms byte floor), so z W runs on mma.sync
//     m16n8k8 TF32 with the 3xTF32 split of tf32_mma.cuh, which keeps f32
//     accuracy (three TF32 products at 495 TFLOP/s: about 0.14 ms). A
//     persistent block of 16 warps keeps its columns of W resident in
//     shared memory where they fit (staged once with cp.async) and walks
//     tiles of 32 or 64 rows. It gathers a tile of z into shared memory
//     (8, 16 or 32 lanes a row, 8 column units a lane, so that a warp has
//     up to 4 rows in flight), splits the depth of the tile's product
//     across its warps (each a 32 x 32 unit of 2 x 4 m16n8 tiles) and adds
//     their partials through shared memory. While the warps multiply, they
//     load the next tile's slot tables and prefetch its live rows into L2,
//     so a gather waits on L2 rather than on device memory. Where W does
//     not fit (F above about 550 at 64 columns), K goes in chunks of whole
//     32-column windows: W's chunk and z's window are staged per chunk and
//     the f32 accumulators carried across chunks. At F = 496 a block takes
//     207.5 KiB, so one block runs on an SM, and its gather and its product
//     take turns. The product holds it back: mma.sync runs TF32 below the
//     card's rate, and W is split again for every tile (its hi and lo
//     would not fit). Two groups of 8 warps on their own z tiles, whose
//     gathers run under each other's products, were no faster.
//   * fused_quant_kernel: bytes, by the read-once count; its 2 signs x
//     in_bits bit-plane products of F x H per row are int8 tensor-core work
//     (crossbar_mma.cuh) that the card could do in less time than it takes
//     to read x. In practice the MMA phase and the gather take the time, one
//     after the other. The design: the block's conductance digits sit in
//     shared memory as int8 for its whole life (a persistent grid of row
//     tiles); each row's group writes both signs' DAC codes as bytes after
//     one division per element; bit planes are made in registers from the
//     code bytes and fed to mma.sync m16n8k32 s8 with int32 accumulators,
//     and two blocks share an SM.
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
// The ideal layer's product sums in another order than the plain matmul
// and agrees with it within rtol 1e-5.
#include <cuda_runtime.h>

#include <algorithm>

#include "crossbar_mma.cuh"
#include "tf32_mma.cuh"
#include "warp_gather.cuh"

namespace {

// ------------------------------------------------------------------ zmax

constexpr int kZWarps = 8;  // warps per block

// One destination row per kLanes lanes: 32 / kLanes rows per warp.
template <bool kVec, int kLanes>
__global__ void __launch_bounds__(32 * kZWarps)
fused_zmax_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                  const float* __restrict__ wts, float* __restrict__ out,
                  long long nd, int s, int f) {
  using T = typename gather::Unit<kVec>::T;
  const long long row =
      ((long long)blockIdx.x * 32 * kZWarps + threadIdx.x) / kLanes;
  const long long warp_row0 =
      ((long long)blockIdx.x * 32 * kZWarps + (threadIdx.x & ~31)) / kLanes;
  if (warp_row0 >= nd) return;  // uniform across the warp
  const bool active = row < nd;
  const long long r = active ? row : warp_row0;
  float pmax = 0.f, nmax = 0.f;
  auto fold = [&](float z) {
    pmax = fmaxf(pmax, fmaxf(z, 0.f));
    nmax = fmaxf(nmax, fmaxf(-z, 0.f));
  };
  gather::warp_rows<kVec, kLanes, true>(
      x, nbr + r * s, wts + r * s, s, f, active, [&](int, const T& z) {
        if constexpr (kVec) {
          fold(z.x);
          fold(z.y);
          fold(z.z);
          fold(z.w);
        } else {
          fold(z);
        }
      });
  for (int o = kLanes / 2; o > 0; o >>= 1) {  // within the group
    pmax = fmaxf(pmax, __shfl_xor_sync(gather::kFull, pmax, o));
    nmax = fmaxf(nmax, __shfl_xor_sync(gather::kFull, nmax, o));
  }
  if (active && threadIdx.x % kLanes == 0)
    *reinterpret_cast<float2*>(out + 2 * row) = make_float2(pmax, nmax);
}

template <bool kVec, int kLanes>
int launch_zmax(const float* x, const int* nbr, const float* wts, float* out,
                long long nd, int s, int f, cudaStream_t stream) {
  constexpr long long kRowsPerBlock = 32 * kZWarps / kLanes;
  const dim3 grid((unsigned)((nd + kRowsPerBlock - 1) / kRowsPerBlock));
  fused_zmax_kernel<kVec, kLanes><<<grid, 32 * kZWarps, 0, stream>>>(
      x, nbr, wts, out, nd, s, f);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- ideal

constexpr int kIWarps = 16;
constexpr int kIThreads = 32 * kIWarps;
constexpr int kUnit = 32;      // a warp's unit of the product: 32 x 32
constexpr int kIMaxCols = 64;  // output columns per block, at most
constexpr int kIPer = 8;       // column units a lane gathers at once
constexpr int kPrePasses = 2;  // gather passes of a tile whose rows prefetch

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

__host__ __device__ __forceinline__ int round8(int v) { return (v + 7) & ~7; }

// Row stride of the z tile in floats: at least kc8, 4 mod 32 (tf32_mma.cuh).
__host__ __device__ __forceinline__ int z_stride(int kc8) {
  return (kc8 + 27) / 32 * 32 + 4;
}

// Warps that share a unit's depth: all of them, but at least 4 k8 steps
// each (a shallow K would spend more on adding partials than on products).
__host__ __device__ __forceinline__ int ideal_splits(int units, int kc) {
  const int all = kIWarps / units, deep = (kc + 7) / 8 / 4;
  return deep < 1 ? 1 : deep < all ? deep : all;
}

// Dynamic shared memory: W's chunk ws[kc8][bn + 8] (a row stride of 8 mod
// 32 floats), then the z tile zs[bm][z_stride], which the warps' partial
// sums red[nsplit][bm][bn + 4] reuse once the tile's product is done.
// Persistent: a block owns bn columns of the output and walks tiles of bm
// rows. Where W fits (kc >= f) it is staged once; else each tile takes K in
// chunks of kc columns (a multiple of 32), W's chunk and z's window staged
// per chunk. A row is gathered by kLanes lanes, kIPer units a lane, so a
// warp has 32 / kLanes rows in flight. Warp w takes unit w % units (a
// 32 x 32 block of the bm x bn tile) and, where its split w / units is
// below nsplit (ideal_splits), every nsplit-th k8 step from it; the
// splits' partials are added in order by all threads.
template <bool kVec, int kLanes, bool kResident>
__global__ void __launch_bounds__(kIThreads, 1)
fused_ideal_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                   const float* __restrict__ wts, const float* __restrict__ w,
                   const float* __restrict__ b, float* __restrict__ out,
                   long long nd, int s, int f, int h, int bm, int bn, int kc,
                   bool wvec, bool ovec, int relu) {
  constexpr int kGroups = 32 / kLanes;  // rows a warp gathers at once
  constexpr int kW = gather::Unit<kVec>::kWidth;
  using T = typename gather::Unit<kVec>::T;
  extern __shared__ int4 smem[];
  const int kc8 = round8(min(kc, f)), wst = bn + 8, zst = z_stride(kc8);
  float* ws = reinterpret_cast<float*>(smem);
  float* zs = ws + kc8 * wst;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int col0 = blockIdx.y * bn;
  const int nchunks = kResident ? 1 : (f + kc - 1) / kc;
  const int mtiles = bm / kUnit, units = mtiles * (bn / kUnit);
  const int nsplit = ideal_splits(units, min(kc, f));
  const int u = warp % units, sp = warp / units;
  const int m0 = u % mtiles * kUnit, n0 = u / mtiles * kUnit;
  auto stage_w = [&](int k0, int kw) {  // rows [k0, k0 + kw) of W, pad 0
    const int rows = round8(kw);
    if (wvec) {
      const int q = bn / 4;
      for (int e = tid; e < rows * q; e += kIThreads) {
        const int k = e / q, c = 4 * (e % q);
        const bool ok = k < kw && col0 + c < h;
        cp_async16(ws + k * wst + c,
                   ok ? w + (long long)(k0 + k) * h + col0 + c : w,
                   ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < rows * bn; e += kIThreads) {
        const int k = e / bn, c = e % bn;
        const bool ok = k < kw && col0 + c < h;
        cp_async4(ws + k * wst + c,
                  ok ? w + (long long)(k0 + k) * h + col0 + c : w,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // slot k < kLanes of the rows this lane's group gathers in a tile
  const int sl = lane % kLanes;
  auto load_next_slots = [&](long long tile, int (&iv)[kPrePasses],
                             float (&wv)[kPrePasses]) {
#pragma unroll
    for (int p = 0; p < kPrePasses; ++p) {
      const int rw = (warp + p * kIWarps) * kGroups;
      const long long row = tile * bm + rw + lane / kLanes;
      iv[p] = 0;
      wv[p] = 0.f;
      if (rw < bm && row < nd && sl < s) {
        iv[p] = __ldg(nbr + row * s + sl);
        wv[p] = __ldg(wts + row * s + sl);
      }
    }
  };
  auto prefetch_rows = [&](const int (&iv)[kPrePasses],
                           const float (&wv)[kPrePasses]) {
    const unsigned group = kLanes == 32
                               ? gather::kFull
                               : ((1u << kLanes) - 1) << (lane - sl);
#pragma unroll
    for (int p = 0; p < kPrePasses; ++p) {
      unsigned live = __ballot_sync(gather::kFull, wv[p] != 0.f) & group;
      while (__any_sync(gather::kFull, live != 0)) {
        const bool has = live != 0;
        const int k = has ? __ffs(live) - 1 : lane;
        live &= live - 1;
        const char* r = reinterpret_cast<const char*>(
            x + (long long)__shfl_sync(gather::kFull, iv[p], k) * f);
        const char* end = r + 4 * (long long)f;
        const char* line = reinterpret_cast<const char*>(
            reinterpret_cast<size_t>(r) & ~size_t{127});  // 128-byte lines
        if (has)
          for (const char* a = line + 128 * sl; a < end; a += 128 * kLanes)
            prefetch_l2(a);
      }
    }
  };
  for (int e = tid; e < bm * zst; e += kIThreads) zs[e] = 0.f;
  __syncthreads();
  if (kResident) stage_w(0, f);  // for the block's life
  const long long row_tiles = (nd + bm - 1) / bm;
  for (long long tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
    const long long row0 = tile * bm;
    // resident: one chunk, and the accumulators live after the gather
    float acc[2][4][4] = {};
    for (int ch = 0; ch < nchunks; ++ch) {
      const int k0 = ch * kc, kw = min(kc, f - k0), kw8 = round8(kw);
      if (!kResident) stage_w(k0, kw);
      // 1. z of the tile's rows, columns [k0, k0 + kw), into zs[.][0, kw)
      for (int rw = warp * kGroups; rw < bm; rw += kIWarps * kGroups) {
        const int rr = rw + lane / kLanes;
        const long long row = row0 + rr;
        const bool active = row < nd;
        float* zr = zs + rr * zst - k0;
        const long long rs = (active ? row : 0) * s;
        gather::warp_rows<kVec, kLanes, false, kIPer>(
            x, nbr + rs, wts + rs, s, f, k0 / kW, (k0 + kw) / kW, active,
            [&](int c, const T& z) {
              *reinterpret_cast<T*>(zr + kW * c) = z;
            });
      }
      for (int e = tid; e < bm * (kw8 - kw); e += kIThreads)  // k8 pad: 0
        zs[e / (kw8 - kw) * zst + kw + e % (kw8 - kw)] = 0.f;
      cp_async_wait_all();
      __syncthreads();
      // 2. this warp's k8 steps of its unit, 3xTF32 on the tensor cores,
      //    with the next tile's slot tables in flight; then their live
      //    rows go to L2, so that the next gather waits on L2, not on HBM
      int piv[kPrePasses];
      float pwv[kPrePasses];
      if (kResident) load_next_slots(tile + gridDim.x, piv, pwv);
      if (sp < nsplit)
        for (int ks = sp; ks < kw8 / 8; ks += nsplit)
          tf32::k8_step<2, 4>(zs + m0 * zst + 8 * ks, zst,
                              ws + 8 * ks * wst + n0, wst, acc);
      if (kResident) prefetch_rows(piv, pwv);
      __syncthreads();
    }
    // 3. every warp's partial into red[split][row][col] (over zs)
    float* red = zs;
    const int rst = bn + 4;
    if (sp < nsplit) {
      const int g = lane >> 2, t = lane & 3;
      float* p = red + (sp * bm + m0 + g) * rst + n0 + 2 * t;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            *reinterpret_cast<float2*>(p + (16 * m + 8 * hf) * rst + 8 * n) =
                make_float2(acc[m][n][2 * hf], acc[m][n][2 * hf + 1]);
    }
    __syncthreads();
    // 4. per 4 columns of a row: the partials added in split order, + b,
    //    activation, [Nd, H] out (a float4 streaming store where aligned)
    for (int e = tid; e < bm * (bn / 4); e += kIThreads) {
      const int r = e / (bn / 4), c = 4 * (e % (bn / 4)), col = col0 + c;
      const long long row = row0 + r;
      if (row >= nd || col >= h) continue;
      float4 v = *reinterpret_cast<const float4*>(red + r * rst + c);
      for (int q = 1; q < nsplit; ++q) {
        const float4 pq =
            *reinterpret_cast<const float4*>(red + (q * bm + r) * rst + c);
        v = make_float4(__fadd_rn(v.x, pq.x), __fadd_rn(v.y, pq.y),
                        __fadd_rn(v.z, pq.z), __fadd_rn(v.w, pq.w));
      }
      float o[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (col + i < h) o[i] = __fadd_rn(o[i], __ldg(b + col + i));
        if (relu) o[i] = fmaxf(o[i], 0.f);
      }
      if (ovec) {
        __stcs(reinterpret_cast<float4*>(out + row * h + col),
               make_float4(o[0], o[1], o[2], o[3]));
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (col + i < h) out[row * h + col + i] = o[i];
      }
    }
    __syncthreads();  // zs is free for the next tile
  }
}

size_t ideal_smem(int bm, int bn, int kc8) {
  const int nsplit = ideal_splits(bm / kUnit * (bn / kUnit), kc8);
  return sizeof(float) *
         ((size_t)kc8 * (bn + 8) +
          std::max((size_t)bm * z_stride(kc8),
                   (size_t)nsplit * bm * (bn + 4)));
}

struct IdealPlan {
  int bm, bn, kc;
};

// The block's columns (32 at H <= 32, else 64), its row tile (64, or 32
// where that keeps W resident) and K's chunk (all of F where W fits the
// card's shared memory at 32 rows, else the deepest multiple of 32 that
// fits; kc = 0 where nothing fits).
IdealPlan ideal_plan(int f, int h, int max_smem) {
  const int bn = h <= kUnit ? kUnit : kIMaxCols;
  int bm = 2 * kUnit, kc = f;
  if (ideal_smem(bm, bn, round8(kc)) > (size_t)max_smem) bm = kUnit;
  if (ideal_smem(bm, bn, round8(kc)) > (size_t)max_smem) {
    kc = f / 32 * 32;
    while (kc > 0 && ideal_smem(bm, bn, kc) > (size_t)max_smem) kc -= 32;
  }
  return {bm, bn, kc};
}

// Launches a persistent grid of as many blocks as fit on the card at once.
template <bool kVec, int kLanes, bool kResident>
int launch_ideal(const float* x, const int* nbr, const float* wts,
                 const float* w, const float* b, float* out, long long nd,
                 int s, int f, int h, int relu, IdealPlan pl, int sms,
                 cudaStream_t stream) {
  auto kernel = fused_ideal_kernel<kVec, kLanes, kResident>;
  int per_sm = 0;
  const size_t smem = ideal_smem(pl.bm, pl.bn, round8(std::min(pl.kc, f)));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kIThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const bool wvec = h % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0;
  const bool ovec = h % 4 == 0 && reinterpret_cast<size_t>(out) % 16 == 0;
  const int ncol = (h + pl.bn - 1) / pl.bn;
  const long long row_tiles = (nd + pl.bm - 1) / pl.bm;
  const long long nx = std::min<long long>(
      row_tiles, std::max<long long>(1, (long long)per_sm * sms / ncol));
  kernel<<<dim3((unsigned)nx, (unsigned)ncol), kIThreads, smem, stream>>>(
      x, nbr, wts, w, b, out, nd, s, f, h, pl.bm, pl.bn, pl.kc, wvec, ovec,
      relu);
  return (int)cudaGetLastError();
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
  const bool vec = gather::vector_ok(f, x, x);
  const int lanes = gather::lanes_covering(f, vec, gather::kChunks);
  auto run = [&](auto launch) {
    return launch((const float*)x, (const int*)nbr, (const float*)wts,
                  (float*)out, nd, s, f, (cudaStream_t)stream);
  };
  if (vec)
    return lanes == 8    ? run(launch_zmax<true, 8>)
           : lanes == 16 ? run(launch_zmax<true, 16>)
                         : run(launch_zmax<true, 32>);
  return lanes == 8    ? run(launch_zmax<false, 8>)
         : lanes == 16 ? run(launch_zmax<false, 16>)
                       : run(launch_zmax<false, 32>);
}

extern "C" int fused_ideal_layer_f32(const void* x, const void* nbr,
                                     const void* wts, const void* w,
                                     const void* b, void* out, long long nd,
                                     int s, int f, int h, int relu,
                                     void* stream) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const IdealPlan pl = ideal_plan(f, h, max_smem);
  if (pl.kc < 1) return (int)cudaErrorInvalidValue;
  const bool vec = gather::vector_ok(f, x, x);
  const int lanes = gather::lanes_covering(f, vec, kIPer);
  auto run = [&](auto launch) {
    return launch((const float*)x, (const int*)nbr, (const float*)wts,
                  (const float*)w, (const float*)b, (float*)out, nd, s, f, h,
                  relu, pl, sms, (cudaStream_t)stream);
  };
  if (pl.kc < f)  // K in chunks (F above about 550): 32 lanes a row
    return vec ? run(launch_ideal<true, 32, false>)
               : run(launch_ideal<false, 32, false>);
  if (vec)
    return lanes == 8    ? run(launch_ideal<true, 8, true>)
           : lanes == 16 ? run(launch_ideal<true, 16, true>)
                         : run(launch_ideal<true, 32, true>);
  return lanes == 8    ? run(launch_ideal<false, 8, true>)
         : lanes == 16 ? run(launch_ideal<false, 16, true>)
                       : run(launch_ideal<false, 32, true>);
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
