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
//     shared memory as int8 (a persistent grid of row tiles); each row's
//     group writes both signs' DAC codes as bytes after one division per
//     element; bit planes are made in registers from the code bytes and
//     fed to mma.sync m16n8k32 s8 with int32 accumulators, and two blocks
//     share an SM. DAC codes wider than a byte (in_bits > 8) take passes of
//     8 bit planes, one byte plane of the codes each, and conductance codes
//     of three or four digits are combined by Horner's rule
//     (crossbar_mma.cuh). K is staged in chunks, as in crossbar_mvm.cu:
//     where the digits fit beside a row tile's codes the depth is one chunk
//     and the digits stay for the block's life; deeper (a depth above
//     2,304 at 64 columns, one digit and one pass; 1,376 with two digits),
//     each chunk gathers the column window of z that it holds. There is no
//     depth limit.
//
// Launch plans: the wrapper computes each launch's plan on the host
// (kernels/launch_plans.py, the one place a plan is made, the default and
// tuning's FusedConfig alike) and passes it in; the launchers only refuse a
// plan that does not fit the card:
//   * ideal layer: bm (rows a block: 32, 64 or 128), bn (32 or 64 columns)
//     and kc (K's chunk: F, or a multiple of 32 below it). The kernel splits
//     K across ideal_splits(units, kc) warps of a unit; the host takes only
//     choices whose split is the default plan's, so every output element
//     sums the same k8 steps in the same order in every choice: the same
//     bits.
//   * quant layer: bn (a multiple of the unit's columns, up to 64), mt (m16
//     tiles a row tile, 1 to 4) and kc (the chunk depth); the kCarry
//     variant takes several passes or a chunk that is not whole tiles. The
//     int32 sums are exact in any chunking and the ADC, bit, pass and tile
//     orders stay: the same bits.
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

size_t ideal_smem(int bm, int bn, int kc8, int nsplit) {
  return sizeof(float) *
         ((size_t)kc8 * (bn + 8) +
          std::max((size_t)bm * z_stride(kc8),
                   (size_t)nsplit * bm * (bn + 4)));
}

struct IdealPlan {
  int bm, bn, kc, nsplit;
};

// The host's plan (launch_plans.ideal_resolve) with its K split; kc = 0
// where the plan does not fit the card.
IdealPlan ideal_fit(int f, int bm, int bn, int kc, int max_smem) {
  IdealPlan o{bm, bn, std::min(kc, f), 0};
  const bool shape = o.bm >= kUnit && o.bm <= 4 * kUnit &&
                     o.bm % kUnit == 0 &&
                     (o.bn == kUnit || o.bn == kIMaxCols);
  if (shape) o.nsplit = ideal_splits(o.bm / kUnit * (o.bn / kUnit), o.kc);
  const bool ok =
      shape && (o.kc == f || (o.kc >= 32 && o.kc % 32 == 0)) &&
      ideal_smem(o.bm, o.bn, round8(o.kc), o.nsplit) <= (size_t)max_smem;
  if (!ok) o.kc = 0;
  return o;
}

// Launches a persistent grid of as many blocks as fit on the card at once.
template <bool kVec, int kLanes, bool kResident>
int launch_ideal(const float* x, const int* nbr, const float* wts,
                 const float* w, const float* b, float* out, long long nd,
                 int s, int f, int h, int relu, IdealPlan pl, int sms,
                 cudaStream_t stream) {
  auto kernel = fused_ideal_kernel<kVec, kLanes, kResident>;
  int per_sm = 0;
  const size_t smem =
      ideal_smem(pl.bm, pl.bn, round8(std::min(pl.kc, f)), pl.nsplit);
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

// The quant layer's epilogue over a row tile: each sign pass's sums
// mv[sign][row][bn + 1] rescaled by its DAC scale times the conductance
// scale (cp, cn), then mvm_pos*(sp*ws) - mvm_neg*(sn*ws) + b and the
// activation, as the composed oracle rounds.
__device__ __forceinline__ void recombine(const float* mv, int rows, int bn,
                                          long long row0, int col0,
                                          long long nd, int h, float cp,
                                          float cn,
                                          const float* __restrict__ b,
                                          float* __restrict__ out, int relu) {
  const int mstride = bn + 1;
  for (int e = threadIdx.x; e < rows * bn; e += kQThreads) {
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

// The quant layer. A block owns bn output columns and walks row tiles of
// mt m16 tiles (16 * mt rows; mt > 1 where bn is narrow, so that every
// warp has a unit). Dynamic shared memory (quant_smem): the block's
// conductance digits ds[ndig][bn][stride], both signs' DAC codes of one row
// tile, one byte plane per pass, codes[2][ng][rows][stride], and the
// per-sign sums mv[2][rows][bn + 1]; stride = kc + 16 bytes
// (crossbar_mma.cuh). K is staged through shared memory in chunks of kc
// tile-padded depth positions, as in crossbar_mvm.cu:
//   * one chunk (kc = kp): the digits are staged once for the block's
//     life, each row tile gathers z once, then each unit (sign, column
//     group, m16 tile), a warp's at a time, walks the crossbar tiles;
//   * chunks of whole crossbar tiles (the launcher's kc where a tile fits
//     one): per chunk, the digits are staged and the column window of z
//     that it holds is gathered (warp_gather.cuh's window; the slot tables
//     are read again), then its tiles multiplied; the launcher keeps the
//     units within the 8 warps, so each warp's running sums stay in
//     registers from chunk to chunk and no int32 sums are live while a
//     chunk is staged;
//   * a tile deeper than a chunk (kCarry only): its int32 sums are carried
//     across the chunks it meets, which are staged again for each pass.
// A row is gathered by kLanes lanes (16 at F <= 64). kCarry: the variant
// of one block an SM (more registers) that carries a tile's sums: its f32
// sum from pass to pass where in_bits > 8 (ng passes of 8 bit planes) and
// its int32 sums across chunks where it is deeper than a chunk; the other
// takes one pass. ndig: the digit count where kD = 3.
template <int kD, bool kVec, int kLanes, bool kCarry>
__global__ void __launch_bounds__(kQThreads, kCarry ? 1 : 2)
fused_quant_kernel(const float* __restrict__ x, const int* __restrict__ nbr,
                   const float* __restrict__ wts,
                   const signed char* __restrict__ digits,
                   const float* __restrict__ b,
                   const float* __restrict__ scales, float* __restrict__ out,
                   long long nd, int s, int f, int h, int r, int rpad, int kp,
                   int kc, int bn, int mt, int nbits, int npass, int ndig,
                   float fs, float lsb, float inv_lsb, int relu) {
  using S = xmma::Shape<kD>;
  using T = typename gather::Unit<kVec>::T;
  constexpr int kW = gather::Unit<kVec>::kWidth;
  constexpr int kGroups = 32 / kLanes;  // rows a warp gathers at once
  const int ndg = kD == 3 ? ndig : kD;
  const int ng = kCarry ? npass : 1;
  const int rows = xmma::kRows * mt;  // rows of a row tile
  const int stride = kc + 16;
  extern __shared__ int4 smem[];
  signed char* ds = reinterpret_cast<signed char*>(smem);
  unsigned char* codes =
      reinterpret_cast<unsigned char*>(ds + ndg * bn * stride);
  float* mv = reinterpret_cast<float*>(codes + 2 * ng * rows * stride);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int col0 = blockIdx.y * bn;
  const float sp = scales[0], sn = scales[1];
  const float cp = __fmul_rn(sp, scales[2]), cn = __fmul_rn(sn, scales[2]);
  const float levels = (float)((1ull << nbits) - 1);
  const int ncg = bn / S::kCols;
  const int units = 2 * ncg * mt;  // (sign, column group, m16 tile)
  const int mstride = bn + 1;
  const int nchunks = (kp + kc - 1) / kc;
  const int ntiles = (kp + rpad - 1) / rpad;
  const int code_words = 2 * ng * rows * stride / 16;
  const long long row_tiles = (nd + rows - 1) / rows;
  if (nchunks == 1)
    xmma::stage_digits(ds, digits, ndg, h, kp, col0, bn, 0, kp, stride, tid,
                       kQThreads);
  for (int e = tid; e < code_words; e += kQThreads)
    reinterpret_cast<int4*>(codes)[e] = make_int4(0, 0, 0, 0);  // pads: 0
  __syncthreads();
  // the first K column at or after tile-padded depth p
  auto column = [&](int p) { return p / rpad * r + min(p % rpad, r); };
  for (long long tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
    const long long row0 = tile * rows;
    // chunk c of the row tile: its digits (where K is chunked) and both
    // signs' DAC codes of z's columns [k0, k1), byte g of the codes in
    // plane g, at depth p - p0 with p = (k / r) * rpad + k % r. The first
    // chunk of a row tile needs no barrier before it: the previous row
    // tile's reads of codes and digits ended before its epilogue.
    auto stage = [&](int c, bool after_reads) {
      const int p0 = c * kc, pn = min(kc, kp - p0);
      if (after_reads) __syncthreads();
      if (nchunks > 1) {
        for (int e = tid; e < code_words; e += kQThreads)
          reinterpret_cast<int4*>(codes)[e] = make_int4(0, 0, 0, 0);
        xmma::stage_digits(ds, digits, ndg, h, kp, col0, bn, p0, pn, stride,
                           tid, kQThreads);
        __syncthreads();
      }
      const int u0 = column(p0) / kW, u1 = min(f, column(p0 + pn)) / kW;
      for (int rw = warp * kGroups; rw < rows; rw += kQWarps * kGroups) {
        const int rr = rw + lane / kLanes;
        const long long row = row0 + rr;
        const bool active = row < nd;
        unsigned char* cpos = codes + rr * stride;
        unsigned char* cneg = codes + (ng * rows + rr) * stride;
        auto emit = [&](int u, const T& z) {
          if constexpr (kVec) {
            const int k = 4 * u, p = k / r * rpad + k % r - p0;
            const float zs[4] = {z.x, z.y, z.z, z.w};
            unsigned q[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) q[i] = dac(zs[i], sp, sn, levels);
            for (int g = 0; g < ng; ++g) {
              unsigned wp = 0, wn = 0;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const unsigned byte = q[i] >> (8 * g) & 0xffu;
                wp |= (zs[i] > 0.f ? byte : 0u) << (8 * i);
                wn |= (zs[i] < 0.f ? byte : 0u) << (8 * i);
              }
              *reinterpret_cast<unsigned*>(cpos + g * rows * stride + p) = wp;
              *reinterpret_cast<unsigned*>(cneg + g * rows * stride + p) = wn;
            }
          } else {
            const int p = u / r * rpad + u % r - p0;
            const unsigned q = dac(z, sp, sn, levels);
            for (int g = 0; g < ng; ++g) {
              const unsigned char byte = (unsigned char)(q >> (8 * g));
              cpos[g * rows * stride + p] = z > 0.f ? byte : 0;
              cneg[g * rows * stride + p] = z < 0.f ? byte : 0;
            }
          }
        };
        const long long rs = (active ? row : 0) * s;
        gather::warp_rows<kVec, kLanes, false>(x, nbr + rs, wts + rs, s, f,
                                               u0, u1, active, emit);
        if (!active)  // past the last row: codes 0
          for (int u = u0 + lane % kLanes; u < u1; u += kLanes)
            emit(u, gather::zero<T>());
      }
      __syncthreads();
    };
    // A unit's passes over tile t, whose depths lie in chunk c, into its
    // running sums mvm.
    auto tile_passes = [&](int u, int t, int c, float(&mvm)[S::kNt][4]) {
      const int sg = u & 1, cg = (u >> 1) % ncg, m0 = (u >> 1) / ncg * 16;
      const int tb = t * rpad, te = min(tb + rpad, kp);
      float sum[S::kNt][4] = {};
      for (int g = 0; g < ng; ++g) {
        int acc[xmma::kPlanes][S::kAcc][4] = {};
        const int planes = kCarry ? min(nbits - 8 * g, xmma::kPlanes) : nbits;
        xmma::tile_mma<kD>(codes + ((sg * ng + g) * rows + m0) * stride,
                           ds + cg * S::kCols * stride, stride, bn * stride,
                           tb - c * kc, (te - tb) / 32, planes, ndg, acc);
        if constexpr (kCarry)
          xmma::pass_adc<kD>(acc, nbits, g, fs, lsb, inv_lsb, sum);
        else
          xmma::tile_adc<kD>(acc, nbits, fs, lsb, inv_lsb, mvm);
      }
      if constexpr (kCarry) {
#pragma unroll
        for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mvm[nt][e] = __fadd_rn(mvm[nt][e], sum[nt][e]);
      }
    };
    auto store = [&](int u, const float(&mvm)[S::kNt][4]) {
      const int sg = u & 1, cg = (u >> 1) % ncg, m0 = (u >> 1) / ncg * 16;
      const int g = lane >> 2, tq = lane & 3;
#pragma unroll
      for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mv[(sg * rows + m0 + g + 8 * (e >> 1)) * mstride + cg * S::kCols +
             nt * 8 + 2 * tq + (e & 1)] = mvm[nt][e];
    };
    // bit-plane products on the int8 tensor cores over the crossbar tiles
    // in order; per pass, the tile's products, then the ADC per (tile,
    // bit), shifted and added in bit order, and the add across tiles, in
    // order.
    if (nchunks == 1) {  // the whole depth staged once: a unit at a time
      stage(0, false);
      for (int u = warp; u < units; u += kQWarps) {
        float mvm[S::kNt][4] = {};
        for (int t = 0; t < ntiles; ++t) tile_passes(u, t, 0, mvm);
        store(u, mvm);
      }
    } else if (!kCarry || kc % rpad == 0) {
      // chunks of whole tiles, in order, each staged and then multiplied
      // (the launcher keeps the units within the warps)
      const bool unit = warp < units;
      float mvm[S::kNt][4] = {};
      for (int c = 0; c < nchunks; ++c) {
        stage(c, c > 0);
        const int t1 = c + 1 < nchunks ? (c + 1) * kc / rpad : ntiles;
        if (unit)
          for (int t = c * kc / rpad; t < t1; ++t)
            tile_passes(warp, t, c, mvm);
      }
      if (unit) store(warp, mvm);
    } else if constexpr (kCarry) {
      // tiles deeper than a chunk: a tile's int32 sums carried across the
      // chunks it meets, which are staged again for each pass
      const bool unit = warp < units;
      const int sg = warp & 1, cg = (warp >> 1) % ncg;
      const int m0 = (warp >> 1) / ncg * 16;
      float mvm[S::kNt][4] = {};
      int cur = -1;  // the chunk in shared memory
      for (int t = 0; t < ntiles; ++t) {
        const int tb = t * rpad, te = min(tb + rpad, kp);
        float sum[S::kNt][4] = {};
        for (int g = 0; g < ng; ++g) {
          int acc[xmma::kPlanes][S::kAcc][4] = {};
          const int planes = min(nbits - 8 * g, xmma::kPlanes);
          for (int p = tb; p < te;) {
            const int c = p / kc;
            if (c != cur) {
              stage(c, cur >= 0);
              cur = c;
            }
            const int end = min(te, (c + 1) * kc);
            if (unit)
              xmma::tile_mma<kD>(
                  codes + ((sg * ng + g) * rows + m0) * stride,
                  ds + cg * S::kCols * stride, stride, bn * stride,
                  p - c * kc, (end - p) / 32, planes, ndg, acc);
            p = end;
          }
          if (unit) xmma::pass_adc<kD>(acc, nbits, g, fs, lsb, inv_lsb, sum);
        }
#pragma unroll
        for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mvm[nt][e] = __fadd_rn(mvm[nt][e], sum[nt][e]);
      }
      if (unit) store(warp, mvm);
    }
    __syncthreads();
    // rescale and recombine the two sign passes
    recombine(mv, rows, bn, row0, col0, nd, h, cp, cn, b, out, relu);
  }
}

size_t quant_smem(int ndig, int ng, int bn, int mt, int kc) {
  const size_t stride = (size_t)kc + 16, rows = (size_t)xmma::kRows * mt;
  return (size_t)ndig * bn * stride + 2 * ng * rows * stride +
         sizeof(float) * 2 * rows * (size_t)(bn + 1);
}

struct QuantPlan {
  int bn, mt, kc;  // columns and m16 tiles of a block, chunk depth
  bool carry;      // the kCarry variant
};

// The host's plan (launch_plans.quant_resolve). The kCarry variant takes
// any plan and is needed for several passes or a chunk that is not whole
// tiles; chunks need the units within the 8 warps; a chunk deeper than kp
// is one chunk. kc = 0 where the plan does not fit the card.
QuantPlan quant_fit(int cols, int ndig, int ng, int r, int kp, int bn, int mt,
                    int kc, bool carry, int max_smem) {
  QuantPlan o{bn, mt, kc, carry};
  const int rpad = (r + 31) / 32 * 32;
  const bool ok =
      o.bn >= cols && o.bn <= kQMaxCols && o.bn % cols == 0 && o.mt >= 1 &&
      o.mt <= 4 && o.kc >= 32 && o.kc % 32 == 0 &&
      (o.carry || (ng == 1 && (o.kc >= kp || o.kc % rpad == 0))) &&
      (o.kc >= kp || 2 * (o.bn / cols) * o.mt <= kQWarps) &&
      quant_smem(ndig, ng, o.bn, o.mt, o.kc) <= (size_t)max_smem;
  if (!ok) o.kc = 0;
  return o;
}

// Launches a persistent grid of as many blocks as fit on the card at once.
template <int kD, bool kVec, int kLanes, bool kCarry>
int launch_quant(const float* x, const int* nbr, const float* wts,
                 const signed char* digits, int ndig, const float* b,
                 const float* scales, float* out, long long nd, int s, int f,
                 int h, int r, int kp, int nbits, float fs, float lsb,
                 float inv_lsb, int relu, const QuantPlan& pl, int sms,
                 cudaStream_t stream) {
  auto kernel = fused_quant_kernel<kD, kVec, kLanes, kCarry>;
  const int ng = (nbits + xmma::kPlanes - 1) / xmma::kPlanes;
  const size_t smem = quant_smem(ndig, ng, pl.bn, pl.mt, pl.kc);
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kQThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ncol = (h + pl.bn - 1) / pl.bn;
  const long long row_tiles =
      (nd + xmma::kRows * pl.mt - 1) / (xmma::kRows * pl.mt);
  const long long nx = std::min<long long>(
      row_tiles, std::max<long long>(1, (long long)per_sm * sms / ncol));
  kernel<<<dim3((unsigned)nx, (unsigned)ncol), kQThreads, smem, stream>>>(
      x, nbr, wts, digits, b, scales, out, nd, s, f, h, r,
      (r + 31) / 32 * 32, kp, pl.kc, pl.bn, pl.mt, nbits, ng, ndig, fs, lsb,
      inv_lsb, relu);
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

// bm, bn, kc: the launch plan (launch_plans.ideal_resolve).
extern "C" int fused_ideal_layer_f32(const void* x, const void* nbr,
                                     const void* wts, const void* w,
                                     const void* b, void* out, long long nd,
                                     int s, int f, int h, int relu, int bm,
                                     int bn, int kc, void* stream) {
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const IdealPlan pl = ideal_fit(f, bm, bn, kc, max_smem);
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

// bn, mt, kc, carry: the launch plan (launch_plans.quant_resolve).
extern "C" int fused_quant_layer_f32(const void* x, const void* nbr,
                                     const void* wts, const void* digits,
                                     int ndigits, const void* b,
                                     const void* scales, void* out,
                                     long long nd, int s, int f, int h,
                                     int rows_per_xbar, int kp, int in_bits,
                                     float full_scale, float lsb,
                                     float inv_lsb, int relu, int bn, int mt,
                                     int kc, int carry, void* stream) {
  if (in_bits < 1 || in_bits > xbar::kMaxBits || rows_per_xbar < 1 ||
      kp % 32 != 0 || ndigits < 1 || ndigits > xmma::kMaxDigits)
    return (int)cudaErrorInvalidValue;
  int dev = 0, max_smem = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const bool vec = gather::vector_ok(f, x, x) && rows_per_xbar % 4 == 0;
  const int ng = (in_bits + xmma::kPlanes - 1) / xmma::kPlanes;
  const int kd = std::min(ndigits, 3);
  const int cols = kd == 1 ? xmma::Shape<1>::kCols : xmma::Shape<2>::kCols;
  const QuantPlan pl =
      quant_fit(cols, ndigits, ng, rows_per_xbar, kp, bn, mt, kc, carry != 0,
                max_smem);
  if (pl.kc < 32) return (int)cudaErrorInvalidValue;
  const bool half = gather::lanes_for(f, vec) == 16;
  auto run = [&](auto launch) {
    return launch((const float*)x, (const int*)nbr, (const float*)wts,
                  (const signed char*)digits, ndigits, (const float*)b,
                  (const float*)scales, (float*)out, nd, s, f, h,
                  rows_per_xbar, kp, in_bits, full_scale, lsb, inv_lsb, relu,
                  pl, sms, (cudaStream_t)stream);
  };
  // the variants: digits (1, 2, or 3 and 4 by Horner's rule) x carry x
  // float4 or scalar gather x 16 or 32 lanes a row
  auto lanes = [&](auto l16, auto l32) { return half ? run(l16) : run(l32); };
  if (!pl.carry) {
    if (kd == 1)
      return vec ? lanes(launch_quant<1, true, 16, false>,
                         launch_quant<1, true, 32, false>)
                 : lanes(launch_quant<1, false, 16, false>,
                         launch_quant<1, false, 32, false>);
    if (kd == 2)
      return vec ? lanes(launch_quant<2, true, 16, false>,
                         launch_quant<2, true, 32, false>)
                 : lanes(launch_quant<2, false, 16, false>,
                         launch_quant<2, false, 32, false>);
    return vec ? lanes(launch_quant<3, true, 16, false>,
                       launch_quant<3, true, 32, false>)
               : lanes(launch_quant<3, false, 16, false>,
                       launch_quant<3, false, 32, false>);
  }
  if (kd == 1)
    return vec ? lanes(launch_quant<1, true, 16, true>,
                       launch_quant<1, true, 32, true>)
               : lanes(launch_quant<1, false, 16, true>,
                       launch_quant<1, false, 32, true>);
  if (kd == 2)
    return vec ? lanes(launch_quant<2, true, 16, true>,
                       launch_quant<2, true, 32, true>)
               : lanes(launch_quant<2, false, 16, true>,
                       launch_quant<2, false, 32, true>);
  return vec ? lanes(launch_quant<3, true, 16, true>,
                     launch_quant<3, true, 32, true>)
             : lanes(launch_quant<3, false, 16, true>,
                     launch_quant<3, false, 32, true>);
}
