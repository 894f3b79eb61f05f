// Neighbour gather by warps, one row per 32, 16 or 8 lanes, shared by
// csr_aggregate.cu and the three fused-layer kernels of fused_layer.cu
// (zmax, the ideal layer, the quant layer):
//
//   z[row, c] = sum over the row's slots k, in slot order, of
//               w[row, k] * x[nbr[row, k], c]
//
// A group of kLanes lanes (the warp, or a half or a quarter of it at small
// F) owns one destination row. Lane k of a kLanes-slot chunk loads slot k's
// index and weight once; a ballot gives the group the slots whose weight
// is not 0, and __shfl_sync hands each live slot's (index, weight) to every
// lane of the group. Padding slots (weight 0) cost no load of x. Each lane
// owns the columns lane + kLanes i of the row, i < kPer, as float4 (kVec:
// F % 4 == 0 and x 16-byte aligned; neighbouring lanes on neighbouring 16
// bytes) or as single floats.
//
// Numerics: one rounded multiply and one rounded add per live slot
// (__fmul_rn/__fadd_rn, never an FMA), in slot order, from +0. Skipping a
// weight-0 slot leaves the bits unchanged for finite x: that slot adds
// 0 * x = +-0, and x + (+-0) == x for any x != 0, while +0 + (+-0) == +0.
// A sum that starts at +0 is never -0 under round to nearest (an exact
// cancellation gives +0), so no -0 can be lost either. The result equals
// the plain slot-order loop (csr_aggregate_ref) bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace gather {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunks = 4;  // column units a lane holds at once, by default

__device__ __forceinline__ float axpy(float acc, float w, float v) {
  return __fadd_rn(acc, __fmul_rn(w, v));
}

__device__ __forceinline__ float4 axpy(float4 acc, float w, float4 v) {
  return make_float4(axpy(acc.x, w, v.x), axpy(acc.y, w, v.y),
                     axpy(acc.z, w, v.z), axpy(acc.w, w, v.w));
}

template <bool kVec>
struct Unit {
  using T = float;
  static constexpr int kWidth = 1;
};
template <>
struct Unit<true> {
  using T = float4;
  static constexpr int kWidth = 4;
};

template <class T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() {
  return 0.f;
}
template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Gathers one destination row per group of kLanes lanes (32 / kLanes rows
// per warp; kLanes = 16 keeps every lane busy at F = 64, and 8 puts four
// rows of a warp in flight at once), whose slot table is nr[0..s),
// wr[0..s) for the calling lane's group. All 32 lanes must
// call; a group whose row does not exist passes active = false, loads
// nothing and emits nothing. Calls emit(c, z) once for every column unit c
// in [u_begin, u_end) (float4 index for kVec, column index otherwise; the
// whole row is [0, f / width)), from the lane that owns it. A column's sum
// is the same in any window. A lane holds kPer column units at once
// (kLanes * kPer a pass); kPair issues two live slots' loads before their
// adds, at the price of kPer more registers.
template <bool kVec, int kLanes, bool kPair, int kPer = kChunks, class Emit>
__device__ __forceinline__ void warp_rows(const float* __restrict__ x,
                                          const int* __restrict__ nr,
                                          const float* __restrict__ wr, int s,
                                          int f, int u_begin, int u_end,
                                          bool active, Emit emit) {
  static_assert(kLanes == 8 || kLanes == 16 || kLanes == 32,
                "a group is 8, 16 or 32 lanes");
  using T = typename Unit<kVec>::T;
  const int lane = threadIdx.x & 31, sl = lane % kLanes;
  const unsigned group =
      kLanes == 32 ? kFull : ((1u << kLanes) - 1) << (lane - sl);
  const int units = f / Unit<kVec>::kWidth;  // column units per row of x
  const T* xv = reinterpret_cast<const T*>(x);
  for (int c0 = u_begin; c0 < u_end; c0 += kLanes * kPer) {
    T acc[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) acc[i] = zero<T>();
    for (int s0 = 0; s0 < s; s0 += kLanes) {
      int iv = 0;
      float wv = 0.f;
      if (active && s0 + sl < s) {
        iv = __ldg(nr + s0 + sl);
        wv = __ldg(wr + s0 + sl);
      }
      // the group's live slots, as lane bits, taken in slot order
      unsigned live = __ballot_sync(kFull, wv != 0.f) & group;
      while (__any_sync(kFull, live != 0)) {
        const bool has1 = live != 0;
        const int k1 = has1 ? __ffs(live) - 1 : lane;
        live &= live - 1;
        const float w1 = __shfl_sync(kFull, wv, k1);
        const T* r1 = xv + (long long)__shfl_sync(kFull, iv, k1) * units;
        bool has2 = false;
        float w2 = 0.f;
        const T* r2 = r1;
        if (kPair) {
          has2 = live != 0;
          const int k2 = has2 ? __ffs(live) - 1 : lane;
          live &= live - 1;
          w2 = __shfl_sync(kFull, wv, k2);
          r2 = xv + (long long)__shfl_sync(kFull, iv, k2) * units;
        }
        T v1[kPer], v2[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int c = c0 + sl + kLanes * i;
          if (has1 && c < u_end) {
            v1[i] = __ldg(r1 + c);
            if (has2) v2[i] = __ldg(r2 + c);
          }
        }
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          if (has1 && c0 + sl + kLanes * i < u_end) {
            acc[i] = axpy(acc[i], w1, v1[i]);
            if (has2) acc[i] = axpy(acc[i], w2, v2[i]);
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = c0 + sl + kLanes * i;
        if (c < u_end) emit(c, acc[i]);
      }
    }
  }
}

// The whole row.
template <bool kVec, int kLanes, bool kPair, int kPer = kChunks, class Emit>
__device__ __forceinline__ void warp_rows(const float* __restrict__ x,
                                          const int* __restrict__ nr,
                                          const float* __restrict__ wr, int s,
                                          int f, bool active, Emit emit) {
  warp_rows<kVec, kLanes, kPair, kPer>(x, nr, wr, s, f, 0,
                                       f / Unit<kVec>::kWidth, active, emit);
}

// Lanes per row for a row of f floats: 16 when a 16-lane group covers the
// row in one float4 (or float) per lane, else 32.
inline int lanes_for(int f, bool vec) {
  return f / (vec ? 4 : 1) <= 16 ? 16 : 32;
}

// Lanes per row where a lane holds `per` column units: the fewest of 8, 16
// and 32 that cover the row in one pass, else 32.
inline int lanes_covering(int f, bool vec, int per) {
  const int units = f / (vec ? 4 : 1);
  return units <= 8 * per ? 8 : units <= 16 * per ? 16 : 32;
}

// Whether the float4 path takes these operands: F % 4 == 0 and every
// pointer 16-byte aligned (rows of x are then 16-byte aligned too).
inline bool vector_ok(int f, const void* a, const void* b) {
  return f % 4 == 0 && (reinterpret_cast<size_t>(a) % 16) == 0 &&
         (reinterpret_cast<size_t>(b) % 16) == 0;
}

}  // namespace gather
