// AdamW with global-norm clipping over every leaf of a parameter tree, in
// place, on Hopper: the gradients' global norm in two launches (partial sums,
// then one block over them), then one update launch for each (parameter
// dtype, gradient dtype) pair of the tree. On a mesh each rank runs them on
// its own blocks of the leaves, and the partial sums are summed over the
// ranks between the norm's two launches.
//
// Replaces no Pallas kernel: the reference's AdamW (src/repro/optim/adamw.py,
// `clip_by_global_norm` and `adamw_update`) is plain jnp that XLA fuses. The
// port composed it from PyTorch operations (optim/adamw.py): some 24 passes a
// leaf over float32 temporaries the size of the leaf, and new p, m and v
// built beside the old ones, so the moments were held twice.
//
// What bounds it on this card: bytes. The update reads p, g, m and v once
// and writes p, m and v once: 22 B a bf16 parameter with a bf16 gradient, 24 B
// with a float32 gradient, 28 B a float32 parameter; the norm reads g once
// more (2 or 4 B). At 3.35 TB/s that is 12.4 ms + 1.1 ms for internlm2-1.8b's
// 1.889 B parameters. The design:
//   * Multi-tensor: the leaves' pointers and sizes travel in a
//     kernel-parameter struct (`Leaves`, up to kMaxLeaves a launch), so
//     nothing is copied to the device each step. A leaf is cut into chunks
//     of kChunk elements; a grid of a few blocks an SM walks the chunks of
//     all the launch's leaves in order.
//   * 16-byte vectors of every operand (8 elements a vector), several
//     vectors in flight a thread; scalar code for a ragged tail and for a
//     leaf whose pointers are not 16-byte aligned. m and v, and g at its last
//     read, are loaded and stored with evict-first hints (`__ldcs`,
//     `__stcs`): each is touched once a step and is far larger than the
//     50 MB L2.
//   * In place: p, m and v are written over their inputs; nothing is
//     allocated. The caller's tree is consumed, as the reference's jitted
//     step donates its parameters and moments.
//
// Numerics:
//   * The update is optim/adamw.py's float32 arithmetic operation for
//     operation, in its order, each operation rounded on its own
//     (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`, `__fdiv_rn`, `__fsqrt_rn`:
//     nothing is contracted into an FMA). The constants b1, 1 - b1, b2,
//     1 - b2, eps and weight_decay are the float32 roundings of the Python
//     numbers PyTorch rounds its scalar operands from; the scale, lr and the
//     bias corrections are read from the device. A bf16 parameter is
//     rounded back with `__float2bfloat16_rn`. Given the same scale, lr and
//     bias corrections, p, m and v equal the plain version's bit for bit.
//   * The norm: each square rounded to float32, as the plain version's
//     `square` rounds it, then summed in float64 in a fixed order (a
//     thread's elements in order, a tree over the block, one block over the
//     blocks' sums): no atomics, so a step's norm is the same on every run.
//     It differs from the plain version's float32 sums by their rounding.
//     The clip scale min(1, max_norm / max(gn, 1e-9)) is a true division.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 48;     // leaves a launch: `Leaves` stays < 4 KB
constexpr int kThreads = 256;
constexpr int kVec = 8;            // elements a vector (16 B of bf16)
constexpr int kUnroll = 2;         // vectors in flight a thread, update
constexpr int kNormUnroll = 4;     // vectors in flight a thread, norm
constexpr long long kChunk = 16384;  // elements a chunk, a multiple of kVec

struct Leaves {
  int count;
  unsigned long long g_f32;           // bit i: leaf i's gradient is float32
  long long first[kMaxLeaves + 1];    // leaf i: chunks [first[i], first[i+1])
  long long n[kMaxLeaves];
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
};

// An element type, bf16 (kept as its 16 bits) or float32, read as float32.
template <bool kBf16>
struct Elt;

template <>
struct Elt<true> {
  using T = unsigned short;
  static __device__ __forceinline__ float get(const T* a, long long i) {
    return __uint_as_float((unsigned)a[i] << 16);
  }
  static __device__ __forceinline__ void put(T* a, long long i, float f) {
    a[i] = __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  // eight elements from vector i of a 16-byte aligned array
  template <bool kStream>
  static __device__ __forceinline__ void get8(const T* a, long long i,
                                              float* f) {
    const uint4* q = reinterpret_cast<const uint4*>(a) + i;
    const uint4 r = kStream ? __ldcs(q) : *q;
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      f[2 * k] = __uint_as_float(w[k] << 16);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void put8(T* a, long long i,
                                              const float* f) {
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w[k] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * k + 1]))
              << 16);
    reinterpret_cast<uint4*>(a)[i] = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Elt<false> {
  using T = float;
  static __device__ __forceinline__ float get(const T* a, long long i) {
    return a[i];
  }
  static __device__ __forceinline__ void put(T* a, long long i, float f) {
    a[i] = f;
  }
  template <bool kStream>
  static __device__ __forceinline__ void get8(const T* a, long long i,
                                              float* f) {
    const float4* q = reinterpret_cast<const float4*>(a) + 2 * i;
    const float4 lo = kStream ? __ldcs(q) : q[0];
    const float4 hi = kStream ? __ldcs(q + 1) : q[1];
    f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w;
    f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
  }
  template <bool kStream = false>
  static __device__ __forceinline__ void put8(T* a, long long i,
                                              const float* f) {
    float4* q = reinterpret_cast<float4*>(a) + 2 * i;
    const float4 lo = make_float4(f[0], f[1], f[2], f[3]);
    const float4 hi = make_float4(f[4], f[5], f[6], f[7]);
    if (kStream) {
      __stcs(q, lo);
      __stcs(q + 1, hi);
    } else {
      q[0] = lo;
      q[1] = hi;
    }
  }
};

// The leaf holding chunk `ch`, searched on from `leaf` (chunks are walked
// in increasing order, so the search only moves forward).
__device__ __forceinline__ int leaf_of(const Leaves& L, long long ch,
                                       int leaf) {
  while (ch >= L.first[leaf + 1]) ++leaf;
  return leaf;
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b,
                                          const void* c, const void* d) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d) &
          15) == 0;
}

// ------------------------------------------------------------------ norm

__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warps[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warps[w];
  return s;  // thread 0's is the block's sum
}

// A thread's float32 squares of chunk elements [0, len) of g, in order.
template <bool kBf16>
__device__ __forceinline__ void sum_squares(const void* gv, long long len,
                                            double& acc) {
  using E = Elt<kBf16>;
  const typename E::T* g = static_cast<const typename E::T*>(gv);
  long long done = 0;
  if (aligned16(g, g, g, g)) {
    const long long nv = len / kVec;
    for (long long i = threadIdx.x; i < nv; i += kThreads * kNormUnroll) {
      float f[kNormUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kNormUnroll; ++u)
        if (i + u * kThreads < nv) E::template get8<false>(g, i + u * kThreads, f[u]);
#pragma unroll
      for (int u = 0; u < kNormUnroll; ++u)
        if (i + u * kThreads < nv)
#pragma unroll
          for (int k = 0; k < kVec; ++k)
            acc += (double)__fmul_rn(f[u][k], f[u][k]);
    }
    done = nv * kVec;
  }
  for (long long e = done + threadIdx.x; e < len; e += kThreads) {
    const float x = E::get(g, e);
    acc += (double)__fmul_rn(x, x);
  }
}

// Pass 1: block b sums the squares of chunks b, b + grid, ... of the
// launch's gradients into partials[b].
__global__ void __launch_bounds__(kThreads)
adamw_norm_partials(const __grid_constant__ Leaves L,
                    double* __restrict__ partials) {
  double acc = 0.0;
  const long long total = L.first[L.count];
  int leaf = 0;
  for (long long ch = blockIdx.x; ch < total; ch += gridDim.x) {
    leaf = leaf_of(L, ch, leaf);
    const long long start = (ch - L.first[leaf]) * kChunk;
    const long long len = min(kChunk, L.n[leaf] - start);
    if ((L.g_f32 >> leaf) & 1ull)
      sum_squares<false>(static_cast<const float*>(L.g[leaf]) + start, len,
                         acc);
    else
      sum_squares<true>(static_cast<const unsigned short*>(L.g[leaf]) + start,
                        len, acc);
  }
  const double s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

// Pass 2: one block sums the n partials in a fixed order and writes
// out[0] = the norm, out[1] = the clip scale.
__global__ void __launch_bounds__(kThreads)
adamw_norm_finish(const double* __restrict__ partials, int n, float max_norm,
                  float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) acc += partials[i];
  const double s = block_sum(acc);
  if (threadIdx.x == 0) {
    const float gn = (float)sqrt(s);
    // torch.clamp_min / clamp_max keep a NaN, fmaxf / fminf would drop it
    const float c = isnan(gn) ? gn : fmaxf(gn, 1e-9f);
    float scale = __fdiv_rn(max_norm, c);
    scale = isnan(scale) ? scale : fminf(scale, 1.0f);
    out[0] = gn;
    out[1] = scale;
  }
}

// ---------------------------------------------------------------- update

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

// optim/adamw.py's `upd` for one element, in its order:
//   g = g * scale
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g
//   u = (m / b1c) / (sqrt(v / b2c) + eps) + wd * p
//   p = p - lr * u
__device__ __forceinline__ void adam(float& p, float g, float& m, float& v,
                                     float scale, float lr, float b1c,
                                     float b2c, const Consts& c) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, gs));
  v = __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, gs), gs));
  float u = __fdiv_rn(__fdiv_rn(m, b1c),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, b2c)), c.eps));
  u = __fadd_rn(u, __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

template <bool kPBf16, bool kGBf16>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const __grid_constant__ Leaves L,
                    const float* __restrict__ scale_p,
                    const float* __restrict__ lr_p,
                    const float* __restrict__ b1c_p,
                    const float* __restrict__ b2c_p, const Consts c) {
  using EP = Elt<kPBf16>;
  using EG = Elt<kGBf16>;
  using EM = Elt<false>;
  const float scale = *scale_p, lr = *lr_p, b1c = *b1c_p, b2c = *b2c_p;
  const long long total = L.first[L.count];
  int leaf = 0;
  for (long long ch = blockIdx.x; ch < total; ch += gridDim.x) {
    leaf = leaf_of(L, ch, leaf);
    const long long start = (ch - L.first[leaf]) * kChunk;
    const long long len = min(kChunk, L.n[leaf] - start);
    typename EP::T* p = static_cast<typename EP::T*>(L.p[leaf]) + start;
    const typename EG::T* g =
        static_cast<const typename EG::T*>(L.g[leaf]) + start;
    float* m = L.m[leaf] + start;
    float* v = L.v[leaf] + start;
    long long done = 0;
    if (aligned16(p, g, m, v)) {
      const long long nv = len / kVec;
      for (long long i = threadIdx.x; i < nv; i += kThreads * kUnroll) {
        float fp[kUnroll][kVec], fg[kUnroll][kVec], fm[kUnroll][kVec],
            fv[kUnroll][kVec];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long j = i + u * kThreads;
          if (j < nv) {
            EP::template get8<false>(p, j, fp[u]);
            EG::template get8<true>(g, j, fg[u]);
            EM::template get8<true>(m, j, fm[u]);
            EM::template get8<true>(v, j, fv[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long j = i + u * kThreads;
          if (j < nv) {
#pragma unroll
            for (int k = 0; k < kVec; ++k)
              adam(fp[u][k], fg[u][k], fm[u][k], fv[u][k], scale, lr, b1c,
                   b2c, c);
            EP::put8(p, j, fp[u]);
            EM::template put8<true>(m, j, fm[u]);
            EM::template put8<true>(v, j, fv[u]);
          }
        }
      }
      done = nv * kVec;
    }
    for (long long e = done + threadIdx.x; e < len; e += kThreads) {
      float fp = EP::get(p, e), fm = m[e], fv = v[e];
      adam(fp, EG::get(g, e), fm, fv, scale, lr, b1c, b2c, c);
      EP::put(p, e, fp);
      m[e] = fm;
      v[e] = fv;
    }
  }
}

// Leaves [lo, lo + k) of the arrays into a launch's struct.
Leaves gather(int lo, int k, void* const* p, void* const* g, void* const* m,
              void* const* v, const long long* n, const int* g_f32) {
  Leaves L = {};
  L.count = k;
  for (int i = 0; i < k; ++i) {
    L.n[i] = n[lo + i];
    L.first[i + 1] = L.first[i] + (n[lo + i] + kChunk - 1) / kChunk;
    L.p[i] = p ? p[lo + i] : nullptr;
    L.g[i] = g[lo + i];
    L.m[i] = m ? static_cast<float*>(m[lo + i]) : nullptr;
    L.v[i] = v ? static_cast<float*>(v[lo + i]) : nullptr;
    if (g_f32 && g_f32[lo + i]) L.g_f32 |= 1ull << i;
  }
  return L;
}

}  // namespace

// Pass 1 of the global norm of `count` gradient leaves g[i] of n[i]
// elements, bf16 or float32 (g_f32[i]): ceil(count / kMaxLeaves) launches
// of `blocks` blocks, each writing `blocks` float64 partial sums of squares
// in turn to `partials`. A caller on several ranks sums the partials over
// them (each rank handing in the same count and blocks) before pass 2.
extern "C" int adamw_norm_sums(int count, void* const* g, const long long* n,
                               const int* g_f32, int blocks, void* partials,
                               void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (count < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  int groups = 0;
  for (int lo = 0; lo < count; lo += kMaxLeaves, ++groups) {
    const int k = count - lo < kMaxLeaves ? count - lo : kMaxLeaves;
    const Leaves L = gather(lo, k, nullptr, g, nullptr, nullptr, n, g_f32);
    adamw_norm_partials<<<blocks, kThreads, 0, st>>>(
        L, static_cast<double*>(partials) + (long long)groups * blocks);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}

// Pass 2: one block over the `n` partials, writing out[0] = the norm,
// out[1] = the clip scale.
extern "C" int adamw_norm_scale(int n, const void* partials, void* out,
                                float max_norm, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  adamw_norm_finish<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const double*>(partials), n, max_norm,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// AdamW over `count` leaves of one (parameter, gradient) dtype pair, bf16
// where p_bf16 / g_bf16, else float32: p, m, v (float32) and g of n[i]
// elements, contiguous; p, m and v written in place. scale, lr, b1c and
// b2c point to float32 numbers on the device. ceil(count / kMaxLeaves)
// launches of up to `blocks` blocks.
extern "C" int adamw_update(int count, int p_bf16, int g_bf16,
                            void* const* p, void* const* g, void* const* m,
                            void* const* v, const long long* n,
                            const void* scale, const void* lr,
                            const void* b1c, const void* b2c, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, int blocks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (count < 0 || blocks < 1) return (int)cudaErrorInvalidValue;
  const Consts c = {b1, omb1, b2, omb2, eps, wd};
  const float *s = static_cast<const float*>(scale),
              *l = static_cast<const float*>(lr),
              *c1 = static_cast<const float*>(b1c),
              *c2 = static_cast<const float*>(b2c);
  for (int lo = 0; lo < count; lo += kMaxLeaves) {
    const int k = count - lo < kMaxLeaves ? count - lo : kMaxLeaves;
    const Leaves L = gather(lo, k, p, g, m, v, n, nullptr);
    const long long chunks = L.first[k];
    if (chunks == 0) continue;
    const unsigned grid =
        (unsigned)(chunks < blocks ? chunks : (long long)blocks);
    if (p_bf16 && g_bf16)
      adamw_update_kernel<true, true><<<grid, kThreads, 0, st>>>(L, s, l, c1,
                                                                 c2, c);
    else if (p_bf16)
      adamw_update_kernel<true, false><<<grid, kThreads, 0, st>>>(L, s, l, c1,
                                                                  c2, c);
    else if (g_bf16)
      adamw_update_kernel<false, true><<<grid, kThreads, 0, st>>>(L, s, l, c1,
                                                                  c2, c);
    else
      adamw_update_kernel<false, false><<<grid, kThreads, 0, st>>>(
          L, s, l, c1, c2, c);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
