// Causal (optionally sliding-window) GQA attention on Hopper, forward and
// backward, with the scores kept on chip:
//   out = softmax(mask(scale * q k^T)) v,   L = m + log l (per query row).
//
// Replaces no Pallas kernel: the reference computes attention with
// `chunked_attention` (src/repro/models/attention.py), an online softmax
// over chunk pairs that XLA fuses. The port composed the same loop from
// PyTorch operations (models/attention.py), some 90 launches for each chunk
// pair and layer across forward, recomputation and backward, and every
// 1,024 x 1,024 float32 score block through device memory about 15 times.
//
// What bounds it on this card: the tensor cores, and issuing the copies.
// At internlm2-1.8b's layer shapes (16 heads, 8 KV heads, head width 128,
// causal) a product of the attention is 34.4 GFLOP a layer at 1 x 4,096
// tokens. Float32 scores and P.V take at least 15 of them (1 + 3 forward,
// 1 + 1 + 3 + 3 + 3 backward): 0.52 ms at 989 TFLOP/s bf16. The kernels
// do 17 (below); the bytes of q, k, v, out, dout, dq, dk, dv and the
// float32 O move in a tenth of that.
//
// Numerics, the program's: float32 scores and float32 P.V.
//   * q, k, v and dout are bf16, so a bf16 product with float32
//     accumulation forms exactly the products of the float32 einsum; the
//     order of summation differs (and the tensor cores' float32 sums over
//     thousands of rows drift further from a float64 sum than the CUDA
//     cores' do: PERF.md has the readings). The score is multiplied
//     by the float32 scale after the product (`__fmul_rn`), masked scores
//     are NEG_INF, and a row's denominator is clamped at 1e-30.
//   * A product with a float32 operand (P.V, P^T.dO, dS.K, dS^T.Q) splits
//     that operand into three bf16 terms, hi + mid + lo, whose sum is the
//     float32 value exactly (8 + 8 + 8 significant bits; exact down to
//     2^-110, below which the lost bits are under 2^-133), and accumulates
//     three bf16 products in float32. P and dS are never rounded to bf16
//     before a product (`terms` = 1 does that, as a control for the tests:
//     mid and lo are then zero).
//   * The backward's row term D = rowsum(dO * O) is taken from the
//     forward's float32 O, and P is recomputed as exp(s - L).
//
// The design: warpgroup products (`wgmma`, wgmma.cuh) on tiles that the
// block's threads stage with `cp.async` (a producer warp feeding them by
// the Tensor Memory Accelerator is left for later):
//   * Every block is one warpgroup, and two blocks share an SM, so one's
//     softmax or copies overlap the other's products. Q, K, V, dO tiles
//     are read by the products from shared memory; P and dS, float32 in
//     the accumulators, become the A operands of the split products in
//     registers and never leave them.
//   * GQA: the G query heads of a KV head are packed into the rows of a
//     tile (row r = position r / G, head r % G), so each K/V tile is loaded
//     once for all G, and dK, dV sum over the G heads in registers.
//   * Forward: a block per (64-row query tile, KV head, batch row); 64-key
//     K/V tiles double-buffered; the online softmax in registers; writes
//     out (bf16), O (float32, only when a gradient will be taken) and L.
//   * Backward, two kernels and no atomics, so a gradient is the same on
//     every run: the dQ pass (a block per 64-row query tile, walking the
//     key tiles: S, P, dP = dO.V^T, dS, dQ += dS.K; it also computes D)
//     and then the dK/dV pass (a block per 64-key tile, walking 32-row
//     query tiles through a ring of 4: S^T, P^T, dP^T, dS^T,
//     dV += P^T.dO, dK += dS^T.Q). 4 + 5 + 8 = 17 products in all.
//   * A tile's copies are issued one row offset a thread, since issuing
//     the copies, not their bytes, paced the first version; a mask is
//     worked out only on tiles that straddle the diagonal, the window's
//     edge or the end, and without branches (a branch a score cost more
//     than its exponential).
//   * Tiles that the causal or window mask hides wholly are skipped; the
//     longest blocks are launched first.
//   * Shared memory tiles are two 64-column panels in the 128-byte swizzle
//     the products read (wgmma.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 128;              // head width (q, k and v)
constexpr int kChunks = kD / 8;      // 16-byte chunks of a row
constexpr int kRowBytes = kD * 2;    // a bf16 row in shared memory
constexpr int kThreads = 128;        // one warpgroup in every block

constexpr int kFwdRows = 64;         // packed query rows of a forward block
constexpr int kFwdKeys = 64;         // keys of a forward K/V tile
constexpr int kDqRows = 64;          // packed query rows of a dQ block
constexpr int kDqKeys = 64;          // keys of a dQ K/V tile
constexpr int kBwdKeys = 64;         // keys of a dK/dV block
constexpr int kBwdRows = 32;         // packed query rows of a dK/dV tile
constexpr int kBwdStages = 4;        // query tiles in the dK/dV pass's ring

constexpr float kNegInf = -1e30f;

// the products are one warpgroup's 64 rows against 64 (forward, dQ) or 32
// (dK/dV) columns
static_assert(kThreads == 128 && kFwdRows == 64 && kDqRows == 64 &&
                  kBwdKeys == 64 && kFwdKeys == 64 && kDqKeys == 64 &&
                  kBwdRows == 32,
              "tile sizes are those of the wgmma shapes used");

struct Shape {
  int B, Sq, Sk, H, KV, G, window, terms;
  float scale;
};

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the dynamic shared memory from its first 1,024-byte boundary
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* smem) {
  return smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// until this thread's copies but the newest N groups have landed, and made
// visible to the products
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
  wg::fence_smem();
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// a pair of float32 values as three bf16 pairs whose sums are the values
// exactly: hi = rn(x), mid = rn(x - hi), lo = rn(x - hi - mid)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  float2 hf = __bfloat1622float2(h);
  float rx = __fsub_rn(x, hf.x), ry = __fsub_rn(y, hf.y);
  __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  float2 mf = __bfloat1622float2(m);
  __nv_bfloat162 l = __floats2bfloat162_rn(__fsub_rn(rx, mf.x),
                                           __fsub_rn(ry, mf.y));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// The A operands (the warp's 16 rows x 16 columns) of hi, mid and lo for
// columns 16 kk .. 16 kk + 15 of a float32 accumulator c (n-tiles of 8)
template <int N>
__device__ __forceinline__ void split_a(const float (&c)[N], int kk,
                                        uint32_t (&hi)[4], uint32_t (&mid)[4],
                                        uint32_t (&lo)[4]) {
  const int i = 8 * kk;
  split3(c[i], c[i + 1], hi[0], mid[0], lo[0]);
  split3(c[i + 2], c[i + 3], hi[1], mid[1], lo[1]);
  split3(c[i + 4], c[i + 5], hi[2], mid[2], lo[2]);
  split3(c[i + 6], c[i + 7], hi[3], mid[3], lo[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row offset (in rows of kD) of packed query row r of a KV head, from the
// head's first row: position r / G, head r % G of the group.
__device__ __forceinline__ long q_row(int r, const Shape& s) {
  return (long)(r / s.G) * s.H + r % s.G;
}

// A tile of kRows rows is copied by the block's threads kThreads / kRows
// to a row (one row offset worked out a thread), each taking every
// (16 / that)-th 16-byte chunk, so neighbouring threads read neighbouring
// chunks: row `row` of global row `src_row` (elements of kD) into `dst`.
template <int kRows>
__device__ __forceinline__ void load_row(uint32_t dst, const bf16* src,
                                         bool ok) {
  constexpr int kPer = kRows * kChunks / kThreads;   // chunks a thread
  constexpr int kTpr = kChunks / kPer;               // threads a row
  static_assert(kPer * kTpr == kChunks && kTpr * kRows == kThreads,
                "a tile's rows must split evenly over the block");
  const int row = threadIdx.x / kTpr, sub = threadIdx.x % kTpr;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = sub + kTpr * j;
    cp_async16(dst + wg::swz(kRows, row, c), src + c * 8, ok);
  }
}

// kRows packed query rows from r0 into a tile (zeros past the end)
template <int kRows>
__device__ __forceinline__ void load_q_rows(uint32_t dst, const bf16* base,
                                            int r0, int n_rows,
                                            const Shape& s) {
  const int r = r0 + threadIdx.x / (kThreads / kRows);
  const bool ok = r < n_rows;
  load_row<kRows>(dst, base + (ok ? q_row(r, s) * kD : 0), ok);
}

// kRows keys from j0 of one KV head into a tile (zeros past the end)
template <int kRows>
__device__ __forceinline__ void load_k_rows(uint32_t dst, const bf16* base,
                                            int j0, const Shape& s) {
  const int j = j0 + threadIdx.x / (kThreads / kRows);
  const bool ok = j < s.Sk;
  load_row<kRows>(dst, base + (ok ? (long)j * s.KV * kD : 0), ok);
}

// without short-circuit branches: a branch per score costs more than the
// score's exponential
__device__ __forceinline__ bool live(int pos, int key, const Shape& s) {
  return (key < s.Sk) & (key <= pos) &
         ((s.window == 0) | (pos - key < s.window));
}

// Whether every score of query positions [p0, p1] against keys [k0, k1]
// is live (then no mask is worked out for the tile)
__device__ __forceinline__ bool all_live(int p0, int p1, int k0, int k1,
                                         const Shape& s) {
  return k1 < s.Sk && k1 <= p0 && (s.window == 0 || p1 - k0 < s.window);
}

// The key tiles [t0, t1) of `keys` keys that positions [lo, hi] can see
__device__ __forceinline__ void key_tiles(int lo, int hi, int keys,
                                          const Shape& s, int& t0, int& t1) {
  int end = min(s.Sk, hi + 1);
  int begin = s.window > 0 ? max(0, lo - s.window + 1) : 0;
  t0 = begin / keys;
  t1 = end > begin ? (end + keys - 1) / keys : t0;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// The three bf16 terms of a float32 accumulator's 16-column steps as A
// operands, kept by the caller until the products that read them are done
template <int N>
struct Terms {
  uint32_t hi[N / 8][4], mid[N / 8][4], lo[N / 8][4];

  __device__ __forceinline__ void pin() {
#pragma unroll
    for (int kk = 0; kk < N / 8; ++kk) {
      wg::pin(hi[kk]);
      wg::pin(mid[kk]);
      wg::pin(lo[kk]);
    }
  }
};

// acc += (hi + mid + lo) B over 16-row steps [0, N / 8) of an MN-major
// tile, the terms split from the columns of c. The control (terms 1)
// keeps hi and zeroes mid and lo, so the same products run.
template <int N>
__device__ __forceinline__ void split_products(float (&acc)[64],
                                               const float (&c)[N],
                                               Terms<N>& a, uint32_t tile,
                                               int rows, int terms) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    split_a(c, kk, a.hi[kk], a.mid[kk], a.lo[kk]);
    if (terms != 3) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a.mid[kk][j] = a.lo[kk][j] = 0u;
    }
  }
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    const uint64_t b = wg::mnmajor(tile, rows, kk);
    wg::rs_m64n128(acc, a.hi[kk], b);
    wg::rs_m64n128(acc, a.mid[kk], b);
    wg::rs_m64n128(acc, a.lo[kk], b);
  }
}

// ---------------------------------------------------------------- forward
__global__ void __launch_bounds__(kThreads, 2)
    fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               float* __restrict__ o32, float* __restrict__ lse, Shape s) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + kFwdRows * kRowBytes;
  const uint32_t sV = sK + 2 * kFwdKeys * kRowBytes;
  const int n_rows = s.Sq * s.G;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * kFwdRows;
  const int last = min(r0 + kFwdRows, n_rows) - 1;
  int t0, t1;
  key_tiles(r0 / s.G, last / s.G, kFwdKeys, s, t0, t1);

  const long qb = (long)b * s.Sq * s.H + (long)kvh * s.G;  // rows of kD
  const bf16* kb = k + ((long)b * s.Sk * s.KV + kvh) * kD;
  const bf16* vb = v + ((long)b * s.Sk * s.KV + kvh) * kD;
  load_q_rows<kFwdRows>(sQ, q + qb * kD, r0, n_rows, s);
  if (t0 < t1) {
    load_k_rows<kFwdKeys>(sK, kb, t0 * kFwdKeys, s);
    load_k_rows<kFwdKeys>(sV, vb, t0 * kFwdKeys, s);
  }
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rA = r0 + warp * 16 + g, rB = rA + 8;
  const int posA = rA / s.G, posB = rB / s.G;

  float o[64];
  zero(o);
  float mA = kNegInf, mB = kNegInf, lA = 0.f, lB = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      load_k_rows<kFwdKeys>(sK + (st ^ 1) * kFwdKeys * kRowBytes, kb,
                            (t + 1) * kFwdKeys, s);
      load_k_rows<kFwdKeys>(sV + (st ^ 1) * kFwdKeys * kRowBytes, vb,
                            (t + 1) * kFwdKeys, s);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint32_t tK = sK + st * kFwdKeys * kRowBytes;
    const uint32_t tV = sV + st * kFwdKeys * kRowBytes;

    float sc[32];   // S: the warpgroup's 64 rows x 64 keys
    zero(sc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wg::ss_m64n64(sc, wg::kmajor(sQ, kFwdRows, kk),
                    wg::kmajor(tK, kFwdKeys, kk));
    wg::commit();
    wg::wait<0>();
    wg::pin(sc);

    // scale, mask, online softmax
    const int key0 = t * kFwdKeys + 2 * tq;
    const bool full = all_live(r0 / s.G, last / s.G, t * kFwdKeys,
                               t * kFwdKeys + kFwdKeys - 1, s);
    float mxA = kNegInf, mxB = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = i & 3, key = key0 + (i >> 2) * 8 + (e & 1);
      const bool ok = full || live(e < 2 ? posA : posB, key, s);
      const float x = ok ? __fmul_rn(sc[i], s.scale) : kNegInf;
      sc[i] = x;
      if (e < 2) mxA = fmaxf(mxA, x);
      else mxB = fmaxf(mxB, x);
    }
    const float nmA = fmaxf(mA, quad_max(mxA));
    const float nmB = fmaxf(mB, quad_max(mxB));
    const float cA = expf(__fsub_rn(mA, nmA)), cB = expf(__fsub_rn(mB, nmB));
    mA = nmA;
    mB = nmB;
    float sumA = 0.f, sumB = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool a = (i & 3) < 2;
      const float p = expf(__fsub_rn(sc[i], a ? nmA : nmB));
      sc[i] = p;
      if (a) sumA += p;
      else sumB += p;
    }
    lA = __fadd_rn(__fmul_rn(lA, cA), sumA);
    lB = __fadd_rn(__fmul_rn(lB, cB), sumB);
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = __fmul_rn(o[i], (i & 3) < 2 ? cA : cB);

    // O += P V, P in three bf16 terms
    Terms<32> pt;
    split_products(o, sc, pt, tV, kFwdKeys, s.terms);
    wg::commit();
    wg::wait<0>();
    wg::pin(o);
    pt.pin();
    __syncthreads();
  }
  cp_wait<0>();

  lA = quad_sum(lA);
  lB = quad_sum(lB);
  const float dA = fmaxf(lA, 1e-30f), dB = fmaxf(lB, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rB : rA;
    if (r >= n_rows) continue;
    const float den = half ? dB : dA;
    const long row = (qb + q_row(r, s)) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = n * 8 + 2 * tq;
      float x = o[4 * n + 2 * half] / den, y = o[4 * n + 2 * half + 1] / den;
      *reinterpret_cast<__nv_bfloat162*>(out + row + d) =
          __floats2bfloat162_rn(x, y);
      if (o32) *reinterpret_cast<float2*>(o32 + row + d) = make_float2(x, y);
    }
    if (tq == 0) lse[qb + q_row(r, s)] = (half ? mB : mA) + logf(den);
  }
}

// ---------------------------------------------------------------- dQ pass
// dQ of a 64-row query tile over its key tiles; also D = rowsum(dO * O)
__global__ void __launch_bounds__(kThreads, 2)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ o32,
              const float* __restrict__ lse, const bf16* __restrict__ dout,
              float* __restrict__ delta, bf16* __restrict__ dq,
              float* __restrict__ dq32, Shape s) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sO = sQ + kDqRows * kRowBytes;  // dO
  const uint32_t sK = sO + kDqRows * kRowBytes;
  const uint32_t sV = sK + 2 * kDqKeys * kRowBytes;
  float* sDelta = reinterpret_cast<float*>(smem + 2 * kDqRows * kRowBytes +
                                           4 * kDqKeys * kRowBytes);
  const int n_rows = s.Sq * s.G;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int r0 = tile * kDqRows;
  const int last = min(r0 + kDqRows, n_rows) - 1;
  int t0, t1;
  key_tiles(r0 / s.G, last / s.G, kDqKeys, s, t0, t1);

  const long qb = (long)b * s.Sq * s.H + (long)kvh * s.G;
  const bf16* kb = k + ((long)b * s.Sk * s.KV + kvh) * kD;
  const bf16* vb = v + ((long)b * s.Sk * s.KV + kvh) * kD;
  load_q_rows<kDqRows>(sQ, q + qb * kD, r0, n_rows, s);
  load_q_rows<kDqRows>(sO, dout + qb * kD, r0, n_rows, s);
  if (t0 < t1) {
    load_k_rows<kDqKeys>(sK, kb, t0 * kDqKeys, s);
    load_k_rows<kDqKeys>(sV, vb, t0 * kDqKeys, s);
  }
  cp_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int w16 = warp * 16;  // the warp's first row

  // D of the warp's 16 rows, from the float32 O and dO in device memory:
  // every load first, then the sums
  {
    float4 o[16];
    uint2 raw[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = min(r0 + w16 + i, n_rows - 1);
      const long row = (qb + q_row(r, s)) * kD + lane * 4;
      o[i] = *reinterpret_cast<const float4*>(o32 + row);
      raw[i] = *reinterpret_cast<const uint2*>(dout + row);
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const float2 d01 =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw[i].x));
      const float2 d23 =
          __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw[i].y));
      float acc = o[i].x * d01.x + o[i].y * d01.y + o[i].z * d23.x +
                  o[i].w * d23.y;
#pragma unroll
      for (int off = 16; off; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int r = r0 + w16 + i;
      if (lane == 0) {
        sDelta[w16 + i] = acc;
        if (r < n_rows) delta[qb + q_row(r, s)] = acc;
      }
    }
  }
  __syncwarp();
  const int rA = r0 + w16 + g, rB = rA + 8;
  const int posA = rA / s.G, posB = rB / s.G;
  const float LA = rA < n_rows ? lse[qb + q_row(rA, s)] : 0.f;
  const float LB = rB < n_rows ? lse[qb + q_row(rB, s)] : 0.f;
  const float DA = sDelta[w16 + g], DB = sDelta[w16 + g + 8];

  float dqa[64];
  zero(dqa);

  for (int t = t0; t < t1; ++t) {
    const int st = (t - t0) & 1;
    if (t + 1 < t1) {
      load_k_rows<kDqKeys>(sK + (st ^ 1) * kDqKeys * kRowBytes, kb,
                           (t + 1) * kDqKeys, s);
      load_k_rows<kDqKeys>(sV + (st ^ 1) * kDqKeys * kRowBytes, vb,
                           (t + 1) * kDqKeys, s);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const uint32_t tK = sK + st * kDqKeys * kRowBytes;
    const uint32_t tV = sV + st * kDqKeys * kRowBytes;

    float sc[32], dp[32];   // S and dP: 64 rows x 64 keys
    zero(sc);
    zero(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wg::ss_m64n64(sc, wg::kmajor(sQ, kDqRows, kk),
                    wg::kmajor(tK, kDqKeys, kk));
      wg::ss_m64n64(dp, wg::kmajor(sO, kDqRows, kk),
                    wg::kmajor(tV, kDqKeys, kk));
    }
    wg::commit();
    wg::wait<0>();
    wg::pin(sc);
    wg::pin(dp);
    // P = exp(s - L), dS = P (dP - D) scale
    const int key0 = t * kDqKeys + 2 * tq;
    const bool full = r0 + kDqRows <= n_rows &&
                      all_live(r0 / s.G, last / s.G, t * kDqKeys,
                               t * kDqKeys + kDqKeys - 1, s);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int e = i & 3;
      const bool a = e < 2;
      const int key = key0 + (i >> 2) * 8 + (e & 1);
      const bool ok = full || (((a ? rA : rB) < n_rows) &
                               live(a ? posA : posB, key, s));
      const float x = ok ? __fmul_rn(sc[i], s.scale) : kNegInf;
      const float p = expf(__fsub_rn(x, a ? LA : LB));
      sc[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], a ? DA : DB)), s.scale);
    }
    // dQ += dS K, dS in three bf16 terms
    Terms<32> dst;
    split_products(dqa, sc, dst, tK, kDqKeys, s.terms);
    wg::commit();
    wg::wait<0>();
    wg::pin(dqa);
    dst.pin();
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rB : rA;
    if (r >= n_rows) continue;
    const long row = (qb + q_row(r, s)) * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = n * 8 + 2 * tq;
      float x = dqa[4 * n + 2 * half], y = dqa[4 * n + 2 * half + 1];
      *reinterpret_cast<__nv_bfloat162*>(dq + row + d) =
          __floats2bfloat162_rn(x, y);
      if (dq32) *reinterpret_cast<float2*>(dq32 + row + d) = make_float2(x, y);
    }
  }
}

// ---------------------------------------------------------------- dK/dV pass
// dK, dV of a 64-key tile over the query tiles that see it, summed over
// the G heads of the KV head (they are rows of the query tiles)
__global__ void __launch_bounds__(kThreads, 2)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const float* __restrict__ lse,
               const float* __restrict__ delta, const bf16* __restrict__ dout,
               bf16* __restrict__ dk, bf16* __restrict__ dv,
               float* __restrict__ dk32, float* __restrict__ dv32, Shape s) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + kBwdKeys * kRowBytes;
  const uint32_t sQ = sV + kBwdKeys * kRowBytes;     // the ring's Q tiles
  const uint32_t sO = sQ + kBwdStages * kBwdRows * kRowBytes;  // dO tiles
  float* sL = reinterpret_cast<float*>(smem + 2 * kBwdKeys * kRowBytes +
                                       2 * kBwdStages * kBwdRows * kRowBytes);
  float* sD = sL + kBwdStages * kBwdRows;
  const int n_rows = s.Sq * s.G;
  const int kt = blockIdx.x;  // the first key tiles see the most rows
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * kBwdKeys;
  const int k_last = min(k0 + kBwdKeys, s.Sk) - 1;
  const int r_begin = k0 * s.G;
  const int r_end = s.window > 0 ? min(n_rows, (k_last + s.window) * s.G)
                                  : n_rows;
  const int u0 = r_begin / kBwdRows;
  const int u1 = r_end > r_begin ? (r_end + kBwdRows - 1) / kBwdRows : u0;

  const long qb = (long)b * s.Sq * s.H + (long)kvh * s.G;
  const bf16* qh = q + qb * kD;
  const bf16* oh = dout + qb * kD;
  const long kvrow = ((long)b * s.Sk * s.KV + kvh) * kD;
  load_k_rows<kBwdKeys>(sK, k + kvrow, k0, s);
  load_k_rows<kBwdKeys>(sV, v + kvrow, k0, s);

  auto load_rows = [&](int u, int st) {
    const int r = u * kBwdRows;
    // Q and dO rows share a row offset
    const int rr = r + threadIdx.x / (kThreads / kBwdRows);
    const bool ok = rr < n_rows;
    const long off = ok ? q_row(rr, s) * kD : 0;
    load_row<kBwdRows>(sQ + st * kBwdRows * kRowBytes, qh + off, ok);
    load_row<kBwdRows>(sO + st * kBwdRows * kRowBytes, oh + off, ok);
    if (threadIdx.x < 2 * kBwdRows) {
      const int i = threadIdx.x % kBwdRows, ri = r + i;
      const bool oki = ri < n_rows;
      const float* src = (threadIdx.x < kBwdRows ? lse : delta) +
                         (oki ? qb + q_row(ri, s) : 0);
      float* dst = (threadIdx.x < kBwdRows ? sL : sD) + st * kBwdRows + i;
      cp_async4(smem_u32(dst), src, oki);
    }
  };
  // tiles u0 .. u0 + kBwdStages - 2 in flight (a group each, empty past
  // the end, so every wait below counts the same groups)
#pragma unroll
  for (int i = 0; i < kBwdStages - 1; ++i) {
    if (u0 + i < u1) load_rows(u0 + i, i);
    cp_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int keyA = k0 + warp * 16 + g, keyB = keyA + 8;

  float dka[64], dva[64];
  zero(dka);
  zero(dva);

  for (int u = u0; u < u1; ++u) {
    const int st = (u - u0) % kBwdStages;
    if (u + kBwdStages - 1 < u1)
      load_rows(u + kBwdStages - 1, (st + kBwdStages - 1) % kBwdStages);
    cp_commit();
    cp_wait<kBwdStages - 1>();
    __syncthreads();
    const uint32_t tQ = sQ + st * kBwdRows * kRowBytes;
    const uint32_t tO = sO + st * kBwdRows * kRowBytes;
    const float* tL = sL + st * kBwdRows;
    const float* tD = sD + st * kBwdRows;

    // S^T = K Q^T and dP^T = V dO^T: keys as rows, query rows as columns
    float sc[16], dp[16];
    zero(sc);
    zero(dp);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wg::ss_m64n32(sc, wg::kmajor(sK, kBwdKeys, kk),
                    wg::kmajor(tQ, kBwdRows, kk));
      wg::ss_m64n32(dp, wg::kmajor(sV, kBwdKeys, kk),
                    wg::kmajor(tO, kBwdRows, kk));
    }
    wg::commit();
    wg::wait<0>();
    wg::pin(sc);
    wg::pin(dp);
    // P^T = exp(s - L), dS^T = P^T (dP^T - D) scale; no mask to work out
    // where the whole tile pair is live
    const int ra = u * kBwdRows;
    const bool full = ra + kBwdRows <= n_rows &&
                      all_live(ra / s.G, (ra + kBwdRows - 1) / s.G, k0,
                               k0 + kBwdKeys - 1, s);
    int pos[8];   // the positions of the thread's 8 columns
    if (!full) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        pos[j] = (ra + (j >> 1) * 8 + 2 * tq + (j & 1)) / s.G;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int e = i & 3;
      const int c = (i >> 2) * 8 + 2 * tq + (e & 1);  // row of the tile
      const bool ok = full || (((ra + c) < n_rows) &
                               live(pos[(i >> 2) * 2 + (e & 1)],
                                    e < 2 ? keyA : keyB, s));
      const float x = ok ? __fmul_rn(sc[i], s.scale) : kNegInf;
      const float p = expf(__fsub_rn(x, tL[c]));
      sc[i] = p;
      dp[i] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[i], tD[c])), s.scale);
    }
    // dV += P^T dO and dK += dS^T Q, P^T and dS^T in three bf16 terms
    Terms<16> pt, dst;
    split_products(dva, sc, pt, tO, kBwdRows, s.terms);
    split_products(dka, dp, dst, tQ, kBwdRows, s.terms);
    wg::commit();
    wg::wait<0>();
    wg::pin(dva);
    wg::pin(dka);
    pt.pin();
    dst.pin();
    __syncthreads();
  }
  cp_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = half ? keyB : keyA;
    if (key >= s.Sk) continue;
    const long row = ((long)b * s.Sk + key) * s.KV * kD + (long)kvh * kD;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int d = n * 8 + 2 * tq;
      const float kx = dka[4 * n + 2 * half], ky = dka[4 * n + 2 * half + 1];
      const float vx = dva[4 * n + 2 * half], vy = dva[4 * n + 2 * half + 1];
      *reinterpret_cast<__nv_bfloat162*>(dk + row + d) =
          __floats2bfloat162_rn(kx, ky);
      *reinterpret_cast<__nv_bfloat162*>(dv + row + d) =
          __floats2bfloat162_rn(vx, vy);
      if (dk32) *reinterpret_cast<float2*>(dk32 + row + d) = make_float2(kx, ky);
      if (dv32) *reinterpret_cast<float2*>(dv32 + row + d) = make_float2(vx, vy);
    }
  }
}

// dynamic shared memory of each kernel, with room to align it to 1,024
constexpr int kFwdSmem = (kFwdRows + 4 * kFwdKeys) * kRowBytes + 1024;
constexpr int kDqSmem = (2 * kDqRows + 4 * kDqKeys) * kRowBytes +
                        kDqRows * 4 + 1024;
constexpr int kBwdSmem =
    (2 * kBwdKeys + 2 * kBwdStages * kBwdRows) * kRowBytes +
    2 * kBwdStages * kBwdRows * 4 + 1024;

Shape make_shape(int B, int Sq, int Sk, int H, int KV, int window,
                 float scale, int terms) {
  Shape s;
  s.B = B;
  s.Sq = Sq;
  s.Sk = Sk;
  s.H = H;
  s.KV = KV;
  s.G = H / KV;
  s.window = window;
  s.terms = terms;
  s.scale = scale;
  return s;
}

// the kernels' shared memory limits raised, once on each device
cudaError_t smem_ready() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  const void* fns[3] = {(const void*)fwd_kernel, (const void*)dq_kernel,
                        (const void*)dkv_kernel};
  const int bytes[3] = {kFwdSmem, kDqSmem, kBwdSmem};
  for (int i = 0; i < 3; ++i) {
    err = cudaFuncSetAttribute(fns[i],
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes[i]);
    if (err != cudaSuccess) return err;
  }
  ready[dev] = true;
  return cudaSuccess;
}

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int window, int terms) {
  return B < 1 || Sq < 1 || Sk < 1 || KV < 1 || H < KV || H % KV ||
         window < 0 || (terms != 1 && terms != 3) || B > 65535 || KV > 65535;
}

}  // namespace

// q [B, Sq, H, 128], k and v [B, Sk, KV, 128] bf16; out [B, Sq, H, 128]
// bf16, o32 the same in float32 (or null), lse [B, Sq, H] float32.
extern "C" int flash_attention_forward(const void* q, const void* k,
                                       const void* v, void* out, void* o32,
                                       void* lse, int B, int Sq, int Sk,
                                       int H, int KV, int window, float scale,
                                       int terms, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, window, terms)) return cudaErrorInvalidValue;
  if (cudaError_t err = smem_ready()) return (int)err;
  const Shape s = make_shape(B, Sq, Sk, H, KV, window, scale, terms);
  dim3 grid((Sq * s.G + kFwdRows - 1) / kFwdRows, KV, B);
  fwd_kernel<<<grid, kThreads, kFwdSmem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)o32, (float*)lse, s);
  return (int)cudaGetLastError();
}

// The gradients of flash_attention_forward: dq [B, Sq, H, 128], dk and dv
// [B, Sk, KV, 128] bf16 (and in float32 where dq32, dk32, dv32 are not
// null), from the forward's float32 O and lse and the bf16 dout; delta
// [B, Sq, H] float32 is scratch (D). Two launches: the dQ pass, which also
// writes D, then the dK/dV pass.
extern "C" int flash_attention_backward(
    const void* q, const void* k, const void* v, const void* o32,
    const void* lse, const void* dout, void* delta, void* dq, void* dk,
    void* dv, void* dq32, void* dk32, void* dv32, int B, int Sq, int Sk,
    int H, int KV, int window, float scale, int terms, void* stream) {
  if (bad_shape(B, Sq, Sk, H, KV, window, terms)) return cudaErrorInvalidValue;
  if (cudaError_t err = smem_ready()) return (int)err;
  const Shape s = make_shape(B, Sq, Sk, H, KV, window, scale, terms);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 gq((Sq * s.G + kDqRows - 1) / kDqRows, KV, B);
  dq_kernel<<<gq, kThreads, kDqSmem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)o32,
      (const float*)lse, (const bf16*)dout, (float*)delta, (bf16*)dq,
      (float*)dq32, s);
  int err = (int)cudaGetLastError();
  if (err) return err;
  dim3 gk((Sk + kBwdKeys - 1) / kBwdKeys, KV, B);
  dkv_kernel<<<gk, kThreads, kBwdSmem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)lse,
      (const float*)delta, (const bf16*)dout, (bf16*)dk, (bf16*)dv,
      (float*)dk32, (float*)dv32, s);
  return (int)cudaGetLastError();
}
