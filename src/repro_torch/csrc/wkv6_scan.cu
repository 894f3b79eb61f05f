// The RWKV-6 "Finch" recurrence on Hopper, per (batch row, head):
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),
//   S_t = diag(w_t) S_{t-1} + k_t v_t^T,          S_{-1} = S0,
// over r, k, v, w: [B, S, H, Dh], u: [H, Dh], S: [B, H, Dh, Dh] (row index
// k, column index v); and its gradient.
//
// Replaces no Pallas kernel: the reference runs this recurrence with
// `jax.lax.scan` (`_rwkv_inner`, src/repro/models/recurrent.py:151), which
// XLA lowers to one loop on the device. Without a kernel the port ran it as
// a Python loop over time, some eight launches a token a layer, with three
// [B, H, Dh, Dh] tensors a step kept for the backward pass.
//
// What bounds it on this card: the issue of instructions. A step is 5
// Dh^2 flops a (b, h) (the backward 14) on a state of Dh^2 floats; the
// inputs are read once and y written once (on rwkv6-3b's layer bytes
// bound the forward at 0.033 ms, the issue of its ~5 instructions an
// element a step on the card's 528 schedulers at 0.05 ms). The
// state's elements are independent of each other from step to step, so
// the work spreads over threads freely, but every step ends in sums
// across them (y's over the state's rows; the gradients' over rows and
// columns), and the state must stay on chip: rwkv6-3b's 160 (b, h)
// states at Dh 64 are 10.5 MB, a step's inputs 160 KB. The design:
//   * every state in registers, 16 elements a thread, split over blocks
//     of 2 warps, one a 16-column (forward) or 16-row (backward) slab of
//     a state: 640 blocks at B 4, H 40, Dh 64, all resident at once (5
//     forward or 6 backward blocks an SM);
//   * a chunk of kChunk steps of inputs staged in shared memory by the
//     Tensor Memory Accelerator (tma.cuh: one tensor copy a chunk and
//     array, asked for by one thread and counted on an mbarrier), so that
//     no thread spends instructions on the copies (the threads' own
//     `cp.async`s took a third of the forward's time) and a barrier covers
//     a chunk, not a step;
//   * the sums across threads by shuffles within a warp, in a fixed order
//     (lane_sum), and across the two warps and the slabs through shared
//     memory.
// The chunk is kChunk = 16 steps: it sets the forward's checkpoints (84
// MB at rwkv6-3b's layer, written once and read once) and the backward's
// staging; a longer one would need more shared memory than six blocks an
// SM leave.
//
// Numerics: the state update `__fadd_rn(__fmul_rn(w, s), __fmul_rn(k, v))`
// repeats the plain loop's roundings element for element, so the final S
// equals the plain loop's bit for bit; sums (y, the gradients) run in a
// fixed order of their own, so two launches give equal outputs. No
// atomics.
//
// Forward: a block per (b, h) and 16-column slab q (Dh / 16 blocks a
// (b, h)); thread (row group g, column group) owns rows [g Dh / 16,
// (g + 1) Dh / 16) x 4 columns of the slab. Each step
//   y_t[j] = sum_i r_i S[i][j]  +  v_j (sum_i r_i u_i k_i),
// the bonus term taken apart: a thread sums its rows, shuffles add the
// warp's 8 row groups, and after the chunk's steps (unrolled, so that one
// step's loads and products overlap the step before's shuffles) the two
// warps' sums are added from shared memory, where half a warp also sums
// r u k for a step. Chunks are fetched kStages - 1 ahead. Where a
// gradient is needed the forward also writes S_{t-1} at every chunk start
// (t = 0, kChunk, ...) to `ckpt`: [B, H, ceil(S / kChunk), Dh, Dh].
//
// Backward, with G_t = dL/dS_t (G_{S-1} = dS_out):
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//   dk_t = G_t v_t + u . r_t (v_t . dy_t)
//   dv_t = G_t^T k_t + dy_t sum(r_t . u . k_t)
//   dw_t = rowsum(G_t . S_{t-1})
//   du  += r_t . k_t (v_t . dy_t)        (a (b, h) partial, summed outside)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  dS0 = G_{-1}.
// A thread block cluster of Dh / 16 blocks per (b, h); block q owns rows
// [16 q, 16 q + 16) and every column; thread (row pair, column group)
// owns two rows x Dh / 8 columns. dr, dk and dw are row sums: shuffles
// add a warp's 4 column groups, and at each kSub-step end the two warps'
// sums are added from shared memory. dv is a column sum: a thread adds
// its two rows, shuffles the warp's 8 row pairs (a reduce-scatter: one
// column a lane), each block adds its rows' dy sum(r u k) and leaves its
// partial in shared memory, and after the chunk the cluster's blocks add
// the partials of their 16 columns in rank order through distributed
// shared memory (the cluster barrier's wait deferred into the next chunk,
// so it costs no stall). The chunks are walked in reverse; each chunk's
// states are recomputed from its checkpoint with the forward's roundings
// and never leave the SM: a pass forward over the chunk keeps the state
// at every kSub-th step in shared memory, and each kSub-step piece is
// recomputed from there into a ring of kSub states in registers and
// walked back. No scratch in device memory.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 16;     // steps between checkpoints; a chunk staged
constexpr int kSub = 4;        // steps of the backward's register ring
constexpr int kThreads = 64;   // 2 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kSlab = 16;      // columns (forward) or rows (backward) a block
constexpr int kStages = 3;     // chunks of inputs staged by the forward
constexpr int kFwdBlocks = 5;  // blocks an SM holds at once: forward
constexpr int kBwdBlocks = 6;  //   and backward (640 at B 4, H 40, Dh 64)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// N consecutive floats at p (aligned to min(N, 4) floats) into x, and back.
template <int N>
__device__ __forceinline__ void load_n(float* x, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + c);
      x[c] = t.x, x[c + 1] = t.y, x[c + 2] = t.z, x[c + 3] = t.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 2) {
      const float2 t = *reinterpret_cast<const float2*>(p + c);
      x[c] = t.x, x[c + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) x[c] = p[c];
  }
}

template <int N>
__device__ __forceinline__ void store_n(float* p, const float* x) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N; c += 4)
      *reinterpret_cast<float4*>(p + c) =
          make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  } else {
#pragma unroll
    for (int c = 0; c < N; c += 2)
      *reinterpret_cast<float2*>(p + c) = make_float2(x[c], x[c + 1]);
  }
}

// A thread's N floats in shared memory, laid out [N / 4][kThreads] in
// float4s, so that a warp's accesses are contiguous.
template <int N>
struct alignas(16) Own {
  static_assert(N % 4 == 0, "whole float4s");
  float4 data[N / 4][kThreads];
  __device__ __forceinline__ void put(int tid, const float* x) {
#pragma unroll
    for (int p = 0; p < N / 4; ++p)
      data[p][tid] = make_float4(x[4 * p], x[4 * p + 1], x[4 * p + 2],
                                 x[4 * p + 3]);
  }
  __device__ __forceinline__ void get(int tid, float* x) const {
#pragma unroll
    for (int p = 0; p < N / 4; ++p) {
      const float4 t = data[p][tid];
      x[4 * p] = t.x, x[4 * p + 1] = t.y, x[4 * p + 2] = t.z,
            x[4 * p + 3] = t.w;
    }
  }
};

// The sum of x[0..N) over the lanes that differ in lane bits [BIT, END):
// at each bit, while the count left is even, the lane keeps the upper half
// of its values if its bit is set, the lower half if not, and adds its
// partner's copy of them; once the count is odd, the remaining bits add
// every value left. Leaves the sums in x[0..) and returns the index of
// x[0] in [0, N). Each value is summed over the lanes as a pairwise tree
// in lane order.
template <int N, int BIT, int END>
__device__ __forceinline__ int lane_sum(float* x, int lane) {
  if constexpr (BIT >= END) {
    return 0;
  } else {
    constexpr int mask = 1 << BIT;
    if constexpr (N % 2 == 0) {
      constexpr int H = N / 2;
      const bool hi = (lane & mask) != 0;
#pragma unroll
      for (int c = 0; c < H; ++c) {
        const float send = hi ? x[c] : x[c + H];
        const float keep = hi ? x[c + H] : x[c];
        x[c] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
      }
      return (hi ? H : 0) + lane_sum<H, BIT + 1, END>(x, lane);
    } else {
#pragma unroll
      for (int c = 0; c < N; ++c)
        x[c] += __shfl_xor_sync(0xffffffffu, x[c], mask);
      return lane_sum<N, BIT + 1, END>(x, lane);
    }
  }
}

// log2 of a power of two
__host__ __device__ constexpr int log2i(int n) {
  return n <= 1 ? 0 : 1 + log2i(n / 2);
}

// Forward: thread (row group rg, column group cg) of the slab owns rows
// [rg R, rg R + R) (R = Dh / 16) x columns [4 cg, 4 cg + 4): 16 row groups
// x 4 column groups; a warp holds 8 row groups, lane = (rg % 8) 4 + cg.
template <int D>
__global__ void __launch_bounds__(kThreads, kFwdBlocks)
wkv6_forward(const __grid_constant__ CUtensorMap map_r,
             const __grid_constant__ CUtensorMap map_k,
             const __grid_constant__ CUtensorMap map_w,
             const __grid_constant__ CUtensorMap map_v,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ s_out,
             float* __restrict__ ckpt, int h, int s, int save) {
  constexpr int P = D / kSlab;       // blocks of a (b, h)
  constexpr int R = D / 16;          // rows a thread
  constexpr int C = 4;               // columns a thread
  constexpr int kBytes = kChunk * (3 * D + kSlab) * 4;   // a chunk's boxes
  __shared__ __align__(128) float sr[kStages][kChunk][D],
      sk[kStages][kChunk][D], sw[kStages][kChunk][D],
      sv[kStages][kChunk][kSlab];
  __shared__ float yp[kChunk][kWarps][kSlab], su[D];
  __shared__ __align__(8) unsigned long long bar[kStages];
  const int q = blockIdx.x % P;
  const int bh = blockIdx.x / P;
  const int head = bh % h;
  const long long b = bh / h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cj = (lane & 3) * C;               // the first column in the slab
  const int row0 = (warp * 8 + (lane >> 2)) * R;
  if (tid < D) su[tid] = u[head * D + tid];
  if (tid == 0)
    for (int i = 0; i < kStages; ++i) tma::bar_init(&bar[i], 1);
  tma::bar_init_fence();
  __syncthreads();
  const long long step = (long long)h * D;                 // t to t + 1
  const long long base = (b * s * h + head) * (long long)D;  // t = 0
  const int nc = (s + kChunk - 1) / kChunk;
  // S[row0 + m][16 q + cj + e] of S0, then of each step
  const long long mine = (long long)bh * D * D + (long long)row0 * D +
                         q * kSlab + cj;
  float st[R][C];
#pragma unroll
  for (int m = 0; m < R; ++m) load_n<C>(st[m], s0 + mine + m * D);

  // chunk c's boxes (steps [16 c, 16 c + 16) of (b, head)) into buffer
  // c % kStages, by thread 0
  auto stage = [&](int c) {
    if (tid != 0 || c >= nc) return;
    const int buf = c % kStages, row = (int)(b * s) + c * kChunk;
    tma::fence_before_copy();
    tma::bar_expect(&bar[buf], kBytes);
    tma::copy_3d(&sr[buf][0][0], &map_r, 0, head, row, &bar[buf]);
    tma::copy_3d(&sk[buf][0][0], &map_k, 0, head, row, &bar[buf]);
    tma::copy_3d(&sw[buf][0][0], &map_w, 0, head, row, &bar[buf]);
    tma::copy_3d(&sv[buf][0][0], &map_v, q * kSlab, head, row, &bar[buf]);
  };

  for (int c = 0; c < kStages - 1; ++c) stage(c);
  for (int c = 0; c < nc; ++c) {
    const int buf = c % kStages, t0 = c * kChunk, len = min(kChunk, s - t0);
    tma::bar_wait(&bar[buf], (c / kStages) & 1);   // chunk c has landed
    __syncthreads();      // chunk c - 1's reads are done
    stage(c + kStages - 1);         // into the buffer chunk c - 1 used
    if (save) {
      float* cp = ckpt + (long long)bh * (nc - 1) * D * D +
                  (long long)c * D * D + mine;
#pragma unroll
      for (int m = 0; m < R; ++m) store_n<C>(cp + m * D, st[m]);
    }
    // a whole chunk's steps unrolled, so that one step's loads and
    // products overlap the step before's shuffles
    auto one_step = [&](int tt) {
      float rr[R], kk[R], ww[R], vv[C], acc[C];
      load_n<R>(rr, &sr[buf][tt][row0]);
      load_n<R>(kk, &sk[buf][tt][row0]);
      load_n<R>(ww, &sw[buf][tt][row0]);
      load_n<C>(vv, &sv[buf][tt][cj]);
#pragma unroll
      for (int e = 0; e < C; ++e) acc[e] = 0.0f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
#pragma unroll
        for (int e = 0; e < C; ++e) {
          acc[e] = fmaf(rr[m], st[m][e], acc[e]);
          st[m][e] =
              __fadd_rn(__fmul_rn(ww[m], st[m][e]), __fmul_rn(kk[m], vv[e]));
        }
      }
      // over the warp's 8 row groups (lane bits 2-4): one column a lane
      const int j = cj + lane_sum<C, 2, 5>(acc, lane);
      if ((lane >> (2 + log2i(C))) == 0) yp[tt][warp][j] = acc[0];
    };
    if (len == kChunk) {
#pragma unroll
      for (int tt = 0; tt < kChunk; ++tt) one_step(tt);
    } else {
      for (int tt = 0; tt < len; ++tt) one_step(tt);
    }
    __syncthreads();      // yp holds the chunk's warp sums
    // y: half a warp a step; lane j sums r u k over rows j Dh/16 ...
    const unsigned half = 0xffffu << (lane & 16);
    const int j = lane & 15;
    for (int tt = tid >> 4; tt < len; tt += kThreads / 16) {
      float ruk = 0.0f;
#pragma unroll
      for (int m = 0; m < D / 16; ++m) {
        const int i = j * (D / 16) + m;
        ruk = fmaf(sr[buf][tt][i] * su[i], sk[buf][tt][i], ruk);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) ruk += __shfl_xor_sync(half, ruk, o);
      y[base + (long long)(t0 + tt) * step + q * kSlab + j] =
          fmaf(sv[buf][tt][j], ruk, yp[tt][0][j] + yp[tt][1][j]);
    }
  }
#pragma unroll
  for (int m = 0; m < R; ++m) store_n<C>(s_out + mine + m * D, st[m]);
}

// Backward: thread (row pair rp, column group cg) of the block owns rows
// 2 rp, 2 rp + 1 of the slab x columns [cg Dh / 8, (cg + 1) Dh / 8): 8 row
// pairs x 8 column groups; warp w holds column groups 4 w .. 4 w + 3, lane
// = rp 4 + cg % 4.
template <int D>
__global__ void __launch_bounds__(kThreads, kBwdBlocks)
wkv6_backward(const __grid_constant__ CUtensorMap map_r,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_w,
              const __grid_constant__ CUtensorMap map_v,
              const __grid_constant__ CUtensorMap map_dy,
              const float* __restrict__ u, const float* __restrict__ ckpt,
              const float* __restrict__ ds_out,
              float* __restrict__ dr, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ dw,
              float* __restrict__ du_part, float* __restrict__ ds0, int h,
              int s) {
  constexpr int P = D / kSlab;       // blocks of a (b, h): the cluster
  constexpr int C = D / 8;           // columns a thread
  constexpr int kBytes = kChunk * (3 * kSlab + 2 * D) * 4;   // the boxes
  constexpr int kPieces = kChunk / kSub;
  __shared__ Own<2 * C> sub[kPieces - 1];   // S at piece starts 1, 2, 3
  __shared__ __align__(128) float sr[kChunk][kSlab], sk[kChunk][kSlab],
      sw[kChunk][kSlab], sv[kChunk][D], sdy[kChunk][D];
  __shared__ __align__(8) unsigned long long bar;
  __shared__ float su[kSlab], svd[kChunk], sruk[kChunk];
  __shared__ float rowp[2][kSub][kWarps][3][kSlab];
  __shared__ float dvp[2][kChunk][D];
  __shared__ float sdu[kSub][kSlab];
  cg::cluster_group cluster = cg::this_cluster();
  const int q = (int)cluster.block_rank();
  const int bh = blockIdx.x / P;
  const int head = bh % h;
  const long long b = bh / h;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = 2 * (lane >> 2);             // the pair's first slab row
  const int col0 = (warp * 4 + (lane & 3)) * C;
  const long long mine =
      ((long long)bh * D + q * kSlab + row) * D + col0;   // row, col0 of S
  if (tid < kSlab) su[tid] = u[head * D + q * kSlab + tid];
  if (tid == 0) tma::bar_init(&bar, 1);
  tma::bar_init_fence();
  __syncthreads();
  const long long step = (long long)h * D;
  const long long base = (b * s * h + head) * (long long)D;
  const int nc = (s + kChunk - 1) / kChunk;
  float g[2][C];
  load_n<C>(g[0], ds_out + mine);
  load_n<C>(g[1], ds_out + mine + D);
  float du = 0.0f;    // row tid & 15 of the slab at piece steps tid >> 4

  // chunk c's boxes (steps [16 c, 16 c + 16) of (b, head)), by thread 0
  auto stage = [&](int c) {
    if (tid != 0) return;
    const int row = (int)(b * s) + c * kChunk;
    tma::fence_before_copy();
    tma::bar_expect(&bar, kBytes);
    tma::copy_3d(&sr[0][0], &map_r, q * kSlab, head, row, &bar);
    tma::copy_3d(&sk[0][0], &map_k, q * kSlab, head, row, &bar);
    tma::copy_3d(&sw[0][0], &map_w, q * kSlab, head, row, &bar);
    tma::copy_3d(&sv[0][0], &map_v, 0, head, row, &bar);
    tma::copy_3d(&sdy[0][0], &map_dy, 0, head, row, &bar);
  };
  // dv of chunk c: the cluster's partials of this block's 16 columns, in
  // rank order
  auto reduce_dv = [&](int c) {
    const int t0 = c * kChunk, len = min(kChunk, s - t0);
    const float* part[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      part[p] = cluster.map_shared_rank(&dvp[c & 1][0][0], p);
    for (int o = tid; o < len * kSlab; o += kThreads) {
      const int tt = o >> 4, jj = q * kSlab + (o & 15);
      float acc = part[0][tt * D + jj];
#pragma unroll
      for (int p = 1; p < P; ++p) acc += part[p][tt * D + jj];
      dv[base + (long long)(t0 + tt) * step + jj] = acc;
    }
  };
  // S <- diag(w_t) S + k_t v_t^T on the thread's two rows, as the forward
  auto advance = [&](float (&st)[2][C], int tt) {
    float vv[C];
    load_n<C>(vv, &sv[tt][col0]);
    const float2 kk = *reinterpret_cast<const float2*>(&sk[tt][row]);
    const float2 ww = *reinterpret_cast<const float2*>(&sw[tt][row]);
#pragma unroll
    for (int e = 0; e < C; ++e) {
      st[0][e] = __fadd_rn(__fmul_rn(ww.x, st[0][e]), __fmul_rn(kk.x, vv[e]));
      st[1][e] = __fadd_rn(__fmul_rn(ww.y, st[1][e]), __fmul_rn(kk.y, vv[e]));
    }
  };

  stage(nc - 1);
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, s - t0);
    const int pieces = (len + kSub - 1) / kSub;
    tma::bar_wait(&bar, (nc - 1 - c) & 1);     // chunk c has landed
    {   // per step: v . dy over every column, r u k over the slab's rows
      const int tt = tid >> 2, p = tid & 3;
      float vd = 0.0f, rk = 0.0f;
      if (tt < len) {
#pragma unroll
        for (int m = 0; m < D / 4; ++m)
          vd = fmaf(sv[tt][p * (D / 4) + m], sdy[tt][p * (D / 4) + m], vd);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          rk = fmaf(sr[tt][4 * p + m] * su[4 * p + m], sk[tt][4 * p + m], rk);
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        vd += __shfl_xor_sync(0xffffffffu, vd, o);
        rk += __shfl_xor_sync(0xffffffffu, rk, o);
      }
      if (p == 0 && tt < len) svd[tt] = vd, sruk[tt] = rk;
    }
    __syncthreads();
    // pass A: the states at the pieces' starts, from the checkpoint
    const float* cpk = ckpt + (long long)bh * (nc - 1) * D * D +
                       (long long)c * D * D + mine;
    {
      float st[2][C];
      load_n<C>(st[0], cpk);
      load_n<C>(st[1], cpk + D);
      for (int tt = 0; tt < (pieces - 1) * kSub; ++tt) {
        advance(st, tt);
        if ((tt + 1) % kSub == 0) sub[(tt + 1) / kSub - 1].put(tid, &st[0][0]);
      }
    }
    if (c + 1 < nc) {     // the chunk after this one: its dv
      cluster_wait();
      reduce_dv(c + 1);
    }
    // pass B: the pieces in reverse, each through a ring of kSub states
    for (int m = pieces - 1; m >= 0; --m) {
      const int p0 = m * kSub, plen = min(kSub, len - p0);
      float ring[kSub][2][C];
      if (m == 0) {
        load_n<C>(ring[0][0], cpk);
        load_n<C>(ring[0][1], cpk + D);
      } else {
        sub[m - 1].get(tid, &ring[0][0][0]);
      }
#pragma unroll
      for (int x = 1; x < kSub; ++x) {
        if (x < plen) {
#pragma unroll
          for (int e = 0; e < C; ++e)
            ring[x][0][e] = ring[x - 1][0][e], ring[x][1][e] = ring[x - 1][1][e];
          advance(ring[x], p0 + x - 1);
        }
      }
#pragma unroll
      for (int x = kSub - 1; x >= 0; --x) {
        if (x < plen) {
          const int tt = p0 + x;
          float dyc[C], vc[C], cs[C];
          load_n<C>(dyc, &sdy[tt][col0]);
          load_n<C>(vc, &sv[tt][col0]);
          const float2 rr = *reinterpret_cast<const float2*>(&sr[tt][row]);
          const float2 kk = *reinterpret_cast<const float2*>(&sk[tt][row]);
          const float2 ww = *reinterpret_cast<const float2*>(&sw[tt][row]);
          // the two rows' partial sums: dr, dk, dw of row 0, then row 1
          float rs[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int e = 0; e < C; ++e) {
            rs[0] = fmaf(ring[x][0][e], dyc[e], rs[0]);
            rs[1] = fmaf(g[0][e], vc[e], rs[1]);
            rs[2] = fmaf(g[0][e], ring[x][0][e], rs[2]);
            rs[3] = fmaf(ring[x][1][e], dyc[e], rs[3]);
            rs[4] = fmaf(g[1][e], vc[e], rs[4]);
            rs[5] = fmaf(g[1][e], ring[x][1][e], rs[5]);
            cs[e] = fmaf(g[1][e], kk.y, g[0][e] * kk.x);
            g[0][e] = fmaf(ww.x, g[0][e], rr.x * dyc[e]);
            g[1][e] = fmaf(ww.y, g[1][e], rr.y * dyc[e]);
          }
          // rows: over the warp's 4 column groups (lane bits 0-1); the
          // lanes with bit 1 clear hold row row + (bit 0)
          const int rsel = lane_sum<6, 0, 2>(rs, lane) / 3;
          if ((lane & 2) == 0) {
            rowp[m & 1][x][warp][0][row + rsel] = rs[0];
            rowp[m & 1][x][warp][1][row + rsel] = rs[1];
            rowp[m & 1][x][warp][2][row + rsel] = rs[2];
          }
          // columns: over the 8 row pairs (lane bits 2-4)
          const int jj = col0 + lane_sum<C, 2, 5>(cs, lane);
          if ((lane >> (2 + log2i(C))) == 0)
            dvp[c & 1][tt][jj] = fmaf(sdy[tt][jj], sruk[tt], cs[0]);
        }
      }
      __syncthreads();    // rowp[m & 1] holds the piece's warp sums
      {   // the piece's row sums: thread (x, rw)
        const int x = tid >> 4, rw = tid & 15;
        if (x < plen) {
          const int tt = p0 + x;
          const long long o =
              base + (long long)(t0 + tt) * step + q * kSlab + rw;
          const float(&pw)[kWarps][3][kSlab] = rowp[m & 1][x];
          const float rr = sr[tt][rw], kk = sk[tt][rw], uu = su[rw];
          const float vd = svd[tt];
          dr[o] = fmaf(uu * kk, vd, pw[0][0][rw] + pw[1][0][rw]);
          dk[o] = fmaf(uu * rr, vd, pw[0][1][rw] + pw[1][1][rw]);
          dw[o] = pw[0][2][rw] + pw[1][2][rw];
          du = fmaf(rr * kk, vd, du);
        }
      }
    }
    __syncthreads();      // the chunk's staged inputs are read
    if (c > 0) stage(c - 1);
    cluster_arrive();     // dvp[c & 1] is written
  }
  cluster_wait();
  reduce_dv(0);
  cluster_arrive();       // no block leaves while another reads its dvp
  cluster_wait();
  sdu[tid >> 4][tid & 15] = du;
  __syncthreads();
  if (tid < kSlab)
    du_part[(long long)bh * D + q * kSlab + tid] =
        ((sdu[0][tid] + sdu[1][tid]) + sdu[2][tid]) + sdu[3][tid];
  store_n<C>(ds0 + mine, g[0]);
  store_n<C>(ds0 + mine + D, g[1]);
}

// Shared memory before L1 on every kernel: kFwdBlocks forward blocks an
// SM need 216 KB of it, kBwdBlocks backward blocks 204 KB. Once a kernel
// and device.
template <typename K>
cudaError_t prefer_shared(K kernel, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <int D>
bool forward_configured[64] = {};
template <int D>
bool backward_configured[64] = {};

// [B, S, H, Dh] float32 read in boxes of `cols` consecutive elements of a
// head's row at kChunk consecutive steps
bool head_map(CUtensorMap* map, const void* base, int b, int s, int h,
              int d, int cols) {
  const cuuint64_t dim[3] = {(cuuint64_t)d, (cuuint64_t)h,
                             (cuuint64_t)b * s};
  const cuuint64_t stride[2] = {(cuuint64_t)d * 4, (cuuint64_t)h * d * 4};
  const cuuint32_t box[3] = {(cuuint32_t)cols, 1, kChunk};
  return tma::map_f32(map, base, 3, dim, stride, box);
}

template <int D>
int launch_forward(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* s0, float* y,
                   float* s_out, float* ckpt, int b, int h, int s, int save,
                   cudaStream_t stream) {
  const cudaError_t err = prefer_shared(wkv6_forward<D>,
                                        forward_configured<D>);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mr, mk, mw, mv;
  if (!(head_map(&mr, r, b, s, h, D, D) && head_map(&mk, k, b, s, h, D, D) &&
        head_map(&mw, w, b, s, h, D, D) &&
        head_map(&mv, v, b, s, h, D, kSlab)))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(b * h * (D / kSlab));
  wkv6_forward<D><<<grid, kThreads, 0, stream>>>(mr, mk, mw, mv, u, s0, y,
                                                 s_out, ckpt, h, s, save);
  return (int)cudaGetLastError();
}

template <int D>
void backward_config(cudaLaunchConfig_t& config, cudaLaunchAttribute* attr,
                     int b, int h, cudaStream_t stream) {
  config = {};
  config.gridDim = dim3((unsigned)(b * h * (D / kSlab)));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = D / kSlab;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
}

template <int D>
int launch_backward(const float* r, const float* k, const float* v,
                    const float* w, const float* u, const float* ckpt,
                    const float* dy, const float* ds_out, float* dr,
                    float* dk, float* dv, float* dw, float* du_part,
                    float* ds0, int b, int h, int s, cudaStream_t stream) {
  cudaError_t err = prefer_shared(wkv6_backward<D>, backward_configured<D>);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap mr, mk, mw, mv, md;
  if (!(head_map(&mr, r, b, s, h, D, kSlab) &&
        head_map(&mk, k, b, s, h, D, kSlab) &&
        head_map(&mw, w, b, s, h, D, kSlab) &&
        head_map(&mv, v, b, s, h, D, D) && head_map(&md, dy, b, s, h, D, D)))
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr[1];
  backward_config<D>(config, attr, b, h, stream);
  err = cudaLaunchKernelEx(&config, wkv6_backward<D>, mr, mk, mw, mv, md, u,
                           ckpt, ds_out, dr, dk, dv, dw, du_part, ds0, h, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D>
int residency(int b, int h, int* out) {
  cudaError_t err = prefer_shared(wkv6_forward<D>, forward_configured<D>);
  if (err == cudaSuccess)
    err = prefer_shared(wkv6_backward<D>, backward_configured<D>);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], wkv6_forward<D>, kThreads, 0);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[1], wkv6_backward<D>, kThreads, 0);
  if (err == cudaSuccess) {
    cudaLaunchConfig_t config;
    cudaLaunchAttribute attr[1];
    backward_config<D>(config, attr, b, h, nullptr);
    err = cudaOccupancyMaxActiveClusters(&out[2], wkv6_backward<D>, &config);
  }
  return (int)err;
}

}  // namespace

// r, k, v, w, y: [B, S, H, Dh], 16-byte aligned; u: [H, Dh]; s0, s_out:
// [B, H, Dh, Dh]; ckpt: [B, H, ceil(S / chunk), Dh, Dh] with chunk 16, or
// null with chunk 0 (no gradient). Dh is 16, 32 or 64; any other Dh or
// chunk, or an input the copy engine cannot read, returns
// cudaErrorInvalidValue.
extern "C" int wkv6_scan_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* y, void* s_out, void* ckpt, int b, int h,
                             int s, int d, int chunk, void* stream) {
  if (chunk != 0 && chunk != kChunk) return (int)cudaErrorInvalidValue;
#define WKV6_FWD(D)                                                         \
  launch_forward<D>((const float*)r, (const float*)k, (const float*)v,      \
                    (const float*)w, (const float*)u, (const float*)s0,     \
                    (float*)y, (float*)s_out, (float*)ckpt, b, h, s,        \
                    chunk != 0, (cudaStream_t)stream)
  if (d == 16) return WKV6_FWD(16);
  if (d == 32) return WKV6_FWD(32);
  if (d == 64) return WKV6_FWD(64);
#undef WKV6_FWD
  return (int)cudaErrorInvalidValue;
}

// dy, dr, dk, dv, dw: [B, S, H, Dh] (r, k, v, w, dy 16-byte aligned);
// ds_out, ds0: [B, H, Dh, Dh]; du_part: [B, H, Dh]; ckpt as the forward
// wrote it, chunk 16.
extern "C" int wkv6_scan_backward_f32(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* ckpt, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* ds0, int b,
    int h, int s, int d, int chunk, void* stream) {
  if (chunk != kChunk) return (int)cudaErrorInvalidValue;
#define WKV6_BWD(D)                                                         \
  launch_backward<D>((const float*)r, (const float*)k, (const float*)v,     \
                     (const float*)w, (const float*)u, (const float*)ckpt,  \
                     (const float*)dy, (const float*)ds_out, (float*)dr,    \
                     (float*)dk, (float*)dv, (float*)dw, (float*)du_part,   \
                     (float*)ds0, b, h, s, (cudaStream_t)stream)
  if (d == 16) return WKV6_BWD(16);
  if (d == 32) return WKV6_BWD(32);
  if (d == 64) return WKV6_BWD(64);
#undef WKV6_BWD
  return (int)cudaErrorInvalidValue;
}

// What the card makes of the launches at Dh d for B b, H h: out[0] forward
// blocks an SM, out[1] backward blocks an SM, out[2] backward clusters
// that can run at once.
extern "C" int wkv6_scan_residency(int b, int h, int d, int* out) {
  if (d == 16) return residency<16>(b, h, out);
  if (d == 32) return residency<32>(b, h, out);
  if (d == 64) return residency<64>(b, h, out);
  return (int)cudaErrorInvalidValue;
}
