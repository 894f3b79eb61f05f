// The RG-LRU recurrence of RecurrentGemma on Hopper:
//   h_t = a_t * h_{t-1} + g_t,   h_{-1} = h0,
// over a [B, S, W] sequence, and its gradient.
//
// Replaces no Pallas kernel: the reference evaluates this recurrence with
// `jax.lax.associative_scan` (src/repro/models/recurrent.py:91, in
// `rglru_mixer`), which XLA lowers to one program over time. Without a
// kernel the port ran it as a Python loop over time, a few launches a
// token a layer, with every step's tensors kept for the backward pass.
//
// What bounds it on this card: bytes. The recurrence is one multiply and
// one add per element; the forward reads a and g and writes h (12 bytes an
// element), the backward reads a, h and dy and writes da and dg. The walk
// over t is a chain of dependent multiply-adds, about 8 cycles a step:
// 4,096 steps are some 20 us, well under the bytes' time, so what the
// kernel has to supply is bytes in flight, not arithmetic.
//
// The design: one thread per (b, w) channel walks t in order and keeps h
// in a register, so every h is computed as the plain loop computes it. A
// block is one warp of 32 neighbouring channels (at recurrentgemma-9b's
// prefill of one sequence, W 4,096: 128 blocks, about one on each of the
// 132 SMs). Its inputs stream through a ring of kStages tiles of kT steps
// x 32 channels in shared memory, filled kStages - 1 tiles ahead of the
// walk: 36 KB in flight on each SM in the forward (a, g: 9 tiles ahead,
// a 40 KB ring), 36 KB in the backward (a, dy, h: 6 tiles ahead, a 42 KB
// ring). Lane 0 asks the Tensor Memory Accelerator for each tile of each
// array with one tensor copy (tma.cuh), counted in bytes on the slot's
// mbarrier; so no lane spends instructions or load slots on the copies.
// The copy engine wants W a multiple of 4 and 16-byte aligned bases: the
// wrapper pads W up to a multiple of 4 (kernels/recurrence/ops.py), and
// the entry points refuse arrays that cannot be mapped. Every step's h
// (da, dg) goes out as one 128-byte row of the warp.
//
// Numerics: `__fmul_rn` then `__fadd_rn`, never contracted into an FMA, so
// every h equals the plain loop's `a[:, t] * h + g[:, t]` (two roundings)
// bit for bit. The backward pass walks the tiles, and t within each, in
// reverse:
//   dh_t = dy_t + a_{t+1} * dh_{t+1},  da_t = dh_t * h_{t-1},  dg_t = dh_t,
//   dh0 = a_0 * dh_0,
// reading the forward's saved output h through the same ring, shifted by
// one step (row r of a tile holds h_{t-1}; h_{-1} is h0, in a register).
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kLanes = 32;        // channels of a block: one warp
constexpr int kT = 16;            // steps of a tile
constexpr int kFwdStages = 10;    // tiles in the forward's ring: 40 KB
constexpr int kBwdStages = 7;     // tiles in the backward's ring: 42 KB

// The block's ring: kStages slots of up to three [kT, 32] tiles and a
// barrier each. Slot n % kStages takes tile n; its barrier completes a
// phase each time a tile has landed.
template <int kStages, int kArrays>
struct Ring {
  alignas(128) float tile[kStages][kArrays][kT][kLanes];
  alignas(8) unsigned long long bar[kStages];
};

template <int kStages, int kArrays>
__device__ __forceinline__ void ring_init(Ring<kStages, kArrays>& ring,
                                          int lane) {
  if (lane == 0)
    for (int i = 0; i < kStages; ++i) tma::bar_init(&ring.bar[i], 1);
  tma::bar_init_fence();
  __syncwarp();
}

// Tile rows [row0, row0 + kT) of the [B S, W] arrays at column c0 into
// `slot` (rows before 0 or past the arrays land as zeros).
template <int kStages, int kArrays>
__device__ __forceinline__ void ring_fill(
    Ring<kStages, kArrays>& ring, int slot,
    const CUtensorMap* const (&map)[kArrays], const int (&row0)[kArrays],
    int c0, int lane) {
  unsigned long long* bar = &ring.bar[slot];
  // the lanes' reads of the slot's last tile before the copy's writes
  tma::fence_before_copy();
  __syncwarp();
  if (lane == 0) {
    tma::bar_expect(bar, kArrays * kT * kLanes * 4);   // whole boxes
#pragma unroll
    for (int x = 0; x < kArrays; ++x)
      tma::copy_2d(&ring.tile[slot][x][0][0], map[x], c0, row0[x], bar);
  }
}

__global__ void __launch_bounds__(kLanes)
rglru_forward(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_g,
              const float* __restrict__ h0, float* __restrict__ h, int s,
              int w) {
  __shared__ Ring<kFwdStages, 2> ring;
  const int lane = threadIdx.x;
  const int nwb = (w + kLanes - 1) / kLanes;
  const int bi = blockIdx.x / nwb;
  const int c0 = (blockIdx.x % nwb) * kLanes;
  const int cols = min(kLanes, w - c0);
  const bool live = lane < cols;
  const int nt = (s + kT - 1) / kT;
  const CUtensorMap* const maps[2] = {&map_a, &map_g};
  ring_init(ring, lane);
  auto fill = [&](int n) {
    if (n >= nt) return;
    const int row = bi * s + n * kT;
    const int row0[2] = {row, row};
    ring_fill(ring, n % kFwdStages, maps, row0, c0, lane);
  };
  for (int n = 0; n < kFwdStages - 1; ++n) fill(n);
  float state = live ? h0[(long long)bi * w + c0 + lane] : 0.0f;
  for (int n = 0; n < nt; ++n) {
    __syncwarp();                         // every lane is done with tile n - 1
    fill(n + kFwdStages - 1);             // into the slot tile n - 1 used
    const int slot = n % kFwdStages, t0 = n * kT;
    tma::bar_wait(&ring.bar[slot], (n / kFwdStages) & 1);
    if (live) {
      float* out = h + ((long long)bi * s + t0) * w + c0 + lane;
      const float(&ta)[kT][kLanes] = ring.tile[slot][0];
      const float(&tg)[kT][kLanes] = ring.tile[slot][1];
#pragma unroll
      for (int r = 0; r < kT; ++r) {
        if (t0 + r < s) {
          state = __fadd_rn(__fmul_rn(ta[r][lane], state), tg[r][lane]);
          out[(long long)r * w] = state;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kLanes)
rglru_backward(const __grid_constant__ CUtensorMap map_a,
               const __grid_constant__ CUtensorMap map_dy,
               const __grid_constant__ CUtensorMap map_h,
               const float* __restrict__ h0, float* __restrict__ da,
               float* __restrict__ dg, float* __restrict__ dh0, int s,
               int w) {
  __shared__ Ring<kBwdStages, 3> ring;
  const int lane = threadIdx.x;
  const int nwb = (w + kLanes - 1) / kLanes;
  const int bi = blockIdx.x / nwb;
  const int c0 = (blockIdx.x % nwb) * kLanes;
  const int cols = min(kLanes, w - c0);
  const bool live = lane < cols;
  const int nt = (s + kT - 1) / kT;
  const CUtensorMap* const maps[3] = {&map_a, &map_dy, &map_h};
  ring_init(ring, lane);
  // the j-th tile filled is tile nt - 1 - j (the tiles in reverse); row r
  // of its h tile holds h_{t-1} (none at t = 0: h0 stands in)
  auto fill = [&](int j) {
    if (j >= nt) return;
    const int row = bi * s + (nt - 1 - j) * kT;
    const int row0[3] = {row, row, row - 1};
    ring_fill(ring, j % kBwdStages, maps, row0, c0, lane);
  };
  for (int j = 0; j < kBwdStages - 1; ++j) fill(j);
  const float first = live ? h0[(long long)bi * w + c0 + lane] : 0.0f;
  float carry = 0.0f;      // a_{t+1} * dh_{t+1}
  for (int j = 0; j < nt; ++j) {
    __syncwarp();
    fill(j + kBwdStages - 1);
    const int slot = j % kBwdStages, t0 = (nt - 1 - j) * kT;
    tma::bar_wait(&ring.bar[slot], (j / kBwdStages) & 1);
    if (live) {
      const float(&ta)[kT][kLanes] = ring.tile[slot][0];
      const float(&td)[kT][kLanes] = ring.tile[slot][1];
      const float(&th)[kT][kLanes] = ring.tile[slot][2];
      const long long at = ((long long)bi * s + t0) * w + c0 + lane;
#pragma unroll
      for (int r = kT - 1; r >= 0; --r) {
        const int t = t0 + r;
        if (t < s) {
          const long long i = at + (long long)r * w;
          const float dh = __fadd_rn(td[r][lane], carry);
          const float prev = t > 0 ? th[r][lane] : first;
          da[i] = __fmul_rn(dh, prev);
          dg[i] = dh;
          carry = __fmul_rn(ta[r][lane], dh);
        }
      }
    }
  }
  if (live) dh0[(long long)bi * w + c0 + lane] = carry;
}

unsigned blocks(int b, int w) {
  return (unsigned)((long long)b * ((w + kLanes - 1) / kLanes));
}

// A [B S, W] float32 array as tiles of kT rows x 32 columns; rows and
// columns outside it read as zeros. False where it cannot be mapped (W
// not a multiple of 4, a base not 16-byte aligned, no driver entry point).
bool tile_map(CUtensorMap* map, const void* base, int rows, int w) {
  const cuuint64_t dim[2] = {(cuuint64_t)w, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)w * 4};
  const cuuint32_t box[2] = {kLanes, kT};
  return tma::map_f32(map, base, 2, dim, stride, box);
}

}  // namespace

// a, g, h: [B, S, W] float32, contiguous, W a multiple of 4, a and g
// 16-byte aligned; h0: [B, W].
extern "C" int rglru_scan_f32(const void* a, const void* g, const void* h0,
                              void* h, int b, int s, int w, void* stream) {
  CUtensorMap ma = {}, mg = {};
  if (!tile_map(&ma, a, b * s, w) || !tile_map(&mg, g, b * s, w))
    return (int)cudaErrorInvalidValue;
  rglru_forward<<<blocks(b, w), kLanes, 0, (cudaStream_t)stream>>>(
      ma, mg, (const float*)h0, (float*)h, s, w);
  return (int)cudaGetLastError();
}

// a, h, dy, da, dg: [B, S, W], W a multiple of 4, a, h and dy 16-byte
// aligned; h0, dh0: [B, W].
extern "C" int rglru_scan_backward_f32(const void* a, const void* h,
                                       const void* h0, const void* dy,
                                       void* da, void* dg, void* dh0, int b,
                                       int s, int w, void* stream) {
  CUtensorMap ma = {}, md = {}, mh = {};
  if (!tile_map(&ma, a, b * s, w) || !tile_map(&md, dy, b * s, w) ||
      !tile_map(&mh, h, b * s, w))
    return (int)cudaErrorInvalidValue;
  rglru_backward<<<blocks(b, w), kLanes, 0, (cudaStream_t)stream>>>(
      ma, md, mh, (const float*)h0, (float*)da, (float*)dg, (float*)dh0, s,
      w);
  return (int)cudaGetLastError();
}
