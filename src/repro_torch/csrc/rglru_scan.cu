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
// element), the backward reads a, h and dy and writes da and dg. The
// design: one thread per (b, w) channel walks t in order and keeps h in a
// register; neighbouring threads own neighbouring channels, so every
// step's loads and stores are coalesced along W, and the loop is unrolled
// so that several steps' loads are in flight ahead of the dependent
// multiply-add. There are only B * W threads (4,096 at recurrentgemma-9b's
// prefill of one sequence), so at B = 1 the card is far from full: a
// chunked two-pass scan would fill it (ROADMAP, open work).
//
// Numerics: `__fmul_rn` then `__fadd_rn`, never contracted into an FMA, so
// every h equals the plain loop's `a[:, t] * h + g[:, t]` (two roundings)
// bit for bit. The backward pass walks t in reverse:
//   dh_t = dy_t + a_{t+1} * dh_{t+1},  da_t = dh_t * h_{t-1},  dg_t = dh_t,
//   dh0 = a_0 * dh_0,
// reading the forward's saved output h (h_{-1} = h0).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
rglru_forward(const float* __restrict__ a, const float* __restrict__ g,
              const float* __restrict__ h0, float* __restrict__ h, int b,
              int s, int w) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= (long long)b * w) return;
  const long long bi = c / w, wi = c % w;
  const long long base = bi * s * w + wi;
  float state = h0[c];
#pragma unroll 8
  for (int t = 0; t < s; ++t) {
    const long long i = base + (long long)t * w;
    state = __fadd_rn(__fmul_rn(__ldg(a + i), state), __ldg(g + i));
    h[i] = state;
  }
}

__global__ void __launch_bounds__(kThreads)
rglru_backward(const float* __restrict__ a, const float* __restrict__ h,
               const float* __restrict__ h0, const float* __restrict__ dy,
               float* __restrict__ da, float* __restrict__ dg,
               float* __restrict__ dh0, int b, int s, int w) {
  const long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (c >= (long long)b * w) return;
  const long long bi = c / w, wi = c % w;
  const long long base = bi * s * w + wi;
  float carry = 0.0f;      // a_{t+1} * dh_{t+1}
#pragma unroll 8
  for (int t = s - 1; t >= 0; --t) {
    const long long i = base + (long long)t * w;
    const float dh = __fadd_rn(__ldg(dy + i), carry);
    const float prev = t > 0 ? __ldg(h + i - w) : h0[c];
    const float at = __ldg(a + i);
    da[i] = __fmul_rn(dh, prev);
    dg[i] = dh;
    carry = __fmul_rn(at, dh);
  }
  dh0[c] = carry;
}

unsigned blocks(int b, int w) {
  return (unsigned)(((long long)b * w + kThreads - 1) / kThreads);
}

}  // namespace

// a, g, h: [B, S, W] float32, contiguous; h0: [B, W].
extern "C" int rglru_scan_f32(const void* a, const void* g, const void* h0,
                              void* h, int b, int s, int w, void* stream) {
  rglru_forward<<<blocks(b, w), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)g, (const float*)h0, (float*)h, b, s,
      w);
  return (int)cudaGetLastError();
}

// a, h, dy, da, dg: [B, S, W]; h0, dh0: [B, W].
extern "C" int rglru_scan_backward_f32(const void* a, const void* h,
                                       const void* h0, const void* dy,
                                       void* da, void* dg, void* dh0, int b,
                                       int s, int w, void* stream) {
  rglru_backward<<<blocks(b, w), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)h, (const float*)h0, (const float*)dy,
      (float*)da, (float*)dg, (float*)dh0, b, s, w);
  return (int)cudaGetLastError();
}
