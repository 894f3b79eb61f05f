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
// What bounds it on this card: the sequential dependence over t, then
// bytes. A step is 5 Dh^2 flops a (b, h) on a state of Dh^2 floats that
// never leaves the SM; the inputs are read once and y written once.
//
// Forward: one block per (b, h) of Dh threads (Dh a template parameter:
// 16, 32 or 64). Thread v owns the column S[:, v] in registers, so y_t[v]
// needs no reduction across threads. Each step stages r_t, k_t, w_t in
// shared memory (double-buffered: one barrier a step) and loads the next
// step's inputs before it computes. The state update
// `__fadd_rn(__fmul_rn(w, s), __fmul_rn(k, v))` repeats the plain loop's
// roundings, so the final S equals the plain loop's bit for bit; y's
// Dh-term sum runs in another order than the plain loop's batched product.
// Where a gradient is needed the forward also writes S_{t-1} at every
// chunk start (t = 0, C, 2C, ...) to `ckpt`: [B, H, ceil(S / C), Dh, Dh].
//
// Backward, with G_t = dL/dS_t (G_{S-1} = dS_out):
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//   dk_t = G_t v_t + u . r_t (v_t . dy_t)
//   dv_t = G_t^T k_t + dy_t sum(r_t . u . k_t)
//   dw_t = rowsum(G_t . S_{t-1})
//   du  += r_t . k_t (v_t . dy_t)        (a (b, h) partial, summed outside)
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T,  dS0 = G_{-1}.
// One block per (b, h) of Dh threads again, but thread k owns the row k of
// G and of S_{t-1}: dr, dk and dw are then sums within a thread, and only
// dv needs a sum across threads (through a padded [Dh, Dh + 1] tile in
// shared memory, free of bank conflicts). The chunks are walked in
// reverse; each chunk's states S_{t-1} are recomputed from its checkpoint
// with the forward's roundings into a scratch buffer ([B * H, C, Dh, Dh],
// written and read coalesced along k) and then read back one step at a
// time.
#include <cuda_runtime.h>

namespace {

template <int D>
__global__ void __launch_bounds__(D)
wkv6_forward(const float* __restrict__ r, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ s0,
             float* __restrict__ y, float* __restrict__ s_out,
             float* __restrict__ ckpt, int h, int s, int chunk) {
  __shared__ float sr[2][D], sk[2][D], sw[2][D], su[D];
  const int bh = blockIdx.x;
  const int head = bh % h;
  const long long b = bh / h;
  const int j = threadIdx.x;              // the column this thread owns
  su[j] = u[head * D + j];
  float st[D];
  const float* s0p = s0 + (long long)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) st[i] = s0p[i * D + j];
  const int nc = chunk > 0 ? (s + chunk - 1) / chunk : 0;
  const long long step = (long long)h * D;   // from t to t + 1
  long long idx = (b * s * h + head) * (long long)D + j;
  float nr = __ldg(r + idx), nk = __ldg(k + idx), nw = __ldg(w + idx),
        nv = __ldg(v + idx);
  for (int t = 0; t < s; ++t, idx += step) {
    const int p = t & 1;
    sr[p][j] = nr;
    sk[p][j] = nk;
    sw[p][j] = nw;
    const float vj = nv;
    if (t + 1 < s) {
      nr = __ldg(r + idx + step);
      nk = __ldg(k + idx + step);
      nw = __ldg(w + idx + step);
      nv = __ldg(v + idx + step);
    }
    if (chunk > 0 && t % chunk == 0) {
      float* cp = ckpt + ((long long)bh * nc + t / chunk) * D * D;
#pragma unroll
      for (int i = 0; i < D; ++i) cp[i * D + j] = st[i];
    }
    __syncthreads();
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float kv = __fmul_rn(sk[p][i], vj);
      acc = fmaf(sr[p][i], __fadd_rn(st[i], __fmul_rn(su[i], kv)), acc);
      st[i] = __fadd_rn(__fmul_rn(sw[p][i], st[i]), kv);
    }
    y[idx] = acc;
  }
  float* sp = s_out + (long long)bh * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i) sp[i * D + j] = st[i];
}

template <int D>
__global__ void __launch_bounds__(D)
wkv6_backward(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ w,
              const float* __restrict__ u, const float* __restrict__ ckpt,
              const float* __restrict__ dy, const float* __restrict__ ds_out,
              float* __restrict__ dr, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ dw,
              float* __restrict__ du_part, float* __restrict__ ds0,
              float* __restrict__ scratch, int h, int s, int chunk) {
  __shared__ float sv[2][D], sdy[2][D], pr[2][D];
  __shared__ float part[2][D][D + 1];     // part[k][v] = G[k][v] * k_t[k]
  const int bh = blockIdx.x;
  const int head = bh % h;
  const long long b = bh / h;
  const int i = threadIdx.x;              // the row this thread owns
  const float ui = u[head * D + i];
  const int nc = (s + chunk - 1) / chunk;
  const long long step = (long long)h * D;
  const long long row0 = (b * s * h + head) * (long long)D;   // t = 0
  float g[D], st[D];
  const float* dso = ds_out + (long long)bh * D * D + (long long)i * D;
#pragma unroll
  for (int c = 0; c < D; ++c) g[c] = dso[c];
  float du = 0.0f;
  float* scr = scratch + (long long)bh * chunk * D * D;
  int q = 0;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * chunk;
    const int t1 = min(s, t0 + chunk);
    // S_{t-1} for t in [t0, t1), row i, from the chunk's checkpoint
    const float* cp = ckpt + ((long long)bh * nc + c) * D * D +
                      (long long)i * D;
#pragma unroll
    for (int col = 0; col < D; ++col) st[col] = cp[col];
    for (int t = t0; t < t1; ++t) {
      float* dst = scr + (long long)(t - t0) * D * D;
      const long long base = row0 + t * step;
      const float wi = __ldg(w + base + i), ki = __ldg(k + base + i);
#pragma unroll
      for (int col = 0; col < D; ++col) {
        dst[col * D + i] = st[col];
        st[col] = __fadd_rn(__fmul_rn(wi, st[col]),
                            __fmul_rn(ki, __ldg(v + base + col)));
      }
    }
    for (int t = t1 - 1; t >= t0; --t, ++q) {
      const int p = q & 1;
      const long long base = row0 + t * step;
      const float ri = __ldg(r + base + i), ki = __ldg(k + base + i),
                  wi = __ldg(w + base + i);
      sv[p][i] = __ldg(v + base + i);
      sdy[p][i] = __ldg(dy + base + i);
      pr[p][i] = ri * ui * ki;
      const float* src = scr + (long long)(t - t0) * D * D;
#pragma unroll
      for (int col = 0; col < D; ++col) st[col] = src[col * D + i];
      __syncthreads();
      float vd = 0.0f, drs = 0.0f, dks = 0.0f, dws = 0.0f;
#pragma unroll
      for (int col = 0; col < D; ++col) {
        const float dyc = sdy[p][col], vc = sv[p][col];
        vd = fmaf(vc, dyc, vd);
        drs = fmaf(st[col], dyc, drs);
        dks = fmaf(g[col], vc, dks);
        dws = fmaf(g[col], st[col], dws);
        part[p][i][col] = g[col] * ki;
        g[col] = fmaf(wi, g[col], ri * dyc);
      }
      dr[base + i] = fmaf(ui * ki, vd, drs);
      dk[base + i] = fmaf(ui * ri, vd, dks);
      dw[base + i] = dws;
      du = fmaf(ri * ki, vd, du);
      __syncthreads();
      // thread i as the column v = i
      float dvs = 0.0f, ruk = 0.0f;
#pragma unroll
      for (int row = 0; row < D; ++row) {
        dvs += part[p][row][i];
        ruk += pr[p][row];
      }
      dv[base + i] = fmaf(sdy[p][i], ruk, dvs);
    }
  }
  du_part[(long long)bh * D + i] = du;
  float* d0 = ds0 + (long long)bh * D * D + (long long)i * D;
#pragma unroll
  for (int col = 0; col < D; ++col) d0[col] = g[col];
}

}  // namespace

// r, k, v, w, y: [B, S, H, Dh]; u: [H, Dh]; s0, s_out: [B, H, Dh, Dh];
// ckpt: [B, H, ceil(S / chunk), Dh, Dh], or null with chunk 0. Dh is 16,
// 32 or 64; any other returns cudaErrorInvalidValue.
extern "C" int wkv6_scan_f32(const void* r, const void* k, const void* v,
                             const void* w, const void* u, const void* s0,
                             void* y, void* s_out, void* ckpt, int b, int h,
                             int s, int d, int chunk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(b * h);
#define WKV6_FWD(D)                                                         \
  wkv6_forward<D><<<grid, D, 0, st>>>(                                      \
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, \
      (const float*)u, (const float*)s0, (float*)y, (float*)s_out,         \
      (float*)ckpt, h, s, chunk)
  if (d == 16)
    WKV6_FWD(16);
  else if (d == 32)
    WKV6_FWD(32);
  else if (d == 64)
    WKV6_FWD(64);
  else
    return (int)cudaErrorInvalidValue;
#undef WKV6_FWD
  return (int)cudaGetLastError();
}

// dy, dr, dk, dv, dw: [B, S, H, Dh]; ds_out, ds0: [B, H, Dh, Dh];
// du_part: [B, H, Dh]; scratch: [B * H, chunk, Dh, Dh]; chunk > 0.
extern "C" int wkv6_scan_backward_f32(
    const void* r, const void* k, const void* v, const void* w,
    const void* u, const void* ckpt, const void* dy, const void* ds_out,
    void* dr, void* dk, void* dv, void* dw, void* du_part, void* ds0,
    void* scratch, int b, int h, int s, int d, int chunk, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = (unsigned)(b * h);
  if (chunk < 1) return (int)cudaErrorInvalidValue;
#define WKV6_BWD(D)                                                         \
  wkv6_backward<D><<<grid, D, 0, st>>>(                                     \
      (const float*)r, (const float*)k, (const float*)v, (const float*)w, \
      (const float*)u, (const float*)ckpt, (const float*)dy,               \
      (const float*)ds_out, (float*)dr, (float*)dk, (float*)dv, (float*)dw, \
      (float*)du_part, (float*)ds0, (float*)scratch, h, s, chunk)
  if (d == 16)
    WKV6_BWD(16);
  else if (d == 32)
    WKV6_BWD(32);
  else if (d == 64)
    WKV6_BWD(64);
  else
    return (int)cudaErrorInvalidValue;
#undef WKV6_BWD
  return (int)cudaGetLastError();
}
