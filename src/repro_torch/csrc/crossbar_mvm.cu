// Bit-serial RRAM crossbar MVM of IMA-GNN on Hopper, on codes:
// out[m, n] = sum over rows_per_xbar K tiles (in order) of
//             sum over input bits b (in order) of
//             ADC(plane_b(xq[m, tile]) . wq[tile, n]) * 2^b
// in the integer domain (the caller rescales).
//
// Replaces the Pallas TPU kernel `crossbar_matmul_quantized` (body `_kernel`)
// in src/repro/kernels/crossbar_mvm/crossbar_mvm.py. The TPU grid walks
// (M/bm, N/bn, K/bk) with the K axis sequential, carrying the sum in the
// revisited output block, and needs every dimension padded to its block.
// Here a block owns a row tile and a column block and walks K itself, in
// order; it masks ragged M, N and K, so nothing is padded.
//
// What bounds it on this card: bytes, by the read-once count. At the
// centralized collab layer-1 shape (M = 372,475, K = 496, N = 64) the int32
// DAC codes are 739 MB; the in_bits bit-plane products are int8 tensor-core
// work (crossbar_mma.cuh) that the card could do in less time than the
// codes take to read. The design:
//   * the conductance codes arrive as int8 digits in the tile-padded layout
//     [D, N, Kp] (one digit for integer codes within +-127, two to four in
//     base 128 for the others; the wrapper builds them with tensor ops);
//   * a block of 8 warps owns 16 * mt rows and up to 64 columns, one warp
//     per (m16 tile, column group) unit, so a small product still spreads
//     over several units; blocks are persistent and walk row tiles;
//   * K is staged through shared memory in chunks of the tile-padded depth
//     (as deep as two blocks an SM allow): the DAC codes of the row tile,
//     read once from the int32 codes (int4 loads where aligned) and packed
//     to bytes, one byte plane per pass of 8 bits, and the digits of the
//     block's columns. Where the whole depth fits one chunk, the digits are
//     staged once for the block's life; deeper, they are staged again with
//     each chunk. There is no depth limit;
//   * each warp walks the crossbar tiles in order; for each pass of 8 bit
//     planes (in_bits > 8 takes two to four) it runs xmma::tile_mma over
//     the chunks the tile meets, staging a chunk where it is not the one in
//     shared memory, so the int32 bit-plane sums of a tile may span chunks,
//     and applies the ADC where the pass ends, carrying the tile's f32 sum
//     from pass to pass. With several passes the chunks hold whole tiles
//     where a tile fits one, so that no chunk is staged twice.
// Launch plan: the wrapper computes it on the host
// (kernels/launch_plans.py crossbar_resolve, the default and tuning's
// CrossbarConfig alike) and the launcher refuses one that does not fit:
// the block's columns bn (column groups bn / kCols, a power of two up to 8;
// the m16 tiles follow from the 8 warps) and the chunk depth kc (a multiple
// of 32 up to kp; with several passes whole tiles where a tile fits).
// Neither moves a bit: a column group's outputs do not depend on the
// others, a tile's int32 sums are exact in any chunking, and the ADC, the
// bit order and the tile order stay.
//
// Numerics: the int32 sums are exact and convert to the plain version's f32
// partials exactly (crossbar_mma.cuh); the ADC, the shift and add in bit
// order and the add across tiles in tile order are the plain version's, so
// the result equals it bit for bit.
#include <cuda_runtime.h>

#include <algorithm>

#include "crossbar_mma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Dynamic shared memory of a block, at most: two blocks share an SM.
constexpr int kSmemBudget = 112 * 1024;
constexpr int kLoads = 4;  // int4 code loads a thread keeps in flight

// Dynamic shared memory: codes[ng][rows][stride] (byte g of the DAC codes,
// at their tile-padded depth within the chunk), then ds[ndig][bn][stride]
// (s8 digits); stride = kc + 16 bytes (crossbar_mma.cuh). rows = 16 * mt,
// bn = ncg * Shape<kD>::kCols, ncg * mt = kWarps. vec: xq is 16-byte
// aligned and K and rows_per_xbar are multiples of 4. kPasses: in_bits > 8
// (ng passes of 8 planes, the tile's sum carried from one to the next).
template <int kD, bool kPasses>
__global__ void __launch_bounds__(kThreads, kPasses ? 1 : 2)
crossbar_mma_kernel(const int* __restrict__ xq,
                    const signed char* __restrict__ digits,
                    float* __restrict__ out, long long m, int k, int n, int r,
                    int rpad, int kp, int kc, int ncg, int nbits, int ng,
                    int ndig, float fs, float lsb, float inv_lsb, int vec) {
  using S = xmma::Shape<kD>;
  const int mt = kWarps / ncg;
  const int rows = xmma::kRows * mt;
  const int bn = ncg * S::kCols;
  const int stride = kc + 16;
  extern __shared__ int4 smem[];
  unsigned char* codes = reinterpret_cast<unsigned char*>(smem);
  signed char* ds = reinterpret_cast<signed char*>(codes + ng * rows * stride);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int cg = warp % ncg, m0 = warp / ncg * xmma::kRows;
  const int col0 = blockIdx.y * bn;
  const int nchunks = (kp + kc - 1) / kc;
  const int ntiles = (kp + rpad - 1) / rpad;
  const long long row_tiles = (m + rows - 1) / rows;
  bool digits_in = false;  // the digits of a one-chunk depth, staged
  for (long long tile = blockIdx.x; tile < row_tiles; tile += gridDim.x) {
    const long long row0 = tile * rows;
    // Stage chunk c: the row tile's DAC codes, one byte plane per pass,
    // and the digits of the block's columns (once for the block's life
    // where the whole depth is one chunk).
    auto stage = [&](int c) {
      const int p0 = c * kc, pn = min(kc, kp - p0), words = pn / 4;
      __syncthreads();  // the previous chunk's reads are done
      // 1. DAC codes: word w of row rr holds depth p0 + 4w .. + 3; depth p
      //    is row (p / rpad) * r + p % rpad of K, or a pad (0).
      for (int e0 = tid; e0 < rows * words; e0 += kThreads * kLoads) {
        int4 v[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          v[u] = make_int4(0, 0, 0, 0);
          const int e = e0 + u * kThreads;
          if (e >= rows * words) continue;
          const int rr = e / words, p = p0 + 4 * (e % words);
          const int t = p / rpad, off = p - t * rpad;
          const int kt = min(r, k - t * r);
          const long long row = row0 + rr;
          if (row >= m || off >= kt) continue;
          const int* src = xq + row * k + (long long)t * r + off;
          if (vec) {
            v[u] = __ldg(reinterpret_cast<const int4*>(src));
          } else {
            v[u].x = __ldg(src);
            if (off + 1 < kt) v[u].y = __ldg(src + 1);
            if (off + 2 < kt) v[u].z = __ldg(src + 2);
            if (off + 3 < kt) v[u].w = __ldg(src + 3);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int e = e0 + u * kThreads;
          if (e >= rows * words) continue;
          for (int g = 0; g < (kPasses ? ng : 1); ++g) {
            const int sh = 8 * g;
            const unsigned word =
                (v[u].x >> sh & 0xff) | (v[u].y >> sh & 0xff) << 8 |
                (v[u].z >> sh & 0xff) << 16 |
                (unsigned)(v[u].w >> sh & 0xff) << 24;
            *reinterpret_cast<unsigned*>(codes + (g * rows + e / words) *
                                                     stride +
                                         4 * (e % words)) = word;
          }
        }
      }
      // 2. digits of the block's columns, 16 bytes at a time (kp, p0 and
      //    pn are multiples of 32).
      if (nchunks > 1 || !digits_in) {
        xmma::stage_digits(ds, digits, ndig, n, kp, col0, bn, p0, pn, stride,
                           tid, kThreads);
        digits_in = true;
      }
      __syncthreads();
    };
    // 3. the crossbar tiles in order; per pass of 8 bit planes the tile's
    //    bit-plane products over the chunks it meets, then the pass's ADC,
    //    shift and add into the tile's running sums; then the add across
    //    tiles.
    float mvm[S::kNt][4] = {};
    int cur = -1;  // the chunk in shared memory
    for (int t = 0; t < ntiles; ++t) {
      const int tb = t * rpad, te = min(tb + rpad, kp);
      float sum[S::kNt][4] = {};
      for (int g = 0; g < (kPasses ? ng : 1); ++g) {
        int acc[xmma::kPlanes][S::kAcc][4] = {};
        const int planes = min(nbits - 8 * g, xmma::kPlanes);
        for (int p = tb; p < te;) {
          const int c = p / kc;
          if (c != cur) {
            stage(c);
            cur = c;
          }
          const int end = min(te, (c + 1) * kc);
          xmma::tile_mma<kD>(codes + (g * rows + m0) * stride,
                             ds + cg * S::kCols * stride, stride,
                             bn * stride, p - c * kc, (end - p) / 32, planes,
                             ndig, acc);
          p = end;
        }
        if constexpr (kPasses)
          xmma::pass_adc<kD>(acc, nbits, g, fs, lsb, inv_lsb, sum);
        else
          xmma::tile_adc<kD>(acc, nbits, fs, lsb, inv_lsb, mvm);
      }
      if constexpr (kPasses) {
#pragma unroll
        for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mvm[nt][e] = __fadd_rn(mvm[nt][e], sum[nt][e]);
      }
    }
    // mvm[nt][e] is the output at row g + 8 (e >> 1), column nt * 8 + 2 t +
    // (e & 1) of the unit.
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int nt = 0; nt < S::kNt; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = row0 + m0 + g + 8 * (e >> 1);
        const int col = col0 + cg * S::kCols + nt * 8 + 2 * tq + (e & 1);
        if (row < m && col < n) out[row * n + col] = mvm[nt][e];
      }
    }
  }
}

// Launches the host's plan (bn columns, chunks of kc) on a persistent grid
// of as many blocks as fit on the card at once.
template <int kD, bool kPasses>
int launch(const int* xq, const signed char* digits, int ndig, float* out,
           long long m, int k, int n, int r, int kp, int nbits, float fs,
           float lsb, float inv_lsb, int bn, int kc,
           cudaStream_t stream) {
  constexpr int kCols = xmma::Shape<kD>::kCols;
  auto kernel = crossbar_mma_kernel<kD, kPasses>;
  static bool configured[64] = {};  // the shared memory limit, per device
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && !(dev < 64 && configured[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err == cudaSuccess && dev < 64) configured[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  const int ncg = bn / kCols;
  if (bn % kCols != 0 || ncg < 1 || ncg > kWarps || (ncg & (ncg - 1)) != 0 ||
      kc < 32 || kc % 32 != 0 || kc > kp)
    return (int)cudaErrorInvalidValue;
  const int ng = (nbits + xmma::kPlanes - 1) / xmma::kPlanes;
  const int rows = xmma::kRows * (kWarps / ncg);
  const int rpad = (r + 31) / 32 * 32;
  const int per_row = ng * rows + ndig * bn;  // shared bytes per depth
  const size_t smem = (size_t)per_row * (kc + 16);
  if (smem > (size_t)kSmemBudget) return (int)cudaErrorInvalidValue;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int ncol = (n + bn - 1) / bn;
  const long long row_tiles = (m + rows - 1) / rows;
  const long long nx = std::min<long long>(
      row_tiles, std::max<long long>(1, (long long)per_sm * sms / ncol));
  const int vec = (size_t)xq % 16 == 0 && k % 4 == 0 && r % 4 == 0;
  kernel<<<dim3((unsigned)nx, (unsigned)ncol), kThreads, smem, stream>>>(
      xq, digits, out, m, k, n, r, rpad, kp, kc, ncg, nbits, ng, ndig, fs,
      lsb, inv_lsb, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// bn, kc: the launch plan (launch_plans.crossbar_resolve).
extern "C" int crossbar_matmul_quantized_i8(
    const void* xq, const void* digits, int ndigits, void* out, long long m,
    int k, int n, int rows_per_xbar, int kp, int in_bits, float full_scale,
    float lsb, float inv_lsb, int bn, int kc, void* stream) {
  if (in_bits < 1 || in_bits > xbar::kMaxBits || rows_per_xbar < 1 ||
      kp < 32 || kp % 32 != 0 || (size_t)digits % 16 != 0 || ndigits < 1 ||
      ndigits > xmma::kMaxDigits)
    return (int)cudaErrorInvalidValue;
  auto run = [&](auto launch_fn) {
    return launch_fn((const int*)xq, (const signed char*)digits, ndigits,
                     (float*)out, m, k, n, rows_per_xbar, kp, in_bits,
                     full_scale, lsb, inv_lsb, bn, kc, (cudaStream_t)stream);
  };
  const bool passes = in_bits > xmma::kPlanes;
  if (ndigits == 1)
    return passes ? run(launch<1, true>) : run(launch<1, false>);
  if (ndigits == 2)
    return passes ? run(launch<2, true>) : run(launch<2, false>);
  return passes ? run(launch<3, true>) : run(launch<3, false>);
}
