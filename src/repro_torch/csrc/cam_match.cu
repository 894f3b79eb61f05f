// Search CAM of IMA-GNN's traversal core on Hopper:
// match[q, e] = (ci[e] == queries[q]) as int8, counts[q] = sum_e match[q, e];
// a negative query matches nothing.
//
// Replaces the Pallas TPU kernel `cam_search` (body `_kernel`) in
// src/repro/kernels/cam_match/cam_match.py, together with what its ops layer
// (src/repro/kernels/cam_match/ops.py) does around it: the TPU grid needs E
// and Q padded to its blocks with sentinels and a mask for negative queries
// afterwards; here the kernel masks ragged E and Q and zeroes negative
// queries itself.
//
// What bounds it on this card: bytes written. It writes Q * E bitmap bytes
// and reads 4E + 4Q, one compare per byte. Each thread loads 16 consecutive
// entries once, compares them with each of its block's queries, and writes
// the 16 match bytes of a query as one 16-byte store, so a warp writes 512
// contiguous bytes of a bitmap row at a time. Counts: each thread counts its
// matches, a warp sums them (__reduce_add_sync) and adds its total with one
// atomicAdd per query into counts the wrapper zeroed; integer sums are exact
// in any order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;                 // entries per thread
constexpr int kTile = kThreads * kPerThread;   // entries per block
constexpr int kQueries = 8;                    // queries per block step
constexpr unsigned kMaxGridY = 65535;

// kVec: E % 16 == 0 and 16-byte aligned pointers, so a thread's 16 entries
// are all in range or all out of it and load and store as 16-byte vectors.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cam_search_kernel(const int* __restrict__ ci, const int* __restrict__ queries,
                  signed char* __restrict__ match, int* __restrict__ counts,
                  long long e, int q) {
  const long long e0 =
      (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPerThread;
  int ent[kPerThread];
  if (kVec) {
    if (e0 < e) {
      const int4* src = reinterpret_cast<const int4*>(ci + e0);
#pragma unroll
      for (int i = 0; i < kPerThread / 4; ++i) {
        const int4 v = src[i];
        ent[4 * i] = v.x;
        ent[4 * i + 1] = v.y;
        ent[4 * i + 2] = v.z;
        ent[4 * i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      ent[i] = (e0 + i < e) ? ci[e0 + i] : -1;  // -1 matches no valid query
  }
  const int n_qblocks = (q + kQueries - 1) / kQueries;
  for (int qb = blockIdx.y; qb < n_qblocks; qb += gridDim.y) {
    for (int j = 0; j < kQueries; ++j) {
      const int qi = qb * kQueries + j;
      if (qi >= q) break;  // uniform across the block
      const int qv = queries[qi];
      const bool live = qv >= 0 && e0 < e;
      unsigned word[kPerThread / 4];
      int hits = 0;
#pragma unroll
      for (int w = 0; w < kPerThread / 4; ++w) {
        word[w] = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const unsigned hit = (live && ent[4 * w + i] == qv) ? 1u : 0u;
          word[w] |= hit << (8 * i);
          hits += (int)hit;
        }
      }
      signed char* dst = match + (long long)qi * e + e0;
      if (kVec) {
        if (e0 < e)
          *reinterpret_cast<uint4*>(dst) =
              make_uint4(word[0], word[1], word[2], word[3]);
      } else {
#pragma unroll
        for (int i = 0; i < kPerThread; ++i)
          if (e0 + i < e)
            dst[i] = (signed char)((word[i / 4] >> (8 * (i % 4))) & 1u);
      }
      const unsigned total = __reduce_add_sync(0xffffffffu, (unsigned)hits);
      if ((threadIdx.x & 31) == 0 && total != 0u)
        atomicAdd(counts + qi, (int)total);
    }
  }
}

}  // namespace

extern "C" int cam_search_i32(const void* ci, const void* queries,
                              void* match, void* counts, long long e, int q,
                              void* stream) {
  const unsigned n_qblocks = (unsigned)((q + kQueries - 1) / kQueries);
  const dim3 grid((unsigned)((e + kTile - 1) / kTile),
                  n_qblocks < kMaxGridY ? n_qblocks : kMaxGridY);
  const bool vec = e % 16 == 0 && (size_t)ci % 16 == 0 &&
                   (size_t)match % 16 == 0;
  if (vec)
    cam_search_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)ci, (const int*)queries, (signed char*)match,
        (int*)counts, e, q);
  else
    cam_search_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)ci, (const int*)queries, (signed char*)match,
        (int*)counts, e, q);
  return (int)cudaGetLastError();
}
