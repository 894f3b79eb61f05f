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
// and reads 4E + 4Q, one compare per byte. The design:
//   * a thread block cluster owns a group of kQ queries and all of E,
//     so it owns whole bitmap rows and writes their counts itself: no fill
//     before the launch and no atomics;
//   * its blocks stride over E in chunks of kThreads * kPer entries; a
//     thread keeps kPer entries in registers, loads the next chunk's while
//     it matches this one, and writes the kPer match bytes of each of the
//     group's queries with one store (8 bytes at kPer = 8: a warp writes
//     256 contiguous bytes of a row), with the default write-back policy:
//     the k-NN fold reads the bitmap right after, from L2;
//   * each thread counts its hits per query (a popcount of its match
//     words), a warp sums them, the block sums its warps, and block rank 0
//     sums the cluster's blocks in rank order through distributed shared
//     memory: integer sums, exact in any order.
// Queries beyond the grid's y limit are taken by the group loop.
//
// Launch choices (tuning's CamConfig): kQ, the queries of a cluster's group
// (4, 8 or 16; 8 by default), and kPer, the entries a thread holds per chunk
// (4, 8 or 16; 8 by default, so a warp matches 32 * kPer entries a chunk:
// CamConfig.be). Both are template parameters. The bitmap is the same and
// the counts are integer sums, so every choice gives the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;             // blocks of a cluster, at most
constexpr unsigned kMaxGridY = 65535;

// kVec: kPer % 4 == 0, E % kPer == 0, ci 16-byte and match kPer-byte
// aligned, so a thread's kPer entries are all in range or all out of it,
// and load and store as vectors.
template <bool kVec, int kPer>
__device__ __forceinline__ void load_chunk(const int* __restrict__ ci,
                                           long long e, long long e0,
                                           int (&ent)[kPer]) {
  if constexpr (kVec) {
    if (e0 < e) {
      const int4* src = reinterpret_cast<const int4*>(ci + e0);
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i) {
        const int4 v = __ldg(src + i);
        ent[4 * i] = v.x;
        ent[4 * i + 1] = v.y;
        ent[4 * i + 2] = v.z;
        ent[4 * i + 3] = v.w;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      ent[i] = e0 + i < e ? __ldg(ci + e0 + i) : 0;
  }
}

// The match bytes of one chunk against the group's nq queries, into rows
// [q0, q0 + nq) of the bitmap; hits[j] += this thread's matches of query j.
template <bool kVec, int kPer, int kQ>
__device__ __forceinline__ void match_chunk(const int (&ent)[kPer],
                                            const int (&qv)[kQ], int nq,
                                            long long e, long long e0,
                                            signed char* __restrict__ rows,
                                            int (&hits)[kQ]) {
  constexpr int kWords = (kPer + 3) / 4;
  if (e0 >= e) return;
#pragma unroll
  for (int j = 0; j < kQ; ++j) {
    if (j >= nq) break;
    unsigned w[kWords];
#pragma unroll
    for (int wi = 0; wi < kWords; ++wi) {
      w[wi] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 4 * wi + i;
        if (idx < kPer) {
          const bool hit =
              qv[j] >= 0 && ent[idx] == qv[j] && (kVec || e0 + idx < e);
          w[wi] |= (hit ? 1u : 0u) << (8 * i);
        }
      }
      hits[j] += __popc(w[wi]);
    }
    signed char* dst = rows + (long long)j * e + e0;
    if constexpr (kVec && kPer == 4) {
      *reinterpret_cast<unsigned*>(dst) = w[0];
    } else if constexpr (kVec && kPer == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else if constexpr (kVec && kPer == 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (e0 + i < e)
          dst[i] = (signed char)((w[i / 4] >> (8 * (i % 4))) & 1u);
    }
  }
}

template <bool kVec, int kPer, int kQ>
__global__ void __launch_bounds__(kThreads)
cam_search_kernel(const int* __restrict__ ci, const int* __restrict__ queries,
                  signed char* __restrict__ match, int* __restrict__ counts,
                  long long e, int q) {
  constexpr int kChunk = kThreads * kPer;  // entries per block and chunk
  __shared__ int warp_hits[kThreads / 32][kQ];
  __shared__ int block_hits[kQ];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const long long nchunks = (e + kChunk - 1) / kChunk;
  const int ngroups = (q + kQ - 1) / kQ;
  for (int grp = blockIdx.y; grp < ngroups; grp += gridDim.y) {
    const int q0 = grp * kQ, nq = min(kQ, q - q0);
    int qv[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j)
      qv[j] = j < nq ? __ldg(queries + q0 + j) : -1;
    int hits[kQ] = {};
    signed char* rows = match + (long long)q0 * e;
    int ent[kPer] = {}, next[kPer] = {};
    long long c = rank;
    if (c < nchunks)
      load_chunk<kVec, kPer>(ci, e, c * kChunk + tid * kPer, ent);
    for (; c < nchunks; c += csize) {
      if (c + csize < nchunks)  // in flight while this chunk is matched
        load_chunk<kVec, kPer>(ci, e, (c + csize) * kChunk + tid * kPer,
                               next);
      match_chunk<kVec, kPer, kQ>(ent, qv, nq, e, c * kChunk + tid * kPer,
                                  rows, hits);
#pragma unroll
      for (int i = 0; i < kPer; ++i) ent[i] = next[i];
    }
    // counts: warp sums, block sum in warp order, cluster sum in rank order
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const int h = (int)__reduce_add_sync(0xffffffffu, (unsigned)hits[j]);
      if ((tid & 31) == 0) warp_hits[tid / 32][j] = h;
    }
    __syncthreads();
    if (tid < kQ) {
      int s = 0;
      for (int w = 0; w < kThreads / 32; ++w) s += warp_hits[w][tid];
      block_hits[tid] = s;
    }
    cluster.sync();
    if (rank == 0 && tid < nq) {
      int s = 0;
      for (int b = 0; b < csize; ++b)
        s += cluster.map_shared_rank(&block_hits[0], b)[tid];
      counts[q0 + tid] = s;
    }
    cluster.sync();  // rank 0's remote reads are done
  }
}

// A cluster of up to kMaxCluster blocks per query group, as many as E has
// chunks; group y-blocks up to the grid's limit.
template <bool kVec, int kPer, int kQ>
int launch(const int* ci, const int* queries, signed char* match, int* counts,
           long long e, int q, cudaStream_t stream) {
  constexpr int kChunk = kThreads * kPer;
  auto kernel = cam_search_kernel<kVec, kPer, kQ>;
  static bool configured[64] = {};  // non-portable cluster sizes, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < 64 && configured[dev])) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess && dev < 64) configured[dev] = true;
  }
  if (err != cudaSuccess) return (int)err;
  const long long nchunks = (e + kChunk - 1) / kChunk;
  const unsigned csize =
      (unsigned)(nchunks < kMaxCluster ? (nchunks > 0 ? nchunks : 1)
                                       : kMaxCluster);
  const unsigned ngroups = (unsigned)((q + kQ - 1) / kQ);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(csize, ngroups < kMaxGridY ? ngroups : kMaxGridY);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, ci, queries, match, counts, e, q);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The variants of one kQ: kPer x float4 or scalar.
template <int kQ>
int launch_per(int per, bool vec, const int* ci, const int* queries,
               signed char* match, int* counts, long long e, int q,
               cudaStream_t st) {
  switch (per) {
    case 4:
      return (vec ? launch<true, 4, kQ> : launch<false, 4, kQ>)(
          ci, queries, match, counts, e, q, st);
    case 8:
      return (vec ? launch<true, 8, kQ> : launch<false, 8, kQ>)(
          ci, queries, match, counts, e, q, st);
    case 16:
      return (vec ? launch<true, 16, kQ> : launch<false, 16, kQ>)(
          ci, queries, match, counts, e, q, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bq: queries of a cluster's group (4, 8 or 16); per: entries a thread
// holds per chunk (4, 8 or 16).
extern "C" int cam_search_i32(const void* ci, const void* queries,
                              void* match, void* counts, long long e, int q,
                              int bq, int per, void* stream) {
  if (q < 1) return (int)cudaSuccess;
  if (per != 4 && per != 8 && per != 16)
    return (int)cudaErrorInvalidValue;
  const bool vec = per % 4 == 0 && e % per == 0 && (size_t)ci % 16 == 0 &&
                   (size_t)match % per == 0;
  const int* c = (const int*)ci;
  const int* qs = (const int*)queries;
  signed char* m = (signed char*)match;
  int* n = (int*)counts;
  const cudaStream_t st = (cudaStream_t)stream;
  if (bq == 4) return launch_per<4>(per, vec, c, qs, m, n, e, q, st);
  if (bq == 8) return launch_per<8>(per, vec, c, qs, m, n, e, q, st);
  if (bq == 16) return launch_per<16>(per, vec, c, qs, m, n, e, q, st);
  return (int)cudaErrorInvalidValue;
}
