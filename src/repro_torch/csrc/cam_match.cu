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
//   * a thread block cluster owns a group of kQueries queries and all of E,
//     so it owns whole bitmap rows and writes their counts itself: no fill
//     before the launch and no atomics;
//   * its blocks stride over E in chunks of kThreads * kPer entries; a
//     thread keeps kPer entries in registers, loads the next chunk's while
//     it matches this one, and writes the kPer match bytes of each of the
//     group's queries with one 8-byte store (a warp writes 256 contiguous
//     bytes of a row), with the default write-back policy: the k-NN fold
//     reads the bitmap right after, from L2;
//   * each thread counts its hits per query (a popcount of its match
//     words), a warp sums them, the block sums its warps, and block rank 0
//     sums the cluster's blocks in rank order through distributed shared
//     memory: integer sums, exact in any order.
// Queries beyond the grid's y limit are taken by the group loop.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;                     // entries per thread and chunk
constexpr int kChunk = kThreads * kPer;     // entries per block and chunk
constexpr int kQueries = 8;                 // queries of a cluster's group
constexpr int kMaxCluster = 16;             // blocks of a cluster, at most
constexpr unsigned kMaxGridY = 65535;

// kVec: E % kPer == 0, ci 16-byte and match 8-byte aligned, so a thread's
// kPer entries are all in range or all out of it, and load and store as
// vectors.
template <bool kVec>
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
template <bool kVec>
__device__ __forceinline__ void match_chunk(const int (&ent)[kPer],
                                            const int (&qv)[kQueries], int nq,
                                            long long e, long long e0,
                                            signed char* __restrict__ rows,
                                            int (&hits)[kQueries]) {
  if (e0 >= e) return;
#pragma unroll
  for (int j = 0; j < kQueries; ++j) {
    if (j >= nq) break;
    unsigned w[kPer / 4];
#pragma unroll
    for (int wi = 0; wi < kPer / 4; ++wi) {
      w[wi] = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = 4 * wi + i;
        const bool hit =
            qv[j] >= 0 && ent[idx] == qv[j] && (kVec || e0 + idx < e);
        w[wi] |= (hit ? 1u : 0u) << (8 * i);
      }
      hits[j] += __popc(w[wi]);
    }
    signed char* dst = rows + (long long)j * e + e0;
    if constexpr (kVec) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (e0 + i < e)
          dst[i] = (signed char)((w[i / 4] >> (8 * (i % 4))) & 1u);
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
cam_search_kernel(const int* __restrict__ ci, const int* __restrict__ queries,
                  signed char* __restrict__ match, int* __restrict__ counts,
                  long long e, int q) {
  __shared__ int warp_hits[kThreads / 32][kQueries];
  __shared__ int block_hits[kQueries];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int tid = threadIdx.x;
  const long long nchunks = (e + kChunk - 1) / kChunk;
  const int ngroups = (q + kQueries - 1) / kQueries;
  for (int grp = blockIdx.y; grp < ngroups; grp += gridDim.y) {
    const int q0 = grp * kQueries, nq = min(kQueries, q - q0);
    int qv[kQueries];
#pragma unroll
    for (int j = 0; j < kQueries; ++j)
      qv[j] = j < nq ? __ldg(queries + q0 + j) : -1;
    int hits[kQueries] = {};
    signed char* rows = match + (long long)q0 * e;
    int ent[kPer] = {}, next[kPer] = {};
    long long c = rank;
    if (c < nchunks) load_chunk<kVec>(ci, e, c * kChunk + tid * kPer, ent);
    for (; c < nchunks; c += csize) {
      if (c + csize < nchunks)  // in flight while this chunk is matched
        load_chunk<kVec>(ci, e, (c + csize) * kChunk + tid * kPer, next);
      match_chunk<kVec>(ent, qv, nq, e, c * kChunk + tid * kPer, rows, hits);
#pragma unroll
      for (int i = 0; i < kPer; ++i) ent[i] = next[i];
    }
    // counts: warp sums, block sum in warp order, cluster sum in rank order
#pragma unroll
    for (int j = 0; j < kQueries; ++j) {
      const int h = (int)__reduce_add_sync(0xffffffffu, (unsigned)hits[j]);
      if ((tid & 31) == 0) warp_hits[tid / 32][j] = h;
    }
    __syncthreads();
    if (tid < kQueries) {
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
template <bool kVec>
int launch(const int* ci, const int* queries, signed char* match, int* counts,
           long long e, int q, cudaStream_t stream) {
  auto kernel = cam_search_kernel<kVec>;
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
  const unsigned ngroups = (unsigned)((q + kQueries - 1) / kQueries);
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

}  // namespace

extern "C" int cam_search_i32(const void* ci, const void* queries,
                              void* match, void* counts, long long e, int q,
                              void* stream) {
  if (q < 1) return (int)cudaSuccess;
  const bool vec =
      e % kPer == 0 && (size_t)ci % 16 == 0 && (size_t)match % 8 == 0;
  auto run = [&](auto launch_fn) {
    return launch_fn((const int*)ci, (const int*)queries,
                     (signed char*)match, (int*)counts, e, q,
                     (cudaStream_t)stream);
  };
  return vec ? run(launch<true>) : run(launch<false>);
}
