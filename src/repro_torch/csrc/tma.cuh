// Tensor Memory Accelerator copies into shared memory, counted on
// mbarriers: the scan kernels' staging (rglru_scan.cu, wkv6_scan.cu).
//
// A tensor map describes a strided box of a global array; one thread asks
// for a whole box with one instruction, the copy engine computes the
// addresses, and the bytes that land are counted on an mbarrier, which
// completes a phase once the arrivals it expects and the bytes announced
// with them are in. Boxes that run past the array read as zeros. The maps
// are encoded on the host by the driver's cuTensorMapEncodeTiled, reached
// through the runtime (no link to the driver library), and passed to the
// kernel by value as `const __grid_constant__ CUtensorMap`.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// `count` arrivals complete a phase (and the bytes announced with them)
__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the copy engine; every thread
// that waits on them then passes a barrier of its own
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival, and `bytes` more to land by copies
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                          int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem(bar)),
      "r"(bytes)
      : "memory");
}

// until the phase of this parity has completed
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                        int parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem(bar)), "r"(parity)
        : "memory");
  }
}

// orders this thread's earlier reads of shared memory before copies that
// it then asks for into the same bytes
__device__ __forceinline__ void fence_before_copy() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the box of a 2D map at (x, y) (x innermost) into dst
__device__ __forceinline__ void copy_2d(void* dst, const CUtensorMap* map,
                                        int x, int y,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem(dst)),
      "l"((unsigned long long)map), "r"(x), "r"(y), "r"(smem(bar))
      : "memory");
}

// the box of a 3D map at (x, y, z) into dst
__device__ __forceinline__ void copy_3d(void* dst, const CUtensorMap* map,
                                        int x, int y, int z,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem(dst)),
      "l"((unsigned long long)map), "r"(x), "r"(y), "r"(z), "r"(smem(bar))
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled; null if the driver has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return (EncodeTiled) nullptr;
    return (EncodeTiled)p;
  }();
  return fn;
}

// A float32 array of `rank` dimensions (dim[0] innermost, contiguous;
// stride[i] the bytes from one index of dimension i + 1 to the next) read
// in boxes of box[0] x box[1] x ...; false if it cannot be encoded (the
// base or a stride not a multiple of 16 bytes, no driver entry point).
inline bool map_f32(CUtensorMap* map, const void* base, int rank,
                    const cuuint64_t* dim, const cuuint64_t* stride,
                    const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode || (unsigned long long)base % 16 != 0) return false;
  for (int i = 0; i + 1 < rank; ++i)
    if (stride[i] % 16 != 0) return false;
  const cuuint32_t one[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank,
                (void*)base, dim, stride, box, one,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
