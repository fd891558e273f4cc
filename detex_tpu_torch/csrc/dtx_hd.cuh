// Qualifiers for per-block decode functions that both nvcc (the kernels)
// and g++ (the host builds the CPU tests load) compile from one source,
// the read-only tables those functions share, and the kernels' launch
// geometry (one thread per block, 128 a CUDA block) and store.

#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define DTX_HD __host__ __device__ __forceinline__
#define DTX_UNROLL _Pragma("unroll")
#else
#define DTX_HD inline
#define DTX_UNROLL
#endif

// A uint32 table, visible to the device pass as read-only global memory
// (a dynamic index into a local array would land in local memory, and
// __constant__ would serialise a warp's differing indices) and to the host
// pass as a plain array.
#if defined(__CUDACC__)
#define DTX_TABLE(name, ...)                                \
  __device__ const uint32_t name##_dev[] = {__VA_ARGS__};   \
  static const uint32_t name##_host[] = {__VA_ARGS__};
#else
#define DTX_TABLE(name, ...) \
  static const uint32_t name##_host[] = {__VA_ARGS__};
#endif

#if defined(__CUDA_ARCH__)
#define DTX_LOOKUP(name, i) __ldg(&name##_dev[i])
#else
#define DTX_LOOKUP(name, i) (name##_host[i])
#endif

#if defined(__CUDACC__)
namespace dtx {

constexpr int kThreads = 128;

// CUDA blocks for n 4x4 blocks.
inline unsigned int grid(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

// One thread's kWords output words as kWords / 4 16 B vector stores.
template <int kWords>
__device__ __forceinline__ void store_words(uint4* dst, const uint32_t* out) {
#pragma unroll
  for (int q = 0; q < kWords / 4; ++q) {
    dst[q] = make_uint4(out[4 * q], out[4 * q + 1], out[4 * q + 2],
                        out[4 * q + 3]);
  }
}

}  // namespace dtx
#endif
