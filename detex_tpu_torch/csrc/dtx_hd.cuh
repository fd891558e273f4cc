// Qualifiers for per-block decode functions that both nvcc (the kernels)
// and g++ (the host builds the CPU tests load) compile from one source.

#pragma once

#if defined(__CUDACC__)
#define DTX_HD __host__ __device__ __forceinline__
#define DTX_UNROLL _Pragma("unroll")
#else
#define DTX_HD inline
#define DTX_UNROLL
#endif
