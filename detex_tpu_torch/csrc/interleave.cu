// The lane-interleave probe for Hopper (sm_90a): two kernels over a
// (16, 8, L) int32 array (interleave.cuh has the functions).
//
//   planar_add1_kernel     replaces tools/interleave_probe.py:_kernel_planar
//                          (L58): x + 1 in the same layout;
//   rows_interleave_kernel replaces :_kernel_rows_strided (L79) and
//                          :_kernel_rows (L86) with stack or repeat: the
//                          (4, 8, 4L) rows out[py, s, 4l + px] =
//                          x[4py + px, s, l] + 1.
//
// On the TPU the probe asked whether Mosaic could interleave four lane
// vectors inside a kernel: it wrote the same rows three ways (strided ref
// stores, stack + reshape, repeat + iota selects), and each failed to lower
// or ran 64x slower than planar.  A CUDA thread stores to any address, so
// the strided store needs no special form and one kernel covers all three.
//
// What bounds both on this card: bytes.  Each reads 4 B and writes 4 B per
// word and does one add, far below the int32 rate.
//   * planar: one thread per 16 B, one vector load and one vector store.
//   * rows: one thread per output 16 B (px = 0..3 of one (py, s, l)): four
//     4 B loads from the four pixel planes, each coalesced across the warp
//     (consecutive l), and one 16 B store, coalesced (consecutive 4l).
// A ragged tail (a word count not a multiple of 4) goes word by word.

#include <cuda_runtime.h>
#include <stdint.h>

#include "interleave.cuh"

namespace {

using dtx::kThreads;

__global__ void __launch_bounds__(kThreads)
    planar_add1_kernel(const uint32_t* __restrict__ x, long long n,
                       uint32_t* __restrict__ out) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long i = 4 * q;
  if (i + 3 < n) {
    const uint4 v = reinterpret_cast<const uint4*>(x)[q];
    reinterpret_cast<uint4*>(out)[q] = make_uint4(
        dtx::add1(v.x), dtx::add1(v.y), dtx::add1(v.z), dtx::add1(v.w));
  } else {
    for (long long k = i; k < n; ++k) out[k] = dtx::add1(x[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
    rows_interleave_kernel(const uint32_t* __restrict__ x, long long lanes,
                           uint32_t* __restrict__ out) {
  // Thread t writes out[py, s, 4l .. 4l+3] for t = (py * 8 + s) * L + l.
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= 32 * lanes) return;
  const long long plane = 8 * lanes;          // words of one pixel plane
  const long long src = dtx::rows_source(4 * t, lanes);
  reinterpret_cast<uint4*>(out)[t] = make_uint4(
      dtx::add1(x[src]), dtx::add1(x[src + plane]),
      dtx::add1(x[src + 2 * plane]), dtx::add1(x[src + 3 * plane]));
}

unsigned int blocks_for(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// x, out: (16, 8, lanes) int32, 16 B aligned.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int dtx_planar_add1(const void* x, long long lanes, void* out,
                               void* stream) {
  const long long n = 128 * lanes;
  if (n <= 0) return (int)cudaSuccess;
  planar_add1_kernel<<<blocks_for((n + 3) / 4), kThreads, 0,
                       (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), n, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}

// x: (16, 8, lanes) int32; out: (4, 8, 4 * lanes) int32, 16 B aligned.
extern "C" int dtx_rows_interleave(const void* x, long long lanes, void* out,
                                   void* stream) {
  if (lanes <= 0) return (int)cudaSuccess;
  rows_interleave_kernel<<<blocks_for(32 * lanes), kThreads, 0,
                           (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(x), lanes, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
