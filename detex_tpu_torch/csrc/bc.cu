// BC1/BC1A, BC2/BC3, RGTC1 and RGTC2 (signed and unsigned) block decode
// for Hopper (sm_90a): four kernels, one thread per 4x4 block, each
// instantiated for both values of its template flag.  bc.cuh holds the
// per-block decode; each kernel computes what its TPU kernel in
// detex_tpu/ops/pallas/bc_pallas.py computes, bit for bit:
//
//   bc1_kernel<A>     replaces _bc1_kernel   (L228)  BC1, BC1A
//   bc23_kernel<BC3>  replaces _bc23_kernel  (L247)  BC2, BC3
//   rgtc1_kernel<S>   replaces _rgtc1_kernel (L279)  RGTC1, SIGNED_RGTC1
//   rgtc2_kernel<S>   replaces _rgtc2_kernel (L305)  RGTC2, SIGNED_RGTC2
//
// The TPU kernels laid blocks out on (sublane, lane) and replaced gathers
// with select trees; here each thread loads its block as one 8 or 16 B
// vector (coalesced), builds the block's palette once in registers and
// selects per pixel.
//
// What bounds them on this card: these decodes do little integer work per
// byte, so at large N they should sit near the memory roofline.  Per
// block, bytes moved (in + out + valid) against integer operations
// (counted from the source, about):
//   bc1, bc1a       8 + 64 + 1 B   ~130 ops   memory-bound
//   bc2            16 + 64 + 1 B   ~150 ops   memory-bound
//   bc3            16 + 64 + 1 B   ~250 ops   memory-bound
//   rgtc1           8 + 16 + 1 B   ~130 ops   near the ridge
//   signed rgtc1    8 + 32 + 1 B   ~190 ops   near the ridge
//   rgtc2          16 + 32 + 1 B   ~230 ops   near the ridge
//   signed rgtc2   16 + 64 + 1 B   ~330 ops   near the ridge
// At 3.35 TB/s and roughly 17 Tops/s of 32-bit integer throughput, the
// ridge is near 5 operations per byte.  At small N (one texture mip of a
// few hundred blocks) launch latency dominates.  Measured on an H100 SXM
// (700 W) at N = 1,048,576: the 64 B-output variants move 1.4-1.6 TB/s,
// the 16-32 B-output ones 2.4-3.2 TB/s, so the scattered stores below,
// not the integer work, cap the former.
//
// Left for later work: a thread's output lies at a 16-64 B stride across
// the warp, so each vector store fills part of every sector it touches
// (L2 merges them before DRAM); staging through shared memory would make
// the stores coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc.cuh"

namespace {

using dtx::grid;
using dtx::kThreads;
using dtx::store_words;

template <bool kAlpha>
__global__ void __launch_bounds__(kThreads)
    bc1_kernel(const uint2* __restrict__ words, long long n, uint32_t flags,
               uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint2 w = words[i];
  uint32_t out[16];
  const bool ok = dtx::bc1_decode_block<kAlpha>(w.x, w.y, flags, out);
  store_words<16>(pixels + 4 * i, out);
  valid[i] = ok;
}

template <bool kBC3>
__global__ void __launch_bounds__(kThreads)
    bc23_kernel(const uint4* __restrict__ words, long long n, uint32_t flags,
                uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = words[i];
  uint32_t out[16];
  const bool ok = dtx::bc23_decode_block<kBC3>(w.x, w.y, w.z, w.w, flags,
                                               out);
  store_words<16>(pixels + 4 * i, out);
  valid[i] = ok;
}

template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
    rgtc1_kernel(const uint2* __restrict__ words, long long n,
                 uint4* __restrict__ pixels, bool* __restrict__ valid) {
  constexpr int kOut = kSigned ? 8 : 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint2 w = words[i];
  uint32_t out[kOut];
  const bool ok = dtx::rgtc1_decode_block<kSigned>(w.x, w.y, out);
  store_words<kOut>(pixels + (kOut / 4) * i, out);
  valid[i] = ok;
}

template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
    rgtc2_kernel(const uint4* __restrict__ words, long long n,
                 uint4* __restrict__ pixels, bool* __restrict__ valid) {
  constexpr int kOut = kSigned ? 16 : 8;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = words[i];
  uint32_t out[kOut];
  const bool ok = dtx::rgtc2_decode_block<kSigned>(w.x, w.y, w.z, w.w, out);
  store_words<kOut>(pixels + (kOut / 4) * i, out);
  valid[i] = ok;
}

}  // namespace

// Every entry point: words (n, 2) or (n, 4) int32, 8 or 16 B aligned;
// pixels (n, words out) int32, 16 B aligned; valid (n,) bool.  `variant`
// picks the instantiation (bc1a, bc3 or signed when nonzero); mode_mask
// is ignored by these families.  Launches on `stream` and returns
// cudaGetLastError().

extern "C" int dtx_bc1_decode(const void* words, long long n,
                              unsigned int mode_mask, unsigned int flags,
                              int variant, void* pixels, void* valid,
                              void* stream) {
  (void)mode_mask;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant ? bc1_kernel<true> : bc1_kernel<false>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint2*>(words), n, flags, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

extern "C" int dtx_bc23_decode(const void* words, long long n,
                               unsigned int mode_mask, unsigned int flags,
                               int variant, void* pixels, void* valid,
                               void* stream) {
  (void)mode_mask;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant ? bc23_kernel<true> : bc23_kernel<false>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, flags, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

extern "C" int dtx_rgtc1_decode(const void* words, long long n,
                                unsigned int mode_mask, unsigned int flags,
                                int variant, void* pixels, void* valid,
                                void* stream) {
  (void)mode_mask;
  (void)flags;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant ? rgtc1_kernel<true> : rgtc1_kernel<false>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint2*>(words), n, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

extern "C" int dtx_rgtc2_decode(const void* words, long long n,
                                unsigned int mode_mask, unsigned int flags,
                                int variant, void* pixels, void* valid,
                                void* stream) {
  (void)mode_mask;
  (void)flags;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant ? rgtc2_kernel<true> : rgtc2_kernel<false>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
