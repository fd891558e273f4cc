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
// byte, so at large N they sit near the memory roofline.  Per block, bytes
// moved (in + out + valid) against integer operations (static SASS count
// per thread, the tile kernels' with their epilogue):
//   bc1, bc1a       8 + 64 + 1 B   197, 206
//   bc2, bc3       16 + 64 + 1 B   229, 309
//   rgtc1           8 + 16 + 1 B   127
//   signed rgtc1    8 + 32 + 1 B   298
//   rgtc2          16 + 32 + 1 B   234
//   signed rgtc2   16 + 64 + 1 B   609
// At 3.35 TB/s and 33.4 T thread-instructions/s of issue the ridge is near
// 10 instructions per byte.  At small N (one texture mip of a few hundred
// blocks) launch latency dominates.  Measured on an H100 SXM (700 W) at
// N = 1,048,576: with each thread's output written as 16 B stores at its
// 16-64 B stride across the warp, the 64 B-output variants move 1.4-2.0
// TB/s and the 16-32 B-output ones 2.4-2.9 TB/s.
//
// bc1_kernel and bc23_kernel now: a CUDA block's 128 threads decode a
// tile of 128 consecutive blocks into shared memory (dtx::decode_tile:
// dtx::TileOut, 64 B rows, XOR swizzle) and store the tile's 8 KB in
// order, 512 contiguous bytes per warp store instruction.  BC1-BC3 have no
// modes, so no order.  It took bc2 from 53.3 to 31.6 us, bc3 from 61.0 to
// 31.3 us (80-81% of the 25.4 us byte bound, 2.7 TB/s) and bc1 / bc1a
// from 52.8 / 53.4 to 28.7 / 28.7 us (80% of 22.8; the texture path's
// blocks and their row-shuffled copy alike); a 256-block tile ran each 1-
// 1.5 us slower (CUDA events, chip_smoke.py "mode batches"; NVIDIA H100
// 80GB HBM3, 700.00 W).  What bounds them now: DRAM, written at 2.6-2.7
// TB/s as etc1's tile and BC6H's one-mode batches are (the plain-copy
// interleave kernels reach 2.9).  The RGTC kernels still write per thread
// (dtx::store_words).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc.cuh"

namespace {

using dtx::grid;
using dtx::kThreads;
using dtx::store_words;

constexpr int kRounds = 1;  // blocks per thread of bc1_kernel and
                            // bc23_kernel: a tile of 128
constexpr int kTile = kThreads * kRounds;

template <bool kAlpha>
__global__ void __launch_bounds__(kThreads)
    bc1_kernel(const uint2* __restrict__ words, long long n, uint32_t flags,
               uint4* __restrict__ pixels, bool* __restrict__ valid) {
  dtx::decode_tile<16, kRounds>(
      words, n, pixels, valid, [&](const uint2& w, uint32_t* out) {
        return dtx::bc1_decode_block<kAlpha>(w.x, w.y, flags, out);
      });
}

template <bool kBC3>
__global__ void __launch_bounds__(kThreads)
    bc23_kernel(const uint4* __restrict__ words, long long n, uint32_t flags,
                uint4* __restrict__ pixels, bool* __restrict__ valid) {
  dtx::decode_tile<16, kRounds>(
      words, n, pixels, valid, [&](const uint4& w, uint32_t* out) {
        return dtx::bc23_decode_block<kBC3>(w.x, w.y, w.z, w.w, flags, out);
      });
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
  kernel<<<grid(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
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
  kernel<<<grid(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
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
