// BC6H (BPTC_FLOAT and BPTC_SIGNED_FLOAT) block decode for Hopper (sm_90a):
// one kernel, one thread per 4x4 block.  bc6h.cuh holds the per-block
// decode; the kernel computes what its TPU kernel computes, bit for bit:
//
//   bc6h_kernel<S>  replaces detex_tpu/ops/pallas/bptc_float_pallas.py
//                   _bc6h_kernel (L128)   BPTC_FLOAT (S false), signed (true)
//
// The TPU body decoded all 14 modes per lane and chose by select trees;
// here each thread loads its block as one 16 B vector, takes its mode's
// field scatter through a switch, runs the endpoint and pixel arithmetic
// once in registers and writes its 128 B payload as eight 16 B stores.
//
// What bounds it on this card: per block 16 B in, 128 B out and 1 B valid,
// against roughly 600-700 integer operations (about 60 for the mode's
// field scatter, 100 for the endpoints, 30 per pixel).  At 3.35 TB/s and
// roughly 17 Tops/s of 32-bit integer throughput the ridge is near 5
// operations per byte; at about 4.5 per byte this kernel sits just below
// it, and the 64 B-output kernels of bc.cu and etc_eac.cu are capped by
// their scattered per-thread stores at 1.3-1.7 TB/s.  A warp whose blocks
// have different modes runs each mode's case in turn, but the cases are
// short (straight-line field extracts); the shared arithmetic is not
// duplicated.
//
// Left for later work: coalesced stores through shared memory (a thread's
// 128 B lie at that stride across the warp); mode-sorted batches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc6h.cuh"

namespace {

using dtx::grid;
using dtx::kThreads;
using dtx::store_words;

template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
    bc6h_kernel(const uint4* __restrict__ words, long long n,
                uint32_t mode_mask, uint4* __restrict__ pixels,
                bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = words[i];
  uint32_t out[32];
  const bool ok =
      dtx::bc6h_decode_block<kSigned>(w.x, w.y, w.z, w.w, mode_mask, out);
  store_words<32>(pixels + 8 * i, out);
  valid[i] = ok;
}

}  // namespace

// words (n, 4) int32, 16 B aligned; pixels (n, 32) int32, 16 B aligned;
// valid (n,) bool.  `variant` 0 decodes BPTC_FLOAT, 1 BPTC_SIGNED_FLOAT;
// flags is ignored, as in the JAX package.  Launches on `stream` and
// returns cudaGetLastError(), or cudaErrorInvalidValue for an unknown
// variant.
extern "C" int dtx_bc6h_decode(const void* words, long long n,
                               unsigned int mode_mask, unsigned int flags,
                               int variant, void* pixels, void* valid,
                               void* stream) {
  (void)flags;
  if (variant < 0 || variant > 1) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant ? bc6h_kernel<true> : bc6h_kernel<false>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, mode_mask,
      static_cast<uint4*>(pixels), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
