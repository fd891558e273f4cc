// BC6H (BPTC_FLOAT and BPTC_SIGNED_FLOAT) block decode for Hopper (sm_90a):
// one kernel, one thread per 4x4 block.  bc6h.cuh holds the per-block
// decode; the kernel computes what its TPU kernel computes, bit for bit:
//
//   bc6h_kernel<S>  replaces detex_tpu/ops/pallas/bptc_float_pallas.py
//                   _bc6h_kernel (L128)   BPTC_FLOAT (S false), signed (true)
//
// The TPU body decoded all 14 modes per lane and chose by select trees;
// here each thread loads its block as one 16 B vector, takes its mode's
// field scatter through a switch and runs the endpoint and pixel
// arithmetic once in registers.
//
// What bounds it on this card: per block 16 B in, 128 B out and 1 B valid,
// 45.4 us of HBM time at N = 1,048,576.  The static SASS count over every
// mode's case is 1,486 (unsigned) / 1,886 (signed) integer instructions per
// thread in the first design.  That design wrote each thread's 128 B as
// eight 16 B stores at a 128 B stride across the warp (each store
// instruction touching 32 lines) and took 190-197 us on an H100 SXM (700
// W), a mode-sorted batch 4% longer.
//
// This design (dtx::decode_tile's ordered form, which etc_eac.cu's ETC2
// kernels share): a CUDA block's 128 threads take a tile of 128 consecutive
// blocks, order them by mode (dtx::order_rows; a reserved code with mode
// 0, whose fields it decodes) and decode them in that order into shared
// memory (dtx::TileOut: 128 B rows, XOR swizzle, 16 KB and 128 B of valid
// flags); after a __syncthreads() the tile's 16 KB leave in order, each
// warp store instruction covering 512 contiguous bytes.  With the stores
// coalesced, a warp's mix of modes became the cost: without the order the
// mixed batch took 78.6 / 93.6 us against 56.5 / 65.9 us for one-mode
// batches; with it 63.0 / 79.5 us (chip_smoke.py's "mode batches" phase).
// A 256-block tile (two blocks per thread) ran the mixed batch in 66.5 /
// 76.6 us, so the tile stays at 128.  What bounds it now: one-mode batches
// take 57 us unsigned (80% of the byte time) and 64-70 us signed, which
// issues more (2,010 static integer instructions per thread against
// 1,560); the mode mix adds 11% / 16% on mixed batches.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc6h.cuh"

namespace {

using dtx::grid;
using dtx::kThreads;

constexpr int kRounds = 1;  // blocks per thread: a tile of 128

// A CUDA block's 128 threads decode a tile of 128 * kRounds consecutive
// blocks into shared memory and store the tile in order.  The tile's blocks
// are first ordered by mode (dtx::order_rows; reserved codes with mode 0,
// whose fields they decode) and decoded in that order.
template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
    bc6h_kernel(const uint4* __restrict__ words, long long n,
                uint32_t mode_mask, uint4* __restrict__ pixels,
                bool* __restrict__ valid) {
  dtx::decode_tile<32, kRounds, 14>(
      words, n, pixels, valid,
      [&](const uint4& w, uint32_t* out) {
        return dtx::bc6h_decode_block<kSigned>(w.x, w.y, w.z, w.w, mode_mask,
                                               out);
      },
      [](const uint4& w) {
        const int mode = dtx::bc6h_mode(w.x);
        return mode < 0 ? 0u : (uint32_t)mode;
      });
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
  kernel<<<grid(n, kThreads * kRounds), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, mode_mask,
      static_cast<uint4*>(pixels), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
