// BC7 (BPTC) block decode for Hopper (sm_90a).
//
// Replaces detex_tpu/ops/pallas/bptc_pallas.py:_bc7_kernel (L240), with the
// same function bit for bit (bc7.cuh holds the per-block decode and the
// kernel body).  The TPU kernel's layout (blocks on (sublane, lane), select
// trees in place of table gathers, SWAR interpolation) answered the TPU's
// vector unit; here a thread decodes a block in scalar registers and reads
// the partition and anchor tables (768 B) from read-only global memory
// through L1.
//
// What bounds it on this card.  A block moves 16 B in, 64 B of pixels and
// 1 B of valid out: 25.4 us of HBM time at N = 1,048,576.  The first
// design (one generic decode: every per-mode constant a run-time nibble,
// every field a funnel shift at a run-time position) compiled to 2,236
// integer instructions per thread; on an H100 SXM (700 W) it took 131 us
// on blocks of mixed modes and 98-110 us on one-mode batches, its four
// 16 B stores per thread 64 B apart across the warp.  A decode specialised
// whole per mode (8 inlined bodies) ran one-mode batches in 43-59 us but
// mixed ones in 120 us even with a tile's blocks ordered by mode (547-872
// us without): a warp that spans two modes issues both bodies.
//
// This design:
//   * bc7.cuh's decode is a short per-mode unpack (bc7_unpack<M>, its
//     constants folded) and one pixel loop for every mode (bc7_pixels),
//     so a warp of mixed modes diverges only in the unpack;
//   * one CUDA block of 128 threads takes a tile of kTile = 256
//     consecutive blocks (2 per thread), orders them by mode
//     (dtx::order_rows) and decodes them in that order, so a warp mostly
//     unpacks one mode;
//   * the pixels are staged in shared memory (dtx::TileOut: 64 B rows, XOR
//     swizzle) and leave as the tile's contiguous 16 KB, each warp store
//     instruction covering 512 B.
// Shared memory per CUDA block: words 4 KB, pixels 16 KB and 256 B of
// valid flags, mode order 512 B.  The tile size was chosen on the card (an
// H100 SXM at 700 W, device time on 1,048,576 blocks of mixed modes): 56
// us at 256 blocks, 59 us at 128 and at 512, 82 us at 256 without the mode
// order.  What bounds it now: mixed batches take 57 us and one-mode
// batches 50-56 us, twice the byte time, so neither its stores nor its
// mode mix (7%) but the decode's own instructions and their latency, at 56
// registers and 21 KB of shared memory per CUDA block.  At the control
// step's 256 blocks one CUDA block runs; the call (0.02-0.05 ms) is
// host-bound.
//
// Input (N, 4) int32 words; output (N, 16) packed RGBA8 and (N,) bool
// valid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc7.cuh"

namespace {

using dtx::kThreads;

constexpr int kRounds = 2;  // blocks per thread: a tile of 256
constexpr int kTile = kThreads * kRounds;

__global__ void __launch_bounds__(kThreads)
    bc7_kernel(const uint4* __restrict__ words, long long n,
               uint32_t mode_mask, uint32_t flags, uint4* __restrict__ pixels,
               bool* __restrict__ valid) {
  dtx::bc7_tile<kRounds, false>(words, nullptr, n, mode_mask, flags, pixels,
                                valid);
}

}  // namespace

// words: (n, 4) int32, 16 B aligned; pixels: (n, 16) int32, 16 B aligned;
// valid: (n,) bool.  Launches on `stream` and returns cudaGetLastError().
extern "C" int dtx_bc7_decode(const void* words, long long n,
                              unsigned int mode_mask, unsigned int flags,
                              void* pixels, void* valid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  bc7_kernel<<<dtx::grid(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, mode_mask, flags,
      static_cast<uint4*>(pixels), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
