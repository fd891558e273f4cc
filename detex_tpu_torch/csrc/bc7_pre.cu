// BC7 decode with pre-gathered partition words, for Hopper (sm_90a).
//
// Replaces tools/mxu_probe.py:_bc7_kernel_pre (L107), reached through
// decode_mxu (L312/322): BC7, bit for bit, except that each block's subset
// word and anchor positions come from an extra (N, 2) input [sub32, pos]
// (gathered ahead of the kernel by a one-hot matrix product,
// detex_tpu_torch/tools/mxu_probe.py:pregather) and not from the partition
// tables.  The kernel body is bc7.cuh's bc7_tile, the production kernel's,
// with PreGatheredPartition in place of TablePartition, so the two kernels
// share one source and one design.
//
// On the TPU the experiment asked whether the otherwise idle matrix unit
// could take the three partition/anchor select trees off the vector unit.
// Here the production kernel reads the 768 B of tables through L1 in two
// loads, so the question becomes whether 8 B more of input per block
// (24 B in, 65 B out) costs less than those two dependent loads.
//
// What bounds it on this card: as bc7.cu, whose note gives the design (a
// short per-mode unpack and one pixel loop, a 256-block tile per CUDA
// block ordered by mode, pixels stored from shared memory in order); the
// pre-gathered words are loaded into the tile beside the block words (2 KB
// more shared memory), and with any anchors bc7.cuh builds the index
// stream pixel by pixel where they are not distinct and past pixel 0.
//
// Input (N, 4) int32 words and (N, 2) int32 pre-gathered words.  Output
// (N, 16) packed RGBA8 and (N,) bool valid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc7.cuh"

namespace {

using dtx::kThreads;

constexpr int kRounds = 2;  // blocks per thread: a tile of 256, as bc7.cu

__global__ void __launch_bounds__(kThreads)
    bc7_pre_kernel(const uint4* __restrict__ words,
                   const uint2* __restrict__ pre, long long n,
                   uint32_t mode_mask, uint32_t flags,
                   uint4* __restrict__ pixels, bool* __restrict__ valid) {
  dtx::bc7_tile<kRounds, true>(words, pre, n, mode_mask, flags, pixels,
                               valid);
}

}  // namespace

// words: (n, 4) int32, 16 B aligned; pre: (n, 2) int32, 8 B aligned;
// pixels: (n, 16) int32, 16 B aligned; valid: (n,) bool.  Launches on
// `stream` and returns cudaGetLastError().
extern "C" int dtx_bc7_pre_decode(const void* words, const void* pre,
                                  long long n, unsigned int mode_mask,
                                  unsigned int flags, void* pixels,
                                  void* valid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  bc7_pre_kernel<<<dtx::grid(n, kThreads * kRounds), kThreads, 0,
                   (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), static_cast<const uint2*>(pre), n,
      mode_mask, flags, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
