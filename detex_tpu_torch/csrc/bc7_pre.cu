// BC7 decode with pre-gathered partition words, for Hopper (sm_90a): one
// thread per 4x4 block.
//
// Replaces tools/mxu_probe.py:_bc7_kernel_pre (L107), reached through
// decode_mxu (L312/322): BC7, bit for bit, except that each block's subset
// word and anchor positions come from an extra (N, 2) input [sub32, pos]
// (gathered ahead of the kernel by a one-hot matrix product,
// detex_tpu_torch/tools/mxu_probe.py:pregather) and not from the partition
// tables.  The per-block decode is bc7.cuh's, with PreGatheredPartition in
// place of TablePartition, so the two kernels share one source.
//
// On the TPU the experiment asked whether the otherwise idle matrix unit
// could take the three partition/anchor select trees off the vector unit.
// Here the production kernel reads the 768 B of tables through L1 in two
// loads, so the question becomes whether 8 B more of input per block
// (24 B in, 65 B out) costs less than those two dependent loads.
//
// What bounds it on this card: as bc7.cu, integer work per block at large
// N (the decode's arithmetic is unchanged) and launch latency at small N.
//
// Input (N, 4) int32 words (one 16 B load per thread) and (N, 2) int32
// pre-gathered words (one 8 B load).  Output (N, 16) packed RGBA8 as four
// 16 B stores per thread, plus (N,) bool valid.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc7.cuh"

namespace {

using dtx::kThreads;

__global__ void __launch_bounds__(kThreads)
    bc7_pre_kernel(const uint4* __restrict__ words,
                   const uint2* __restrict__ pre, long long n,
                   uint32_t mode_mask, uint32_t flags,
                   uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = words[i];
  const uint2 p = pre[i];
  const uint64_t lo = (uint64_t)w.x | ((uint64_t)w.y << 32);
  const uint64_t hi = (uint64_t)w.z | ((uint64_t)w.w << 32);
  uint32_t out[16];
  const bool ok = dtx::bc7_decode_block(lo, hi, mode_mask, flags, out,
                                        dtx::PreGatheredPartition{p.x, p.y});
  dtx::store_words<16>(pixels + 4 * i, out);
  valid[i] = ok;
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
  bc7_pre_kernel<<<dtx::grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), static_cast<const uint2*>(pre), n,
      mode_mask, flags, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
