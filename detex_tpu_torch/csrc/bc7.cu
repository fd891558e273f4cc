// BC7 (BPTC) block decode for Hopper (sm_90a): one thread per 4x4 block.
//
// Replaces detex_tpu/ops/pallas/bptc_pallas.py:_bc7_kernel (L240), with the
// same function bit for bit (bc7.cuh holds the per-block decode).  The TPU
// kernel's layout (blocks on (sublane, lane), select trees in place of
// table gathers, SWAR interpolation) answered the TPU's vector unit; here a
// thread decodes one block in scalar registers and reads the partition and
// anchor tables (768 B) from read-only global memory through L1.
//
// What bounds it on this card: integer ALU work per block at large N (about
// a thousand integer operations per block against 80 B of traffic), and
// launch latency at the control step's 256 blocks, which fill two of the
// 132 SMs.
//
// Input (N, 4) int32 words, one 16 B vector load per thread (coalesced).
// Output (N, 16) packed RGBA8 as four 16 B stores per thread, plus (N,)
// bool valid.
//
// Left for later work:
//   * coalesced stores through shared memory: a thread's 64 B of output
//     lie at a 64 B stride across the warp, so each store instruction
//     fills half of every 32 B sector it touches;
//   * writing the linear (H, W) image straight from the kernel; on the TPU
//     that took a separate relayout (detex_tpu/mpc/runtime.py:45-60);
//   * warp divergence when one warp holds blocks of several modes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bc7.cuh"

namespace {

using dtx::kThreads;

__global__ void __launch_bounds__(kThreads)
    bc7_kernel(const uint4* __restrict__ words, long long n,
               uint32_t mode_mask, uint32_t flags, uint4* __restrict__ pixels,
               bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = words[i];
  const uint64_t lo = (uint64_t)w.x | ((uint64_t)w.y << 32);
  const uint64_t hi = (uint64_t)w.z | ((uint64_t)w.w << 32);
  uint32_t out[16];
  const bool ok = dtx::bc7_decode_block(lo, hi, mode_mask, flags, out);
  dtx::store_words<16>(pixels + 4 * i, out);
  valid[i] = ok;
}

}  // namespace

// words: (n, 4) int32, 16 B aligned; pixels: (n, 16) int32, 16 B aligned;
// valid: (n,) bool.  Launches on `stream` and returns cudaGetLastError().
extern "C" int dtx_bc7_decode(const void* words, long long n,
                              unsigned int mode_mask, unsigned int flags,
                              void* pixels, void* valid, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  bc7_kernel<<<dtx::grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, mode_mask, flags,
      static_cast<uint4*>(pixels), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
