// ETC1, ETC2, ETC2 punchthrough, ETC2_EAC and EAC R11/RG11 (signed and
// unsigned) block decode for Hopper (sm_90a): four kernels, one thread per
// 4x4 block.  etc_eac.cuh holds the per-block decode; each kernel computes
// what its TPU kernel in detex_tpu/ops/pallas/etc_eac_pallas.py computes,
// bit for bit:
//
//   etc_kernel<Kind>     replaces _etc1_kernel    (L490)  ETC1
//                                 _etc2_kernel    (L509)  ETC2
//                                 _etc2_pt_kernel (L518)  ETC2_PUNCHTHROUGH
//   etc2_eac_kernel      replaces _etc2_eac_kernel (L533) ETC2_EAC
//   eac_r11_kernel<S>    replaces _eac_r11_kernel (L546)  EAC_(SIGNED_)R11
//   eac_rg11_kernel<S>   replaces _eac_rg11_kernel (L559) EAC_(SIGNED_)RG11
//
// The six TPU bodies shared one pallas_call (L593) and laid blocks out on
// (sublane, lane) with SWAR lanes and select trees; here each thread loads
// its block as one 8 or 16 B vector (coalesced), decodes it in registers
// (the colour block's mode through a switch) and writes its payload as
// 16 B vector stores.
//
// What bounds them on this card: per block, bytes moved (in + out + valid)
// against integer operations (counted from the source, about):
//   etc1                 8 + 64 + 1 B   ~250 ops
//   etc2, etc2_pt        8 + 64 + 1 B   ~250-350 ops (by mode)
//   etc2_eac            16 + 64 + 1 B   ~450 ops
//   eac r11 (signed)     8 + 32 + 1 B   ~200 (~260) ops
//   eac rg11 (signed)   16 + 64 + 1 B   ~400 (~520) ops
// At 3.35 TB/s and roughly 17 Tops/s of 32-bit integer throughput the
// ridge is near 5 operations per byte, so the ETC2 variants, whose warps
// also split over the modes of their blocks, were expected to be bound by
// integer work.  Measured on an H100 SXM (700 W) at N = 1,048,576 blocks
// of mixed modes, they are not: the 64 B-output variants run in 47-58 us
// (1.3-1.7 TB/s, as bc.cu's 64 B-output ones), EAC R11 in 17-19 us
// (2.2-2.5 TB/s), so the scattered stores cap them all.
//
// Left for later work: coalesced stores through shared memory (a thread's
// 32-64 B lie at that stride across the warp, as in bc.cu); mode-sorted
// batches against warp divergence on mixed-mode textures.

#include <cuda_runtime.h>
#include <stdint.h>

#include "etc_eac.cuh"

namespace {

using dtx::grid;
using dtx::kThreads;
using dtx::store_words;

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    etc_kernel(const uint2* __restrict__ words, long long n,
               uint32_t mode_mask, uint32_t flags,
               uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint2 w = words[i];
  uint32_t out[16];
  const bool ok = dtx::etc_decode_block<kKind>(w.x, w.y, mode_mask, flags,
                                               out);
  store_words<16>(pixels + 4 * i, out);
  valid[i] = ok;
}

__global__ void __launch_bounds__(kThreads)
    etc2_eac_kernel(const uint4* __restrict__ words, long long n,
                    uint32_t mode_mask, uint32_t flags,
                    uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = words[i];
  uint32_t out[16];
  const bool ok = dtx::etc2_eac_decode_block(w.x, w.y, w.z, w.w, mode_mask,
                                             flags, out);
  store_words<16>(pixels + 4 * i, out);
  valid[i] = ok;
}

template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
    eac_r11_kernel(const uint2* __restrict__ words, long long n,
                   uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint2 w = words[i];
  uint32_t out[8];
  const bool ok = dtx::eac_r11_decode_block<kSigned>(w.x, w.y, out);
  store_words<8>(pixels + 2 * i, out);
  valid[i] = ok;
}

template <bool kSigned>
__global__ void __launch_bounds__(kThreads)
    eac_rg11_kernel(const uint4* __restrict__ words, long long n,
                    uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = words[i];
  uint32_t out[16];
  const bool ok = dtx::eac_rg11_decode_block<kSigned>(w.x, w.y, w.z, w.w,
                                                      out);
  store_words<16>(pixels + 4 * i, out);
  valid[i] = ok;
}

}  // namespace

// Every entry point: words (n, 2) or (n, 4) int32, 8 or 16 B aligned;
// pixels (n, words out) int32, 16 B aligned; valid (n,) bool.  `variant`
// picks the instantiation: for etc, 0 ETC1, 1 ETC2, 2 ETC2 punchthrough;
// for the EAC 11-bit kernels, signed when nonzero (they ignore mode_mask
// and flags); etc2_eac has one.  Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for an unknown variant.

extern "C" int dtx_etc_decode(const void* words, long long n,
                              unsigned int mode_mask, unsigned int flags,
                              int variant, void* pixels, void* valid,
                              void* stream) {
  if (variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant == 0   ? etc_kernel<dtx::kEtc1>
                : variant == 1 ? etc_kernel<dtx::kEtc2>
                               : etc_kernel<dtx::kEtc2Pt>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint2*>(words), n, mode_mask, flags,
      static_cast<uint4*>(pixels), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

extern "C" int dtx_etc2_eac_decode(const void* words, long long n,
                                   unsigned int mode_mask, unsigned int flags,
                                   int variant, void* pixels, void* valid,
                                   void* stream) {
  if (variant != 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaSuccess;
  etc2_eac_kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, mode_mask, flags,
      static_cast<uint4*>(pixels), static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

extern "C" int dtx_eac_r11_decode(const void* words, long long n,
                                  unsigned int mode_mask, unsigned int flags,
                                  int variant, void* pixels, void* valid,
                                  void* stream) {
  (void)mode_mask;
  (void)flags;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant ? eac_r11_kernel<true> : eac_r11_kernel<false>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint2*>(words), n, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}

extern "C" int dtx_eac_rg11_decode(const void* words, long long n,
                                   unsigned int mode_mask, unsigned int flags,
                                   int variant, void* pixels, void* valid,
                                   void* stream) {
  (void)mode_mask;
  (void)flags;
  if (n <= 0) return (int)cudaSuccess;
  auto kernel = variant ? eac_rg11_kernel<true> : eac_rg11_kernel<false>;
  kernel<<<grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
