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
// its block as one 8 or 16 B vector (coalesced) and decodes it in
// registers (the colour block's mode through a switch).
//
// What bounds them on this card: per block, bytes moved (in + out + valid)
// against integer operations (static SASS count per thread, the tile
// kernels' with their epilogue):
//   etc1                 8 + 64 + 1 B    423 (one code path)
//   etc2, etc2_pt        8 + 64 + 1 B    861, 1,118 (three paths by mode)
//   etc2_eac            16 + 64 + 1 B    991 (963 writing per thread)
//   eac r11 (signed)     8 + 32 + 1 B    253 (333)
//   eac rg11 (signed)   16 + 64 + 1 B    538 (688)
// At 3.35 TB/s and 33.4 T thread-instructions/s of issue the ridge is near
// 10 instructions per byte, so all are bound by their bytes: 22.8 us at
// N = 1,048,576 for the 73 B colour blocks.  The first design wrote each
// thread's 64 B as four 16 B stores, 64 B apart across the warp; on an
// H100 SXM (700 W) the colour kernels took 49-60 us (38-47% of the bound)
// and etc1 (one path) ran slowest: where a warp's blocks took different
// paths its stores spread out (etc2's row-shuffled batch 39.6 us, its
// sorted one 51.9).
//
// etc_kernel now: a CUDA block's 128 threads decode a tile of 128
// consecutive blocks into shared memory (dtx::decode_tile: dtx::TileOut,
// 64 B rows, XOR swizzle, 8 KB and 128 B of valid flags), and after a
// __syncthreads() the tile's 8 KB leave in order, 512 contiguous bytes per
// warp store instruction.  With the stores coalesced, a warp's mix of
// modes became etc2's and punchthrough's cost (row-shuffled batch 44.3 /
// 58.8 us against 29.3 / 31.4 sorted), so their tiles are decoded in mode
// order (dtx::order_rows, as bc6h.cu): 32.2 / 40.7 us shuffled.  ETC1's
// shuffled and sorted batches differ by 1% and the order cost it 0.7 us,
// so its tile stays in place.  A 256-block tile ran etc1 and etc2 1-2 us
// slower and punchthrough 1.9 us faster (texture blocks); capping the
// registers at 40 or 32 (launch bounds) made punchthrough spill.  On the
// texture path's blocks (chip_smoke.py "mode batches", CUDA events; H100
// SXM, 700 W): etc1 29.0 us (79% of the byte bound, 2.6 TB/s), etc2 31.3
// (73%), etc2_pt 36.3 (63%); one-mode batches 28.6-32.1 us, but
// punchthrough's differential mode (opaque or not) 34.6.  What bounds them
// now: DRAM, which etc1 writes at 2.6 TB/s as bc.cu's bc23_kernel (2.7)
// and BC6H's one-mode batches do (the plain-copy interleave kernels reach
// 2.9); for etc2 and punchthrough also the warps that straddle two modes
// of a tile.
//
// eac_rg11_kernel (both signs) takes the same in-place tile of 128: 58.4 ->
// 34.2 us (74% of its 25.4 us byte bound) and signed 56.4 -> 41.0 us (62%),
// the texture path's blocks and their row-shuffled copy alike (CUDA
// events; NVIDIA H100 80GB HBM3, 700.00 W).  What holds the signed one is
// its decode's integer work: decoded alone, with no pixel stores, it takes
// 33.0 us (unsigned 24.6), near its 521 non-IMAD integer instructions per
// thread over the SMs' 64 INT32 lanes a clock (31.2 us; unsigned 399,
// 23.9), while the tile's stores alone take 32.0 us.  A 256-block tile ran
// the signed kernel 0.6-0.8 us faster and the unsigned one no faster, and
// four tiles per CUDA block, the next one's words loaded ahead, ran both
// 1.5 us slower, so both signs keep the tile of 128.
//
// etc2_eac_kernel takes etc2's ordered tile of 128, keyed by its colour
// word (w.z), and draws each alpha pixel from the block's 8 alpha values,
// computed once (eac_alpha_palette) and looked up with one PRMT
// (dtx::with_palette_byte3): 52.4 -> 35.4 us on the texture path's blocks
// (72% of its 25.4 us byte bound), row-shuffled 48.6 -> 38.4, sorted 55.2
// -> 33.1 (CUDA events; NVIDIA H100 80GB HBM3, 700.00 W).  In place, the
// shuffled batch took 50.8 us; with eac_channel's per-pixel alpha rule the
// ordered tile took 37.0.  What holds it: decoded alone, with no pixel
// stores, it takes 28.1 us (per-pixel alpha 30.7), the tile's stores alone
// 31.8, and the two overlap to 35.4; the shuffled batch's extra 3 us over
// the texture path's is the warps that straddle two colour paths.
//
// eac_r11_kernel still writes per thread (dtx::store_words).

#include <cuda_runtime.h>
#include <stdint.h>

#include "etc_eac.cuh"

namespace {

using dtx::grid;
using dtx::kThreads;
using dtx::store_words;

constexpr int kRounds = 1;  // blocks per thread of the tile kernels: a
                            // tile of 128
constexpr int kTile = kThreads * kRounds;

// ETC1 decodes its tile in order; ETC2 and punchthrough, whose modes take
// three code paths, decode theirs ordered by mode.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
    etc_kernel(const uint2* __restrict__ words, long long n,
               uint32_t mode_mask, uint32_t flags,
               uint4* __restrict__ pixels, bool* __restrict__ valid) {
  const auto decode = [&](const uint2& w, uint32_t* out) {
    return dtx::etc_decode_block<kKind>(w.x, w.y, mode_mask, flags, out);
  };
  if constexpr (kKind == dtx::kEtc1) {
    dtx::decode_tile<16, kRounds>(words, n, pixels, valid, decode);
  } else {
    dtx::decode_tile<16, kRounds, 5>(
        words, n, pixels, valid, decode,
        [](const uint2& w) { return (uint32_t)dtx::etc_mode<kKind>(w.x); });
  }
}

// ETC2_EAC decodes its tile ordered by the colour block's mode: the colour
// words are (w.z, w.w), the alpha words (w.x, w.y).
__global__ void __launch_bounds__(kThreads)
    etc2_eac_kernel(const uint4* __restrict__ words, long long n,
                    uint32_t mode_mask, uint32_t flags,
                    uint4* __restrict__ pixels, bool* __restrict__ valid) {
  dtx::decode_tile<16, kRounds, 5>(
      words, n, pixels, valid,
      [&](const uint4& w, uint32_t* out) {
        return dtx::etc2_eac_decode_block(w.x, w.y, w.z, w.w, mode_mask,
                                          flags, out);
      },
      [](const uint4& w) { return (uint32_t)dtx::etc_mode<dtx::kEtc2>(w.z); });
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
  dtx::decode_tile<16, kRounds>(
      words, n, pixels, valid, [](const uint4& w, uint32_t* out) {
        return dtx::eac_rg11_decode_block<kSigned>(w.x, w.y, w.z, w.w, out);
      });
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
  kernel<<<grid(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
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
  etc2_eac_kernel<<<grid(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
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
  kernel<<<grid(n, kTile), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint4*>(words), n, static_cast<uint4*>(pixels),
      static_cast<bool*>(valid));
  return (int)cudaGetLastError();
}
