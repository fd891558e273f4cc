// Host build of the per-block decodes in bc.cuh, for tests that run the
// kernels' own arithmetic on a CPU.  Build:
//   g++ -std=c++17 -O2 -shared -fPIC -o libbc_host.so bc_host.cpp
// Each function mirrors the entry point of bc.cu of the same name without
// `_host` (no stream; valid as one byte per block).  Nothing on the main
// path uses it.

#include <stdint.h>

#include "bc.cuh"

extern "C" {

void dtx_bc1_decode_host(const uint32_t* words, long long n,
                         uint32_t mode_mask, uint32_t flags, int variant,
                         uint32_t* pixels, uint8_t* valid) {
  (void)mode_mask;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 2 * i;
    uint32_t* out = pixels + 16 * i;
    valid[i] = variant ? dtx::bc1_decode_block<true>(w[0], w[1], flags, out)
                       : dtx::bc1_decode_block<false>(w[0], w[1], flags, out);
  }
}

void dtx_bc23_decode_host(const uint32_t* words, long long n,
                          uint32_t mode_mask, uint32_t flags, int variant,
                          uint32_t* pixels, uint8_t* valid) {
  (void)mode_mask;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 4 * i;
    uint32_t* out = pixels + 16 * i;
    valid[i] = variant ? dtx::bc23_decode_block<true>(w[0], w[1], w[2], w[3],
                                                      flags, out)
                       : dtx::bc23_decode_block<false>(w[0], w[1], w[2],
                                                       w[3], flags, out);
  }
}

void dtx_rgtc1_decode_host(const uint32_t* words, long long n,
                           uint32_t mode_mask, uint32_t flags, int variant,
                           uint32_t* pixels, uint8_t* valid) {
  (void)mode_mask;
  (void)flags;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 2 * i;
    valid[i] = variant
                   ? dtx::rgtc1_decode_block<true>(w[0], w[1], pixels + 8 * i)
                   : dtx::rgtc1_decode_block<false>(w[0], w[1],
                                                    pixels + 4 * i);
  }
}

void dtx_rgtc2_decode_host(const uint32_t* words, long long n,
                           uint32_t mode_mask, uint32_t flags, int variant,
                           uint32_t* pixels, uint8_t* valid) {
  (void)mode_mask;
  (void)flags;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 4 * i;
    valid[i] = variant ? dtx::rgtc2_decode_block<true>(w[0], w[1], w[2], w[3],
                                                       pixels + 16 * i)
                       : dtx::rgtc2_decode_block<false>(w[0], w[1], w[2],
                                                        w[3], pixels + 8 * i);
  }
}

}  // extern "C"
