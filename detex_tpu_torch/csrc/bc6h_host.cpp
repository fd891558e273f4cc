// Host build of the per-block decode in bc6h.cuh, for tests that run the
// kernel's own arithmetic on a CPU.  Build:
//   g++ -std=c++17 -O2 -shared -fPIC -o libbc6h_host.so bc6h_host.cpp
// dtx_bc6h_decode_host mirrors dtx_bc6h_decode of bc6h.cu without the
// stream (valid as one byte per block).  Nothing on the main path uses it.

#include <stdint.h>

#include "bc6h.cuh"

extern "C" {

void dtx_bc6h_decode_host(const uint32_t* words, long long n,
                          uint32_t mode_mask, uint32_t flags, int variant,
                          uint32_t* pixels, uint8_t* valid) {
  (void)flags;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 4 * i;
    uint32_t* out = pixels + 32 * i;
    valid[i] = variant ? dtx::bc6h_decode_block<true>(w[0], w[1], w[2], w[3],
                                                      mode_mask, out)
                       : dtx::bc6h_decode_block<false>(w[0], w[1], w[2],
                                                       w[3], mode_mask, out);
  }
}

}  // extern "C"
