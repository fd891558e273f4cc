// Host build of the BC7 per-block decode in bc7.cuh, for tests that run the
// kernel's own arithmetic on a CPU.  Build:
//   g++ -std=c++17 -O2 -shared -fPIC -o libbc7_host.so bc7_host.cpp
// Nothing on the main path uses it.

#include <stdint.h>

#include "bc7.cuh"

extern "C" void dtx_bc7_decode_host(const uint32_t* words, long long n,
                                    uint32_t mode_mask, uint32_t flags,
                                    uint32_t* pixels, uint8_t* valid) {
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 4 * i;
    const uint64_t lo = (uint64_t)w[0] | ((uint64_t)w[1] << 32);
    const uint64_t hi = (uint64_t)w[2] | ((uint64_t)w[3] << 32);
    valid[i] = dtx::bc7_decode_block(lo, hi, mode_mask, flags,
                                     pixels + 16 * i)
                   ? 1
                   : 0;
  }
}
