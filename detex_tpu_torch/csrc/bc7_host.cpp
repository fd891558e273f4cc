// Host build of the BC7 per-block decode in bc7.cuh, for tests that run the
// kernels' own arithmetic on a CPU: dtx_bc7_decode_host as bc7.cu's kernel
// (partition tables) and dtx_bc7_pre_decode_host as bc7_pre.cu's
// (pre-gathered partition words).  Build:
//   g++ -std=c++17 -O2 -shared -fPIC -o libbc7_host.so bc7_host.cpp
// Nothing on the main path uses it.

#include <stdint.h>

#include "bc7.cuh"

namespace {

void load(const uint32_t* w, uint64_t& lo, uint64_t& hi) {
  lo = (uint64_t)w[0] | ((uint64_t)w[1] << 32);
  hi = (uint64_t)w[2] | ((uint64_t)w[3] << 32);
}

}  // namespace

extern "C" void dtx_bc7_decode_host(const uint32_t* words, long long n,
                                    uint32_t mode_mask, uint32_t flags,
                                    uint32_t* pixels, uint8_t* valid) {
  for (long long i = 0; i < n; ++i) {
    uint64_t lo, hi;
    load(words + 4 * i, lo, hi);
    valid[i] = dtx::bc7_decode_block(lo, hi, mode_mask, flags,
                                     pixels + 16 * i)
                   ? 1
                   : 0;
  }
}

// pre: (n, 2) words [sub32, pos] per block.
extern "C" void dtx_bc7_pre_decode_host(const uint32_t* words,
                                        const uint32_t* pre, long long n,
                                        uint32_t mode_mask, uint32_t flags,
                                        uint32_t* pixels, uint8_t* valid) {
  for (long long i = 0; i < n; ++i) {
    uint64_t lo, hi;
    load(words + 4 * i, lo, hi);
    const dtx::PreGatheredPartition part{pre[2 * i], pre[2 * i + 1]};
    valid[i] = dtx::bc7_decode_block(lo, hi, mode_mask, flags,
                                     pixels + 16 * i, part)
                   ? 1
                   : 0;
  }
}
