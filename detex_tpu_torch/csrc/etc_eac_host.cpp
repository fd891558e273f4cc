// Host build of the per-block decodes in etc_eac.cuh, for tests that run
// the kernels' own arithmetic on a CPU.  Build:
//   g++ -std=c++17 -O2 -shared -fPIC -o libetc_eac_host.so etc_eac_host.cpp
// Each function mirrors the entry point of etc_eac.cu of the same name
// without `_host` (no stream; valid as one byte per block).  Nothing on
// the main path uses it.

#include <stdint.h>

#include "etc_eac.cuh"

extern "C" {

void dtx_etc_decode_host(const uint32_t* words, long long n,
                         uint32_t mode_mask, uint32_t flags, int variant,
                         uint32_t* pixels, uint8_t* valid) {
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 2 * i;
    uint32_t* out = pixels + 16 * i;
    valid[i] =
        variant == 0
            ? dtx::etc_decode_block<dtx::kEtc1>(w[0], w[1], mode_mask, flags,
                                                out)
        : variant == 1
            ? dtx::etc_decode_block<dtx::kEtc2>(w[0], w[1], mode_mask, flags,
                                                out)
            : dtx::etc_decode_block<dtx::kEtc2Pt>(w[0], w[1], mode_mask,
                                                  flags, out);
  }
}

void dtx_etc2_eac_decode_host(const uint32_t* words, long long n,
                              uint32_t mode_mask, uint32_t flags, int variant,
                              uint32_t* pixels, uint8_t* valid) {
  (void)variant;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 4 * i;
    valid[i] = dtx::etc2_eac_decode_block(w[0], w[1], w[2], w[3], mode_mask,
                                          flags, pixels + 16 * i);
  }
}

void dtx_eac_r11_decode_host(const uint32_t* words, long long n,
                             uint32_t mode_mask, uint32_t flags, int variant,
                             uint32_t* pixels, uint8_t* valid) {
  (void)mode_mask;
  (void)flags;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 2 * i;
    uint32_t* out = pixels + 8 * i;
    valid[i] = variant ? dtx::eac_r11_decode_block<true>(w[0], w[1], out)
                       : dtx::eac_r11_decode_block<false>(w[0], w[1], out);
  }
}

void dtx_eac_rg11_decode_host(const uint32_t* words, long long n,
                              uint32_t mode_mask, uint32_t flags, int variant,
                              uint32_t* pixels, uint8_t* valid) {
  (void)mode_mask;
  (void)flags;
  for (long long i = 0; i < n; ++i) {
    const uint32_t* w = words + 4 * i;
    uint32_t* out = pixels + 16 * i;
    valid[i] = variant ? dtx::eac_rg11_decode_block<true>(w[0], w[1], w[2],
                                                          w[3], out)
                       : dtx::eac_rg11_decode_block<false>(w[0], w[1], w[2],
                                                           w[3], out);
  }
}

// dtx::with_palette_byte3 on n (word, lo, hi, code) quadruples.
void dtx_with_palette_byte3_host(const uint32_t* word, const uint32_t* lo,
                                 const uint32_t* hi, const uint32_t* code,
                                 long long n, uint32_t* out) {
  for (long long i = 0; i < n; ++i) {
    out[i] = dtx::with_palette_byte3(word[i], lo[i], hi[i], code[i]);
  }
}

}  // extern "C"
