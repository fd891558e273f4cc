// Host build of the lane-interleave probe's functions in interleave.cuh,
// for tests that run the kernels' own arithmetic on a CPU.  Build:
//   g++ -std=c++17 -O2 -shared -fPIC -o libinterleave_host.so interleave_host.cpp
// Nothing on the main path uses it.

#include <stdint.h>

#include "interleave.cuh"

// x, out: (16, 8, lanes) int32.
extern "C" void dtx_planar_add1_host(const uint32_t* x, long long lanes,
                                     uint32_t* out) {
  for (long long i = 0; i < 128 * lanes; ++i) out[i] = dtx::add1(x[i]);
}

// x: (16, 8, lanes) int32; out: (4, 8, 4 * lanes) int32.
extern "C" void dtx_rows_interleave_host(const uint32_t* x, long long lanes,
                                         uint32_t* out) {
  for (long long o = 0; o < 128 * lanes; ++o) {
    out[o] = dtx::add1(x[dtx::rows_source(o, lanes)]);
  }
}
