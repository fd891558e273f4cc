// Host build of the ALU mix probe's chain in mix_probe.cuh, for tests that
// run the kernel's own arithmetic on a CPU.  Build:
//   g++ -std=c++17 -O1 -shared -fPIC -o libmix_probe_host.so mix_probe_host.cpp
// Nothing on the main path uses it.

#include <stdint.h>

#include "mix_probe.cuh"
#include "mix_sched.h"

// x: (n, 4) int32; out: (n,) int32; family as dtx_mix_probe.  Returns 0,
// or -1 for an unknown family.
extern "C" int dtx_mix_probe_host(const uint32_t* x, long long n, int family,
                                  uint32_t* out) {
  switch (family) {
#define DTX_RUN(index, sched)                                           \
  case index:                                                           \
    for (long long i = 0; i < n; ++i) {                                 \
      const uint32_t* w = x + 4 * i;                                    \
      out[i] = dtx::mix_block<dtx::sched>(w[0], w[1], w[2], w[3]);      \
    }                                                                   \
    return 0;
    DTX_MIX_SCHEDULES(DTX_RUN)
#undef DTX_RUN
    default:
      return -1;
  }
}
