// The ALU mix probe for Hopper (sm_90a): one thread per block of four
// int32 words, one instantiation per census family.
//
// Replaces tools/profile_sections.py:_mix_probe_kernel (L186, inner kernel
// L201, launched by `call` L225/229): a synthetic int32 chain whose op mix
// is a decode kernel's census (mix_probe.cuh has the chain, mix_sched.h the
// schedules).  Each step's class and constant are immediates, so the
// kernel body is the schedule as straight-line code.
//
// The census is the TPU kernel's: its select-tree op count, per block, by
// class.  The CUDA decoders branch and execute fewer operations, so the
// probe's rate says how fast this card runs the TPU kernel's op mix; it is
// not a roofline share of a CUDA kernel.
//
// What bounds it on this card: integer operations.  A block reads 16 B and
// writes 4 B against 367-2,245 dependent-in-fours int32 steps; with four
// independent chains per thread and many warps per SM, the ALU pipes, not
// the latency of one chain, should set the rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mix_probe.cuh"
#include "mix_sched.h"

namespace {

using dtx::kThreads;

template <class Sched>
__global__ void __launch_bounds__(kThreads)
    mix_probe_kernel(const uint4* __restrict__ x, long long n,
                     uint32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint4 w = x[i];
  out[i] = dtx::mix_block<Sched>(w.x, w.y, w.z, w.w);
}

}  // namespace

// x: (n, 4) int32, 16 B aligned; out: (n,) int32; family: the index of the
// schedule in mix_sched.h (DTX_MIX_SCHEDULES).  Launches on `stream` and
// returns cudaGetLastError(); an unknown family is cudaErrorInvalidValue.
extern "C" int dtx_mix_probe(const void* x, long long n, int family,
                             void* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const auto* in = static_cast<const uint4*>(x);
  auto* o = static_cast<uint32_t*>(out);
  switch (family) {
#define DTX_LAUNCH(index, sched)                                           \
  case index:                                                              \
    mix_probe_kernel<dtx::sched>                                           \
        <<<dtx::grid(n), kThreads, 0, (cudaStream_t)stream>>>(in, n, o);   \
    break;
    DTX_MIX_SCHEDULES(DTX_LAUNCH)
#undef DTX_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
