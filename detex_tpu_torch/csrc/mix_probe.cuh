// The ALU mix probe's per-block chain, shared by the CUDA kernels
// (mix_probe.cu) and a host build (mix_probe_host.cpp) that lets CPU tests
// run this exact code.
//
// Computes what tools/profile_sections.py:_mix_probe_kernel (L186, inner
// kernel L201) computes per block: four int32 accumulators start as the
// block's four words; step k of a family's schedule (mix_sched.h) works on
// acc[i], i = k & 3, with j = (k + 1) & 3, the constant
// c = (0x9E3779B1 * (k + 1)) & 0x7FFFFFFF and `alt` = bit 2 of k:
//   mul      acc[i] *= c | 1
//   addsub   acc[i] += alt ? acc[j] : c
//   shift    alt ? acc[i] << (k % 31 + 1) : acc[i] >>> (k % 31 + 1)
//            (a logical right shift)
//   logical  acc[i] ^= alt ? acc[j] : c
//   cmpsel   acc[i] = alt ? (acc[i] > acc[j] ? acc[i] : acc[j])
//                         : max(acc[i], c)          (signed compares)
// with int32 wrap-around; the result is acc0 ^ acc1 ^ acc2 ^ acc3.
//
// Each step is a template on its index and class, so its class, constant
// and shift are immediates and the schedule expands at compile time into
// straight-line code (a fold over std::make_integer_sequence): no loop and
// no op-code table is executed, only the op mix.
//
// The chain itself is degenerate: within about 40 steps every accumulator
// stops depending on the input (logical shifts and max with large
// constants), so the result is nearly constant.  The TPU compiler ran every
// op anyway; nvcc folds what it can prove (BC7's 2,245 steps to 7
// instructions).  So each step's result passes through DTX_OPAQUE, an empty
// asm that the compiler must assume changed it: nothing is folded across
// steps, and the values, hence the result, stay exactly the JAX kernel's.

#pragma once

#include <stdint.h>

#include <utility>

#include "dtx_hd.cuh"

#if defined(__CUDA_ARCH__)
#define DTX_OPAQUE(v) asm("" : "+r"(v))
#else
#define DTX_OPAQUE(v) ((void)0)
#endif

namespace dtx {

enum MixClass : int { kMul = 0, kAddSub = 1, kShift = 2, kLogical = 3,
                      kCmpSel = 4 };

DTX_HD uint32_t smax(uint32_t a, uint32_t b) {
  return (int32_t)a > (int32_t)b ? a : b;
}

template <int K, int Cls>
DTX_HD void mix_step(uint32_t (&acc)[4]) {
  constexpr int i = K & 3, j = (K + 1) & 3;
  constexpr uint32_t c =
      (uint32_t)((0x9E3779B1ull * (unsigned long long)(K + 1)) & 0x7FFFFFFFull);
  constexpr bool alt = (K & 4) != 0;
  constexpr int sh = K % 31 + 1;
  if constexpr (Cls == kMul) {
    acc[i] = acc[i] * (c | 1u);
  } else if constexpr (Cls == kAddSub) {
    acc[i] = acc[i] + (alt ? acc[j] : c);
  } else if constexpr (Cls == kShift) {
    acc[i] = alt ? acc[i] << sh : acc[i] >> sh;
  } else if constexpr (Cls == kLogical) {
    acc[i] = acc[i] ^ (alt ? acc[j] : c);
  } else {
    acc[i] = smax(acc[i], alt ? acc[j] : c);
  }
  DTX_OPAQUE(acc[i]);
}

template <class Sched, int... K>
DTX_HD void mix_run(uint32_t (&acc)[4], std::integer_sequence<int, K...>) {
  (mix_step<K, Sched::kSteps[K]>(acc), ...);
}

// The chain of schedule `Sched` (a struct of mix_sched.h) on one block.
template <class Sched>
DTX_HD uint32_t mix_block(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
  uint32_t acc[4] = {w0, w1, w2, w3};
  mix_run<Sched>(acc, std::make_integer_sequence<int, Sched::kLen>{});
  return acc[0] ^ acc[1] ^ acc[2] ^ acc[3];
}

}  // namespace dtx
