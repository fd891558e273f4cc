// The lane-interleave probe's per-element functions, shared by the CUDA
// kernels (interleave.cu) and a host build (interleave_host.cpp) that lets
// CPU tests run this exact code.
//
// Computes what tools/interleave_probe.py computes on a (16, 8, L) int32
// array x, pixel p = 4 py + px of 16, sublane s of 8, lane l of L:
//   planar: out[p, s, l] = x[p, s, l] + 1           (_kernel_planar, L58)
//   rows:   out[py, s, 4 l + px] = x[4 py + px, s, l] + 1, a (4, 8, 4L)
//           array of image rows (_kernel_rows_strided L79, _kernel_rows
//           L86 with stack or repeat: one function written three ways)
// with int32 wrap-around (0x7FFFFFFF + 1 is INT32_MIN), done as uint32.

#pragma once

#include <stdint.h>

#include "dtx_hd.cuh"

namespace dtx {

DTX_HD uint32_t add1(uint32_t v) { return v + 1u; }

// Index into x of the input of output word o of rows, o over (4, 8, 4L).
DTX_HD long long rows_source(long long o, long long lanes) {
  const long long m = o % (4 * lanes);      // position in the row
  const long long row = o / (4 * lanes);    // py * 8 + s
  const long long py = row / 8, s = row % 8;
  const long long px = m & 3, l = m >> 2;
  return ((4 * py + px) * 8 + s) * lanes + l;
}

}  // namespace dtx
