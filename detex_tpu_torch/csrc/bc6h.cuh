// BC6H (BPTC_FLOAT, BPTC_SIGNED_FLOAT) per-block decode, shared by the CUDA
// kernel (bc6h.cu) and a host build (bc6h_host.cpp) that lets CPU tests run
// this exact code.
//
// Computes what detex_tpu/ops/pallas/bptc_float_pallas.py:_bc6h_kernel
// computes, bit for bit, for every 128-bit input (reference semantics:
// decompress-bptc-float.c:110-644):
//   * the 2-then-5-bit mode code; a reserved code (19, 23, 27, 31) decodes
//     as mode 0 and the block is invalid;
//   * each mode's field scatter (the switch below, one case per mode, as in
//     detex_tpu/ops/bptc_float.py:_FIELDS): modes 12 and 13 read reversed
//     fields, highest memory bit to the LSB, and mode 12 has no b0[11] (the
//     reference's detexGetBits64(data0, 63, 63) computes 1 << 64 and the
//     compiled reference yields 0);
//   * delta endpoints sign-extended, added mod 2^EPB and re-sign-extended
//     when signed; unquantize to 16 bits, saturating (signed: at |x| >=
//     2^(EPB-1) - 1) and skipped at EPB 16;
//   * ((64 - w) * e0 + w * e1 + 32) >> 6, then * 31 >> 6 (unsigned) or the
//     sign-magnitude * 31 >> 5 (signed; a negative value that scales to 0
//     stays +0).
//
// The TPU kernel unrolls all 14 modes and selects by select trees, because
// Mosaic has no per-lane branches; here a thread takes its mode's case of a
// switch and does the shared arithmetic once.  The 12 endpoints are named
// members of a struct, so no array is indexed at run time.  Signed
// arithmetic is on int, right shifts of a negative value go through asr(),
// and no negative value is shifted left; no shift reaches the operand width.

#pragma once

#include <stdint.h>

#include "dtx_hd.cuh"

namespace dtx {

// The 32 two-subset partitions (bptc-tables.c:23-155, 157-188; the first
// 32 of detex_tpu/data/bptc_tables.npz P2 and anchor2): bits 0-15 the
// subset of pixel i at bit i, bits 16-19 the pixel of the second anchor.
DTX_TABLE(kBc6hSubAnc,
    0xfccccu, 0xf8888u, 0xfeeeeu, 0xfecc8u, 0xfc880u, 0xffeecu,
    0xffec8u, 0xfec80u, 0xfc800u, 0xfffecu, 0xffe80u, 0xfe800u,
    0xfffe8u, 0xfff00u, 0xffff0u, 0xff000u, 0xff710u, 0x2008eu,
    0x87100u, 0x208ceu, 0x2008cu, 0x87310u, 0x83100u, 0xf8cceu,
    0x2088cu, 0x83110u, 0x26666u, 0x2366cu, 0x817e8u, 0x80ff0u,
    0x2718eu, 0x2399cu)

// `width` (<= 16) bits of the 128-bit block (lo | hi << 64) at bit
// `start`, where start + width <= 128.
DTX_HD uint32_t bc6h_bits(uint64_t lo, uint64_t hi, uint32_t start,
                          uint32_t width) {
  uint64_t v;
  if (start >= 64) {
    v = hi >> (start - 64);
  } else if (start == 0) {
    v = lo;
  } else {
    v = (lo >> start) | (hi << (64 - start));
  }
  return (uint32_t)v & ((1u << width) - 1u);
}

// Bits first..last of the block reversed: bit `last` lands in the LSB
// (detexGetBits64Reversed, bits.h:34-47).
DTX_HD uint32_t bc6h_rbits(uint64_t lo, uint64_t hi, uint32_t first,
                           uint32_t last) {
  uint32_t v = 0;
DTX_UNROLL
  for (uint32_t i = 0; i <= last - first; ++i) {
    v |= bc6h_bits(lo, hi, last - i, 1) << i;
  }
  return v;
}

// x >> n rounding toward minus infinity, for any sign of x.
DTX_HD int asr(int x, int n) { return x >= 0 ? x >> n : ~(~x >> n); }

// The low `bits` bits of v as a two's-complement value.
DTX_HD int sext(int v, int bits) {
  const int half = 1 << (bits - 1);
  return ((v & ((1 << bits) - 1)) ^ half) - half;
}

// Endpoint to the 16-bit work range (decompress-bptc-float.c:52-86).
template <bool kSigned>
DTX_HD int unquantize(int x, int epb) {
  if (epb >= 16) return x;
  if (kSigned) {
    const int mag = x < 0 ? -x : x;
    int unq = ((mag << 15) + 0x4000) >> (epb - 1);
    if (mag == 0) unq = 0;
    if (mag >= (1 << (epb - 1)) - 1) unq = 0x7FFF;
    return x < 0 ? -unq : unq;
  }
  if (x == 0) return 0;
  if (x == (1 << epb) - 1) return 0xFFFF;
  return ((x << 15) + 0x4000) >> (epb - 1);
}

// Endpoint 1, 2 or 3 of a channel from its raw field (decompress-bptc-
// float.c:496-518): a delta against endpoint 0 where the mode has
// `dbits` > 0, else a value of its own.
template <bool kSigned>
DTX_HD int endpoint(int e0, uint32_t raw, int epb, int dbits) {
  int v = (int)raw;
  if (dbits > 0) {
    v = (int)((uint32_t)(e0 + sext(v, dbits)) & ((1u << epb) - 1u));
  }
  if (kSigned) v = sext(v, epb);
  return unquantize<kSigned>(v, epb);
}

struct Bc6hChannel {
  int e0, e1, e2, e3;
};

template <bool kSigned>
DTX_HD Bc6hChannel bc6h_channel(uint32_t x0, uint32_t x1, uint32_t x2,
                                uint32_t x3, int epb, int dbits) {
  const int e0 = kSigned ? sext((int)x0, epb) : (int)x0;
  return {unquantize<kSigned>(e0, epb), endpoint<kSigned>(e0, x1, epb, dbits),
          endpoint<kSigned>(e0, x2, epb, dbits),
          endpoint<kSigned>(e0, x3, epb, dbits)};
}

// ((64 - w) * e0 + w * e1 + 32) >> 6 with the endpoints of subset 0 or 1
// (decompress-bptc-float.c:566-575).
DTX_HD int interp6(const Bc6hChannel& c, bool subset1, int w) {
  const int e0 = subset1 ? c.e2 : c.e0;
  const int e1 = subset1 ? c.e3 : c.e1;
  return asr((64 - w) * e0 + w * e1 + 32, 6);
}

// An interpolated value to its 16-bit half-float pattern
// (decompress-bptc-float.c:576-622).
template <bool kSigned>
DTX_HD uint32_t bc6h_finish(int v) {
  if (kSigned) {
    const int s = v < 0 ? -((-v * 31) >> 5) : (v * 31) >> 5;
    return s < 0 ? (uint32_t)(-s) | 0x8000u : (uint32_t)s;
  }
  return (uint32_t)(v * 31) >> 6;
}

// A block's mode from the 2-then-5-bit code in word 0, or -1 for a
// reserved code (19, 23, 27, 31), which decodes as mode 0.
DTX_HD int bc6h_mode(uint32_t w0) {
  const uint32_t m2 = w0 & 3u, code5 = w0 & 31u;
  return m2 < 2        ? (int)m2
         : m2 == 2     ? 2 + (int)(code5 >> 2)
         : code5 < 16  ? 10 + (int)(code5 >> 2)
                       : -1;
}

// Decodes one block into its FLOAT_RGBX16 payload, out[2i] = R | G << 16
// and out[2i + 1] = B (X = 0) for pixel i = 4y + x, and returns whether
// the block is valid under mode_mask.
template <bool kSigned>
DTX_HD bool bc6h_decode_block(uint32_t w0, uint32_t w1, uint32_t w2,
                              uint32_t w3, uint32_t mode_mask,
                              uint32_t out[32]) {
  const uint64_t lo = (uint64_t)w0 | ((uint64_t)w1 << 32);
  const uint64_t hi = (uint64_t)w2 | ((uint64_t)w3 << 32);
  const int mode_raw = bc6h_mode(w0);

  // Raw endpoint fields, endpoint bits and delta bits of the mode.
  struct {
    uint32_t r0, r1, r2, r3, g0, g1, g2, g3, b0, b1, b2, b3;
  } e = {};
  int epb = 0, dr = 0, dg = 0, db = 0;
#define FLD(d, lo_bit, hi_bit, sh) \
  e.d |= bc6h_bits(lo, hi, lo_bit, hi_bit - lo_bit + 1) << sh
#define REV(d, lo_bit, hi_bit, sh) \
  e.d |= bc6h_rbits(lo, hi, lo_bit, hi_bit) << sh
  switch (mode_raw < 0 ? 0 : mode_raw) {
    case 0:
      epb = 10;
      dr = 5, dg = 5, db = 5;
      FLD(g2, 2, 2, 4); FLD(b2, 3, 3, 4); FLD(b3, 4, 4, 4); FLD(r0, 5, 14, 0);
      FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0); FLD(r1, 35, 39, 0);
      FLD(g3, 40, 40, 4); FLD(g2, 41, 44, 0); FLD(g1, 45, 49, 0);
      FLD(b3, 50, 50, 0); FLD(g3, 51, 54, 0); FLD(b1, 55, 59, 0);
      FLD(b3, 60, 60, 1); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 69, 0); FLD(b3, 70, 70, 2); FLD(r3, 71, 75, 0);
      FLD(b3, 76, 76, 3);
      break;
    case 1:
      epb = 7;
      dr = 6, dg = 6, db = 6;
      FLD(g2, 2, 2, 5); FLD(g3, 3, 3, 4); FLD(g3, 4, 4, 5); FLD(r0, 5, 11, 0);
      FLD(b3, 12, 12, 0); FLD(b3, 13, 13, 1); FLD(b2, 14, 14, 4);
      FLD(g0, 15, 21, 0); FLD(b2, 22, 22, 5); FLD(b3, 23, 23, 2);
      FLD(g2, 24, 24, 4); FLD(b0, 25, 31, 0); FLD(b3, 32, 32, 3);
      FLD(b3, 33, 33, 5); FLD(b3, 34, 34, 4); FLD(r1, 35, 40, 0);
      FLD(g2, 41, 44, 0); FLD(g1, 45, 50, 0); FLD(g3, 51, 54, 0);
      FLD(b1, 55, 60, 0); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 70, 0); FLD(r3, 71, 76, 0);
      break;
    case 2:
      epb = 11;
      dr = 5, dg = 4, db = 4;
      FLD(r0, 5, 14, 0); FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0);
      FLD(r1, 35, 39, 0); FLD(r0, 40, 40, 10); FLD(g2, 41, 44, 0);
      FLD(g1, 45, 48, 0); FLD(g0, 49, 49, 10); FLD(b3, 50, 50, 0);
      FLD(g3, 51, 54, 0); FLD(b1, 55, 58, 0); FLD(b0, 59, 59, 10);
      FLD(b3, 60, 60, 1); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 69, 0); FLD(b3, 70, 70, 2); FLD(r3, 71, 75, 0);
      FLD(b3, 76, 76, 3);
      break;
    case 3:
      epb = 11;
      dr = 4, dg = 5, db = 4;
      FLD(r0, 5, 14, 0); FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0);
      FLD(r1, 35, 38, 0); FLD(r0, 39, 39, 10); FLD(g3, 40, 40, 4);
      FLD(g2, 41, 44, 0); FLD(g1, 45, 49, 0); FLD(g0, 50, 50, 10);
      FLD(g3, 51, 54, 0); FLD(b1, 55, 58, 0); FLD(b0, 59, 59, 10);
      FLD(b3, 60, 60, 1); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 68, 0); FLD(b3, 69, 69, 0); FLD(b3, 70, 70, 2);
      FLD(r3, 71, 74, 0); FLD(g2, 75, 75, 4); FLD(b3, 76, 76, 3);
      break;
    case 4:
      epb = 11;
      dr = 4, dg = 4, db = 5;
      FLD(r0, 5, 14, 0); FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0);
      FLD(r1, 35, 38, 0); FLD(r0, 39, 39, 10); FLD(b2, 40, 40, 4);
      FLD(g2, 41, 44, 0); FLD(g1, 45, 48, 0); FLD(g0, 49, 49, 10);
      FLD(b3, 50, 50, 0); FLD(g3, 51, 54, 0); FLD(b1, 55, 59, 0);
      FLD(b0, 60, 60, 10); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 68, 0); FLD(b3, 69, 69, 1); FLD(b3, 70, 70, 2);
      FLD(r3, 71, 74, 0); FLD(b3, 75, 75, 4); FLD(b3, 76, 76, 3);
      break;
    case 5:
      epb = 9;
      dr = 5, dg = 5, db = 5;
      FLD(r0, 5, 13, 0); FLD(b2, 14, 14, 4); FLD(g0, 15, 23, 0);
      FLD(g2, 24, 24, 4); FLD(b0, 25, 33, 0); FLD(b3, 34, 34, 4);
      FLD(r1, 35, 39, 0); FLD(g3, 40, 40, 4); FLD(g2, 41, 44, 0);
      FLD(g1, 45, 49, 0); FLD(b3, 50, 50, 0); FLD(g3, 51, 54, 0);
      FLD(b1, 55, 59, 0); FLD(b3, 60, 60, 1); FLD(b2, 61, 63, 0);
      FLD(b2, 64, 64, 3); FLD(r2, 65, 69, 0); FLD(b3, 70, 70, 2);
      FLD(r3, 71, 75, 0); FLD(b3, 76, 76, 3);
      break;
    case 6:
      epb = 8;
      dr = 6, dg = 5, db = 5;
      FLD(r0, 5, 12, 0); FLD(g3, 13, 13, 4); FLD(b2, 14, 14, 4);
      FLD(g0, 15, 22, 0); FLD(b3, 23, 23, 2); FLD(g2, 24, 24, 4);
      FLD(b0, 25, 32, 0); FLD(b3, 33, 33, 3); FLD(b3, 34, 34, 4);
      FLD(r1, 35, 40, 0); FLD(g2, 41, 44, 0); FLD(g1, 45, 49, 0);
      FLD(b3, 50, 50, 0); FLD(g3, 51, 54, 0); FLD(b1, 55, 59, 0);
      FLD(b3, 60, 60, 1); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 70, 0); FLD(r3, 71, 76, 0);
      break;
    case 7:
      epb = 8;
      dr = 5, dg = 6, db = 5;
      FLD(r0, 5, 12, 0); FLD(b3, 13, 13, 0); FLD(b2, 14, 14, 4);
      FLD(g0, 15, 22, 0); FLD(g2, 23, 23, 5); FLD(g2, 24, 24, 4);
      FLD(b0, 25, 32, 0); FLD(g3, 33, 33, 5); FLD(b3, 34, 34, 4);
      FLD(r1, 35, 39, 0); FLD(g3, 40, 40, 4); FLD(g2, 41, 44, 0);
      FLD(g1, 45, 50, 0); FLD(g3, 51, 54, 0); FLD(b1, 55, 59, 0);
      FLD(b3, 60, 60, 1); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 69, 0); FLD(b3, 70, 70, 2); FLD(r3, 71, 75, 0);
      FLD(b3, 76, 76, 3);
      break;
    case 8:
      epb = 8;
      dr = 5, dg = 5, db = 6;
      FLD(r0, 5, 12, 0); FLD(b3, 13, 13, 1); FLD(b2, 14, 14, 4);
      FLD(g0, 15, 22, 0); FLD(b2, 23, 23, 5); FLD(g2, 24, 24, 4);
      FLD(b0, 25, 32, 0); FLD(b3, 33, 33, 5); FLD(b3, 34, 34, 4);
      FLD(r1, 35, 39, 0); FLD(g3, 40, 40, 4); FLD(g2, 41, 44, 0);
      FLD(g1, 45, 49, 0); FLD(b3, 50, 50, 0); FLD(g3, 51, 54, 0);
      FLD(b1, 55, 60, 0); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 69, 0); FLD(b3, 70, 70, 2); FLD(r3, 71, 75, 0);
      FLD(b3, 76, 76, 3);
      break;
    case 9:
      epb = 6;
      dr = 0, dg = 0, db = 0;
      FLD(r0, 5, 10, 0); FLD(g3, 11, 11, 4); FLD(b3, 12, 13, 0);
      FLD(b2, 14, 14, 4); FLD(g0, 15, 20, 0); FLD(g2, 21, 21, 5);
      FLD(b2, 22, 22, 5); FLD(b3, 23, 23, 2); FLD(g2, 24, 24, 4);
      FLD(b0, 25, 30, 0); FLD(g3, 31, 31, 5); FLD(b3, 32, 32, 3);
      FLD(b3, 33, 33, 5); FLD(b3, 34, 34, 4); FLD(r1, 35, 40, 0);
      FLD(g2, 41, 44, 0); FLD(g1, 45, 50, 0); FLD(g3, 51, 54, 0);
      FLD(b1, 55, 60, 0); FLD(b2, 61, 63, 0); FLD(b2, 64, 64, 3);
      FLD(r2, 65, 70, 0); FLD(r3, 71, 76, 0);
      break;
    case 10:
      epb = 10;
      dr = 0, dg = 0, db = 0;
      FLD(r0, 5, 14, 0); FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0);
      FLD(r1, 35, 44, 0); FLD(g1, 45, 54, 0); FLD(b1, 55, 63, 0);
      FLD(b1, 64, 64, 9);
      break;
    case 11:
      epb = 11;
      dr = 9, dg = 9, db = 9;
      FLD(r0, 5, 14, 0); FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0);
      FLD(r1, 35, 43, 0); FLD(r0, 44, 44, 10); FLD(g1, 45, 53, 0);
      FLD(g0, 54, 54, 10); FLD(b1, 55, 63, 0); FLD(b0, 64, 64, 10);
      break;
    case 12:
      epb = 12;
      dr = 8, dg = 8, db = 8;
      FLD(r0, 5, 14, 0); FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0);
      FLD(r1, 35, 42, 0); REV(r0, 43, 44, 10); FLD(g1, 45, 52, 0);
      REV(g0, 53, 54, 10); FLD(b1, 55, 62, 0); FLD(b0, 64, 64, 10);
      break;
    case 13:
      epb = 16;
      dr = 4, dg = 4, db = 4;
      FLD(r0, 5, 14, 0); FLD(g0, 15, 24, 0); FLD(b0, 25, 34, 0);
      FLD(r1, 35, 38, 0); REV(r0, 39, 44, 10); FLD(g1, 45, 48, 0);
      REV(g0, 49, 54, 10); FLD(b1, 55, 58, 0); REV(b0, 59, 63, 11);
      FLD(b0, 64, 64, 10);
      break;
  }
#undef FLD
#undef REV

  const Bc6hChannel r =
      bc6h_channel<kSigned>(e.r0, e.r1, e.r2, e.r3, epb, dr);
  const Bc6hChannel g =
      bc6h_channel<kSigned>(e.g0, e.g1, e.g2, e.g3, epb, dg);
  const Bc6hChannel b =
      bc6h_channel<kSigned>(e.b0, e.b1, e.b2, e.b3, epb, db);

  // Index streams (decompress-bptc-float.c:543-564): one subset (modes
  // 10-13), 4-bit indices from bit 65; two subsets, 3-bit indices from bit
  // 82.  Anchor pixels (0, and the second subset's anchor) store one bit
  // less.  Both streams lie in hi.
  const bool one = mode_raw >= 10;
  const uint32_t subanc = DTX_LOOKUP(kBc6hSubAnc, bc6h_bits(lo, hi, 77, 5));
  const uint32_t sub = one ? 0u : subanc & 0xFFFFu;
  const uint32_t anchor2 = one ? 0u : subanc >> 16;
  const uint32_t ib = one ? 4u : 3u;
  // floor((64 * idx + c) / d) as (idx * (mul << 6) + c * mul) >> sh for
  // (c, d) = (3, 7) and (7, 15) (the magics are checked against the weight
  // tables at import of bptc_float_pallas.py).
  const uint32_t mul64 = one ? 34953u << 6 : 9363u << 6;
  const uint32_t cm = one ? 7u * 34953u : 3u * 9363u;
  const uint32_t wsh = one ? 19u : 16u;
  uint32_t pos = (one ? 65u : 82u) - 64u;
DTX_UNROLL
  for (uint32_t i = 0; i < 16; ++i) {
    const uint32_t width = (i == 0 || i == anchor2) ? ib - 1 : ib;
    const uint32_t idx = (uint32_t)(hi >> pos) & ((1u << width) - 1u);
    pos += width;
    const int w = (int)((idx * mul64 + cm) >> wsh);
    const bool s1 = (sub >> i) & 1u;
    const uint32_t rv = bc6h_finish<kSigned>(interp6(r, s1, w));
    const uint32_t gv = bc6h_finish<kSigned>(interp6(g, s1, w));
    out[2 * i] = rv | (gv << 16);
    out[2 * i + 1] = bc6h_finish<kSigned>(interp6(b, s1, w));
  }
  return mode_raw >= 0 && ((mode_mask >> mode_raw) & 1u) != 0;
}

}  // namespace dtx
