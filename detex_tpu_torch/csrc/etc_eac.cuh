// ETC1 / ETC2 / ETC2 punchthrough colour and EAC channel per-block decode,
// shared by the CUDA kernels (etc_eac.cu) and a host build
// (etc_eac_host.cpp) that lets CPU tests run this exact code.
//
// Computes what detex_tpu/ops/pallas/etc_eac_pallas.py computes, bit for
// bit, for every input block, invalid ones included (reference semantics:
// decompress-etc.c:72-717, decompress-eac.c:44-231).  Two cores:
//   etc_color_block<Kind>  the ETC colour rules (_etc2_pixels_swar L160
//                          with _swar_pixel_loop L318)
//   eac_channel<Rule>      the EAC rules (L398-483): 8-bit alpha, unsigned
//                          and signed 11-bit
// and on them one decoder per TPU kernel:
//   etc_decode_block<kEtc1 / kEtc2 / kEtc2Pt>  _etc1_kernel (L490),
//                                              _etc2_kernel (L509),
//                                              _etc2_pt_kernel (L518)
//   etc2_eac_decode_block                      _etc2_eac_kernel (L533)
//   eac_r11_decode_block<S>                    _eac_r11_kernel (L546)
//   eac_rg11_decode_block<S>                   _eac_rg11_kernel (L559)
// Each writes the true packed payload (the reference's pixel buffer as
// little-endian words) and returns the block's valid flag:
//   etc1, etc2, etc2_pt, etc2_eac   16 words, RGBA8 (alpha 0xFF but in
//                                   punchthrough's transparent pixels and
//                                   ETC2_EAC's alpha channel)
//   eac r11 (signed or not)          8 words, R16, 2 pixels per word
//   eac rg11 (signed or not)        16 words, RG16, R low and G high half
//
// Pixel order: output pixel j (row-major) reads the reference's loop
// variable i = (j & 3) * 4 + (j >> 2), the column-major transpose.  ETC
// index bits come from the byte-swapped word 1 (LSB at bit i, MSB at bit
// 16 + i); each EAC code sits at bit 45 - 3i of the big-endian qword, so
// pixel 5's straddles the two words: the qword is one uint64_t.
//
// The TPU kernel packed RGB into 10-bit SWAR lanes and replaced every
// table gather with a select tree; a thread here keeps per-channel ints in
// registers, takes the block's mode once (a switch), reads the ETC tables
// from 64-bit immediates by shift and the EAC table from read-only global
// memory.  Channel arithmetic is signed int: an overflowing differential
// channel (ETC1 keeps decoding it) lies in [-32, 280] before the clamp,
// and planar's bilinear sum is shifted right arithmetically.  No shift of
// a negative value to the left, none reaches the operand width.

#pragma once

#include <stdint.h>

#include "dtx_hd.cuh"

namespace dtx {

enum EtcKind { kEtc1 = 0, kEtc2 = 1, kEtc2Pt = 2 };
enum EacRule { kEacAlpha = 0, kEacU11 = 1, kEacS11 = 2 };

// ETC modifier rows are [a, b, -a, -b] (decompress-etc.c:25-34): a in
// 6-bit and b in 8-bit fields, codeword k in field k.  The punchthrough
// table (decompress-etc.c:472-481) is the same with a = 0.  The ETC2
// distance table (decompress-etc.c:200) in 8-bit fields.  Checked against
// detex_tpu/ops/etc.py's tables in tests/test_torch_etc.py.
constexpr uint64_t kEtcA = 0xbe1612349142ull;
constexpr uint64_t kEtcB = 0xb76a503c2a1d1108ull;
constexpr uint64_t kEtcDist = 0x40292017100b0603ull;

// EAC modifier rows (decompress-eac.c:21-38): columns 4-7 equal
// -(columns 0-3) - 1, so a row is its first four entries, each biased by
// 16 into a 5-bit field (etc_eac_pallas.py:56-64 checks the structure).
DTX_TABLE(kEacRows,
    0x09d4du, 0x1992du, 0x1a16eu, 0x1a98eu, 0x2214du, 0x29d2du, 0x2a12cu,
    0x2a16du, 0x3214eu, 0x3216eu, 0x3218eu, 0x3256eu, 0x3258du, 0x335cfu,
    0x3a14cu, 0x3a56du)

DTX_HD int clamp_int(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

DTX_HD int clamp255(int v) { return clamp_int(v, 0, 255); }

// 4-bit value -> 8 bits.
DTX_HD int rep4(int v) { return v | (v << 4); }

// 5 bits in [7:3] -> 8 bits; v may be negative (an overflowing channel).
DTX_HD int rep5hi(int v) { return v | ((v & 224) >> 5); }

DTX_HD uint32_t bswap32(uint32_t w) {
  return (w >> 24) | ((w >> 8) & 0xFF00u) | ((w & 0xFF00u) << 8) | (w << 24);
}

// The reference's loop variable of output pixel j.
DTX_HD int src_pixel(int j) { return (j & 3) * 4 + (j >> 2); }

DTX_HD uint32_t rgbx(int r, int g, int b) {
  return (uint32_t)r | ((uint32_t)g << 8) | ((uint32_t)b << 16) |
         0xFF000000u;
}

// Field k of a packed table.
DTX_HD int field8(uint64_t table, int k) {
  return (int)(table >> (8 * k)) & 0xFF;
}

// Byte c (0..2) of a colour word: R, G, B.
DTX_HD int color_byte(uint32_t w0, int c) {
  return (int)(w0 >> (8 * c)) & 0xFF;
}

// Second subblock's differential channel before replication,
// (b & 0xF8) + (3-bit two's complement delta) * 8 (decompress-etc.c:54-62).
DTX_HD int diff_raw(int b) {
  const int d = b & 7;
  return (b & 0xF8) + (d >= 4 ? d - 8 : d) * 8;
}

// Bit c set when channel c's differential sum overflows, raw & 0xFF07
// (decompress-etc.c:111-122).  ETC1 marks such a block invalid; ETC2 reads
// R, G, B overflow as the T, H and planar modes (decompress-etc.c:331-362).
DTX_HD int etc_overflow(uint32_t w0) {
  int m = 0;
DTX_UNROLL
  for (int c = 0; c < 3; ++c) {
    if (diff_raw(color_byte(w0, c)) & 0xFF07) m |= 1 << c;
  }
  return m;
}

// The block's mode: 0 individual, 1 differential, 2 T, 3 H, 4 planar.
// Punchthrough's differential bit is the opaque bit, and mode detection
// ignores it: never 0.
template <int Kind>
DTX_HD int etc_mode(uint32_t w0) {
  const bool diff = (w0 >> 25) & 1u;
  if (Kind == kEtc1) return diff ? 1 : 0;
  if (Kind == kEtc2 && !diff) return 0;
  const int ovf = etc_overflow(w0);
  return (ovf & 1) ? 2 : (ovf & 2) ? 3 : (ovf & 4) ? 4 : 1;
}

// The 2-bit index of output pixel j.
DTX_HD uint32_t etc_index(uint32_t piw, int j) {
  const int i = src_pixel(j);
  return ((piw >> i) & 1u) | (((piw >> (16 + i)) & 1u) << 1);
}

// Individual (mode 0) or differential (mode 1) pixels: two subblock base
// colours, 2x4 or 4x2 by the flip bit, each with a modifier row.  In a
// non-opaque punchthrough block (`punch`) the table has a = 0 and index 2
// is transparent black (decompress-etc.c:503-563).
DTX_HD void etc_subblocks(uint32_t w0, uint32_t w1, bool individual,
                          bool punch, uint32_t out[16]) {
  const uint32_t b3 = w0 >> 24;
  int s1[3], s2[3];
DTX_UNROLL
  for (int c = 0; c < 3; ++c) {
    const int b = color_byte(w0, c);
    if (individual) {
      s1[c] = (b & 0xF0) | ((b & 0xF0) >> 4);
      s2[c] = rep4(b & 0x0F);
    } else {
      s1[c] = rep5hi(b & 0xF8);
      s2[c] = rep5hi(diff_raw(b));
    }
  }
  const bool flip = b3 & 1u;
  const int cw1 = (b3 >> 5) & 7, cw2 = (b3 >> 2) & 7;
  const int a1 = punch ? 0 : (int)(kEtcA >> (6 * cw1)) & 63;
  const int a2 = punch ? 0 : (int)(kEtcA >> (6 * cw2)) & 63;
  const int m1 = field8(kEtcB, cw1), m2 = field8(kEtcB, cw2);
  const uint32_t piw = bswap32(w1);
DTX_UNROLL
  for (int j = 0; j < 16; ++j) {
    const int x = j & 3, y = j >> 2;
    const bool second = flip ? y >= 2 : x >= 2;
    const uint32_t idx = etc_index(piw, j);
    const int mag = (idx & 1u) ? (second ? m2 : m1) : (second ? a2 : a1);
    const int mod = (idx & 2u) ? -mag : mag;
    int ch[3];
DTX_UNROLL
    for (int c = 0; c < 3; ++c) {
      ch[c] = clamp255((second ? s2[c] : s1[c]) + mod);
    }
    out[j] = (punch && idx == 2u) ? 0u : rgbx(ch[0], ch[1], ch[2]);
  }
}

// T (mode 2) or H (mode 3) pixels: a 4-entry paint palette from two base
// colours and a distance (decompress-etc.c:200-285); in a non-opaque
// punchthrough block index 2 is transparent black.
DTX_HD void etc_th(uint32_t w0, uint32_t w1, bool h_mode, bool punch,
                   uint32_t out[16]) {
  const int b0 = color_byte(w0, 0), b1 = color_byte(w0, 1);
  const int b2 = color_byte(w0, 2), b3 = (int)(w0 >> 24);
  uint32_t paint[4];
  if (!h_mode) {
    const int r1 = rep4(((b0 & 0x18) >> 1) | (b0 & 0x3));
    const int g1 = (b1 & 0xF0) | ((b1 & 0xF0) >> 4);
    const int bl1 = rep4(b1 & 0x0F);
    const int r2 = (b2 & 0xF0) | ((b2 & 0xF0) >> 4);
    const int g2 = rep4(b2 & 0x0F);
    const int bl2 = (b3 & 0xF0) | ((b3 & 0xF0) >> 4);
    const int d = field8(kEtcDist, ((b3 & 0x0C) >> 1) | (b3 & 1));
    paint[0] = rgbx(r1, g1, bl1);
    paint[1] = rgbx(clamp255(r2 + d), clamp255(g2 + d), clamp255(bl2 + d));
    paint[2] = rgbx(r2, g2, bl2);
    paint[3] = rgbx(clamp255(r2 - d), clamp255(g2 - d), clamp255(bl2 - d));
  } else {
    const int r1 = rep4((b0 & 0x78) >> 3);
    const int g1 = rep4(((b0 & 0x07) << 1) | ((b1 & 0x10) >> 4));
    const int bl1 =
        rep4((b1 & 0x08) | ((b1 & 0x03) << 1) | ((b2 & 0x80) >> 7));
    const int r2 = rep4((b2 & 0x78) >> 3);
    const int g2 = rep4(((b2 & 0x07) << 1) | ((b3 & 0x80) >> 7));
    const int bl2 = rep4((b3 & 0x78) >> 3);
    // The tie bit compares the 24-bit composites (decompress-etc.c:253-260).
    const int tie =
        ((r1 << 16) + (g1 << 8) + bl1) >= ((r2 << 16) + (g2 << 8) + bl2);
    const int d = field8(kEtcDist, (b3 & 0x04) | ((b3 & 0x01) << 1) | tie);
    paint[0] = rgbx(clamp255(r1 + d), clamp255(g1 + d), clamp255(bl1 + d));
    paint[1] = rgbx(clamp255(r1 - d), clamp255(g1 - d), clamp255(bl1 - d));
    paint[2] = rgbx(clamp255(r2 + d), clamp255(g2 + d), clamp255(bl2 + d));
    paint[3] = rgbx(clamp255(r2 - d), clamp255(g2 - d), clamp255(bl2 - d));
  }
  const uint32_t piw = bswap32(w1);
DTX_UNROLL
  for (int j = 0; j < 16; ++j) {
    const uint32_t idx = etc_index(piw, j);
    // paint[idx] as selects: a dynamic index would put paint in local
    // memory.
    const uint32_t lo = (idx & 1u) ? paint[1] : paint[0];
    const uint32_t hi = (idx & 1u) ? paint[3] : paint[2];
    out[j] = (punch && idx == 2u) ? 0u : ((idx & 2u) ? hi : lo);
  }
}

// Planar (mode 4) pixels: three 6-7-6 colours O, H, V and the bilinear
// (x (H - O) + y (V - O) + 4 O + 2) >> 2 per channel, clamped
// (decompress-etc.c:287-317).  Always opaque.
DTX_HD void etc_planar(uint32_t w0, uint32_t w1, uint32_t out[16]) {
  const int b0 = color_byte(w0, 0), b1 = color_byte(w0, 1);
  const int b2 = color_byte(w0, 2), b3 = (int)(w0 >> 24);
  const int b4 = color_byte(w1, 0), b5 = color_byte(w1, 1);
  const int b6 = color_byte(w1, 2), b7 = (int)(w1 >> 24);
  int o[3], h[3], v[3];
  o[0] = (b0 & 0x7E) >> 1;
  o[1] = ((b0 & 1) << 6) | ((b1 & 0x7E) >> 1);
  o[2] = ((b1 & 1) << 5) | (b2 & 0x18) | ((b2 & 0x03) << 1) |
         ((b3 & 0x80) >> 7);
  h[0] = ((b3 & 0x7C) >> 1) | (b3 & 1);
  h[1] = (b4 & 0xFE) >> 1;
  h[2] = ((b4 & 1) << 5) | ((b5 & 0xF8) >> 3);
  v[0] = ((b5 & 0x7) << 3) | ((b6 & 0xE0) >> 5);
  v[1] = ((b6 & 0x1F) << 2) | ((b7 & 0xC0) >> 6);
  v[2] = b7 & 0x3F;
DTX_UNROLL
  for (int c = 0; c < 3; ++c) {
    if (c == 1) {                                 // 7-bit green
      o[c] = (o[c] << 1) | ((o[c] & 0x40) >> 6);
      h[c] = (h[c] << 1) | ((h[c] & 0x40) >> 6);
      v[c] = (v[c] << 1) | ((v[c] & 0x40) >> 6);
    } else {                                      // 6-bit red and blue
      o[c] = (o[c] << 2) | ((o[c] & 0x30) >> 4);
      h[c] = (h[c] << 2) | ((h[c] & 0x30) >> 4);
      v[c] = (v[c] << 2) | ((v[c] & 0x30) >> 4);
    }
  }
DTX_UNROLL
  for (int j = 0; j < 16; ++j) {
    const int x = j & 3, y = j >> 2;
    int ch[3];
DTX_UNROLL
    for (int c = 0; c < 3; ++c) {
      // The sum may be negative: >> on int is arithmetic, as the
      // reference's shift of a signed int (decompress-etc.c:312-314).
      ch[c] = clamp255(
          (x * (h[c] - o[c]) + y * (v[c] - o[c]) + 4 * o[c] + 2) >> 2);
    }
    out[j] = rgbx(ch[0], ch[1], ch[2]);
  }
}

// The colour core: 16 RGBA8 words of an ETC1 / ETC2 / punchthrough colour
// block; returns the block's mode.
template <int Kind>
DTX_HD int etc_color_block(uint32_t w0, uint32_t w1, uint32_t out[16]) {
  const int mode = etc_mode<Kind>(w0);
  const bool punch = Kind == kEtc2Pt && !((w0 >> 25) & 1u);   // non-opaque
  if constexpr (Kind == kEtc1) {
    etc_subblocks(w0, w1, mode == 0, false, out);
  } else {
    switch (mode) {
      case 0:
      case 1:
        etc_subblocks(w0, w1, mode == 0, punch, out);
        break;
      case 2:
      case 3:
        etc_th(w0, w1, mode == 3, punch, out);
        break;
      default:
        etc_planar(w0, w1, out);
        break;
    }
  }
  return mode;
}

// ETC1, ETC2 or ETC2 punchthrough.  valid: mode_mask bit `mode` (ETC1:
// bit 0 individual, bit 1 differential); ETC1 also rejects an overflowing
// differential block; punchthrough's flag 0x4 rejects opaque and planar
// blocks, 0x2 non-opaque ones.
template <int Kind>
DTX_HD bool etc_decode_block(uint32_t w0, uint32_t w1, uint32_t mode_mask,
                             uint32_t flags, uint32_t out[16]) {
  const int mode = etc_color_block<Kind>(w0, w1, out);
  bool valid = (mode_mask >> mode) & 1u;
  if (Kind == kEtc1 && mode == 1 && etc_overflow(w0)) valid = false;
  if (Kind == kEtc2Pt) {
    const bool opaque = (w0 >> 25) & 1u;
    if ((flags & 0x4u) && (opaque || mode == 4)) valid = false;
    if ((flags & 0x2u) && !opaque) valid = false;
  }
  return valid;
}

// --- EAC ----------------------------------------------------------------

// The big-endian qword of an 8-byte EAC block (decompress-eac.c:44-48).
DTX_HD uint64_t eac_codes(uint32_t w0, uint32_t w1) {
  return ((uint64_t)bswap32(w0) << 32) | bswap32(w1);
}

// The 3-bit code of output pixel j.
DTX_HD uint32_t eac_code(uint64_t q, int j) {
  return (uint32_t)(q >> (45 - 3 * src_pixel(j))) & 7u;
}

// Modifier of a 3-bit code in a packed row.
DTX_HD int eac_modifier(uint32_t row, uint32_t code) {
  const int v = (int)((row >> (5 * (code & 3u))) & 31u) - 16;
  return (code & 4u) ? -v - 1 : v;
}

// One EAC channel of 16 pixels, as bit patterns: kEacAlpha 8-bit alpha,
// clamp255(base + modifier * multiplier) (decompress-eac.c:54-86; a
// multiplier of 0 gives the base); kEacU11 unsigned 11-bit, base * 8 + 4
// with the multiplier * 8 raised to 1 from 0, clamped to [0, 2047] and
// replicated to 16 bits (decompress-eac.c:111-128); kEacS11 signed 11-bit,
// int8 base * 8, clamped to [-1023, 1023], the magnitude replicated
// (|v| << 5 | |v| >> 5) under the sign, as a 16-bit pattern
// (decompress-eac.c:159-202).  Returns false for a signed base of -128,
// which still decodes.
template <int Rule>
DTX_HD bool eac_channel(uint32_t w0, uint32_t w1, uint32_t vals[16]) {
  const uint64_t q = eac_codes(w0, w1);
  const uint32_t row = DTX_LOOKUP(kEacRows, (w0 >> 8) & 0xFu);
  const int mult = (int)(w0 >> 12) & 0xF;
  const int byte0 = (int)w0 & 0xFF;
  const int mult8 = mult ? mult * 8 : 1;
  const int base = Rule == kEacU11   ? byte0 * 8 + 4
                   : Rule == kEacS11 ? (byte0 - ((byte0 & 0x80) << 1)) * 8
                                     : byte0;
DTX_UNROLL
  for (int j = 0; j < 16; ++j) {
    const int mod = eac_modifier(row, eac_code(q, j));
    if (Rule == kEacAlpha) {
      vals[j] = (uint32_t)clamp255(base + mod * mult);
    } else if (Rule == kEacU11) {
      const int v = clamp_int(base + mod * mult8, 0, 2047);
      vals[j] = (uint32_t)((v << 5) | (v >> 6));
    } else {
      const int v = clamp_int(base + mod * mult8, -1023, 1023);
      const int mag = v < 0 ? -v : v;
      const int rep = (mag << 5) | (mag >> 5);
      vals[j] = (uint32_t)(v < 0 ? -rep : rep) & 0xFFFFu;
    }
  }
  return Rule != kEacS11 || byte0 != 0x80;
}

// ETC2_EAC: alpha block in (aw0, aw1), ETC2 colour in (cw0, cw1)
// (etc_eac_pallas.py:534).  valid: mode_mask bit `mode`; FLAG_ENCODE
// (0x1) rejects an alpha multiplier of 0.
DTX_HD bool etc2_eac_decode_block(uint32_t aw0, uint32_t aw1, uint32_t cw0,
                                  uint32_t cw1, uint32_t mode_mask,
                                  uint32_t flags, uint32_t out[16]) {
  const int mode = etc_color_block<kEtc2>(cw0, cw1, out);
  uint32_t alpha[16];
  eac_channel<kEacAlpha>(aw0, aw1, alpha);
DTX_UNROLL
  for (int j = 0; j < 16; ++j) {
    out[j] = (out[j] & 0xFFFFFFu) | (alpha[j] << 24);
  }
  bool valid = (mode_mask >> mode) & 1u;
  if ((flags & 0x1u) && ((aw0 >> 12) & 0xFu) == 0) valid = false;
  return valid;
}

// EAC R11: 8 words of R16, pixels 2w and 2w + 1 in word w.  mode_mask and
// flags play no part.
template <bool kSigned>
DTX_HD bool eac_r11_decode_block(uint32_t w0, uint32_t w1, uint32_t out[8]) {
  uint32_t v[16];
  const bool valid = eac_channel<kSigned ? kEacS11 : kEacU11>(w0, w1, v);
DTX_UNROLL
  for (int w = 0; w < 8; ++w) out[w] = v[2 * w] | (v[2 * w + 1] << 16);
  return valid;
}

// EAC RG11: R from (rw0, rw1), G from (gw0, gw1); 16 words R | G << 16.
// Valid when both channels are.
template <bool kSigned>
DTX_HD bool eac_rg11_decode_block(uint32_t rw0, uint32_t rw1, uint32_t gw0,
                                  uint32_t gw1, uint32_t out[16]) {
  uint32_t r[16], g[16];
  const bool vr = eac_channel<kSigned ? kEacS11 : kEacU11>(rw0, rw1, r);
  const bool vg = eac_channel<kSigned ? kEacS11 : kEacU11>(gw0, gw1, g);
DTX_UNROLL
  for (int j = 0; j < 16; ++j) out[j] = r[j] | (g[j] << 16);
  return vr && vg;
}

}  // namespace dtx
