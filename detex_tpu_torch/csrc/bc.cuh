// BC1/BC1A/BC2/BC3 and RGTC1/RGTC2 (unsigned and signed) per-block decode,
// shared by the CUDA kernels (bc.cu) and a host build (bc_host.cpp) that
// lets CPU tests run this exact code.
//
// Computes what detex_tpu/ops/pallas/bc_pallas.py computes, bit for bit,
// for every input block (reference semantics: decompress-bc.c:23-240,
// decompress-rgtc.c:26-147):
//   bc1_decode_block<A>      _bc1_kernel   (bc_pallas.py:228-244)
//   bc23_decode_block<BC3>   _bc23_kernel  (bc_pallas.py:247-276)
//   rgtc1_decode_block<S>    _rgtc1_kernel (bc_pallas.py:279-302)
//   rgtc2_decode_block<S>    _rgtc2_kernel (bc_pallas.py:305-335)
// Each writes the true packed payload (the reference's pixel buffer as
// little-endian words) and returns the block's valid flag:
//   bc1, bc1a, bc2, bc3   16 words, RGBA8
//   rgtc1                  4 words, R8, 4 pixels per word
//   signed rgtc1           8 words, SIGNED_R16, 2 pixels per word
//   rgtc2                  8 words, RG8, 2 pixels (R, G, R, G) per word
//   signed rgtc2          16 words, SIGNED_RG16, R low and G high half
// mode_mask plays no part in these families.
//
// Unsigned arithmetic for all bit work; no shift reaches the operand width.
// The truncating divisions are multiply-shift magics, and the signed map is
// a closed form, all checked exhaustively over their ranges at import of
// bc_pallas.py (L49-63).

#pragma once

#include <stdint.h>

#include "dtx_hd.cuh"

namespace dtx {

// x / 3 for x <= 2047, x / 7 for x <= 1785, x / 5 for x <= 1275.
DTX_HD uint32_t div3(uint32_t x) { return (x * 683u) >> 11; }
DTX_HD uint32_t div7(uint32_t x) { return (x * 9363u) >> 16; }
DTX_HD uint32_t div5(uint32_t x) { return (x * 13108u) >> 16; }

DTX_HD uint32_t rgba(uint32_t r, uint32_t g, uint32_t b, uint32_t a) {
  return r | (g << 8) | (b << 16) | (a << 24);
}

// p[k] for a 2-bit k, as selects (a dynamic index would put p in local
// memory).
DTX_HD uint32_t sel4(const uint32_t p[4], uint32_t k) {
  const uint32_t lo = (k & 1u) ? p[1] : p[0];
  const uint32_t hi = (k & 1u) ? p[3] : p[2];
  return (k & 2u) ? hi : lo;
}

// c0 > c1: the 4-colour palette of a BC1 colour block.
DTX_HD bool four_colors(uint32_t colors) {
  return (colors & 0xFFFFu) > (colors >> 16);
}

// RGB palette (alpha byte 0) of a colour block: two RGB565 endpoints
// expanded by shifts only; entries 2 and 3 are (2a+b)/3 and (a+2b)/3 when
// `four`, else (a+b)/2 and black (decompress-bc.c:34-53).
DTX_HD void color_palette(uint32_t colors, bool four, uint32_t pal[4]) {
  uint32_t e[2][3];
DTX_UNROLL
  for (int k = 0; k < 2; ++k) {
    const uint32_t c = k ? colors >> 16 : colors & 0xFFFFu;
    e[k][0] = ((c >> 11) & 0x1Fu) << 3;
    e[k][1] = ((c >> 5) & 0x3Fu) << 2;
    e[k][2] = (c & 0x1Fu) << 3;
  }
  uint32_t m2[3], m3[3];
DTX_UNROLL
  for (int ch = 0; ch < 3; ++ch) {
    const uint32_t a = e[0][ch], b = e[1][ch];
    m2[ch] = four ? div3(2u * a + b) : (a + b) >> 1;
    m3[ch] = four ? div3(a + 2u * b) : 0u;
  }
  pal[0] = rgba(e[0][0], e[0][1], e[0][2], 0u);
  pal[1] = rgba(e[1][0], e[1][1], e[1][2], 0u);
  pal[2] = rgba(m2[0], m2[1], m2[2], 0u);
  pal[3] = rgba(m3[0], m3[1], m3[2], 0u);
}

// The 16 3-bit codes of an RGTC channel (or BC3 alpha) block: a 48-bit
// stream at bit 16 of the 64-bit block; pixel i's code at bit 3i.
DTX_HD uint64_t code_stream(uint32_t w0, uint32_t w1) {
  return ((uint64_t)w1 << 16) | (w0 >> 16);
}

DTX_HD uint32_t code_at(uint64_t stream, int i) {
  return (uint32_t)(stream >> (3 * i)) & 7u;
}

// 8-entry palette of an unsigned channel, entry k in byte k: 7 steps when
// l0 > l1, else 5 steps plus 0 and 255 (decompress-rgtc.c:35-56,
// decompress-bc.c:210-235).
DTX_HD uint64_t luma_palette_u8(uint32_t w0) {
  const uint32_t l0 = w0 & 0xFFu, l1 = (w0 >> 8) & 0xFFu;
  const bool seven = l0 > l1;
  uint64_t pal = l0 | (l1 << 8);
DTX_UNROLL
  for (uint32_t c = 2; c < 8; ++c) {
    uint32_t v;
    if (seven) {
      v = div7((8u - c) * l0 + (c - 1u) * l1);
    } else if (c < 6) {
      v = div5((6u - c) * l0 + (c - 1u) * l1);
    } else {
      v = c == 6 ? 0u : 0xFFu;
    }
    pal |= (uint64_t)v << (8 * c);
  }
  return pal;
}

DTX_HD uint32_t sel8_u8(uint64_t pal, uint32_t code) {
  return (uint32_t)(pal >> (8u * code)) & 0xFFu;
}

// int8 value of a byte.
DTX_HD int32_t sext8(uint32_t x) {
  return (int32_t)(x & 0xFFu) - (int32_t)((x & 0x80u) << 1);
}

// num / d rounded toward zero, through the unsigned magic on |num|.
DTX_HD int32_t div_trunc(int32_t num, uint32_t d) {
  const uint32_t mag = num < 0 ? (uint32_t)(-num) : (uint32_t)num;
  const int32_t q = (int32_t)(d == 7u ? div7(mag) : div5(mag));
  return num < 0 ? -q : q;
}

// [-127, 127] -> 16-bit pattern of floor((v + 127) * 65535 / 254) - 32768
// (decompress-rgtc.c:124-126), as 258k + [k >= 85] + [k >= 170] +
// [k >= 254] with k = v + 127.
DTX_HD uint32_t snorm16(int32_t v) {
  const uint32_t k = (uint32_t)(v + 127);
  const uint32_t m = 258u * k + (k >= 85u) + (k >= 170u) + (k >= 254u);
  return (m - 32768u) & 0xFFFFu;
}

// 8-entry palette of a signed channel as 16-bit patterns, entries 0-3 in
// lo and 4-7 in hi.  int8 endpoints, -128 clamped to -127; the
// (-127, -128) pair makes the block invalid (decompress-rgtc.c:90-126).
DTX_HD bool luma_palette_s16(uint32_t w0, uint64_t& lo, uint64_t& hi) {
  int32_t l0 = sext8(w0), l1 = sext8(w0 >> 8);
  const bool valid = !(l0 == -127 && l1 == -128);
  l0 = l0 < -127 ? -127 : l0;
  l1 = l1 < -127 ? -127 : l1;
  const bool seven = l0 > l1;
  lo = snorm16(l0) | ((uint64_t)snorm16(l1) << 16);
  hi = 0;
DTX_UNROLL
  for (int32_t c = 2; c < 8; ++c) {
    int32_t v;
    if (seven) {
      v = div_trunc((8 - c) * l0 + (c - 1) * l1, 7u);
    } else if (c < 6) {
      v = div_trunc((6 - c) * l0 + (c - 1) * l1, 5u);
    } else {
      v = c == 6 ? -127 : 127;
    }
    const uint64_t e = (uint64_t)snorm16(v) << (16 * (c & 3));
    if (c < 4) {
      lo |= e;
    } else {
      hi |= e;
    }
  }
  return valid;
}

DTX_HD uint32_t sel8_u16(uint64_t lo, uint64_t hi, uint32_t code) {
  return (uint32_t)(((code & 4u) ? hi : lo) >> (16u * (code & 3u))) & 0xFFFFu;
}

// --- per-block decoders ---------------------------------------------------

// BC1 (kAlpha false) or BC1A: index 3 of a 3-colour block is black, and
// transparent in BC1A.  Flags (BC1A only): 0x4 rejects opaque blocks, 0x2
// non-opaque ones.
template <bool kAlpha>
DTX_HD bool bc1_decode_block(uint32_t colors, uint32_t indices,
                             uint32_t flags, uint32_t out[16]) {
  const bool opaque = four_colors(colors);
  uint32_t pal[4];
  color_palette(colors, opaque, pal);
  pal[0] |= 0xFF000000u;
  pal[1] |= 0xFF000000u;
  pal[2] |= 0xFF000000u;
  if (!kAlpha || opaque) pal[3] |= 0xFF000000u;
DTX_UNROLL
  for (int i = 0; i < 16; ++i) out[i] = sel4(pal, (indices >> (2 * i)) & 3u);
  bool valid = true;
  if (kAlpha) {
    if ((flags & 0x4u) && opaque) valid = false;
    if ((flags & 0x2u) && !opaque) valid = false;
  }
  return valid;
}

// BC2 (kBC3 false: explicit 4-bit alpha * 17, pixels 0-7 in aw0) or BC3
// (interpolated alpha), colours always 4-colour.  Flags: 0x1 rejects
// c0 <= c1; for BC3, 0x2 rejects a0 > a1.
template <bool kBC3>
DTX_HD bool bc23_decode_block(uint32_t aw0, uint32_t aw1, uint32_t colors,
                              uint32_t indices, uint32_t flags,
                              uint32_t out[16]) {
  uint32_t pal[4];
  color_palette(colors, true, pal);
  uint64_t apal = 0, codes = 0;
  if (kBC3) {
    apal = luma_palette_u8(aw0);
    codes = code_stream(aw0, aw1);
  }
DTX_UNROLL
  for (int i = 0; i < 16; ++i) {
    uint32_t a;
    if (kBC3) {
      a = sel8_u8(apal, code_at(codes, i));
    } else {
      a = (((i < 8 ? aw0 : aw1) >> ((4 * i) & 31)) & 0xFu) * 17u;
    }
    out[i] = sel4(pal, (indices >> (2 * i)) & 3u) | (a << 24);
  }
  bool valid = true;
  if ((flags & 0x1u) && !four_colors(colors)) valid = false;
  if (kBC3 && (flags & 0x2u) && (aw0 & 0xFFu) > ((aw0 >> 8) & 0xFFu)) {
    valid = false;
  }
  return valid;
}

// RGTC1 (BC4): 4 words of R8, or 8 words of SIGNED_R16 when kSigned.
template <bool kSigned>
DTX_HD bool rgtc1_decode_block(uint32_t w0, uint32_t w1,
                               uint32_t out[kSigned ? 8 : 4]) {
  const uint64_t codes = code_stream(w0, w1);
  if constexpr (kSigned) {
    uint64_t lo, hi;
    const bool valid = luma_palette_s16(w0, lo, hi);
DTX_UNROLL
    for (int w = 0; w < 8; ++w) {
      out[w] = sel8_u16(lo, hi, code_at(codes, 2 * w)) |
               (sel8_u16(lo, hi, code_at(codes, 2 * w + 1)) << 16);
    }
    return valid;
  } else {
    const uint64_t pal = luma_palette_u8(w0);
DTX_UNROLL
    for (int w = 0; w < 4; ++w) {
      uint32_t v = 0;
DTX_UNROLL
      for (int j = 0; j < 4; ++j) {
        v |= sel8_u8(pal, code_at(codes, 4 * w + j)) << (8 * j);
      }
      out[w] = v;
    }
    return true;
  }
}

// RGTC2 (BC5): R from (rw0, rw1), G from (gw0, gw1); 8 words of RG8, or
// 16 words of SIGNED_RG16 when kSigned.  Valid when both channels are.
template <bool kSigned>
DTX_HD bool rgtc2_decode_block(uint32_t rw0, uint32_t rw1, uint32_t gw0,
                               uint32_t gw1,
                               uint32_t out[kSigned ? 16 : 8]) {
  const uint64_t rc = code_stream(rw0, rw1), gc = code_stream(gw0, gw1);
  if constexpr (kSigned) {
    uint64_t rlo, rhi, glo, ghi;
    const bool vr = luma_palette_s16(rw0, rlo, rhi);
    const bool vg = luma_palette_s16(gw0, glo, ghi);
DTX_UNROLL
    for (int i = 0; i < 16; ++i) {
      out[i] = sel8_u16(rlo, rhi, code_at(rc, i)) |
               (sel8_u16(glo, ghi, code_at(gc, i)) << 16);
    }
    return vr && vg;
  } else {
    const uint64_t rp = luma_palette_u8(rw0), gp = luma_palette_u8(gw0);
DTX_UNROLL
    for (int w = 0; w < 8; ++w) {
      out[w] = sel8_u8(rp, code_at(rc, 2 * w)) |
               (sel8_u8(gp, code_at(gc, 2 * w)) << 8) |
               (sel8_u8(rp, code_at(rc, 2 * w + 1)) << 16) |
               (sel8_u8(gp, code_at(gc, 2 * w + 1)) << 24);
    }
    return true;
  }
}

}  // namespace dtx
