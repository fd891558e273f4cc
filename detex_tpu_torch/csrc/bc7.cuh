// BC7 (BPTC) per-block decode, shared by the CUDA kernel (bc7.cu) and a
// host build (bc7_host.cpp) that lets CPU tests run this exact code.
//
// Computes what detex_tpu/ops/pallas/bptc_pallas.py:_bc7_kernel computes,
// bit for bit, for every 128-bit input (reference semantics:
// decompress-bptc.c:354-512):
//   * byte0 == 0 has no mode; the block is decoded as mode 0 anyway and
//     marked invalid.  Blocks rejected by mode_mask / flags are decoded
//     too: only `valid` says they were rejected.
//   * mode 1 shares one p-bit per subset; mode 6's second p-bit always
//     reads 0 (the reference reads both from data0 >> 63).
//   * anchor pixels store one index bit less; mode 4's index-selection
//     bit swaps the colour and alpha streams; rotation swaps alpha with
//     R/G/B after interpolation.
//   * interpolation ((64-w)*e0 + w*e1 + 32) >> 6, w = floor((64i+c)/d).
//
// The decode has two parts.  bc7_unpack<M> is written once per mode: every
// field position and per-mode constant is a compile-time value, so each
// field read folds to a shift or two.  It reduces the block to a Bc7Setup:
// packed endpoints, the subset word, weights, the rotation, and each index
// stream laid out at a uniform width (the bit an anchor pixel does not
// store put back as a 0).  bc7_pixels, one code path for every mode, then
// computes the 16 pixels from the setup.  bc7_decode_block dispatches on
// the mode to the unpack and runs bc7_pixels once, so a warp of mixed
// modes diverges only in the short unpack.
//
// All arithmetic is unsigned 32/64-bit and no shift reaches the operand
// width (a C++ shift by >= width is undefined, where lax.shift_left gives 0).

#pragma once

#include <stdint.h>

#include "dtx_hd.cuh"

namespace dtx {

// Subset id of each pixel, 2 bits per pixel (pixel i at bits 2i..2i+1), for
// the 64 two-subset and 64 three-subset partitions (bptc-tables.c:23-155;
// detex_tpu/data/bptc_tables.npz P2 and P3).
DTX_TABLE(kSubset2,
    0x50505050u, 0x40404040u, 0x54545454u, 0x54505040u, 0x50404000u, 0x55545450u,
    0x55545040u, 0x54504000u, 0x50400000u, 0x55555450u, 0x55544000u, 0x54400000u,
    0x55555440u, 0x55550000u, 0x55555500u, 0x55000000u, 0x55150100u, 0x00004054u,
    0x15010000u, 0x00405054u, 0x00004050u, 0x15050100u, 0x05010000u, 0x40505054u,
    0x00404050u, 0x05010100u, 0x14141414u, 0x05141450u, 0x01155440u, 0x00555500u,
    0x15014054u, 0x05414150u, 0x44444444u, 0x55005500u, 0x11441144u, 0x05055050u,
    0x05500550u, 0x11114444u, 0x41144114u, 0x44111144u, 0x15055054u, 0x01055040u,
    0x05041050u, 0x05455150u, 0x14414114u, 0x50050550u, 0x41411414u, 0x00141400u,
    0x00041504u, 0x00105410u, 0x10541000u, 0x04150400u, 0x50410514u, 0x41051450u,
    0x05415014u, 0x14054150u, 0x41050514u, 0x41505014u, 0x40011554u, 0x54150140u,
    0x50505500u, 0x00555050u, 0x15151010u, 0x54540404u)

DTX_TABLE(kSubset3,
    0xaa685050u, 0x6a5a5040u, 0x5a5a4200u, 0x5450a0a8u, 0xa5a50000u, 0xa0a05050u,
    0x5555a0a0u, 0x5a5a5050u, 0xaa550000u, 0xaa555500u, 0xaaaa5500u, 0x90909090u,
    0x94949494u, 0xa4a4a4a4u, 0xa9a59450u, 0x2a0a4250u, 0xa5945040u, 0x0a425054u,
    0xa5a5a500u, 0x55a0a0a0u, 0xa8a85454u, 0x6a6a4040u, 0xa4a45000u, 0x1a1a0500u,
    0x0050a4a4u, 0xaaa59090u, 0x14696914u, 0x69691400u, 0xa08585a0u, 0xaa821414u,
    0x50a4a450u, 0x6a5a0200u, 0xa9a58000u, 0x5090a0a8u, 0xa8a09050u, 0x24242424u,
    0x00aa5500u, 0x24924924u, 0x24499224u, 0x50a50a50u, 0x500aa550u, 0xaaaa4444u,
    0x66660000u, 0xa5a0a5a0u, 0x50a050a0u, 0x69286928u, 0x44aaaa44u, 0x66666600u,
    0xaa444444u, 0x54a854a8u, 0x95809580u, 0x96969600u, 0xa85454a8u, 0x80959580u,
    0xaa141414u, 0x96960000u, 0xaaaa1414u, 0xa05050a0u, 0xa0a5a5a0u, 0x96000000u,
    0x40804080u, 0xa9a8a9a8u, 0xaaaaaa44u, 0x2a4a5254u)

// Anchor pixel positions per partition, 4 bits each: bits 0-3 the second
// anchor of two subsets, 4-7 and 8-11 the second and third anchors of
// three subsets (bptc-tables.c:157-188; npz anchor2, anchor2of3, anchor3).
DTX_TABLE(kAnchors,
    0xf3fu, 0x83fu, 0x8ffu, 0x3ffu, 0xf8fu, 0xf3fu,
    0x3ffu, 0x8ffu, 0xf8fu, 0xf8fu, 0xf6fu, 0xf6fu,
    0xf6fu, 0xf5fu, 0xf3fu, 0x83fu, 0xf3fu, 0x832u,
    0xf88u, 0x3f2u, 0xf32u, 0x838u, 0xf68u, 0x8afu,
    0x352u, 0xf88u, 0x682u, 0xa62u, 0xf88u, 0xf58u,
    0xaf2u, 0x8f2u, 0xf8fu, 0x3ffu, 0xf36u, 0xa58u,
    0xa62u, 0x8a8u, 0x98fu, 0xaffu, 0x6f2u, 0xf38u,
    0x8f2u, 0xf52u, 0x3f2u, 0x6ffu, 0x6ffu, 0x8f6u,
    0xf36u, 0x3f2u, 0xf56u, 0xf58u, 0xf5fu, 0xf8fu,
    0xf52u, 0xfa2u, 0xf5fu, 0xfafu, 0xf8fu, 0xfdfu,
    0x3ffu, 0xfc2u, 0xf32u, 0x83fu)

// Per-mode constants (decompress-bptc.c:45-71), one nibble per mode: the
// value for mode m is (k >> 4m) & 0xF.
constexpr uint32_t kNS = 0x21112323u;   // subsets       3 2 3 2 1 1 1 2
constexpr uint32_t kPB = 0x60006664u;   // partition bits 4 6 6 6 0 0 0 6
constexpr uint32_t kRB = 0x00220000u;   // rotation bits  0 0 0 0 2 2 0 0
constexpr uint32_t kCP = 0x57757564u;   // colour bits    4 6 5 7 5 7 7 5
constexpr uint32_t kCPP = 0x68758575u;  // + p-bit        5 7 5 8 5 7 8 6
constexpr uint32_t kAP = 0x57860000u;   // alpha bits     0 0 0 0 6 8 7 5
constexpr uint32_t kAPP = 0x68860000u;  // + p-bit        0 0 0 0 6 8 8 6
constexpr uint32_t kIB = 0x24222233u;   // index bits     3 3 2 2 2 2 4 2
constexpr uint32_t kIB2 = 0x00230000u;  // second stream  0 0 0 0 3 2 0 0

DTX_HD constexpr uint32_t nib(uint32_t packed, uint32_t mode) {
  return (packed >> (4u * mode)) & 0xFu;
}

DTX_HD uint32_t lowest_set_bit(uint32_t x) {  // x != 0
#if defined(__CUDA_ARCH__)
  return (uint32_t)(__ffs((int)x) - 1);
#else
  return (uint32_t)__builtin_ctz(x);
#endif
}

// A block's mode: the lowest set bit of byte 0.  byte0 == 0 has none and
// is decoded as mode 0 (and marked invalid).
DTX_HD uint32_t bc7_mode(uint32_t word0) {
  const uint32_t byte0 = word0 & 0xFFu;
  return byte0 ? lowest_set_bit(byte0) : 0u;
}

// The 64 bits of the 128-bit block (lo | hi << 64) from bit `start`
// (< 128) up, zero above bit 127.
DTX_HD uint64_t bits64(uint64_t lo, uint64_t hi, uint32_t start) {
  if (start >= 64) return hi >> (start - 64);
  if (start == 0) return lo;
  return (lo >> start) | (hi << (64 - start));
}

// `width` (<= 16) bits of the block at bit `start`, where start + width
// <= 128.
DTX_HD uint32_t bits(uint64_t lo, uint64_t hi, uint32_t start,
                     uint32_t width) {
  return (uint32_t)bits64(lo, hi, start) & ((1u << width) - 1u);
}

// Endpoint to 8 bits: append the p-bit if the mode has one, shift up,
// replicate the top bits (decompress-bptc.c:136-180).
DTX_HD uint32_t dequant(uint32_t raw, uint32_t pbit, uint32_t prec,
                        uint32_t prec_p) {
  uint32_t v = prec_p > prec ? ((raw << 1) | pbit) : raw;
  v <<= 8u - prec_p;
  return (v | (v >> prec_p)) & 0xFFu;
}

DTX_HD uint32_t sel3(uint32_t s, uint32_t v0, uint32_t v1, uint32_t v2) {
  return s == 1 ? v1 : (s == 2 ? v2 : v0);
}

// floor((64*idx + c) / d) for (c, d) = (1,3), (3,7), (7,15) at 2, 3, 4
// index bits, as one multiply and shift: (idx*(mul<<6) + c*mul) >> sh.
// The magics are checked against the aWeight tables for every index at
// import of detex_tpu/ops/pallas/bptc_pallas.py.
struct Weights {
  uint32_t mul64, cm, sh;
};

DTX_HD Weights weights_for(uint32_t nbits) {
  if (nbits == 2) return {683u << 6, 1u * 683u, 11u};
  if (nbits == 3) return {9363u << 6, 3u * 9363u, 16u};
  return {34953u << 6, 7u * 34953u, 19u};
}

DTX_HD uint32_t interp(uint32_t e0, uint32_t e1, uint32_t w) {
  return ((64u - w) * e0 + w * e1 + 32u) >> 6;
}

// Byte k of the result is byte (sel >> 4k) & 3 of x.
DTX_HD uint32_t permute_bytes(uint32_t x, uint32_t sel) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, 0u, sel);
#else
  uint32_t r = 0;
  for (uint32_t k = 0; k < 4; ++k) {
    r |= ((x >> (8 * ((sel >> (4 * k)) & 3u))) & 0xFFu) << (8 * k);
  }
  return r;
#endif
}

// x with a 0 bit put in at bit p (< 64): the bits from p up move up one.
DTX_HD uint64_t insert_zero(uint64_t x, uint32_t p) {
  const uint64_t low = (uint64_t(1) << p) - 1u;
  return (x & low) | ((x & ~low) << 1);
}

// Where a block's partition comes from: the subset word (2 bits per pixel)
// and the second and third anchor positions, for `ns` subsets and
// partition id `psid`.
struct Partition {
  uint32_t subsets, a2, a3;
};

// The production kernel's source: the tables above (one subset needs
// none).  Their anchors are never pixel 0 and never equal.
struct TablePartition {
  static constexpr bool kTableAnchors = true;
  DTX_HD Partition operator()(uint32_t ns, uint32_t psid) const {
    if (ns == 1) return {0u, 0u, 0u};
    const uint32_t subsets = ns == 2 ? DTX_LOOKUP(kSubset2, psid)
                                     : DTX_LOOKUP(kSubset3, psid);
    const uint32_t anchors = DTX_LOOKUP(kAnchors, psid);
    return {subsets, ns == 2 ? (anchors & 0xFu) : ((anchors >> 4) & 0xFu),
            (anchors >> 8) & 0xFu};
  }
};

// Two words gathered per block ahead of the kernel
// (tools/mxu_probe.py:84-99): `sub32`, the subset word used as it is for
// every subset count, and `pos`, the anchors packed a0 | a1 << 4 | a2 << 8
// (the second of two subsets in bits 0-3, the second and third of three in
// bits 4-7 and 8-11), as tools/mxu_probe.py:_bc7_kernel_pre reads them.
// Any anchors are taken, the tables' or not.
struct PreGatheredPartition {
  static constexpr bool kTableAnchors = false;
  uint32_t sub32, pos;
  DTX_HD Partition operator()(uint32_t ns, uint32_t) const {
    return {sub32, ns == 2 ? (pos & 0xFu) : ((pos >> 4) & 0xFu),
            (pos >> 8) & 0xFu};
  }
};

// A block reduced to what its pixels need, whatever its mode.
struct Bc7Setup {
  uint32_t ep[3][2];      // endpoint k of subset j, packed RGBA8
  uint32_t subsets;       // subset of pixel i at bits 2i..2i+1
  uint64_t color, alpha;  // index of pixel i at bits [n*i, n*i + n)
  uint32_t cbits, abits;  // n of each stream: 2, 3 or 4
  Weights wc, wa;
  uint32_t perm;          // the rotation, as a permute_bytes selector
};

// A stream of 16 `ib`-bit indices built pixel by pixel from `window` (the
// 64 bits from 3 below the first index, zero above bit 127), for any
// anchors a2, a3: pixel i lies 3 + ib*i - before bits in, before the anchor
// pixels below i, each counted once (as tools/mxu_probe.py:_bc7_kernel_pre
// does with its anchor bitmask), and is one bit narrower where it is an
// anchor.  bc7_unpack's bit insertion gives the same for distinct anchors
// past pixel 0; this serves the others (pre-gathered words not from the
// tables), whose last index may run past bit 127 and read 0 there.
DTX_HD uint64_t bc7_stream_any_anchors(uint64_t window, uint32_t ib,
                                       uint32_t ns, uint32_t a2,
                                       uint32_t a3) {
  const bool on3 = ns == 3 && a3 != 0 && a3 != a2;
  uint64_t u = 0;
#if defined(__CUDA_ARCH__)
#pragma unroll 1
#endif
  for (uint32_t i = 0; i < 16; ++i) {
    const bool anchor = i == 0 || i == a2 || (ns == 3 && i == a3);
    const uint32_t before = (i > 0 ? 1u : 0u) +
                            (a2 != 0 && a2 < i ? 1u : 0u) +
                            (on3 && a3 < i ? 1u : 0u);
    const uint32_t idx = (uint32_t)(window >> (3 + ib * i - before)) &
                         ((1u << (ib - (anchor ? 1u : 0u))) - 1u);
    u |= (uint64_t)idx << (ib * i);
  }
  return u;
}

// Unpacks one block of mode M (the block's bc7_mode) into its Bc7Setup
// (decompress-bptc.c:354-512).  `partition` gives the subset word and
// anchors (TablePartition for BC7 itself).
template <uint32_t M, class PartitionSource>
DTX_HD Bc7Setup bc7_unpack(uint64_t lo, uint64_t hi,
                           const PartitionSource& partition) {
  constexpr uint32_t ns = nib(kNS, M), pb = nib(kPB, M), rb = nib(kRB, M);
  constexpr uint32_t cp = nib(kCP, M), cpp = nib(kCPP, M);
  constexpr uint32_t ap = nib(kAP, M), app = nib(kAPP, M);
  constexpr uint32_t ib = nib(kIB, M), ib2 = nib(kIB2, M);
  constexpr bool has_pbits = cpp > cp || app > ap;
  constexpr uint32_t rot_start = M + 1 + pb;
  constexpr uint32_t ep_start = rot_start + rb + (M == 4 ? 1u : 0u);
  constexpr uint32_t alpha_start = ep_start + cp * ns * 6;
  constexpr uint32_t pbit_start = alpha_start + ap * ns * 2;
  constexpr uint32_t index_start =
      pbit_start + (has_pbits ? (M == 1 ? 2u : ns * 2) : 0u);
  constexpr uint32_t prim_bits = ib * 16 - ns;  // as stored
  constexpr uint32_t sec_start = index_start + prim_bits;

  const uint32_t psid = bits(lo, hi, M + 1, pb);
  const uint32_t rot = bits(lo, hi, rot_start, rb);
  const uint32_t isb = M == 4 ? bits(lo, hi, rot_start + rb, 1) : 0u;

  Bc7Setup s;
DTX_UNROLL
  for (uint32_t j = 0; j < 3; ++j) {
DTX_UNROLL
    for (uint32_t k = 0; k < 2; ++k) {
      const bool used = j < ns;
      uint32_t pbit = 0;
      if (used && has_pbits && !(M == 6 && k == 1)) {
        pbit = bits(lo, hi, pbit_start + (M == 1 ? j : j * 2 + k), 1);
      }
      uint32_t rgba = 0;
DTX_UNROLL
      for (uint32_t c = 0; c < 3; ++c) {
        const uint32_t raw =
            used ? bits(lo, hi, ep_start + (c * ns * 2 + j * 2 + k) * cp, cp)
                 : 0u;
        rgba |= dequant(raw, pbit, cp, cpp) << (8 * c);
      }
      uint32_t a = 0xFFu;
      if (ap != 0) {
        const uint32_t raw =
            used ? bits(lo, hi, alpha_start + (j * 2 + k) * ap, ap) : 0u;
        a = dequant(raw, pbit, ap, app);
      }
      s.ep[j][k] = rgba | (a << 24);
    }
  }

  const Partition part = partition(ns, psid);
  s.subsets = part.subsets;

  // The primary stream, each anchor's missing top bit put back as a 0 in
  // rising pixel order: pixel 0, then the smaller and larger other anchor.
  uint64_t prim = bits64(lo, hi, index_start);
  if (prim_bits < 64) prim &= (uint64_t(1) << prim_bits) - 1u;
  prim = insert_zero(prim, ib - 1);
  if (ns >= 2) {
    const uint32_t a2 = part.a2, a3 = part.a3;
    if (!PartitionSource::kTableAnchors &&
        (a2 == 0 || (ns == 3 && (a3 == 0 || a3 == a2)))) {
      prim = bc7_stream_any_anchors(bits64(lo, hi, index_start - 3), ib, ns,
                                    a2, a3);
    } else if (ns == 2) {
      prim = insert_zero(prim, ib * a2 + ib - 1);
    } else {
      const uint32_t q1 = a2 < a3 ? a2 : a3, q2 = a2 < a3 ? a3 : a2;
      prim = insert_zero(prim, ib * q1 + ib - 1);
      prim = insert_zero(prim, ib * q2 + ib - 1);
    }
  }
  // Modes 4 and 5: a second stream (one subset: anchor pixel 0 only), and
  // mode 4's index-selection bit gives colour the second stream
  // (decompress-bptc.c:381-385, 422-451).
  uint64_t sec = 0;
  if (ib2 > 0) sec = insert_zero(bits64(lo, hi, sec_start), ib2 - 1);
  const bool color_sec = ib2 > 0 && isb != 0;
  const bool alpha_sec = ib2 > 0 && isb == 0;
  s.color = color_sec ? sec : prim;
  s.alpha = alpha_sec ? sec : prim;
  s.cbits = color_sec ? ib2 : ib;
  s.abits = alpha_sec ? ib2 : ib;
  s.wc = weights_for(s.cbits);
  s.wa = weights_for(s.abits);
  // Rotation swaps alpha with R, G or B (rot 1, 2, 3) after interpolation.
  s.perm = rb ? (uint32_t)(0x2310123002133210ull >> (16 * rot)) & 0xFFFFu
              : 0x3210u;
  return s;
}

// The 16 packed RGBA8 pixels (R in the low byte, pixel i = 4y + x) of an
// unpacked block: interpolation ((64-w)*e0 + w*e1 + 32) >> 6 per channel,
// w = floor((64i+c)/d), R and B side by side in the 16-bit halves of one
// word (a term is at most 64*255 + 32 < 2^16).
DTX_HD void bc7_pixels(const Bc7Setup& s, uint32_t out[16]) {
  uint64_t color = s.color, alpha = s.alpha;
  const uint32_t cmask = (1u << s.cbits) - 1u, amask = (1u << s.abits) - 1u;
DTX_UNROLL
  for (uint32_t i = 0; i < 16; ++i) {
    const uint32_t ci = (uint32_t)color & cmask;
    const uint32_t ai = (uint32_t)alpha & amask;
    color >>= s.cbits;
    alpha >>= s.abits;
    const uint32_t wc = (ci * s.wc.mul64 + s.wc.cm) >> s.wc.sh;
    const uint32_t wa = (ai * s.wa.mul64 + s.wa.cm) >> s.wa.sh;
    const uint32_t sub = (s.subsets >> (2 * i)) & 3u;
    const uint32_t e0 = sel3(sub, s.ep[0][0], s.ep[1][0], s.ep[2][0]);
    const uint32_t e1 = sel3(sub, s.ep[0][1], s.ep[1][1], s.ep[2][1]);
    const uint32_t rb = (((e0 & 0x00FF00FFu) * (64u - wc) +
                          (e1 & 0x00FF00FFu) * wc + 0x00200020u) >> 6) &
                        0x00FF00FFu;
    const uint32_t g = interp((e0 >> 8) & 0xFFu, (e1 >> 8) & 0xFFu, wc);
    const uint32_t a = interp(e0 >> 24, e1 >> 24, wa);
    out[i] = permute_bytes(rb | (g << 8) | (a << 24), s.perm);
  }
}

// Whether a block of mode `mode` is valid under mode_mask and flags (0x2
// rejects modes >= 4, 0x4 rejects modes < 4); byte0 == 0 never is.
DTX_HD bool bc7_valid(uint64_t lo, uint32_t mode, uint32_t mode_mask,
                      uint32_t flags) {
  bool valid = (lo & 0xFFu) != 0 && ((mode_mask >> mode) & 1u) != 0;
  if ((flags & 0x2u) && mode >= 4) valid = false;
  if ((flags & 0x4u) && mode < 4) valid = false;
  return valid;
}

// Decodes one block into 16 packed RGBA8 pixels and returns whether it is
// valid: the mode's unpack, then bc7_pixels.
template <class PartitionSource>
DTX_HD bool bc7_decode_block(uint64_t lo, uint64_t hi, uint32_t mode_mask,
                             uint32_t flags, uint32_t out[16],
                             const PartitionSource& partition) {
  const uint32_t mode = bc7_mode((uint32_t)lo);
  Bc7Setup s;
  switch (mode) {
#define DTX_BC7_CASE(M)                       \
  case M:                                     \
    s = bc7_unpack<M>(lo, hi, partition);     \
    break;
    DTX_BC7_CASE(0) DTX_BC7_CASE(1) DTX_BC7_CASE(2) DTX_BC7_CASE(3)
    DTX_BC7_CASE(4) DTX_BC7_CASE(5) DTX_BC7_CASE(6)
#undef DTX_BC7_CASE
    default:
      s = bc7_unpack<7>(lo, hi, partition);
  }
  bc7_pixels(s, out);
  return bc7_valid(lo, mode, mode_mask, flags);
}

DTX_HD bool bc7_decode_block(uint64_t lo, uint64_t hi, uint32_t mode_mask,
                             uint32_t flags, uint32_t out[16]) {
  return bc7_decode_block(lo, hi, mode_mask, flags, out, TablePartition{});
}

#if defined(__CUDACC__)

// The CUDA kernels' body (bc7.cu, bc7_pre.cu): one CUDA block of kThreads
// threads decodes a tile of kThreads * kRounds consecutive 4x4 blocks.
//   1. Each thread loads kRounds of the tile's blocks (16 B loads,
//      consecutive threads on consecutive blocks) into shared memory, with
//      the pre-gathered partition words where kPre.
//   2. The tile's blocks are ordered by mode (order_rows), and rounds of
//      kThreads threads walk that order, so a warp mostly unpacks one
//      mode.
//   3. Each block's pixels go to its own row of the tile in shared memory
//      (TileOut), and after __syncthreads() the tile's 64 B rows go out in
//      order as contiguous 16 B stores.
template <int kRounds, bool kPre>
__device__ __forceinline__ void bc7_tile(const uint4* __restrict__ words,
                                         const uint2* __restrict__ pre,
                                         long long n, uint32_t mode_mask,
                                         uint32_t flags,
                                         uint4* __restrict__ pixels,
                                         bool* __restrict__ valid) {
  constexpr int kTile = kThreads * kRounds;
  constexpr uint32_t kModes = 8;
  __shared__ uint4 s_words[kTile];
  __shared__ uint2 s_pre[kPre ? kTile : 1];
  __shared__ TileOut<16, kTile> s_out;
  __shared__ uint16_t s_order[kTile];
  __shared__ uint32_t s_count[kModes + 1];
  const long long base = (long long)blockIdx.x * kTile;
  const int rows = n - base < kTile ? (int)(n - base) : kTile;
  const int t = threadIdx.x;

  uint32_t bin[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int e = r * kThreads + t;
    bin[r] = kModes;
    if (e < rows) {
      const uint4 w = words[base + e];
      s_words[e] = w;
      if (kPre) s_pre[e] = pre[base + e];
      bin[r] = bc7_mode(w.x);
    }
  }
  order_rows<kRounds, kModes>(bin, s_count, s_order);

#pragma unroll 1
  for (int r = 0; r < kRounds; ++r) {
    const int j = r * kThreads + t;
    if (j >= rows) break;
    const int e = s_order[j];
    const uint4 w = s_words[e];
    const uint64_t lo = (uint64_t)w.x | ((uint64_t)w.y << 32);
    const uint64_t hi = (uint64_t)w.z | ((uint64_t)w.w << 32);
    uint32_t out[16];
    bool ok;
    if (kPre) {
      ok = bc7_decode_block(lo, hi, mode_mask, flags, out,
                            PreGatheredPartition{s_pre[e].x, s_pre[e].y});
    } else {
      ok = bc7_decode_block(lo, hi, mode_mask, flags, out);
    }
    s_out.put(e, out, ok);
  }
  __syncthreads();
  s_out.store(pixels + base * 4, valid + base, rows);
}

#endif  // __CUDACC__

}  // namespace dtx
