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

DTX_HD uint32_t nib(uint32_t packed, uint32_t mode) {
  return (packed >> (4u * mode)) & 0xFu;
}

DTX_HD uint32_t lowest_set_bit(uint32_t x) {  // x != 0
#if defined(__CUDA_ARCH__)
  return (uint32_t)(__ffs((int)x) - 1);
#else
  return (uint32_t)__builtin_ctz(x);
#endif
}

// `width` (<= 16) bits of the 128-bit block (lo | hi << 64) at bit
// `start`, where start + width <= 128.
DTX_HD uint32_t bits(uint64_t lo, uint64_t hi, uint32_t start,
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

// Where a block's partition comes from: the subset word (2 bits per pixel)
// and the second and third anchor positions, for `ns` subsets and
// partition id `psid`.
struct Partition {
  uint32_t subsets, a2, a3;
};

// The production kernel's source: the tables above.
struct TablePartition {
  DTX_HD Partition operator()(uint32_t ns, uint32_t psid) const {
    uint32_t subsets = 0;
    if (ns == 2) subsets = DTX_LOOKUP(kSubset2, psid);
    if (ns == 3) subsets = DTX_LOOKUP(kSubset3, psid);
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
struct PreGatheredPartition {
  uint32_t sub32, pos;
  DTX_HD Partition operator()(uint32_t ns, uint32_t) const {
    return {sub32, ns == 2 ? (pos & 0xFu) : ((pos >> 4) & 0xFu),
            (pos >> 8) & 0xFu};
  }
};

// Decodes one block into 16 packed RGBA8 pixels (R in the low byte, pixel
// i = 4y + x) and returns whether the block is valid under mode_mask and
// flags (0x2 rejects modes >= 4, 0x4 rejects modes < 4).  `partition`
// gives the subset word and anchors (TablePartition for BC7 itself).
template <class PartitionSource>
DTX_HD bool bc7_decode_block(uint64_t lo, uint64_t hi, uint32_t mode_mask,
                             uint32_t flags, uint32_t out[16],
                             const PartitionSource& partition) {
  const uint32_t byte0 = (uint32_t)lo & 0xFFu;
  const uint32_t m = byte0 ? lowest_set_bit(byte0) : 0u;

  const uint32_t ns = nib(kNS, m), pb = nib(kPB, m), rb = nib(kRB, m);
  const uint32_t cp = nib(kCP, m), cpp = nib(kCPP, m);
  const uint32_t ap = nib(kAP, m), app = nib(kAPP, m);
  const uint32_t ib = nib(kIB, m), ib2 = nib(kIB2, m);
  const bool has_pbits = cpp > cp || app > ap;

  uint32_t pos = m + 1;
  const uint32_t psid = bits(lo, hi, pos, pb);
  pos += pb;
  const uint32_t rot = bits(lo, hi, pos, rb);
  pos += rb;
  const uint32_t isb = m == 4 ? bits(lo, hi, pos, 1) : 0u;
  pos += m == 4 ? 1u : 0u;
  const uint32_t ep_start = pos;
  const uint32_t alpha_start = ep_start + cp * ns * 6;
  const uint32_t pbit_start = alpha_start + ap * ns * 2;
  const uint32_t index_start =
      pbit_start + (has_pbits ? (m == 1 ? 2u : ns * 2) : 0u);
  const uint32_t sec_start = index_start + ib * 16 - ns;

  // ep[c][j][k]: channel c (RGBA), subset j, endpoint k, 8 bits.
  uint32_t ep[4][3][2];
DTX_UNROLL
  for (uint32_t j = 0; j < 3; ++j) {
DTX_UNROLL
    for (uint32_t k = 0; k < 2; ++k) {
      const bool used = j < ns;
      uint32_t pbit = 0;
      if (used && has_pbits && !(m == 6 && k == 1)) {
        pbit = bits(lo, hi, pbit_start + (m == 1 ? j : j * 2 + k), 1);
      }
DTX_UNROLL
      for (uint32_t c = 0; c < 3; ++c) {
        const uint32_t raw =
            used ? bits(lo, hi, ep_start + (c * ns * 2 + j * 2 + k) * cp, cp)
                 : 0u;
        ep[c][j][k] = dequant(raw, pbit, cp, cpp);
      }
      if (ap == 0) {
        ep[3][j][k] = 0xFFu;
      } else {
        const uint32_t raw =
            used ? bits(lo, hi, alpha_start + (j * 2 + k) * ap, ap) : 0u;
        ep[3][j][k] = dequant(raw, pbit, ap, app);
      }
    }
  }

  const Partition part = partition(ns, psid);
  const uint32_t subsets = part.subsets, a2 = part.a2, a3 = part.a3;

  // Stream choice (decompress-bptc.c:381-385, 422-451): with a second
  // stream, the index-selection bit gives colour the second stream.
  const bool color_sec = ib2 > 0 && isb != 0;
  const bool alpha_sec = ib2 > 0 && isb == 0;
  const Weights wc = weights_for(color_sec ? ib2 : ib);
  const Weights wa = weights_for(alpha_sec ? ib2 : ib);

  const uint32_t sh_r = rot == 1 ? 24u : 0u;
  const uint32_t sh_g = rot == 2 ? 24u : 8u;
  const uint32_t sh_b = rot == 3 ? 24u : 16u;
  const uint32_t sh_a = rot == 0 ? 24u : (rot - 1) * 8u;

DTX_UNROLL
  for (uint32_t i = 0; i < 16; ++i) {
    const bool anchor = i == 0 || (ns >= 2 && i == a2) || (ns == 3 && i == a3);
    const uint32_t before = (i > 0 ? 1u : 0u) + (ns >= 2 && a2 < i ? 1u : 0u) +
                            (ns == 3 && a3 < i ? 1u : 0u);
    const uint32_t drop = anchor ? 1u : 0u;
    const uint32_t prim = bits(lo, hi, index_start + ib * i - before, ib - drop);
    const uint32_t sec =
        ib2 ? bits(lo, hi, sec_start + ib2 * i - before, ib2 - drop) : 0u;
    const uint32_t ci = color_sec ? sec : prim;
    const uint32_t ai = alpha_sec ? sec : prim;
    const uint32_t w_c = (ci * wc.mul64 + wc.cm) >> wc.sh;
    const uint32_t w_a = (ai * wa.mul64 + wa.cm) >> wa.sh;

    const uint32_t s = (subsets >> (2 * i)) & 3u;
    const uint32_t r = interp(sel3(s, ep[0][0][0], ep[0][1][0], ep[0][2][0]),
                              sel3(s, ep[0][0][1], ep[0][1][1], ep[0][2][1]),
                              w_c);
    const uint32_t g = interp(sel3(s, ep[1][0][0], ep[1][1][0], ep[1][2][0]),
                              sel3(s, ep[1][0][1], ep[1][1][1], ep[1][2][1]),
                              w_c);
    const uint32_t b = interp(sel3(s, ep[2][0][0], ep[2][1][0], ep[2][2][0]),
                              sel3(s, ep[2][0][1], ep[2][1][1], ep[2][2][1]),
                              w_c);
    const uint32_t a = interp(sel3(s, ep[3][0][0], ep[3][1][0], ep[3][2][0]),
                              sel3(s, ep[3][0][1], ep[3][1][1], ep[3][2][1]),
                              w_a);
    // Rotation is a permutation of output byte positions.
    out[i] = (r << sh_r) | (g << sh_g) | (b << sh_b) | (a << sh_a);
  }

  bool valid = byte0 != 0 && ((mode_mask >> m) & 1u) != 0;
  if ((flags & 0x2u) && m >= 4) valid = false;
  if ((flags & 0x4u) && m < 4) valid = false;
  return valid;
}

DTX_HD bool bc7_decode_block(uint64_t lo, uint64_t hi, uint32_t mode_mask,
                             uint32_t flags, uint32_t out[16]) {
  return bc7_decode_block(lo, hi, mode_mask, flags, out, TablePartition{});
}

}  // namespace dtx
