// dtxnative — native C++ host runtime for the detex-tpu framework.
//
// A from-scratch, multithreaded CPU implementation of every compressed
// block family the framework decodes (BC1-BC7, RGTC, BC6H, ETC1/ETC2,
// EAC; reference semantics per /root/reference decompress-*.c, cited
// per function).  It serves three roles:
//   1. in-repo bit-exactness oracle for the JAX/Pallas kernels
//      (golden generation without needing the reference tree),
//   2. fast host-side decode for the CLI tools when no accelerator is
//      attached,
//   3. the native half of the framework runtime (block slicing and
//      threaded decode run off the Python GIL).
//
// C ABI (see detex_tpu/native.py):
//   int dtx_decode(int family, const uint8_t* blocks, int64_t n,
//                  uint8_t* out, uint8_t* valid,
//                  uint32_t mode_mask, uint32_t flags, int n_threads);
// Returns 0 on success.  `out` layout matches the framework's golden
// packers (RGBA8 u32 / u8 / u16 / i16 per family).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "dtx_tables.h"

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;
using i64 = int64_t;

enum Family {
  kBC1 = 0, kBC1A, kBC2, kBC3,
  kRGTC1, kSignedRGTC1, kRGTC2, kSignedRGTC2,
  kBPTCFloat, kBPTCSignedFloat, kBPTC,
  kETC1, kETC2, kETC2PT, kETC2EAC,
  kEACR11, kEACSignedR11, kEACRG11, kEACSignedRG11,
  kNumFamilies
};

struct FamilyInfo { int block_bytes; int out_bytes; };
const FamilyInfo kInfo[kNumFamilies] = {
  {8, 64}, {8, 64}, {16, 64}, {16, 64},          // BC1..BC3
  {8, 16}, {8, 32}, {16, 32}, {16, 64},          // RGTC
  {16, 128}, {16, 128}, {16, 64},                // BC6H x2, BC7
  {8, 64}, {8, 64}, {8, 64}, {16, 64},           // ETC family
  {8, 32}, {8, 32}, {16, 64}, {16, 64},          // EAC
};

enum Flags { kFlagEncode = 1, kFlagOpaqueOnly = 2, kFlagNonOpaqueOnly = 4 };

inline u64 load64(const u8* p) { u64 v; std::memcpy(&v, p, 8); return v; }
inline u32 load32(const u8* p) { u32 v; std::memcpy(&v, p, 4); return v; }
inline int getbits64(u64 d, int start, int width) {
  return int((d >> start) & ((1ull << width) - 1));
}
inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// ---------------------------------------------------------------------
// BC1/BC2/BC3 (decompress-bc.c:23-240 semantics)
// ---------------------------------------------------------------------

struct Pal4 { int r[4], g[4], b[4]; bool opaque; };

Pal4 bc1_palette(u32 colors, bool always4) {
  Pal4 p;
  int c0 = colors & 0xFFFF, c1 = colors >> 16;
  int r0 = ((c0 >> 11) & 31) << 3, g0 = ((c0 >> 5) & 63) << 2,
      b0 = (c0 & 31) << 3;
  int r1 = ((c1 >> 11) & 31) << 3, g1 = ((c1 >> 5) & 63) << 2,
      b1 = (c1 & 31) << 3;
  p.opaque = c0 > c1;
  p.r[0] = r0; p.r[1] = r1; p.g[0] = g0; p.g[1] = g1;
  p.b[0] = b0; p.b[1] = b1;
  if (p.opaque || always4) {
    p.r[2] = (2 * r0 + r1) / 3; p.r[3] = (r0 + 2 * r1) / 3;
    p.g[2] = (2 * g0 + g1) / 3; p.g[3] = (g0 + 2 * g1) / 3;
    p.b[2] = (2 * b0 + b1) / 3; p.b[3] = (b0 + 2 * b1) / 3;
  } else {
    p.r[2] = (r0 + r1) / 2; p.r[3] = 0;
    p.g[2] = (g0 + g1) / 2; p.g[3] = 0;
    p.b[2] = (b0 + b1) / 2; p.b[3] = 0;
  }
  return p;
}

inline void put_rgba(u8* out, int i, int r, int g, int b, int a) {
  out[i * 4 + 0] = u8(r); out[i * 4 + 1] = u8(g);
  out[i * 4 + 2] = u8(b); out[i * 4 + 3] = u8(a);
}

bool decode_bc1(const u8* blk, u8* out, bool bc1a, u32 flags) {
  Pal4 p = bc1_palette(load32(blk), false);
  u32 idxw = load32(blk + 4);
  for (int i = 0; i < 16; i++) {
    int idx = (idxw >> (2 * i)) & 3;
    int a = 0xFF;
    if (bc1a && idx == 3 && !p.opaque) a = 0;
    put_rgba(out, i, p.r[idx], p.g[idx], p.b[idx], a);
  }
  if (bc1a) {
    if ((flags & kFlagNonOpaqueOnly) && p.opaque) return false;
    if ((flags & kFlagOpaqueOnly) && !p.opaque) return false;
  }
  return true;
}

// 3-bit-coded alpha channel shared by BC3/RGTC (decompress-bc.c:177-235).
void alpha3_codes(const u8* blk, int codes[16]) {
  u64 d = load64(blk);
  for (int i = 0; i < 16; i++) codes[i] = int((d >> (16 + 3 * i)) & 7);
}

int alpha3_value(int code, int a0, int a1) {
  if (code == 0) return a0;
  if (code == 1) return a1;
  if (a0 > a1) return ((8 - code) * a0 + (code - 1) * a1) / 7;
  if (code == 6) return 0;
  if (code == 7) return 255;
  return ((6 - code) * a0 + (code - 1) * a1) / 5;
}

bool decode_bc2(const u8* blk, u8* out, u32, u32 flags) {
  Pal4 p = bc1_palette(load32(blk + 8), true);
  u32 idxw = load32(blk + 12);
  u64 aw = load64(blk);
  for (int i = 0; i < 16; i++) {
    int idx = (idxw >> (2 * i)) & 3;
    int a4 = int((aw >> (4 * i)) & 0xF);
    put_rgba(out, i, p.r[idx], p.g[idx], p.b[idx], a4 * 255 / 15);
  }
  if (flags & kFlagEncode) {
    int c0 = load32(blk + 8) & 0xFFFF, c1 = load32(blk + 8) >> 16;
    if (!(c0 > c1)) return false;
  }
  return true;
}

bool decode_bc3(const u8* blk, u8* out, u32, u32 flags) {
  Pal4 p = bc1_palette(load32(blk + 8), true);
  u32 idxw = load32(blk + 12);
  int a0 = blk[0], a1 = blk[1], codes[16];
  alpha3_codes(blk, codes);
  for (int i = 0; i < 16; i++) {
    int idx = (idxw >> (2 * i)) & 3;
    put_rgba(out, i, p.r[idx], p.g[idx], p.b[idx],
             alpha3_value(codes[i], a0, a1));
  }
  if ((flags & kFlagOpaqueOnly) && a0 > a1) return false;
  if (flags & kFlagEncode) {
    int c0 = load32(blk + 8) & 0xFFFF, c1 = load32(blk + 8) >> 16;
    if (!(c0 > c1)) return false;
  }
  return true;
}

// ---------------------------------------------------------------------
// RGTC (decompress-rgtc.c semantics)
// ---------------------------------------------------------------------

void rgtc_unsigned(const u8* blk, u8* out, int stride) {
  int a0 = blk[0], a1 = blk[1], codes[16];
  alpha3_codes(blk, codes);
  for (int i = 0; i < 16; i++) out[i * stride] = u8(alpha3_value(codes[i], a0, a1));
}

inline int div_trunc(int num, int den) {
  int s = num < 0 ? -1 : 1;
  return s * ((s * num) / den);
}

bool rgtc_signed(const u8* blk, int16_t* out, int stride) {
  int l0 = int8_t(blk[0]), l1 = int8_t(blk[1]);
  if (l0 == -127 && l1 == -128) return false;
  if (l0 < -127) l0 = -127;
  if (l1 < -127) l1 = -127;
  int codes[16];
  alpha3_codes(blk, codes);
  for (int i = 0; i < 16; i++) {
    int c = codes[i], v;
    if (c == 0) v = l0;
    else if (c == 1) v = l1;
    else if (l0 > l1) v = div_trunc((8 - c) * l0 + (c - 1) * l1, 7);
    else if (c == 6) v = -127;
    else if (c == 7) v = 127;
    else v = div_trunc((6 - c) * l0 + (c - 1) * l1, 5);
    out[i * stride] = int16_t((v + 127) * 65535 / 254 - 32768);
  }
  return true;
}

// ---------------------------------------------------------------------
// BC7 (decompress-bptc.c:354-512 semantics)
// ---------------------------------------------------------------------

struct Bits128 {
  u64 lo, hi;
  int pos = 0;
  int take(int width) {
    int v;
    if (pos + width <= 64) v = int((lo >> pos) & ((1ull << width) - 1));
    else if (pos >= 64) v = int((hi >> (pos - 64)) & ((1ull << width) - 1));
    else {
      u64 l = lo >> pos;
      u64 h = hi << (64 - pos);
      v = int((l | h) & ((1ull << width) - 1));
    }
    pos += width;
    return v;
  }
  int at(int p, int width) const {
    Bits128 b{lo, hi, p};
    return b.take(width);
  }
};

bool decode_bc7(const u8* blk, u8* out, u32 mode_mask, u32 flags) {
  Bits128 bs{load64(blk), load64(blk + 8)};
  int mode = -1;
  for (int m = 0; m < 8; m++)
    if (blk[0] & (1 << m)) { mode = m; break; }
  if (mode < 0) return false;
  if (!((mode_mask >> mode) & 1)) return false;
  if ((flags & kFlagOpaqueOnly) && mode >= 4) return false;
  if ((flags & kFlagNonOpaqueOnly) && mode < 4) return false;

  bs.pos = mode + 1;
  int ns = kNS[mode];
  int psid = kPB[mode] ? bs.take(kPB[mode]) : 0;
  int rot = kRB[mode] ? bs.take(kRB[mode]) : 0;
  int isb = kISB[mode] ? bs.take(1) : 0;

  int ep[3][2][4];  // [subset][endpoint][component]
  int cp = kCP[mode], ap = kAP[mode];
  for (int c = 0; c < 3; c++)
    for (int j = 0; j < ns; j++)
      for (int k = 0; k < 2; k++) ep[j][k][c] = bs.take(cp);
  if (ap)
    for (int j = 0; j < ns; j++)
      for (int k = 0; k < 2; k++) ep[j][k][3] = bs.take(ap);

  // p-bits (mode 1 shared per subset; mode 6's second p-bit reads 0 —
  // bug-compatible with the reference's data0>>63 read).
  int pbit[3][2] = {{0}};
  if (kHasPB[mode]) {
    if (mode == 1) {
      int s0 = bs.take(1), s1 = bs.take(1);
      pbit[0][0] = pbit[0][1] = s0;
      pbit[1][0] = pbit[1][1] = s1;
    } else {
      for (int j = 0; j < ns; j++)
        for (int k = 0; k < 2; k++) pbit[j][k] = bs.take(1);
      if (mode == 6) pbit[0][1] = 0;
    }
  }
  int cpp = kCPP[mode], app = kAPP[mode];
  for (int j = 0; j < ns; j++)
    for (int k = 0; k < 2; k++) {
      for (int c = 0; c < 4; c++) {
        if (c == 3 && !ap) { ep[j][k][3] = 0xFF; continue; }
        int prec = c == 3 ? ap : cp, precp = c == 3 ? app : cpp;
        int v = ep[j][k][c];
        if (precp > prec) v = (v << 1) | pbit[j][k];
        v <<= (8 - precp);
        ep[j][k][c] = v | (v >> precp);
      }
      if (mode <= 3) ep[j][k][3] = 0xFF;
    }

  const int* subset_tab =
      ns == 3 ? &kP3[psid * 16] : (ns == 2 ? &kP2[psid * 16] : nullptr);
  int anchors[3] = {0, 0, 0};
  if (ns == 2) anchors[1] = kAnchor2[psid];
  if (ns == 3) { anchors[1] = kAnchor2of3[psid]; anchors[2] = kAnchor3[psid]; }

  int ib = kIB[mode], ib2 = kIB2[mode];
  int prim[16], sec[16];
  for (int i = 0; i < 16; i++) {
    int sub = subset_tab ? subset_tab[i] : 0;
    bool anchor = (i == 0) || (ns >= 2 && i == anchors[1]) ||
                  (ns == 3 && i == anchors[2]);
    (void)sub;
    prim[i] = bs.take(anchor ? ib - 1 : ib);
  }
  if (ib2)
    for (int i = 0; i < 16; i++) {
      bool anchor = (i == 0) || (ns >= 2 && i == anchors[1]) ||
                    (ns == 3 && i == anchors[2]);
      sec[i] = bs.take(anchor ? ib2 - 1 : ib2);
    }

  const int* wtab[5] = {nullptr, nullptr, kWeight2, kWeight3, kWeight4};
  for (int i = 0; i < 16; i++) {
    int sub = subset_tab ? subset_tab[i] : 0;
    int cidx = prim[i], cbits = ib, aidx = prim[i], abits = ib;
    if (ib2) {
      if (isb) { cidx = sec[i]; cbits = ib2; aidx = prim[i]; abits = ib; }
      else { aidx = sec[i]; abits = ib2; }
    }
    int wc = wtab[cbits][cidx];
    int wa = wtab[abits][aidx];
    int px[4];
    for (int c = 0; c < 4; c++) {
      int w = c == 3 ? wa : wc;
      int e0 = ep[sub][0][c], e1 = ep[sub][1][c];
      px[c] = ((64 - w) * e0 + w * e1 + 32) >> 6;
    }
    if (rot == 1) std::swap(px[3], px[0]);
    if (rot == 2) std::swap(px[3], px[1]);
    if (rot == 3) std::swap(px[3], px[2]);
    put_rgba(out, i, px[0], px[1], px[2], px[3]);
  }
  return true;
}

// ---------------------------------------------------------------------
// BC6H (decompress-bptc-float.c semantics)
// ---------------------------------------------------------------------

inline int sign_extend(int v, int bits) {
  int half = 1 << (bits - 1);
  return ((v & ((1 << bits) - 1)) ^ half) - half;
}

bool decode_bc6h(const u8* blk, u16* out, u32 mode_mask, bool sig) {
  Bits128 bs{load64(blk), load64(blk + 8)};
  int m2 = int(bs.lo & 3);
  int mode = m2 < 2 ? m2 : kMapMode[bs.lo & 31];
  if (mode < 0) return false;
  if (!((mode_mask >> mode) & 1)) return false;
  int epb = kEPB[mode];

  int ep[12] = {0};  // r0..r3, g0..g3, b0..b3
  for (int f = 0; f < kBC6HNumFields; f++) {
    const int* row = &kBC6HFields[f * 6];
    if (row[0] != mode) continue;
    int dest = row[1], lo = row[2], hi = row[3], shift = row[4],
        rev = row[5];
    int width = hi - lo + 1, val = 0;
    if (rev) {
      for (int i = 0; i < width; i++) val |= bs.at(hi - i, 1) << i;
    } else {
      val = bs.at(lo, width);
    }
    ep[dest] |= val << shift;
  }

  int ns = mode >= 10 ? 1 : 2;
  for (int c = 0; c < 3; c++) {
    int* e = &ep[c * 4];
    if (sig) e[0] = sign_extend(e[0], epb);
    // modes 9/10 are untransformed (kDelta row is zero there)
    bool has_delta = kDelta[mode * 3 + c] != 0;
    for (int i = 1; i < ns * 2; i++) {
      if (has_delta) {
        int d = sign_extend(e[i], kDelta[mode * 3 + c]);
        e[i] = (e[0] + d) & ((1 << epb) - 1);
        if (sig) e[i] = sign_extend(e[i], epb);
      } else if (sig) {
        e[i] = sign_extend(e[i], epb);
      }
    }
    for (int i = 0; i < ns * 2; i++) {
      int x = e[i];
      if (sig) {
        if (epb < 16) {
          int mag = x < 0 ? -x : x, s = x < 0 ? -1 : 1;
          int unq;
          if (mag == 0) unq = 0;
          else if (mag >= (1 << (epb - 1)) - 1) unq = 0x7FFF;
          else unq = ((mag << 15) + 0x4000) >> (epb - 1);
          x = s * unq;
        }
      } else if (mode != 13) {
        if (x == 0) x = 0;
        else if (x == (1 << epb) - 1) x = 0xFFFF;
        else x = int((u32(x) << 15) + 0x4000) >> (epb - 1);
      }
      e[i] = x;
    }
  }

  int psid = ns == 2 ? bs.at(77, 5) : 0;
  const int* subset_tab = ns == 2 ? &kP2[psid * 16] : nullptr;
  int anchor2 = ns == 2 ? kAnchor2[psid] : 0;
  int ib = ns == 2 ? 3 : 4;
  bs.pos = ns == 2 ? 82 : 65;
  const int* wtab = ns == 2 ? kWeight3 : kWeight4;
  for (int i = 0; i < 16; i++) {
    bool anchor = (i == 0) || (ns == 2 && i == anchor2);
    int idx = bs.take(anchor ? ib - 1 : ib);
    int w = wtab[idx];
    int sub = subset_tab ? subset_tab[i] : 0;
    for (int c = 0; c < 3; c++) {
      int e0 = ep[c * 4 + sub * 2], e1 = ep[c * 4 + sub * 2 + 1];
      int v = ((64 - w) * e0 + w * e1 + 32) >> 6;
      if (sig) {
        int scaled = v < 0 ? -((-v * 31) >> 5) : (v * 31) >> 5;
        v = scaled < 0 ? ((-scaled) | 0x8000) : scaled;
      } else {
        v = (v * 31) / 64;
      }
      out[i * 4 + c] = u16(v);
    }
    out[i * 4 + 3] = 0;
  }
  return true;
}

// ---------------------------------------------------------------------
// ETC1 / ETC2 (decompress-etc.c semantics)
// ---------------------------------------------------------------------

inline int rep4(int v) { return v | (v << 4); }
inline int rep5hi(int v) { return v | ((v & 224) >> 5); }

struct EtcState {
  int b[8];           // bytes 0..7
  u32 pix_word;       // big-endian bytes 4-7
  int mode;           // 0 ind, 1 diff, 2 T, 3 H, 4 planar
  int base1[3], base2[3];  // selected subblock bases (ind or diff)
  bool overflow[3];
};

EtcState etc_analyze(const u8* blk, bool etc1_only, bool punchthrough) {
  EtcState s;
  for (int i = 0; i < 8; i++) s.b[i] = blk[i];
  s.pix_word = (u32(blk[4]) << 24) | (u32(blk[5]) << 16) |
               (u32(blk[6]) << 8) | u32(blk[7]);
  bool differential = (s.b[3] & 2) != 0;
  int raw2[3];
  for (int c = 0; c < 3; c++) {
    int d = s.b[c] & 7;
    int comp = d >= 4 ? (d - 8) << 3 : d << 3;
    raw2[c] = (s.b[c] & 0xF8) + comp;
    s.overflow[c] = (raw2[c] & 0xFF07) != 0;
  }
  if (etc1_only) s.mode = differential ? 1 : 0;
  else if (punchthrough)
    s.mode = s.overflow[0] ? 2 : s.overflow[1] ? 3 : s.overflow[2] ? 4 : 1;
  else if (!differential) s.mode = 0;
  else s.mode = s.overflow[0] ? 2 : s.overflow[1] ? 3 : s.overflow[2] ? 4 : 1;
  for (int c = 0; c < 3; c++) {
    if (s.mode == 0) {
      s.base1[c] = (s.b[c] & 0xF0) | ((s.b[c] & 0xF0) >> 4);
      s.base2[c] = rep4(s.b[c] & 0x0F);
    } else {
      s.base1[c] = rep5hi(s.b[c] & 0xF8);
      s.base2[c] = rep5hi(raw2[c]);
    }
  }
  return s;
}

// Decode one ETC-family block to RGBA8.  Returns validity.
bool decode_etc(const u8* blk, u8* out, u32 mode_mask, u32 flags,
                bool etc1_only, bool punchthrough) {
  EtcState s = etc_analyze(blk, etc1_only, punchthrough);
  bool opaque = (s.b[3] & 2) != 0;   // punchthrough opaque bit
  if (!((mode_mask >> s.mode) & 1)) return false;
  if (etc1_only && s.mode == 1 &&
      (s.overflow[0] || s.overflow[1] || s.overflow[2]))
    return false;
  if (punchthrough) {
    if ((flags & kFlagNonOpaqueOnly) && (opaque || s.mode == 4)) return false;
    if ((flags & kFlagOpaqueOnly) && !opaque) return false;
  }

  auto pidx_of = [&](int i) {
    return int(((s.pix_word >> i) & 1) | (((s.pix_word >> (16 + i)) & 1) << 1));
  };

  if (s.mode <= 1) {  // individual / differential
    int flip = s.b[3] & 1;
    int cw1 = (s.b[3] & 224) >> 5, cw2 = (s.b[3] & 28) >> 2;
    const int* tab = (punchthrough && !opaque) ? kEtcPTModifier : kEtcModifier;
    for (int j = 0; j < 16; j++) {
      int i = (j & 3) * 4 + (j >> 2);
      int x = j & 3, y = j >> 2;
      bool use2 = flip == 0 ? x >= 2 : y >= 2;
      int pidx = pidx_of(i);
      int modif = tab[(use2 ? cw2 : cw1) * 4 + pidx];
      const int* base = use2 ? s.base2 : s.base1;
      bool transparent = punchthrough && !opaque && pidx == 2;
      if (transparent) put_rgba(out, j, 0, 0, 0, 0);
      else put_rgba(out, j, clamp255(base[0] + modif),
                    clamp255(base[1] + modif), clamp255(base[2] + modif),
                    0xFF);
    }
    return true;
  }

  if (s.mode == 2 || s.mode == 3) {  // T / H
    int paint[4][3];
    if (s.mode == 2) {
      int t1[3] = {rep4(((s.b[0] & 0x18) >> 1) | (s.b[0] & 3)),
                   (s.b[1] & 0xF0) | ((s.b[1] & 0xF0) >> 4),
                   rep4(s.b[1] & 0x0F)};
      int t2[3] = {(s.b[2] & 0xF0) | ((s.b[2] & 0xF0) >> 4),
                   rep4(s.b[2] & 0x0F),
                   (s.b[3] & 0xF0) | ((s.b[3] & 0xF0) >> 4)};
      int dist = kEtcDistance[((s.b[3] & 0x0C) >> 1) | (s.b[3] & 1)];
      for (int c = 0; c < 3; c++) {
        paint[0][c] = t1[c];
        paint[1][c] = clamp255(t2[c] + dist);
        paint[2][c] = t2[c];
        paint[3][c] = clamp255(t2[c] - dist);
      }
    } else {
      int h1[3] = {rep4((s.b[0] & 0x78) >> 3),
                   rep4(((s.b[0] & 0x07) << 1) | ((s.b[1] & 0x10) >> 4)),
                   rep4((s.b[1] & 0x08) | ((s.b[1] & 0x03) << 1) |
                        ((s.b[2] & 0x80) >> 7))};
      int h2[3] = {rep4((s.b[2] & 0x78) >> 3),
                   rep4(((s.b[2] & 0x07) << 1) | ((s.b[3] & 0x80) >> 7)),
                   rep4((s.b[3] & 0x78) >> 3)};
      int v1 = (h1[0] << 16) + (h1[1] << 8) + h1[2];
      int v2 = (h2[0] << 16) + (h2[1] << 8) + h2[2];
      int tie = v1 >= v2 ? 1 : 0;
      int dist = kEtcDistance[(s.b[3] & 0x04) | ((s.b[3] & 0x01) << 1) | tie];
      for (int c = 0; c < 3; c++) {
        paint[0][c] = clamp255(h1[c] + dist);
        paint[1][c] = clamp255(h1[c] - dist);
        paint[2][c] = clamp255(h2[c] + dist);
        paint[3][c] = clamp255(h2[c] - dist);
      }
    }
    for (int j = 0; j < 16; j++) {
      int i = (j & 3) * 4 + (j >> 2);
      int pidx = pidx_of(i);
      bool transparent = punchthrough && !opaque && pidx == 2;
      if (transparent) put_rgba(out, j, 0, 0, 0, 0);
      else put_rgba(out, j, paint[pidx][0], paint[pidx][1], paint[pidx][2],
                    0xFF);
    }
    return true;
  }

  // planar (always opaque)
  int ro = (s.b[0] & 0x7E) >> 1;
  int go = ((s.b[0] & 1) << 6) | ((s.b[1] & 0x7E) >> 1);
  int bo = ((s.b[1] & 1) << 5) | (s.b[2] & 0x18) | ((s.b[2] & 0x03) << 1) |
           ((s.b[3] & 0x80) >> 7);
  int rh = ((s.b[3] & 0x7C) >> 1) | (s.b[3] & 1);
  int gh = (s.b[4] & 0xFE) >> 1;
  int bh = ((s.b[4] & 1) << 5) | ((s.b[5] & 0xF8) >> 3);
  int rv = ((s.b[5] & 0x7) << 3) | ((s.b[6] & 0xE0) >> 5);
  int gv = ((s.b[6] & 0x1F) << 2) | ((s.b[7] & 0xC0) >> 6);
  int bv = s.b[7] & 0x3F;
  auto rep_r = [](int v) { return (v << 2) | ((v & 0x30) >> 4); };
  auto rep_g = [](int v) { return (v << 1) | ((v & 0x40) >> 6); };
  ro = rep_r(ro); rh = rep_r(rh); rv = rep_r(rv);
  go = rep_g(go); gh = rep_g(gh); gv = rep_g(gv);
  bo = rep_r(bo); bh = rep_r(bh); bv = rep_r(bv);
  for (int j = 0; j < 16; j++) {
    int x = j & 3, y = j >> 2;
    int r = clamp255((x * (rh - ro) + y * (rv - ro) + 4 * ro + 2) >> 2);
    int g = clamp255((x * (gh - go) + y * (gv - go) + 4 * go + 2) >> 2);
    int b = clamp255((x * (bh - bo) + y * (bv - bo) + 4 * bo + 2) >> 2);
    put_rgba(out, j, r, g, b, 0xFF);
  }
  return true;
}

// ---------------------------------------------------------------------
// EAC (decompress-eac.c semantics)
// ---------------------------------------------------------------------

void eac_codes(const u8* blk, int codes[16]) {
  u64 qw = 0;  // big-endian qword
  for (int i = 0; i < 8; i++) qw = (qw << 8) | blk[i];
  for (int j = 0; j < 16; j++) {
    int i = (j & 3) * 4 + (j >> 2);
    codes[j] = int((qw >> (45 - 3 * i)) & 7);
  }
}

bool eac_alpha(const u8* blk, u8* out, int stride, u32 flags) {
  int base = blk[0];
  int tidx = blk[1] & 0xF, mult = blk[1] >> 4;
  int codes[16];
  eac_codes(blk, codes);
  for (int j = 0; j < 16; j++)
    out[j * stride] = u8(clamp255(base + kEacModifier[tidx * 8 + codes[j]] * mult));
  if ((flags & kFlagEncode) && mult == 0) return false;
  return true;
}

void eac11(const u8* blk, u16* out, int stride) {
  int base = (blk[0] << 3) | 4;
  int tidx = blk[1] & 0xF;
  int mult = (blk[1] >> 4) << 3;
  if (mult == 0) mult = 1;
  int codes[16];
  eac_codes(blk, codes);
  for (int j = 0; j < 16; j++) {
    int v = base + kEacModifier[tidx * 8 + codes[j]] * mult;
    v = v < 0 ? 0 : (v > 2047 ? 2047 : v);
    out[j * stride] = u16((v << 5) | (v >> 6));
  }
}

bool eac11_signed(const u8* blk, int16_t* out, int stride) {
  int base = int8_t(blk[0]);
  if (base == -128) return false;
  int base8 = base << 3;
  int tidx = blk[1] & 0xF;
  int mult = (blk[1] >> 4) << 3;
  if (mult == 0) mult = 1;
  int codes[16];
  eac_codes(blk, codes);
  for (int j = 0; j < 16; j++) {
    int v = base8 + kEacModifier[tidx * 8 + codes[j]] * mult;
    v = v < -1023 ? -1023 : (v > 1023 ? 1023 : v);
    int mag = v < 0 ? -v : v;
    int rep = (mag << 5) | (mag >> 5);
    out[j * stride] = int16_t(v < 0 ? -rep : rep);
  }
  return true;
}

// ---------------------------------------------------------------------
// dispatch + threading
// ---------------------------------------------------------------------

bool decode_one(int family, const u8* blk, u8* out, u32 mm, u32 fl) {
  switch (family) {
    case kBC1: return decode_bc1(blk, out, false, fl);
    case kBC1A: return decode_bc1(blk, out, true, fl);
    case kBC2: return decode_bc2(blk, out, mm, fl);
    case kBC3: return decode_bc3(blk, out, mm, fl);
    case kRGTC1: rgtc_unsigned(blk, out, 1); return true;
    case kRGTC2:
      rgtc_unsigned(blk, out, 2);
      rgtc_unsigned(blk + 8, out + 1, 2);
      return true;
    case kSignedRGTC1:
      return rgtc_signed(blk, reinterpret_cast<int16_t*>(out), 1);
    case kSignedRGTC2: {
      bool a = rgtc_signed(blk, reinterpret_cast<int16_t*>(out), 2);
      bool b = rgtc_signed(blk + 8, reinterpret_cast<int16_t*>(out) + 1, 2);
      return a && b;
    }
    case kBPTC: return decode_bc7(blk, out, mm, fl);
    case kBPTCFloat:
      return decode_bc6h(blk, reinterpret_cast<u16*>(out), mm, false);
    case kBPTCSignedFloat:
      return decode_bc6h(blk, reinterpret_cast<u16*>(out), mm, true);
    case kETC1: return decode_etc(blk, out, mm, fl, true, false);
    case kETC2: return decode_etc(blk, out, mm, fl, false, false);
    case kETC2PT: return decode_etc(blk, out, mm, fl, false, true);
    case kETC2EAC: {
      bool c = decode_etc(blk + 8, out, mm, fl, false, false);
      bool a = eac_alpha(blk, out + 3, 4, fl);
      return c && a;
    }
    case kEACR11:
      eac11(blk, reinterpret_cast<u16*>(out), 1);
      return true;
    case kEACRG11:
      eac11(blk, reinterpret_cast<u16*>(out), 2);
      eac11(blk + 8, reinterpret_cast<u16*>(out) + 1, 2);
      return true;
    case kEACSignedR11:
      return eac11_signed(blk, reinterpret_cast<int16_t*>(out), 1);
    case kEACSignedRG11: {
      bool a = eac11_signed(blk, reinterpret_cast<int16_t*>(out), 2);
      bool b = eac11_signed(blk + 8, reinterpret_cast<int16_t*>(out) + 1, 2);
      return a && b;
    }
  }
  return false;
}

}  // namespace

extern "C" {

int dtx_family_info(int family, int* block_bytes, int* out_bytes) {
  if (family < 0 || family >= kNumFamilies) return -1;
  *block_bytes = kInfo[family].block_bytes;
  *out_bytes = kInfo[family].out_bytes;
  return 0;
}

int dtx_decode(int family, const u8* blocks, i64 n, u8* out, u8* valid,
               u32 mode_mask, u32 flags, int n_threads) {
  if (family < 0 || family >= kNumFamilies) return -1;
  const int bb = kInfo[family].block_bytes, ob = kInfo[family].out_bytes;
  if (n_threads <= 0)
    n_threads = int(std::thread::hardware_concurrency());
  n_threads = std::max(1, std::min<int>(n_threads, 64));
  if (n < 1024) n_threads = 1;

  auto worker = [&](i64 lo, i64 hi) {
    for (i64 i = lo; i < hi; i++) {
      bool ok = decode_one(family, blocks + i * bb, out + i * ob,
                           mode_mask, flags);
      valid[i] = ok ? 1 : 0;
      if (!ok) std::memset(out + i * ob, 0, ob);
    }
  };
  if (n_threads == 1) {
    worker(0, n);
  } else {
    std::vector<std::thread> ts;
    i64 chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; t++) {
      i64 lo = t * chunk, hi = std::min<i64>(n, lo + chunk);
      if (lo >= hi) break;
      ts.emplace_back(worker, lo, hi);
    }
    for (auto& t : ts) t.join();
  }
  return 0;
}

// Tiled -> linear assembly (texture.c:105-145 semantics): per-block
// 4x4 pixel tiles into a row-major image, cropping edge blocks.
int dtx_assemble_linear(const u8* block_pixels, i64 wb, i64 hb,
                        i64 width, i64 height, int ps, u8* out) {
  for (i64 by = 0; by < hb; by++)
    for (i64 y = 0; y < 4; y++) {
      i64 iy = by * 4 + y;
      if (iy >= height) continue;
      for (i64 bx = 0; bx < wb; bx++) {
        const u8* src = block_pixels + ((by * wb + bx) * 16 + y * 4) * ps;
        i64 ix = bx * 4;
        i64 m = std::min<i64>(4, width - ix);
        if (m > 0)
          std::memcpy(out + (iy * width + ix) * ps, src, size_t(m) * ps);
      }
    }
  return 0;
}

}  // extern "C"
