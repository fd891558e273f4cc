"""ETC1 / ETC2 / ETC2_PUNCHTHROUGH / ETC2_EAC block decode: the CUDA
kernels' wrappers and their plain PyTorch versions.

`decode_etc1`, `decode_etc2`, `decode_etc2_punchthrough` (csrc/etc_eac.cu
etc_kernel<Kind>, which replaces detex_tpu/ops/pallas/etc_eac_pallas.py:
_etc1_kernel, _etc2_kernel and _etc2_pt_kernel) and `decode_etc2_eac`
(etc2_eac_kernel, replacing _etc2_eac_kernel) launch the kernel for a CUDA
tensor and run the plain version (`decode_*_plain`) for a CPU tensor; see
ops/_cuda.py.

The plain versions follow the jnp decoders of detex_tpu/ops/etc.py: every
mode's pixels are computed for the whole batch and each block takes its
mode's:
  * individual / differential base colours, the flip bit choosing 2x4 or
    4x2 subblocks, modifier rows [a, b, -a, -b] (decompress-etc.c:25-34,
    89-180); a differential channel overflows when
    ((b & 0xF8) + delta * 8) & 0xFF07 != 0, which invalidates an ETC1 block
    (whose pixels are still decoded) and selects ETC2's T, H or planar mode
    by the first overflowing channel R, G or B (decompress-etc.c:321-367);
  * T and H paint colours with the distance table, H's tie bit from the
    24-bit composites (decompress-etc.c:200-285); planar's 6-7-6 bilinear
    (x (H - O) + y (V - O) + 4 O + 2) >> 2, arithmetic (:287-317);
  * punchthrough: the differential bit is the opaque bit and mode
    detection ignores it; non-opaque differential blocks take the
    punchthrough table (a = 0) without overflow check, and in non-opaque
    differential and T/H blocks index 2 is transparent black
    (decompress-etc.c:472-717);
  * output pixel j reads the reference's pixel i = (j & 3) * 4 + (j >> 2),
    whose index bits sit at bits i and 16 + i of the byte-swapped word 1.
Validity: mode_mask bit `mode` (ETC1: bit 0 individual, bit 1
differential); ETC1 rejects an overflowing differential block;
punchthrough's flag 0x4 rejects opaque and planar blocks, 0x2 non-opaque
ones; ETC2_EAC's FLAG_ENCODE (0x1) rejects an alpha multiplier of 0.

Input: (N, 2) little-endian int32 words, or (N, 4) for ETC2_EAC (alpha
words 0-1, colour words 2-3).  Output: ((N, 16) int32 packed RGBA8, (N,)
bool valid).
"""

from __future__ import annotations

import numpy as np
import torch

from detex_tpu_torch import formats as F
from detex_tpu_torch.ops import _cuda
from detex_tpu_torch.ops.bitops import field, has_flag, mask_bit, pack_rgba8
from detex_tpu_torch.ops.eac import SRC_I, bswap32, decode_eac_alpha

_FULL = 0xFFFFFFFF

# decompress-etc.c:25-34 and 472-481: rows [a, b, -a, -b], and the
# punchthrough rows with a = 0 (detex_tpu/ops/etc.py).
ETC_A = np.array([2, 5, 9, 13, 18, 24, 33, 47])
ETC_B = np.array([8, 17, 29, 42, 60, 80, 106, 183])
ETC_MODIFIER_TABLE = np.stack([ETC_A, ETC_B, -ETC_A, -ETC_B], 1)
PUNCHTHROUGH_MODIFIER_TABLE = np.stack([0 * ETC_A, ETC_B, 0 * ETC_A, -ETC_B],
                                       1)
# decompress-etc.c:200
ETC2_DISTANCE_TABLE = np.array([3, 6, 11, 16, 23, 32, 41, 64])

_OUT_X = np.arange(16) & 3
_OUT_Y = np.arange(16) >> 2

# Launches of the CUDA kernel per variant in this process (plain-version
# calls are not counted).
KERNEL_LAUNCHES = {"etc1": 0, "etc2": 0, "etc2_punchthrough": 0,
                   "etc2_eac": 0}


def _const(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(device)


def _bytes(w: torch.Tensor):
    """The 4 bytes of (N,) int32 words, as (N, 1) int64."""
    return [field(w, 8 * k, 8).long()[:, None] for k in range(4)]


def _rep4(v):
    return v | (v << 4)


def _rep5hi(v):
    return v | ((v & 224) >> 5)


def _hi4(b):
    """High nibble of a byte -> 8 bits."""
    return (b & 0xF0) | ((b & 0xF0) >> 4)


def _clamp(v):
    return torch.clamp(v, 0, 255)


def _candidates(w0: torch.Tensor):
    """Individual and differential subblock base colours, each a list of 3
    (N, 1) channels, and the 3 channels' (N, 1) differential overflow."""
    b = _bytes(w0)[:3]
    ind1 = [_hi4(x) for x in b]
    ind2 = [_rep4(x & 0x0F) for x in b]
    dif1 = [_rep5hi(x & 0xF8) for x in b]
    d = [x & 7 for x in b]
    raw2 = [(x & 0xF8) + torch.where(dd >= 4, dd - 8, dd) * 8
            for x, dd in zip(b, d)]
    dif2 = [_rep5hi(r) for r in raw2]
    overflow = [(r & 0xFF07) != 0 for r in raw2]
    return ind1, ind2, dif1, dif2, overflow


def _indices(w1: torch.Tensor) -> torch.Tensor:
    """(N, 16) 2-bit pixel indices in output pixel order, int64."""
    piw = bswap32(w1)[:, None]
    i = _const(SRC_I, w1.device)
    return ((piw >> i) & 1) | (((piw >> (16 + i)) & 1) << 1)


def _subblock_pixels(w0, idx, sub1, sub2, table):
    """(r, g, b) (N, 16) of an individual or differential block."""
    b3 = _bytes(w0)[3]
    dev = w0.device
    use2 = torch.where((b3 & 1) == 0, _const(_OUT_X >= 2, dev).bool(),
                       _const(_OUT_Y >= 2, dev).bool())
    cw = torch.where(use2, (b3 & 28) >> 2, (b3 & 224) >> 5)
    mod = _const(table, dev)[cw, idx]
    return [_clamp(torch.where(use2, s2, s1) + mod)
            for s1, s2 in zip(sub1, sub2)]


def _paint_pixels(paint, idx):
    """(r, g, b) (N, 16) from a 4-entry palette of (N, 1) channels."""
    return [torch.gather(torch.cat([p[c] for p in paint], 1), 1, idx)
            for c in range(3)]


def _th_paint(w0):
    """T and H paint palettes: 4 entries of (r, g, b) each
    (decompress-etc.c:202-273)."""
    b0, b1, b2, b3 = _bytes(w0)
    dist = _const(ETC2_DISTANCE_TABLE, w0.device)
    t1 = (_rep4(((b0 & 0x18) >> 1) | (b0 & 0x3)), _hi4(b1),
          _rep4(b1 & 0x0F))
    t2 = (_hi4(b2), _rep4(b2 & 0x0F), _hi4(b3))
    dt = dist[((b3 & 0x0C) >> 1) | (b3 & 1)]
    t_paint = [t1, [_clamp(c + dt) for c in t2], t2,
               [_clamp(c - dt) for c in t2]]
    h1 = (_rep4((b0 & 0x78) >> 3),
          _rep4(((b0 & 0x07) << 1) | ((b1 & 0x10) >> 4)),
          _rep4((b1 & 0x08) | ((b1 & 0x03) << 1) | ((b2 & 0x80) >> 7)))
    h2 = (_rep4((b2 & 0x78) >> 3),
          _rep4(((b2 & 0x07) << 1) | ((b3 & 0x80) >> 7)),
          _rep4((b3 & 0x78) >> 3))

    def composite(c):
        return (c[0] << 16) + (c[1] << 8) + c[2]

    tie = (composite(h1) >= composite(h2)).long()
    dh = dist[(b3 & 0x04) | ((b3 & 0x01) << 1) | tie]
    h_paint = [[_clamp(c + dh) for c in h1], [_clamp(c - dh) for c in h1],
               [_clamp(c + dh) for c in h2], [_clamp(c - dh) for c in h2]]
    return t_paint, h_paint


def _planar_pixels(w0, w1):
    """(r, g, b) (N, 16) of a planar block (decompress-etc.c:287-317)."""
    b0, b1, b2, b3 = _bytes(w0)
    b4, b5, b6, b7 = _bytes(w1)
    o = [(b0 & 0x7E) >> 1, ((b0 & 1) << 6) | ((b1 & 0x7E) >> 1),
         ((b1 & 1) << 5) | (b2 & 0x18) | ((b2 & 0x03) << 1)
         | ((b3 & 0x80) >> 7)]
    h = [((b3 & 0x7C) >> 1) | (b3 & 1), (b4 & 0xFE) >> 1,
         ((b4 & 1) << 5) | ((b5 & 0xF8) >> 3)]
    v = [((b5 & 0x7) << 3) | ((b6 & 0xE0) >> 5),
         ((b6 & 0x1F) << 2) | ((b7 & 0xC0) >> 6), b7 & 0x3F]

    def rep(x, green):
        return (x << 1) | ((x & 0x40) >> 6) if green \
            else (x << 2) | ((x & 0x30) >> 4)

    x = _const(_OUT_X, w0.device)
    y = _const(_OUT_Y, w0.device)
    out = []
    for c in range(3):
        oc, hc, vc = (rep(t[c], c == 1) for t in (o, h, v))
        # torch's >> on a signed tensor is arithmetic, as the reference's
        # shift of a negative int.
        out.append(_clamp((x * (hc - oc) + y * (vc - oc) + 4 * oc + 2) >> 2))
    return out


def _rgba(rgb) -> torch.Tensor:
    return pack_rgba8(*rgb, torch.full_like(rgb[0], 0xFF))


def _etc2_modes(differential, overflow, punchthrough: bool):
    """(N, 1) mode: 0 individual, 1 differential, 2 T, 3 H, 4 planar."""
    mode = torch.where(overflow[0], 2, torch.where(
        overflow[1], 3, torch.where(overflow[2], 4, 1)))
    return mode if punchthrough else torch.where(differential, mode, 0)


def _etc2_pixels(w0, w1, punchthrough: bool = False):
    """ETC2 or punchthrough pixels: ((N, 16) packed RGBA8, (N, 1) mode,
    (N, 1) opaque / differential bit)."""
    diff = (_bytes(w0)[3] & 2) != 0
    ind1, ind2, dif1, dif2, overflow = _candidates(w0)
    mode = _etc2_modes(diff, overflow, punchthrough)
    idx = _indices(w1)
    t_paint, h_paint = _th_paint(w0)
    pix = [_rgba(_subblock_pixels(w0, idx, ind1, ind2, ETC_MODIFIER_TABLE)),
           _rgba(_subblock_pixels(w0, idx, dif1, dif2, ETC_MODIFIER_TABLE)),
           _rgba(_paint_pixels(t_paint, idx)),
           _rgba(_paint_pixels(h_paint, idx)),
           _rgba(_planar_pixels(w0, w1))]
    if punchthrough:
        # Non-opaque: the punchthrough table in differential mode, and
        # index 2 transparent black there and in T/H.
        nonopaque = ~diff
        pt_diff = _rgba(_subblock_pixels(w0, idx, dif1, dif2,
                                         PUNCHTHROUGH_MODIFIER_TABLE))
        pix[1] = torch.where(nonopaque, pt_diff, pix[1])
        for k in (1, 2, 3):
            pix[k] = torch.where(nonopaque & (idx == 2), 0, pix[k])
    out = pix[0]
    for k in range(1, 5):
        out = torch.where(mode == k, pix[k], out)
    return out, mode, diff


def decode_etc1_plain(words: torch.Tensor, mode_mask: int = _FULL,
                      flags: int = 0):
    """Plain PyTorch ETC1 decode (detexDecompressBlockETC1,
    decompress-etc.c:89-180)."""
    w0, w1 = words[:, 0], words[:, 1]
    diff = (_bytes(w0)[3] & 2) != 0
    ind1, ind2, dif1, dif2, overflow = _candidates(w0)
    idx = _indices(w1)
    pix = torch.where(
        diff,
        _rgba(_subblock_pixels(w0, idx, dif1, dif2, ETC_MODIFIER_TABLE)),
        _rgba(_subblock_pixels(w0, idx, ind1, ind2, ETC_MODIFIER_TABLE)))
    diff = diff[:, 0]
    overflowed = overflow[0] | overflow[1] | overflow[2]
    valid = mask_bit(mode_mask, diff.long()) & ~(diff & overflowed[:, 0])
    return pix, valid


def decode_etc2_plain(words: torch.Tensor, mode_mask: int = _FULL,
                      flags: int = 0):
    """Plain PyTorch ETC2 decode (detexDecompressBlockETC2,
    decompress-etc.c:321-367)."""
    pix, mode, _ = _etc2_pixels(words[:, 0], words[:, 1])
    return pix, mask_bit(mode_mask, mode[:, 0])


def decode_etc2_punchthrough_plain(words: torch.Tensor,
                                   mode_mask: int = _FULL, flags: int = 0):
    """Plain PyTorch ETC2_PUNCHTHROUGH decode
    (detexDecompressBlockETC2_PUNCHTHROUGH, decompress-etc.c:653-717)."""
    pix, mode, opaque = _etc2_pixels(words[:, 0], words[:, 1],
                                     punchthrough=True)
    mode, opaque = mode[:, 0], opaque[:, 0]
    valid = mask_bit(mode_mask, mode)
    if has_flag(flags, F.FLAG_NON_OPAQUE_ONLY):
        valid = valid & ~(opaque | (mode == 4))      # planar is opaque
    if has_flag(flags, F.FLAG_OPAQUE_ONLY):
        valid = valid & opaque
    return pix, valid


def decode_etc2_eac_plain(words: torch.Tensor, mode_mask: int = _FULL,
                          flags: int = 0):
    """Plain PyTorch ETC2_EAC decode: ETC2 colour from words 2-3, EAC alpha
    from words 0-1 (detexDecompressBlockETC2_EAC, decompress-eac.c:54-86)."""
    color, mode, _ = _etc2_pixels(words[:, 2], words[:, 3])
    alpha, alpha_valid = decode_eac_alpha(words[:, 0], words[:, 1], flags)
    pix = pack_rgba8(color, color >> 8, color >> 16, alpha)
    return pix, mask_bit(mode_mask, mode[:, 0]) & alpha_valid


_ETC1 = _cuda.Variant("etc1", "dtx_etc_decode", 0, 2, 16, decode_etc1_plain)
_ETC2 = _cuda.Variant("etc2", "dtx_etc_decode", 1, 2, 16, decode_etc2_plain)
_ETC2_PT = _cuda.Variant("etc2_punchthrough", "dtx_etc_decode", 2, 2, 16,
                         decode_etc2_punchthrough_plain)
_ETC2_EAC = _cuda.Variant("etc2_eac", "dtx_etc2_eac_decode", 0, 4, 16,
                          decode_etc2_eac_plain)


def decode_etc1(words: torch.Tensor, mode_mask: int = _FULL, flags: int = 0):
    """ETC1: (N, 2) int32 words -> ((N, 16) packed RGBA8, (N,) valid)."""
    return _cuda.decode(_ETC1, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_etc2(words: torch.Tensor, mode_mask: int = _FULL, flags: int = 0):
    """ETC2: (N, 2) int32 words -> ((N, 16) packed RGBA8, (N,) valid)."""
    return _cuda.decode(_ETC2, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_etc2_punchthrough(words: torch.Tensor, mode_mask: int = _FULL,
                             flags: int = 0):
    """ETC2_PUNCHTHROUGH: (N, 2) int32 words -> ((N, 16) packed RGBA8,
    (N,) valid)."""
    return _cuda.decode(_ETC2_PT, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_etc2_eac(words: torch.Tensor, mode_mask: int = _FULL,
                    flags: int = 0):
    """ETC2_EAC: (N, 4) int32 words -> ((N, 16) packed RGBA8, (N,)
    valid)."""
    return _cuda.decode(_ETC2_EAC, KERNEL_LAUNCHES, words, mode_mask, flags)
