"""Pixel / texture format registry for detex-tpu.

The port's own copy of detex_tpu/formats.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

This is the TPU-native rebuild's equivalent of the reference's bit-encoded
format enums (reference: detex.h:83-379 pixel formats, detex.h:575-727
texture formats).  Formats are plain ints whose bits encode structure, so
format-driven dispatch stays table-based and jit-friendly.

Bit layout of a pixel format (identical semantics to detex.h:83-123):

  bit 0   (0x0001)  16-bit components
  bit 1   (0x0002)  32-bit components
  bit 2   (0x0004)  has alpha
  bit 3   (0x0008)  BGR component order
  bits4-5 (0x0030)  number of components - 1
  bits8-11(0x0F00)  pixel size in bytes - 1
  bit 12  (0x1000)  signed components
  bit 13  (0x2000)  float components
  bit 14  (0x4000)  HDR

A texture format is  pixel_format | (compressed_format_index << 24) |
(0x00800000 if the block is 128-bit)  — reference detex.h:575-615.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# ---------------------------------------------------------------------------
# Pixel-format component bits (reference detex.h:83-123)
# ---------------------------------------------------------------------------

COMPONENT_16BIT = 0x1
COMPONENT_32BIT = 0x2
HAS_ALPHA = 0x4
ORDER_BGR = 0x8
ONE_COMPONENT = 0x0
TWO_COMPONENTS = 0x10
THREE_COMPONENTS = 0x20
FOUR_COMPONENTS = 0x30
PIXEL_8BIT = 0x000
PIXEL_16BIT = 0x100
PIXEL_24BIT = 0x200
PIXEL_32BIT = 0x300
PIXEL_48BIT = 0x500
PIXEL_64BIT = 0x700
PIXEL_96BIT = 0xB00
PIXEL_128BIT = 0xF00
SIGNED = 0x1000
FLOAT = 0x2000
HDR = 0x4000


def _pf(*bits: int) -> int:
    v = 0
    for b in bits:
        v |= b
    return v


# --- Uncompressed pixel formats (reference detex.h:124-379) ----------------
RGBA8 = _pf(HAS_ALPHA, FOUR_COMPONENTS, PIXEL_32BIT)
BGRA8 = _pf(HAS_ALPHA, ORDER_BGR, FOUR_COMPONENTS, PIXEL_32BIT)
RGBX8 = _pf(THREE_COMPONENTS, PIXEL_32BIT)
BGRX8 = _pf(ORDER_BGR, THREE_COMPONENTS, PIXEL_32BIT)
RGB8 = _pf(THREE_COMPONENTS, PIXEL_24BIT)
BGR8 = _pf(ORDER_BGR, THREE_COMPONENTS, PIXEL_24BIT)
R8 = _pf(ONE_COMPONENT, PIXEL_8BIT)
SIGNED_R8 = _pf(ONE_COMPONENT, PIXEL_8BIT, SIGNED)
RG8 = _pf(TWO_COMPONENTS, PIXEL_16BIT)
SIGNED_RG8 = _pf(TWO_COMPONENTS, PIXEL_16BIT, SIGNED)
R16 = _pf(COMPONENT_16BIT, ONE_COMPONENT, PIXEL_16BIT)
SIGNED_R16 = _pf(COMPONENT_16BIT, ONE_COMPONENT, PIXEL_16BIT, SIGNED)
RG16 = _pf(COMPONENT_16BIT, TWO_COMPONENTS, PIXEL_32BIT)
SIGNED_RG16 = _pf(COMPONENT_16BIT, TWO_COMPONENTS, PIXEL_32BIT, SIGNED)
RGB16 = _pf(COMPONENT_16BIT, THREE_COMPONENTS, PIXEL_48BIT)
RGBX16 = _pf(COMPONENT_16BIT, THREE_COMPONENTS, PIXEL_64BIT)
RGBA16 = _pf(COMPONENT_16BIT, HAS_ALPHA, FOUR_COMPONENTS, PIXEL_64BIT)
A8 = _pf(HAS_ALPHA, ONE_COMPONENT, PIXEL_8BIT)

FLOAT_R16 = _pf(COMPONENT_16BIT, ONE_COMPONENT, PIXEL_16BIT, FLOAT)
FLOAT_RG16 = _pf(COMPONENT_16BIT, TWO_COMPONENTS, PIXEL_32BIT, FLOAT)
FLOAT_RGB16 = _pf(COMPONENT_16BIT, THREE_COMPONENTS, PIXEL_48BIT, FLOAT)
FLOAT_RGBX16 = _pf(COMPONENT_16BIT, THREE_COMPONENTS, PIXEL_64BIT, FLOAT)
FLOAT_R16_HDR = FLOAT_R16 | HDR
FLOAT_RG16_HDR = FLOAT_RG16 | HDR
FLOAT_RGB16_HDR = FLOAT_RGB16 | HDR
FLOAT_RGBX16_HDR = FLOAT_RGBX16 | HDR
# NOTE: the reference header defines FLOAT_RGBA16 *with* the HDR bit and
# FLOAT_RGBA16_HDR *without* it (detex.h:249-263 — the two are swapped).
# We mirror the numeric values so the conversion graph behaves identically.
FLOAT_RGBA16 = _pf(COMPONENT_16BIT, HAS_ALPHA, FOUR_COMPONENTS, PIXEL_64BIT,
                   FLOAT, HDR)
FLOAT_RGBA16_HDR = _pf(COMPONENT_16BIT, HAS_ALPHA, FOUR_COMPONENTS,
                       PIXEL_64BIT, FLOAT)

FLOAT_BGRX16 = _pf(COMPONENT_16BIT, ORDER_BGR, THREE_COMPONENTS,
                   PIXEL_64BIT, FLOAT)
FLOAT_BGRX16_HDR = FLOAT_BGRX16 | HDR
SIGNED_FLOAT_RGBX16 = FLOAT_RGBX16 | SIGNED
SIGNED_FLOAT_BGRX16 = FLOAT_BGRX16 | SIGNED

FLOAT_R32 = _pf(COMPONENT_32BIT, ONE_COMPONENT, PIXEL_32BIT, FLOAT)
FLOAT_RG32 = _pf(COMPONENT_32BIT, TWO_COMPONENTS, PIXEL_64BIT, FLOAT)
FLOAT_RGB32 = _pf(COMPONENT_32BIT, THREE_COMPONENTS, PIXEL_96BIT, FLOAT)
FLOAT_RGBX32 = _pf(COMPONENT_32BIT, THREE_COMPONENTS, PIXEL_128BIT, FLOAT)
FLOAT_RGBA32 = _pf(COMPONENT_32BIT, HAS_ALPHA, FOUR_COMPONENTS, PIXEL_128BIT,
                   FLOAT)
FLOAT_R32_HDR = FLOAT_R32 | HDR
FLOAT_RG32_HDR = FLOAT_RG32 | HDR
FLOAT_RGB32_HDR = FLOAT_RGB32 | HDR
FLOAT_RGBX32_HDR = FLOAT_RGBX32 | HDR
FLOAT_RGBA32_HDR = FLOAT_RGBA32 | HDR

# ---------------------------------------------------------------------------
# Pixel-format accessors (reference detex.h:879-930 inline helpers)
# ---------------------------------------------------------------------------


def pixel_size(fmt: int) -> int:
    """Bytes per pixel (reference detexGetPixelSize, detex.h:887-890)."""
    return ((fmt & 0xF00) >> 8) + 1


def num_components(fmt: int) -> int:
    """Component count (reference detexGetNumberOfComponents, detex.h:879-884)."""
    return ((fmt & 0x30) >> 4) + 1


def component_size(fmt: int) -> int:
    """Bytes per component (reference detexGetComponentSize, detex.h)."""
    if fmt & COMPONENT_32BIT:
        return 4
    if fmt & COMPONENT_16BIT:
        return 2
    return 1


def component_precision_bits(fmt: int) -> int:
    return 8 * component_size(fmt)


def is_signed(fmt: int) -> bool:
    return bool(fmt & SIGNED)


def is_float(fmt: int) -> bool:
    return bool(fmt & FLOAT)


def is_hdr(fmt: int) -> bool:
    return bool(fmt & HDR)


def has_alpha(fmt: int) -> bool:
    return bool(fmt & HAS_ALPHA)


def is_bgr(fmt: int) -> bool:
    return bool(fmt & ORDER_BGR)


# ---------------------------------------------------------------------------
# Texture formats (reference detex.h:575-727)
# ---------------------------------------------------------------------------

BLOCK_128BIT = 0x00800000
PIXEL_FORMAT_MASK = 0x0000FFFF


def _tf(index: int, pixel_format: int, big_block: bool = False) -> int:
    return (index << 24) | (BLOCK_128BIT if big_block else 0) | pixel_format


# Compressed-format indices (reference detex.h:577-613 enum; texture.c:27-48
# dispatch table is ordered by these).  Index 0 == uncompressed.
IDX_UNCOMPRESSED = 0
IDX_BC1 = 1
IDX_BC1A = 2
IDX_BC2 = 3
IDX_BC3 = 4
IDX_RGTC1 = 5
IDX_SIGNED_RGTC1 = 6
IDX_RGTC2 = 7
IDX_SIGNED_RGTC2 = 8
IDX_BPTC_FLOAT = 9
IDX_BPTC_SIGNED_FLOAT = 10
IDX_BPTC = 11
IDX_ETC1 = 12
IDX_ETC2 = 13
IDX_ETC2_PUNCHTHROUGH = 14
IDX_ETC2_EAC = 15
IDX_EAC_R11 = 16
IDX_EAC_SIGNED_R11 = 17
IDX_EAC_RG11 = 18
IDX_EAC_SIGNED_RG11 = 19
IDX_ASTC_4X4 = 20

BC1 = _tf(IDX_BC1, RGBX8)
BC1A = _tf(IDX_BC1A, RGBA8)
BC2 = _tf(IDX_BC2, RGBA8, True)
BC3 = _tf(IDX_BC3, RGBA8, True)
RGTC1 = _tf(IDX_RGTC1, R8)
SIGNED_RGTC1 = _tf(IDX_SIGNED_RGTC1, SIGNED_R16)
RGTC2 = _tf(IDX_RGTC2, RG8, True)
SIGNED_RGTC2 = _tf(IDX_SIGNED_RGTC2, SIGNED_RG16, True)
BPTC_FLOAT = _tf(IDX_BPTC_FLOAT, FLOAT_RGBX16, True)
BPTC_SIGNED_FLOAT = _tf(IDX_BPTC_SIGNED_FLOAT, FLOAT_RGBX16 | SIGNED, True)
BPTC = _tf(IDX_BPTC, RGBA8, True)
ETC1 = _tf(IDX_ETC1, RGBX8)
ETC2 = _tf(IDX_ETC2, RGBX8)
ETC2_PUNCHTHROUGH = _tf(IDX_ETC2_PUNCHTHROUGH, RGBA8)
ETC2_EAC = _tf(IDX_ETC2_EAC, RGBA8, True)
EAC_R11 = _tf(IDX_EAC_R11, R16)
EAC_SIGNED_R11 = _tf(IDX_EAC_SIGNED_R11, SIGNED_R16)
EAC_RG11 = _tf(IDX_EAC_RG11, RG16, True)
EAC_SIGNED_RG11 = _tf(IDX_EAC_SIGNED_RG11, SIGNED_RG16, True)


def compressed_index(tex_fmt: int) -> int:
    """Compressed-format index (reference detexGetCompressedFormat)."""
    return tex_fmt >> 24


def is_compressed(tex_fmt: int) -> bool:
    return (tex_fmt >> 24) != 0


def block_size_bytes(tex_fmt: int) -> int:
    """Compressed block size: 8 or 16 bytes (reference detex.h:917-920)."""
    if not is_compressed(tex_fmt):
        return pixel_size(tex_fmt)
    return 8 + ((tex_fmt & BLOCK_128BIT) >> 20)


def texture_pixel_format(tex_fmt: int) -> int:
    """Pixel format produced by decoding (reference detex.h:926-930)."""
    return tex_fmt & PIXEL_FORMAT_MASK


# ---------------------------------------------------------------------------
# Mode masks & decompression flags (reference detex.h:383-424)
# ---------------------------------------------------------------------------

MODE_MASK_ETC_INDIVIDUAL = 0x1
MODE_MASK_ETC_DIFFERENTIAL = 0x2
MODE_MASK_ETC_T = 0x4
MODE_MASK_ETC_H = 0x8
MODE_MASK_ETC_PLANAR = 0x10
MODE_MASK_ALL_MODES_ETC1 = 0x3
MODE_MASK_ALL_MODES_ETC2 = 0x1F
MODE_MASK_ALL_MODES_ETC2_PUNCHTHROUGH = 0x1E
MODE_MASK_ALL_MODES_BPTC = 0xFF
MODE_MASK_ALL_MODES_BPTC_FLOAT = 0x3FFF
MODE_MASK_ALL = 0xFFFFFFFF

FLAG_ENCODE = 0x1
FLAG_OPAQUE_ONLY = 0x2
FLAG_NON_OPAQUE_ONLY = 0x4


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TextureFormatInfo:
    """Static metadata for one texture format (cf. file-info.c:49-127)."""

    fmt: int
    name: str
    block_w: int
    block_h: int

    @property
    def block_bytes(self) -> int:
        return block_size_bytes(self.fmt)

    @property
    def decoded_pixel_format(self) -> int:
        return texture_pixel_format(self.fmt)

    @property
    def decoded_pixel_bytes(self) -> int:
        return pixel_size(self.decoded_pixel_format)


_COMPRESSED_FORMATS = [
    TextureFormatInfo(BC1, "BC1", 4, 4),
    TextureFormatInfo(BC1A, "BC1A", 4, 4),
    TextureFormatInfo(BC2, "BC2", 4, 4),
    TextureFormatInfo(BC3, "BC3", 4, 4),
    TextureFormatInfo(RGTC1, "RGTC1", 4, 4),
    TextureFormatInfo(SIGNED_RGTC1, "SIGNED_RGTC1", 4, 4),
    TextureFormatInfo(RGTC2, "RGTC2", 4, 4),
    TextureFormatInfo(SIGNED_RGTC2, "SIGNED_RGTC2", 4, 4),
    TextureFormatInfo(BPTC_FLOAT, "BPTC_FLOAT", 4, 4),
    TextureFormatInfo(BPTC_SIGNED_FLOAT, "BPTC_SIGNED_FLOAT", 4, 4),
    TextureFormatInfo(BPTC, "BPTC", 4, 4),
    TextureFormatInfo(ETC1, "ETC1", 4, 4),
    TextureFormatInfo(ETC2, "ETC2", 4, 4),
    TextureFormatInfo(ETC2_PUNCHTHROUGH, "ETC2_PUNCHTHROUGH", 4, 4),
    TextureFormatInfo(ETC2_EAC, "ETC2_EAC", 4, 4),
    TextureFormatInfo(EAC_R11, "EAC_R11", 4, 4),
    TextureFormatInfo(EAC_SIGNED_R11, "EAC_SIGNED_R11", 4, 4),
    TextureFormatInfo(EAC_RG11, "EAC_RG11", 4, 4),
    TextureFormatInfo(EAC_SIGNED_RG11, "EAC_SIGNED_RG11", 4, 4),
]

BY_NAME = {info.name: info for info in _COMPRESSED_FORMATS}
BY_FORMAT = {info.fmt: info for info in _COMPRESSED_FORMATS}

_PIXEL_FORMAT_NAMES = {
    RGBA8: "RGBA8", BGRA8: "BGRA8", RGBX8: "RGBX8", BGRX8: "BGRX8",
    RGB8: "RGB8", BGR8: "BGR8", R8: "R8", SIGNED_R8: "SIGNED_R8",
    RG8: "RG8", SIGNED_RG8: "SIGNED_RG8", R16: "R16",
    SIGNED_R16: "SIGNED_R16", RG16: "RG16", SIGNED_RG16: "SIGNED_RG16",
    RGB16: "RGB16", RGBX16: "RGBX16", RGBA16: "RGBA16", A8: "A8",
    FLOAT_R16: "FLOAT_R16", FLOAT_RG16: "FLOAT_RG16",
    FLOAT_RGB16: "FLOAT_RGB16", FLOAT_RGBX16: "FLOAT_RGBX16",
    FLOAT_RGBA16: "FLOAT_RGBA16", FLOAT_R16_HDR: "FLOAT_R16_HDR",
    FLOAT_RG16_HDR: "FLOAT_RG16_HDR", FLOAT_RGB16_HDR: "FLOAT_RGB16_HDR",
    FLOAT_RGBX16_HDR: "FLOAT_RGBX16_HDR", FLOAT_RGBA16_HDR: "FLOAT_RGBA16_HDR",
    FLOAT_R32: "FLOAT_R32", FLOAT_RG32: "FLOAT_RG32",
    FLOAT_RGB32: "FLOAT_RGB32", FLOAT_RGBX32: "FLOAT_RGBX32",
    FLOAT_RGBA32: "FLOAT_RGBA32", FLOAT_R32_HDR: "FLOAT_R32_HDR",
    FLOAT_RG32_HDR: "FLOAT_RG32_HDR", FLOAT_RGB32_HDR: "FLOAT_RGB32_HDR",
    FLOAT_RGBX32_HDR: "FLOAT_RGBX32_HDR", FLOAT_RGBA32_HDR: "FLOAT_RGBA32_HDR",
}


def format_name(fmt: int) -> str:
    """Human-readable name for a pixel or texture format."""
    if fmt in BY_FORMAT:
        return BY_FORMAT[fmt].name
    return _PIXEL_FORMAT_NAMES.get(fmt, f"0x{fmt:08X}")


def lookup(name_or_fmt) -> Optional[TextureFormatInfo]:
    if isinstance(name_or_fmt, str):
        return BY_NAME.get(name_or_fmt)
    return BY_FORMAT.get(name_or_fmt)
