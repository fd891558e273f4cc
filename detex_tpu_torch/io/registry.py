"""Texture-format <-> file-format metadata registry.

The port's own copy of detex_tpu/io/registry.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

TPU-rebuild equivalent of the reference's texture_info / synonym tables
(reference: file-info.c:49-188) and the lookup functions
(file-info.c:193-330).  Pure host-side metadata.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from detex_tpu_torch import formats as F


@dataclasses.dataclass(frozen=True)
class FileInfo:
    """Per-format file metadata (reference file-info.h:19-32)."""

    texture_format: int
    ktx_support: bool
    dds_support: bool
    text1: str
    text2: str
    block_width: int
    block_height: int
    gl_internal_format: int
    gl_format: int
    gl_type: int
    dx_four_cc: str
    dx10_format: int


def _e(fmt, ktx, dds, t1, t2, bw, bh, gli, glf, glt, cc, dx10):
    return FileInfo(fmt, bool(ktx), bool(dds), t1, t2, bw, bh, gli, glf,
                    glt, cc, dx10)


# Primary table (reference file-info.c:49-127).
TABLE = [
    # Uncompressed (texture format == pixel format).
    _e(F.RGB8, 1, 1, "RGB8", "", 1, 1, 0x1907, 0x1907, 0x1401, "", 0),
    _e(F.RGBA8, 1, 1, "RGBA8", "", 1, 1, 0x1908, 0x1908, 0x1401, "DX10", 28),
    _e(F.R8, 1, 1, "R8", "", 1, 1, 0x8229, 0x1903, 0x1401, "DX10", 61),
    _e(F.SIGNED_R8, 1, 1, "SIGNED_R8", "", 1, 1, 0x8F49, 0x1903, 0x1400,
       "DX10", 63),
    _e(F.RG8, 1, 1, "RG8", "", 1, 1, 0x822B, 0x8227, 0x1401, "DX10", 49),
    _e(F.SIGNED_RG8, 1, 1, "SIGNED_RG8", "", 1, 1, 0x8F95, 0x8227, 0x1400,
       "DX10", 51),
    _e(F.R16, 1, 1, "R16", "", 1, 1, 0x822A, 0x1903, 0x1403, "DX10", 56),
    _e(F.SIGNED_R16, 1, 1, "SIGNED_R16", "", 1, 1, 0x8F98, 0x1903, 0x1402,
       "DX10", 58),
    _e(F.RG16, 1, 1, "RG16", "", 1, 1, 0x8226, 0x8227, 0x1403, "DX10", 35),
    _e(F.SIGNED_RG16, 1, 1, "SIGNED_RG16", "", 1, 1, 0x8F99, 0x8227, 0x1402,
       "DX10", 37),
    _e(F.RGB16, 1, 0, "RGB16", "", 1, 1, 0x8054, 0x1907, 0x1403, "", 0),
    _e(F.RGBA16, 1, 1, "RGBA16", "", 1, 1, 0x805B, 0x8227, 0x1403,
       "DX10", 11),
    _e(F.FLOAT_R16, 1, 1, "FLOAT_R16", "", 1, 1, 0x822D, 0x1903, 0x140B,
       "DX10", 54),
    _e(F.FLOAT_RG16, 1, 1, "FLOAT_RG16", "", 1, 1, 0x822F, 0x8227, 0x140B,
       "DX10", 34),
    _e(F.FLOAT_RGB16, 1, 0, "FLOAT_RGB16", "", 1, 1, 0x1907, 0x1907, 0x140B,
       "", 0),
    _e(F.FLOAT_RGBA16, 1, 1, "FLOAT_RGBA16", "", 1, 1, 0x1908, 0x1908,
       0x140B, "DX10", 10),
    _e(F.FLOAT_R32, 1, 1, "FLOAT_R32", "", 1, 1, 0x822E, 0x1903, 0x1406,
       "DX10", 41),
    _e(F.FLOAT_RG32, 1, 1, "FLOAT_RG32", "", 1, 1, 0x8230, 0x8227, 0x1406,
       "DX10", 16),
    _e(F.FLOAT_RGB32, 1, 1, "FLOAT_RGB32", "", 1, 1, 0x8815, 0x1907, 0x1406,
       "DX10", 6),
    _e(F.FLOAT_RGBA32, 1, 1, "FLOAT_RGBA32", "", 1, 1, 0x8814, 0x1908,
       0x1406, "DX10", 2),
    _e(F.A8, 1, 1, "A8", "", 1, 1, 0x1906, 0x1906, 0x1401, "DX10", 65),
    # Compressed.
    _e(F.BC1, 1, 1, "BC1", "DXT1", 4, 4, 0x83F0, 0, 0, "DXT1", 0),
    _e(F.BC1A, 1, 1, "BC1A", "DXT1A", 4, 4, 0x83F1, 0, 0, "", 0),
    _e(F.BC2, 1, 1, "BC2", "DXT3", 4, 4, 0x83F2, 0, 0, "DXT3", 0),
    _e(F.BC3, 1, 1, "BC3", "DXT5", 4, 4, 0x83F3, 0, 0, "DXT5", 0),
    _e(F.RGTC1, 1, 1, "RGTC1", "BC4_UNORM", 4, 4, 0x8DBB, 0, 0, "DX10", 80),
    _e(F.SIGNED_RGTC1, 1, 1, "SIGNED_RGTC1", "BC4_SNORM", 4, 4, 0x8DBC, 0,
       0, "DX10", 81),
    _e(F.RGTC2, 1, 1, "RGTC2", "BC5_UNORM", 4, 4, 0x8DBD, 0, 0, "DX10", 83),
    _e(F.SIGNED_RGTC2, 1, 1, "SIGNED_RGTC2", "BC5_SNORM", 4, 4, 0x8DBE, 0,
       0, "DX10", 84),
    _e(F.BPTC_FLOAT, 1, 1, "BPTC_FLOAT", "BC6H_UF16", 4, 4, 0x8E8F, 0, 0,
       "DX10", 95),
    _e(F.BPTC_SIGNED_FLOAT, 1, 1, "BPTC_SIGNED_FLOAT", "BC6H_SF16", 4, 4,
       0x8E8E, 0, 0, "DX10", 96),
    _e(F.BPTC, 1, 1, "BPTC", "BC7", 4, 4, 0x8E8C, 0, 0, "DX10", 98),
    _e(F.ETC1, 1, 0, "ETC1", "", 4, 4, 0x8D64, 0, 0, "", 0),
    _e(F.ETC2, 1, 0, "ETC2", "ETC2_RGB8", 4, 4, 0x9274, 0, 0, "", 0),
    _e(F.ETC2_PUNCHTHROUGH, 1, 0, "ETC2_PUNCHTHROUGH", "", 4, 4, 0x9275, 0,
       0, "", 0),
    _e(F.ETC2_EAC, 1, 0, "ETC2_EAC", "EAC", 4, 4, 0x9278, 0, 0, "", 0),
    _e(F.EAC_R11, 1, 0, "EAC_R11", "", 4, 4, 0x9270, 0, 0, "", 0),
    _e(F.EAC_SIGNED_R11, 1, 0, "EAC_SIGNED_R11", "", 4, 4, 0x9271, 0, 0,
       "", 0),
    _e(F.EAC_RG11, 1, 0, "EAC_RG11", "", 4, 4, 0x9272, 0, 0, "", 0),
    _e(F.EAC_SIGNED_RG11, 1, 0, "EAC_SIGNED_RG11", "", 4, 4, 0x9273, 0, 0,
       "", 0),
    # Pseudo-formats (name lookup only, file-info.c:114-126).
    _e(F.RGBX8, 0, 0, "RGBX8", "", 1, 1, 0, 0, 0, "", 0),
    _e(F.BGRX8, 0, 0, "BGRX8", "", 1, 1, 0, 0, 0, "", 0),
    _e(F.FLOAT_RGBX16, 0, 0, "FLOAT_RGBX16", "", 1, 1, 0, 0, 0, "", 0),
    _e(F.FLOAT_R16_HDR, 0, 0, "FLOAT_R16_HDR", "", 1, 1, 0, 0, 0, "", 0),
    _e(F.FLOAT_RG16_HDR, 0, 0, "FLOAT_RG16_HDR", "", 1, 1, 0, 0, 0, "", 0),
    _e(F.FLOAT_RGB16_HDR, 0, 0, "FLOAT_RGB16_HDR", "", 1, 1, 0, 0, 0,
       "", 0),
    _e(F.FLOAT_RGBA16_HDR, 0, 0, "FLOAT_RGBA16_HDR", "", 1, 1, 0, 0, 0,
       "", 0),
    _e(F.FLOAT_R32_HDR, 0, 0, "FLOAT_R32_HDR", "", 1, 1, 0, 0, 0, "", 0),
    _e(F.FLOAT_RG32_HDR, 0, 0, "FLOAT_RG32_HDR", "", 1, 1, 0, 0, 0, "", 0),
    _e(F.FLOAT_RGB32_HDR, 0, 0, "FLOAT_RGB32_HDR", "", 1, 1, 0, 0, 0,
       "", 0),
    _e(F.FLOAT_RGBA32_HDR, 0, 0, "FLOAT_RGBA32_HDR", "", 1, 1, 0, 0, 0,
       "", 0),
]

# GL synonyms (file-info.c:139-149).
GL_SYNONYMS = [
    (F.RGB8, 0x8051, 0x1907, 0x1401),
    (F.RGBA8, 0x8058, 0x1908, 0x1401),
    (F.FLOAT_RGB16, 0x881B, 0x1907, 0x140B),
    (F.FLOAT_RGBA16, 0x881A, 0x1908, 0x140B),
    (F.A8, 0x803C, 0x1906, 0x1401),
    (F.RGTC1, 0x8C70, 0, 0),
    (F.SIGNED_RGTC1, 0x8C71, 0, 0),
    (F.RGTC2, 0x8C72, 0, 0),
    (F.SIGNED_RGTC2, 0x8C73, 0, 0),
]

# DDS synonyms (file-info.c:161-188).
DDS_SYNONYMS = [
    (F.RGBA8, "DX10", 27), (F.RGBA8, "DX10", 30), (F.RG16, "DX10", 36),
    (F.R16, "DX10", 57), (F.SIGNED_RG16, "DX10", 38),
    (F.SIGNED_R16, "DX10", 59), (F.RG8, "DX10", 50), (F.R8, "DX10", 62),
    (F.SIGNED_RG8, "DX10", 52), (F.SIGNED_R8, "DX10", 64),
    (F.RGBA16, "DX10", 12), (F.BC1, "DX10", 70), (F.BC1, "DX10", 71),
    (F.BC2, "DX10", 73), (F.BC2, "DX10", 74), (F.BC3, "DX10", 76),
    (F.BC3, "DX10", 77), (F.RGTC1, "DX10", 79), (F.RGTC1, "BC4U", 0),
    (F.SIGNED_RGTC1, "BC4S", 0), (F.RGTC2, "DX10", 82),
    (F.SIGNED_RGTC2, "BC5S", 0), (F.BPTC, "DX10", 97),
    (F.BPTC_FLOAT, "DX10", 94), (F.RGTC1, "ATI1", 0), (F.RGTC2, "ATI2", 0),
]

DDPF_ALPHAPIXELS = 0x1
DDPF_ALPHA = 0x2
DDPF_RGB = 0x40


def by_format(texture_format: int) -> Optional[FileInfo]:
    """reference detexLookupTextureFormatFileInfo (file-info.c:193-198)."""
    for info in TABLE:
        if info.texture_format == texture_format:
            return info
    return None


def by_name(name: str) -> Optional[FileInfo]:
    """reference detexLookupTextureDescription (file-info.c:201-206)."""
    s = name.lower()
    for info in TABLE:
        if info.text1.lower() == s or (info.text2
                                       and info.text2.lower() == s):
            return info
    return None


def by_gl(gl_internal_format: int, gl_format: int,
          gl_type: int) -> Optional[FileInfo]:
    """reference detexLookupKTXFileInfo (file-info.c:209-225)."""
    for info in TABLE:
        if info.gl_internal_format and \
                info.gl_internal_format == gl_internal_format:
            if info.gl_format == 0:
                return info
            if info.gl_format == gl_format and info.gl_type == gl_type:
                return info
    for fmt, gli, glf, glt in GL_SYNONYMS:
        if gli == gl_internal_format:
            if glf == 0 or (glf == gl_format and glt == gl_type):
                return by_format(fmt)
    return None


def component_masks(pixel_format: int):
    """reference detexGetComponentMasks (misc.c:35-71)."""
    cs = F.component_size(pixel_format) * 8
    nc = F.num_components(pixel_format)
    r = g = b = a = 0
    if nc == 1 and F.has_alpha(pixel_format):
        a = (1 << cs) - 1
        return r, g, b, a
    r = (1 << cs) - 1
    if nc > 1:
        g = r << cs
        if nc > 2:
            b = r << (2 * cs)
            if nc > 3:
                a = r << (3 * cs)
    if F.is_bgr(pixel_format):
        r, b = b, r
    return r, g, b, a


def by_dds(four_cc: str, dx10_format: int, pixel_format_flags: int,
           bitcount: int, red_mask: int, green_mask: int, blue_mask: int,
           alpha_mask: int) -> Optional[FileInfo]:
    """reference detexLookupDDSFileInfo (file-info.c:234-280)."""
    is_dx10 = four_cc[:4] == "DX10"
    for info in TABLE:
        if is_dx10:
            if info.dx10_format == dx10_format:
                return info
            continue
        if info.dx_four_cc and info.dx_four_cc[:4] == four_cc[:4]:
            return info
        fmt = info.texture_format
        if (pixel_format_flags & DDPF_RGB) and not F.is_compressed(fmt):
            if bitcount <= 32:
                fr, fg, fb, fa = component_masks(fmt)
                if (F.pixel_size(fmt) * 8 == bitcount and fr == red_mask
                        and fg == green_mask and fb == blue_mask
                        and ((pixel_format_flags & DDPF_ALPHAPIXELS) == 0
                             or fa == alpha_mask)):
                    return info
        if (pixel_format_flags & DDPF_ALPHA) and bitcount == 8 \
                and fmt == F.A8:
            return info
    for fmt, cc, dx10 in DDS_SYNONYMS:
        if is_dx10:
            if dx10 == dx10_format:
                return by_format(fmt)
        elif cc and cc[:4] == four_cc[:4]:
            return by_format(fmt)
    return None


def format_text(texture_format: int) -> str:
    """reference detexGetTextureFormatText (file-info.c:283-291)."""
    info = by_format(texture_format)
    return info.text1 if info else "Invalid"


def gl_parameters(texture_format: int):
    """reference detexGetOpenGLParameters (file-info.c:304-315)."""
    info = by_format(texture_format)
    if info is None:
        raise ValueError("invalid texture format")
    return info.gl_internal_format, info.gl_format, info.gl_type


def dx10_format(texture_format: int) -> int:
    """reference detexGetDX10Parameters (file-info.c:318-330)."""
    info = by_format(texture_format)
    if info is None or info.dx_four_cc != "DX10":
        raise ValueError("no DX10 format for texture format")
    return info.dx10_format
