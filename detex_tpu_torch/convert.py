"""Pixel-format conversion engine (host-side numpy, bit-exact).

The port's own copy of detex_tpu/convert.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

TPU-rebuild equivalent of the reference conversion engine
(reference: convert.c:31-751 kernels, convert.c:765-864 edge table,
convert.c:888-1048 path search).  The kernels are vectorized numpy over
flat byte buffers; the 72-entry conversion graph and the path search
(direct, then 2/3/4-step with no-loss-of-components/precision pruning,
first match in table order wins) are reproduced exactly, because
*different paths can round differently* — path identity is part of
bit-exactness.

The reference's in-place/temp-buffer machinery (convert.c:1099-1163) is
irrelevant here: steps run functionally, producing new arrays.

Half-float conversions mirror the reference's integer implementations
(half-float.c:102-267, James Tursa's routines): f32->f16 rounds half
*up* (not to-even), flushes denormals to signed zero, canonicalizes NaN
to 0xFE00; f16->f32 is exact with NaN canonicalized to 0xFFC00000.
Normalized float->u16 is floor(clamp01(f)*65535 + 0.5) — the
FE_DOWNWARD + lrintf pair (half-float.c:304-322) — computed here in
float64, where the product is exact.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from detex_tpu_torch import formats as F
from detex_tpu_torch import hdr


class ConversionError(Exception):
    pass


# ---------------------------------------------------------------------------
# Half-float primitives (reference half-float.c)
# ---------------------------------------------------------------------------


def float_to_half(f32: np.ndarray) -> np.ndarray:
    """f32 array -> u16 half bits (reference singles2halfp,
    half-float.c:102-180)."""
    x = np.ascontiguousarray(f32, dtype=np.float32).view(np.uint32)
    xs = x & 0x80000000
    xe = x & 0x7F800000
    xm = x & 0x007FFFFF
    hs = (xs >> 16).astype(np.uint32)
    hes = (xe >> 23).astype(np.int32) - 127 + 15
    out = np.zeros(x.shape, dtype=np.uint32)
    # Signed zero and denormal underflow -> signed zero
    zero = (x & 0x7FFFFFFF) == 0
    denorm = (xe == 0) & ~zero
    out[zero] = (x[zero] >> 16)
    out[denorm] = hs[denorm]
    inf_nan = xe == 0x7F800000
    inf = inf_nan & (xm == 0)
    nan = inf_nan & (xm != 0)
    out[inf] = hs[inf] | 0x7C00
    out[nan] = 0xFE00
    normal = ~zero & ~denorm & ~inf_nan
    over = normal & (hes >= 0x1F)
    out[over] = hs[over] | 0x7C00
    under = normal & (hes <= 0)
    if under.any():
        sh = 14 - hes[under]
        xmu = xm[under] | 0x00800000
        hm = np.where(sh > 24, 0,
                      xmu >> np.minimum(sh, 31).astype(np.uint32))
        rnd = np.where(sh - 1 > 31, 0,
                       (xmu >> np.minimum(np.maximum(sh - 1, 0), 31)
                        .astype(np.uint32)) & 1)
        hm = np.where(sh > 24, 0, hm + rnd)
        out[under] = hs[under] | hm
    rest = normal & (hes > 0) & (hes < 0x1F)
    he = (hes.astype(np.uint32) << 10)
    hm = xm >> 13
    rounded = hs | he | hm
    rounded = np.where((xm & 0x1000) != 0, rounded + 1, rounded)
    out[rest] = rounded[rest]
    return out.astype(np.uint16)


def half_to_float(h16: np.ndarray) -> np.ndarray:
    """u16 half bits -> f32 (reference halfp2singles,
    half-float.c:197-267)."""
    h = np.ascontiguousarray(h16, dtype=np.uint16).astype(np.uint32)
    hs = h & 0x8000
    he = h & 0x7C00
    hm = h & 0x03FF
    out = np.zeros(h.shape, dtype=np.uint32)
    zero = (h & 0x7FFF) == 0
    out[zero] = h[zero] << 16
    denorm = (he == 0) & ~zero
    if denorm.any():
        hmd = hm[denorm].astype(np.uint32)
        e = np.zeros(hmd.shape, np.int32) - 1
        # Normalize: shift until bit 10 set (at most 10 iterations).
        for _ in range(11):
            not_done = (hmd & 0x0400) == 0
            hmd = np.where(not_done, hmd << 1, hmd)
            e = np.where(not_done, e + 1, e)
        xes = -15 + 127 - e
        out[denorm] = ((hs[denorm] << 16)
                       | (xes.astype(np.uint32) << 23)
                       | ((hmd & 0x03FF) << 13))
    inf_nan = he == 0x7C00
    inf = inf_nan & (hm == 0)
    nan = inf_nan & (hm != 0)
    out[inf] = (hs[inf] << 16) | 0x7F800000
    out[nan] = 0xFFC00000
    normal = ~zero & ~denorm & ~inf_nan
    xes = (he >> 10).astype(np.int32) - 15 + 127
    out[normal] = ((hs[normal] << 16)
                   | (xes[normal].astype(np.uint32) << 23)
                   | (hm[normal] << 13))
    return out.view(np.float32)


def normalized_float_to_u16(f32: np.ndarray) -> np.ndarray:
    """FE_DOWNWARD lrintf(clamp01(f)*65535.0f + 0.5f)
    (half-float.c:315-322), with each downward f32 op emulated
    exactly (see hdr.quantize_u16_downward)."""
    from detex_tpu_torch.hdr import _clamp01_f32, quantize_u16_downward
    return quantize_u16_downward(_clamp01_f32(f32))


def normalized_half_to_u16(h16: np.ndarray) -> np.ndarray:
    """reference detexConvertNormalizedHalfFloatToUInt16
    (half-float.c:304-312)."""
    return normalized_float_to_u16(half_to_float(h16))


# ---------------------------------------------------------------------------
# Conversion kernels.  Each maps a flat byte buffer to a new byte buffer.
# ---------------------------------------------------------------------------


def _u8(buf):
    return np.ascontiguousarray(buf, dtype=np.uint8)


def _noop(buf, n):
    return _u8(buf).copy()


def _swap_rb_32(buf, n):
    px = _u8(buf).reshape(n, 4).copy()
    px[:, [0, 2]] = px[:, [2, 0]]
    return px.ravel()


def _swap_rb_64(buf, n):
    px = _u8(buf).view(np.uint16).reshape(n, 4).copy()
    px[:, [0, 2]] = px[:, [2, 0]]
    return px.view(np.uint8).ravel()


def _rgb8_to_bgrx8(buf, n):
    src = _u8(buf).reshape(n, 3)
    out = np.empty((n, 4), np.uint8)
    out[:, 0] = src[:, 2]
    out[:, 1] = src[:, 1]
    out[:, 2] = src[:, 0]
    out[:, 3] = 0xFF
    return out.ravel()


def _offset_u8(buf, n, comps):
    px = _u8(buf).copy()
    return (px + np.uint8(128)).ravel()


def _offset_u16(buf, n, comps):
    px = _u8(buf).view(np.uint16).copy()
    return ((px + np.uint16(32768)).view(np.uint8)).ravel()


def _take_components_u8(buf, n, src_c, dst_c):
    src = _u8(buf).reshape(n, src_c)
    return np.ascontiguousarray(src[:, :dst_c]).ravel()


def _expand_u8(buf, n, src_c):
    src = _u8(buf).reshape(n, src_c)
    out = np.zeros((n, 4), np.uint8)
    out[:, :src_c] = src
    out[:, 3] = 0xFF
    return out.ravel()


def _u16_to_u8(buf, n, comps, alpha_ff=False):
    src = _u8(buf).view(np.uint16).reshape(n, comps).astype(np.uint32)
    out = ((src + 127) * 255 // 65535).astype(np.uint8)
    if alpha_ff:
        out[:, 3] = 0xFF
    return out.ravel()


def _u8_to_u16(buf, n, comps, alpha_ffff=False):
    src = _u8(buf).reshape(n, comps).astype(np.uint32)
    out = (src * 65535 // 255).astype(np.uint16)
    if alpha_ffff:
        out[:, 3] = 0xFFFF
    return out.view(np.uint8).ravel()


def _f32_to_f16(buf, n, comps):
    src = _u8(buf).view(np.float32)
    return float_to_half(src).view(np.uint8).ravel()


def _f16_to_f32(buf, n, comps):
    src = _u8(buf).view(np.uint16)
    return half_to_float(src).view(np.uint8).ravel()


def _f32_to_u16(buf, n, comps):
    src = _u8(buf).view(np.float32)
    return normalized_float_to_u16(src).view(np.uint8).ravel()


def _u16_to_f16(buf, n, comps, rgbx_signed_quirk=False):
    src = _u8(buf).view(np.uint16)
    if rgbx_signed_quirk:
        # Reference quirk: ConvertPixel64RGBX16ToPixel64FloatRGBX16
        # reads components as *signed* int16 (convert.c:564-566), so
        # values >= 32768 go negative; the X lane becomes f16(1.0).
        vals = src.view(np.int16).astype(np.float32) * np.float32(1 / 65535)
        vals = vals.reshape(n, 4).copy()
        vals[:, 3] = np.float32(1.0)
        return float_to_half(vals.ravel()).view(np.uint8).ravel()
    vals = src.astype(np.float32) * np.float32(1 / 65535)
    return float_to_half(vals).view(np.uint8).ravel()


def _f16_to_u16(buf, n, comps):
    src = _u8(buf).view(np.uint16)
    return normalized_half_to_u16(src).view(np.uint8).ravel()


def _hdr_f16_to_u16(buf, n, comps):
    src = _u8(buf).view(np.uint16)
    return hdr.hdr_half_to_u16(src).view(np.uint8).ravel()


def _hdr_f32_to_f32(buf, n, comps):
    src = _u8(buf).view(np.float32)
    return hdr.hdr_float_to_float(src).view(np.uint8).ravel()


def _rgb8_to_rgbx8(buf, n):
    return _expand_u8(buf, n, 3)


def _rgbx8_to_rgb8(buf, n):
    return _take_components_u8(buf, n, 4, 3)


def _rgb16_to_rgbx16(buf, n):
    src = _u8(buf).view(np.uint16).reshape(n, 3)
    out = np.empty((n, 4), np.uint16)
    out[:, :3] = src
    out[:, 3] = float_to_half(np.float32([1.0]))[0]
    return out.view(np.uint8).ravel()


def _rgbx16_to_rgb16(buf, n):
    # Deliberate deviation: the reference's
    # ConvertPixel64RGBX16ToPixel48RGB16 (convert.c:704-716) initializes
    # its target pointer from itself (uninitialized) — UB that compiles
    # to writing nothing.  We implement the intended semantics (drop X).
    src = _u8(buf).view(np.uint16).reshape(n, 4)
    return np.ascontiguousarray(src[:, :3]).view(np.uint8).ravel()


def _rgb32_to_rgbx32(buf, n):
    src = _u8(buf).view(np.float32).reshape(n, 3)
    out = np.empty((n, 4), np.float32)
    out[:, :3] = src
    out[:, 3] = 1.0
    return out.view(np.uint8).ravel()


def _rgbx32_to_rgb32(buf, n):
    src = _u8(buf).view(np.float32).reshape(n, 4)
    return np.ascontiguousarray(src[:, :3]).view(np.uint8).ravel()


# ---------------------------------------------------------------------------
# Conversion edge table — same entries, same ORDER as the reference
# (convert.c:765-864); table order determines which multi-step path the
# search picks.
# ---------------------------------------------------------------------------

_T = []


def _edge(src, dst, fn):
    _T.append((src, dst, fn))


# No-ops (convert.c:768-771)
_edge(F.RGBX8, F.RGBA8, _noop)
_edge(F.RGBA8, F.RGBX8, _noop)
_edge(F.BGRX8, F.BGRA8, _noop)
_edge(F.BGRA8, F.BGRX8, _noop)
# R/B swaps (convert.c:773-778)
_edge(F.RGBX8, F.BGRX8, _swap_rb_32)
_edge(F.BGRX8, F.RGBX8, _swap_rb_32)
_edge(F.RGBA8, F.BGRA8, _swap_rb_32)
_edge(F.BGRA8, F.RGBA8, _swap_rb_32)
_edge(F.FLOAT_RGBX16, F.FLOAT_BGRX16, _swap_rb_64)
_edge(F.FLOAT_BGRX16, F.FLOAT_RGBX16, _swap_rb_64)
_edge(F.RGB8, F.BGRX8, _rgb8_to_bgrx8)
# Signed conversions (convert.c:783-790)
_edge(F.R8, F.SIGNED_R8, lambda b, n: _offset_u8(b, n, 1))
_edge(F.RG8, F.SIGNED_RG8, lambda b, n: _offset_u8(b, n, 2))
_edge(F.SIGNED_R8, F.R8, lambda b, n: _offset_u8(b, n, 1))
_edge(F.SIGNED_RG8, F.RG8, lambda b, n: _offset_u8(b, n, 2))
_edge(F.R16, F.SIGNED_R16, lambda b, n: _offset_u16(b, n, 1))
_edge(F.RG16, F.SIGNED_RG16, lambda b, n: _offset_u16(b, n, 2))
_edge(F.SIGNED_R16, F.R16, lambda b, n: _offset_u16(b, n, 1))
_edge(F.SIGNED_RG16, F.RG16, lambda b, n: _offset_u16(b, n, 2))
# Reducing components (convert.c:792-795)
_edge(F.RGBA8, F.R8, lambda b, n: _take_components_u8(b, n, 4, 1))
_edge(F.RGBA8, F.RG8, lambda b, n: _take_components_u8(b, n, 4, 2))
_edge(F.RGB8, F.R8, lambda b, n: _take_components_u8(b, n, 3, 1))
_edge(F.RGB8, F.RG8, lambda b, n: _take_components_u8(b, n, 3, 2))
# Increasing components (convert.c:798-799)
_edge(F.R8, F.RGBX8, lambda b, n: _expand_u8(b, n, 1))
_edge(F.RG8, F.RGBX8, lambda b, n: _expand_u8(b, n, 2))
# Component size changes (convert.c:801-810)
_edge(F.R16, F.R8, lambda b, n: _u16_to_u8(b, n, 1))
_edge(F.RG16, F.RG8, lambda b, n: _u16_to_u8(b, n, 2))
_edge(F.RGB16, F.RGB8, lambda b, n: _u16_to_u8(b, n, 3))
_edge(F.RGBX16, F.RGBX8, lambda b, n: _u16_to_u8(b, n, 4, alpha_ff=True))
_edge(F.RGBA16, F.RGBA8, lambda b, n: _u16_to_u8(b, n, 4))
_edge(F.R8, F.R16, lambda b, n: _u8_to_u16(b, n, 1))
_edge(F.RG8, F.RG16, lambda b, n: _u8_to_u16(b, n, 2))
_edge(F.RGB8, F.RGB16, lambda b, n: _u8_to_u16(b, n, 3))
_edge(F.RGBX8, F.RGBX16, lambda b, n: _u8_to_u16(b, n, 4,
                                                 alpha_ffff=True))
_edge(F.RGBA8, F.RGBA16, lambda b, n: _u8_to_u16(b, n, 4))
# Integer to half-float (convert.c:813-816)
_edge(F.R16, F.FLOAT_R16, lambda b, n: _u16_to_f16(b, n, 1))
_edge(F.RG16, F.FLOAT_RG16, lambda b, n: _u16_to_f16(b, n, 2))
_edge(F.RGB16, F.FLOAT_RGB16, lambda b, n: _u16_to_f16(b, n, 3))
_edge(F.RGBX16, F.FLOAT_RGBX16,
      lambda b, n: _u16_to_f16(b, n, 4, rgbx_signed_quirk=True))
# Half-float to integer (convert.c:818-822)
_edge(F.FLOAT_R16, F.R16, lambda b, n: _f16_to_u16(b, n, 1))
_edge(F.FLOAT_RG16, F.RG16, lambda b, n: _f16_to_u16(b, n, 2))
_edge(F.FLOAT_RGB16, F.RGB16, lambda b, n: _f16_to_u16(b, n, 3))
_edge(F.FLOAT_RGBX16, F.RGBX16, lambda b, n: _f16_to_u16(b, n, 4))
_edge(F.FLOAT_RGBA16, F.RGBA16, lambda b, n: _f16_to_u16(b, n, 4))
# HDR half-float to integer (convert.c:824-826)
_edge(F.FLOAT_R16_HDR, F.R16, lambda b, n: _hdr_f16_to_u16(b, n, 1))
_edge(F.FLOAT_RG16_HDR, F.RG16, lambda b, n: _hdr_f16_to_u16(b, n, 2))
_edge(F.FLOAT_RGBX16_HDR, F.RGBX16, lambda b, n: _hdr_f16_to_u16(b, n, 4))
# Float to half-float (convert.c:829-832)
_edge(F.FLOAT_R32, F.FLOAT_R16, lambda b, n: _f32_to_f16(b, n, 1))
_edge(F.FLOAT_RG32, F.FLOAT_RG16, lambda b, n: _f32_to_f16(b, n, 2))
_edge(F.FLOAT_RGB32, F.FLOAT_RGB16, lambda b, n: _f32_to_f16(b, n, 3))
_edge(F.FLOAT_RGBX32, F.FLOAT_RGBX16, lambda b, n: _f32_to_f16(b, n, 4))
# Float to 16-bit integer (convert.c:834-837)
_edge(F.FLOAT_R32, F.R16, lambda b, n: _f32_to_u16(b, n, 1))
_edge(F.FLOAT_RG32, F.RG16, lambda b, n: _f32_to_u16(b, n, 2))
_edge(F.FLOAT_RGB32, F.RGB16, lambda b, n: _f32_to_u16(b, n, 3))
_edge(F.FLOAT_RGBX32, F.RGBX16, lambda b, n: _f32_to_u16(b, n, 4))
# Half-float to float (convert.c:840-843)
_edge(F.FLOAT_R16, F.FLOAT_R32, lambda b, n: _f16_to_f32(b, n, 1))
_edge(F.FLOAT_RG16, F.FLOAT_RG32, lambda b, n: _f16_to_f32(b, n, 2))
_edge(F.FLOAT_RGB16, F.FLOAT_RGB32, lambda b, n: _f16_to_f32(b, n, 3))
_edge(F.FLOAT_RGBX16, F.FLOAT_RGBX32, lambda b, n: _f16_to_f32(b, n, 4))
# HDR float to float (convert.c:845-849)
_edge(F.FLOAT_R32_HDR, F.FLOAT_R32, lambda b, n: _hdr_f32_to_f32(b, n, 1))
_edge(F.FLOAT_RG32_HDR, F.FLOAT_RG32, lambda b, n: _hdr_f32_to_f32(b, n, 2))
_edge(F.FLOAT_RGB32_HDR, F.FLOAT_RGB32,
      lambda b, n: _hdr_f32_to_f32(b, n, 3))
_edge(F.FLOAT_RGBX32_HDR, F.FLOAT_RGBX32,
      lambda b, n: _hdr_f32_to_f32(b, n, 4))
# RGB8 <-> RGBX8 (convert.c:852-853)
_edge(F.RGB8, F.RGBX8, _rgb8_to_rgbx8)
_edge(F.RGBX8, F.RGB8, _rgbx8_to_rgb8)
# half RGB16 <-> RGBX16 (convert.c:855-858)
_edge(F.FLOAT_RGB16, F.FLOAT_RGBX16, _rgb16_to_rgbx16)
_edge(F.FLOAT_RGBX16, F.FLOAT_RGB16, _rgbx16_to_rgb16)
_edge(F.FLOAT_RGB16_HDR, F.FLOAT_RGBX16_HDR, _rgb16_to_rgbx16)
_edge(F.FLOAT_RGBX16_HDR, F.FLOAT_RGB16_HDR, _rgbx16_to_rgb16)
# float RGB32 <-> RGBX32 (convert.c:860-863)
_edge(F.FLOAT_RGB32, F.FLOAT_RGBX32, _rgb32_to_rgbx32)
_edge(F.FLOAT_RGBX32, F.FLOAT_RGB32, _rgbx32_to_rgb32)
_edge(F.FLOAT_RGB32_HDR, F.FLOAT_RGBX32_HDR, _rgb32_to_rgbx32)
_edge(F.FLOAT_RGBX32_HDR, F.FLOAT_RGB32_HDR, _rgbx32_to_rgb32)

TABLE = _T
_N = len(TABLE)

_match_cache: dict = {}


def match_conversion(src_fmt: int, dst_fmt: int) -> Optional[list]:
    """Find the conversion path (list of table indices) exactly like
    reference detexMatchConversion (convert.c:888-1048): direct, then
    2/3/4 steps, first match in table order, pruning steps that lose
    components or precision below min(src, dst)."""
    if src_fmt == dst_fmt:
        return []
    key = (src_fmt, dst_fmt)
    if key in _match_cache:
        return _match_cache[key]
    result = _match_uncached(src_fmt, dst_fmt)
    _match_cache[key] = result
    return result


def _match_uncached(src_fmt, dst_fmt):
    for i in range(_N):
        if TABLE[i][0] == src_fmt and TABLE[i][1] == dst_fmt:
            return [i]
    min_c = min(F.num_components(src_fmt), F.num_components(dst_fmt))
    min_p = min(F.component_precision_bits(src_fmt),
                F.component_precision_bits(dst_fmt))

    def ok(fmt):
        return (F.num_components(fmt) >= min_c
                and F.component_precision_bits(fmt) >= min_p)

    # two-step (convert.c:920-940)
    for i in range(_N):
        if TABLE[i][1] == dst_fmt and ok(TABLE[i][0]):
            for j in range(_N):
                if TABLE[j][1] == TABLE[i][0] and TABLE[j][0] == src_fmt:
                    return [j, i]
    # three-step (convert.c:942-983)
    for i in range(_N):
        if TABLE[i][0] == src_fmt and ok(TABLE[i][1]):
            for j in range(_N):
                if TABLE[j][1] == dst_fmt and ok(TABLE[j][0]):
                    for k in range(_N):
                        if TABLE[k][1] == TABLE[j][0] \
                                and TABLE[k][0] == TABLE[i][1]:
                            return [i, k, j]
    # four-step (convert.c:985-1046)
    for i in range(_N):
        if TABLE[i][0] == src_fmt and ok(TABLE[i][1]):
            for j in range(_N):
                if TABLE[j][1] == dst_fmt and ok(TABLE[j][0]):
                    for k in range(_N):
                        if TABLE[k][0] == TABLE[i][1] and ok(TABLE[k][1]):
                            for m in range(_N):
                                if TABLE[m][1] == TABLE[j][0] \
                                        and TABLE[m][0] == TABLE[k][1]:
                                    return [i, k, m, j]
    return None


def convert_pixels(src: np.ndarray, n_pixels: int, src_fmt: int,
                   dst_fmt: int) -> np.ndarray:
    """Convert a flat uint8 pixel buffer between formats (reference
    detexConvertPixels, convert.c:1082-1166)."""
    src = np.ascontiguousarray(src, dtype=np.uint8).ravel()
    if src_fmt == dst_fmt:
        return src.copy()
    path = match_conversion(src_fmt, dst_fmt)
    if path is None:
        raise ConversionError(
            f"Unable to find conversion path "
            f"{F.format_name(src_fmt)} -> {F.format_name(dst_fmt)}")
    buf = src
    for step in path:
        buf = np.ascontiguousarray(TABLE[step][2](buf, n_pixels),
                                   dtype=np.uint8)
    return buf


def convert_pixels_in_place(buf: np.ndarray, n_pixels: int, src_fmt: int,
                            dst_fmt: int) -> None:
    """In-place variant (reference detexConvertPixelsInPlace,
    convert.c:1168-1171): only conversions that preserve pixel size are
    allowed; `buf` (flat uint8) is overwritten with the result."""
    if F.pixel_size(src_fmt) != F.pixel_size(dst_fmt):
        raise ConversionError(
            f"In-place conversion requires equal pixel sizes: "
            f"{F.format_name(src_fmt)} -> {F.format_name(dst_fmt)}")
    out = convert_pixels(buf, n_pixels, src_fmt, dst_fmt)
    np.copyto(buf.view(np.uint8).reshape(-1), out)
