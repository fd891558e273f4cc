"""HDR -> LDR mapping with gamma/range parameters.

The port's own copy of detex_tpu/hdr.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

TPU-rebuild equivalent of the reference HDR module
(reference: hdr.c:32-213).  The reference keeps gamma/range in
thread-local globals (hdr.c:32-36) set by detexSetHDRParameters
(hdr.c:38-43); we mirror that as module state so the conversion graph
behaves identically, and also expose an explicit HDRParams.

Rounding-mode fidelity: the gamma==1 paths call
fesetround(FE_DOWNWARD) before their float32 arithmetic
(hdr.c:124, 174) and never restore it, so every f32 op in those chains
rounds toward -inf.  We emulate that exactly: each elementary f32 op is
computed exactly in float64 (f32 +-* fit in f64's 53-bit mantissa) and
then rounded *down* to f32.  The gamma!=1 paths never set a rounding
mode; goldens pin FE_TONEAREST, which matches default numpy float32.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HDRParams:
    gamma: float = 1.0
    range_min: float = 0.0
    range_max: float = 1.0


_params = HDRParams()


def set_hdr_parameters(gamma: float, range_min: float,
                       range_max: float) -> None:
    """reference detexSetHDRParameters (hdr.c:38-43)."""
    global _params
    _params = HDRParams(gamma, range_min, range_max)


def get_hdr_parameters() -> HDRParams:
    return _params


def _down32(x64: np.ndarray) -> np.ndarray:
    """Round float64 values toward -inf onto the float32 grid
    (emulates one FE_DOWNWARD float32 operation)."""
    y = np.asarray(x64, dtype=np.float64).astype(np.float32)
    over = y.astype(np.float64) > x64
    return np.where(over, np.nextafter(y, np.float32(-np.inf)), y)


def _down_sub_f32(a, b) -> np.ndarray:
    """f32 a - b rounded toward -inf with a SINGLE rounding (one
    FE_DOWNWARD subtraction, hdr.c:124/174 semantics).  The plain
    float64 subtraction can itself round (1 - 2^-57 -> 1.0 in RN64),
    so `_down32` alone double-rounds; a float64 TwoSum residual
    recovers the exact difference and disambiguates."""
    with np.errstate(invalid="ignore"):
        a64 = np.asarray(a, np.float32).astype(np.float64)
        b64 = np.asarray(b, np.float32).astype(np.float64)
        c = -b64
        s = a64 + c
        bv = s - a64
        err = (a64 - (s - bv)) + (c - bv)
        y = s.astype(np.float32)
        y64 = y.astype(np.float64)
        over = (y64 > s) | ((y64 == s) & (err < 0))
        return np.where(over, np.nextafter(y, np.float32(-np.inf)), y)


def _down_recip_f32(d: np.float32) -> np.float32:
    """f32 1/d rounded toward -inf with a single rounding.  The
    over-rounding test y > 1/d is evaluated exactly as y*d > 1 for
    d > 0 (y*d is exact in float64: 24+24 mantissa bits), avoiding the
    double rounding of f32(RN64(1/d))."""
    d64 = np.float64(np.float32(d))
    y = np.float32(1.0 / d64)
    prod = y.astype(np.float64) * d64
    over = (prod > 1.0) if d64 > 0 else (prod < 1.0)
    if over:
        y = np.nextafter(y, np.float32(-np.inf))
    return np.float32(y)


def _clamp01_f32(x: np.ndarray) -> np.ndarray:
    """detexClamp0To1 (detex.h): NaN passes through (both compares
    false), exactly like the C code."""
    x = np.asarray(x, dtype=np.float32)
    return np.where(x < 0, np.float32(0),
                    np.where(x > 1, np.float32(1), x))


def quantize_u16_downward(c01_f32: np.ndarray) -> np.ndarray:
    """FE_DOWNWARD lrintf(x*65535.0f + 0.5f) on already-clamped f32
    (half-float.c:306-311): both f32 ops round down, lrintf floors."""
    with np.errstate(invalid="ignore"):
        # NaN inputs flow through the arithmetic and cast like the C
        # code's lrintf(NaN) path; suppress numpy's cast warning.
        w = _down32(c01_f32.astype(np.float64) * 65535.0)
        w2 = _down32(w.astype(np.float64) + 0.5)
        return np.floor(w2.astype(np.float64)).astype(np.int64) \
            .astype(np.uint16)


_powf_impl = None


def _libm_powf():
    """Exact glibc powf via ctypes: the reference's gamma table is built
    with powf (hdr.c:55-59) and np.power(float64) occasionally
    double-rounds one ulp differently."""
    global _powf_impl
    if _powf_impl is None:
        import ctypes
        libm = ctypes.CDLL("libm.so.6")
        libm.powf.restype = ctypes.c_float
        libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
        _powf_impl = np.frompyfunc(
            lambda a, b: np.float32(libm.powf(float(a), float(b))), 2, 1)
    return _powf_impl


def _signed_powf(x: np.ndarray, e: float) -> np.ndarray:
    """powf with sign passthrough (hdr.c:55-60, 145-152)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float32))
    powf = _libm_powf()
    with np.errstate(invalid="ignore"):
        mag = powf(np.abs(x), np.float32(e)).astype(np.float32)
    return np.where(x >= 0, mag, -mag).astype(np.float32)


def _map_range_gamma1(f: np.ndarray, rmin: float, rmax: float):
    """Gamma-1 chain under FE_DOWNWARD (hdr.c:121-141, 171-186):
    returns clamped f32 in [0,1]."""
    f = np.asarray(f, dtype=np.float32)
    if rmin == 0.0 and rmax == 1.0:
        return _clamp01_f32(f)
    denom = np.float32(_down_sub_f32(np.float32(rmax), np.float32(rmin)))
    factor = _down_recip_f32(denom)
    t = _down_sub_f32(f, np.float32(rmin))
    # t * factor is exact in float64 (24+24 mantissa bits), so one
    # downward f32 rounding of the float64 product is single-rounded.
    with np.errstate(invalid="ignore"):
        u = _down32(t.astype(np.float64) * factor.astype(np.float64))
    return _clamp01_f32(u)


def _map_range_gamma(f: np.ndarray, params: HDRParams,
                     correct_values: bool):
    """Gamma!=1 chain at FE_TONEAREST (hdr.c:143-166, 188-206).

    correct_values=True is the half-float path: pixel values go through
    the gamma-corrected table (hdr.c:155).  The f32 path maps the RAW
    value against the pow-corrected range endpoints only
    (hdr.c:188-206 never applies powf to buffer[i])."""
    inv_g = np.float32(1.0) / np.float32(params.gamma)
    fg = _signed_powf(f, float(inv_g)) if correct_values \
        else np.asarray(f, np.float32)
    cmin = np.float32(_signed_powf(np.float32(params.range_min),
                                   float(inv_g)))
    cmax = np.float32(_signed_powf(np.float32(params.range_max),
                                   float(inv_g)))
    factor = np.float32(1.0) / np.float32(cmax - cmin)
    return _clamp01_f32((fg - cmin) * factor)


def hdr_half_to_u16(h16: np.ndarray, params: HDRParams = None) -> np.ndarray:
    """reference detexConvertHDRHalfFloatToUInt16 (hdr.c:119-166)."""
    from detex_tpu_torch.convert import half_to_float
    p = params or _params
    f = half_to_float(h16)
    if p.gamma == 1.0:
        c = _map_range_gamma1(f, p.range_min, p.range_max)
        return quantize_u16_downward(c)
    c = _map_range_gamma(f, p, correct_values=True)
    # lrintf at FE_TONEAREST: rint(x*65535f + 0.5f) in f32.
    w = (c * np.float32(65535.0) + np.float32(0.5))
    with np.errstate(invalid="ignore"):
        return np.rint(w.astype(np.float64)).astype(np.int64) \
            .astype(np.uint16)


def hdr_float_to_float(f32: np.ndarray,
                       params: HDRParams = None) -> np.ndarray:
    """reference detexConvertHDRFloatToFloat (hdr.c:168-213)."""
    p = params or _params
    f = np.asarray(f32, dtype=np.float32)
    if p.gamma == 1.0:
        return _map_range_gamma1(f, p.range_min, p.range_max)
    return _map_range_gamma(f, p, correct_values=False)


def calculate_dynamic_range(pixel_buffer: np.ndarray, pixel_format: int):
    """reference detexCalculateDynamicRange (hdr.c:94-116)."""
    from detex_tpu_torch import formats as F
    from detex_tpu_torch.convert import half_to_float
    buf = np.ascontiguousarray(pixel_buffer, dtype=np.uint8)
    if not F.is_float(pixel_format):
        raise ValueError("Pixel buffer not in float format")
    if pixel_format & F.COMPONENT_16BIT:
        f = half_to_float(buf.view(np.uint16))
    elif pixel_format & F.COMPONENT_32BIT:
        f = buf.view(np.float32)
    else:
        raise ValueError("Unable to handle pixel buffer format")
    return float(f.min()), float(f.max())
