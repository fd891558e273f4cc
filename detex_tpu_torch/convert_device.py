"""Pixel-format conversion on the tensor's device, in plain PyTorch.

Counterpart of detex_tpu/convert_device.py: every edge of the host
conversion graph (convert.TABLE of the port's copy of the host converter;
reference convert.c:765-864) has a device function here, held bit-exact
to the host oracle (the port's convert and hdr) by
tests/test_torch_convert_device.py.
The path through the graph comes from the host's match_conversion, so the
device runs the same steps in the same order, and the HDR parameters are
read from the port's hdr at call time.

Pixel representation: a (n_pixels, lanes) tensor per format, uint8 lanes
for 8-bit formats, int16 lanes for 16-bit integer and half-float formats
and int32 lanes for 32-bit float formats, each holding the component's
bit pattern (half and float values are carried as bits).  Arithmetic runs
on int32/int64 copies, since torch's uint16/uint32 tensors lack shifts,
sums and compares; float arithmetic views int32 bits as float32.

Exact-rounding notes (as in the JAX module):
  * f32 <-> f16 follow James Tursa's integer routines (half-float.c:102-267)
    on the bit patterns.
  * normalized float -> u16 is FE_DOWNWARD lrintf(clamp01(f) * 65535 + 0.5)
    (half-float.c:304-322), computed exactly in integer limbs.
  * The gamma 1 HDR range map runs under FE_DOWNWARD in the reference
    (hdr.c:124, 174).  The JAX module emulates each downward f32 op with
    f32 TwoSum/Dekker residuals, which a TPU needs (it has no float64) and
    which fail where XLA flushes denormals.  Here down_sub/down_mul work as
    the host oracle does: the f32 operands' product is exact in float64, a
    difference is exact with its float64 TwoSum residual, and the result is
    rounded to f32 and stepped one ulp down where that rounded up.  So the
    port matches the oracle on every input, denormal chains included.
  * The gamma != 1 half path gathers from a 65,536-entry u16 table built on
    the host with the oracle (hdr.c:46-60, 143-166), cached per HDR
    parameters and device; the f32 path is plain FE_TONEAREST arithmetic
    against pow-corrected endpoints (hdr.c:188-206).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from detex_tpu_torch import formats as F
from detex_tpu_torch import graphs
from detex_tpu_torch import resolve_device
from detex_tpu_torch import hdr as hdr_mod
from detex_tpu_torch.convert import TABLE, ConversionError, match_conversion
from detex_tpu_torch.utils import trace

_U32 = 0xFFFFFFFF
_DTYPES = {1: torch.uint8, 2: torch.int16, 4: torch.int32}

# --- representation -----------------------------------------------------------


def repr_dtype(fmt: int) -> torch.dtype:
    """Tensor dtype of one component lane of `fmt`."""
    return _DTYPES[F.component_size(fmt)]


def repr_lanes(fmt: int) -> int:
    """Number of stored component lanes (X padding lanes included)."""
    return F.pixel_size(fmt) // F.component_size(fmt)


def _fill(host: torch.Tensor, src: np.ndarray) -> torch.Tensor:
    """Copy src's bytes into the contiguous host tensor `host` in one pass,
    in C order, src cast to uint8 as np.ascontiguousarray(src, np.uint8)
    casts it: host's bytes viewed in src's shape are src.  Returns host."""
    src = np.asarray(src)
    np.copyto(host.numpy().view(np.uint8).reshape(src.shape), src,
              casting="unsafe")
    return host


def staged(src: np.ndarray, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """A host tensor of `shape` and `dtype` holding src's bytes (_fill),
    to be uploaded to `device`: for a card, a pinned block taken from
    torch's caching host allocator."""
    return _fill(torch.empty(shape, dtype=dtype,
                             pin_memory=device.type == "cuda"), src)


def upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The host tensor `host` on `device`, the copy enqueued without a
    wait.  From a pinned block (staged()) the caching host allocator
    records the copy's event and hands the block to no one else until the
    copy has run, so the caller may drop it at once."""
    trace.count_copy(host, device)
    if host.is_pinned():
        trace.count_pinned(host)
    return host.to(device, non_blocking=True)


def from_bytes(buf: np.ndarray, n_pixels: int, fmt: int,
               device="cuda") -> torch.Tensor:
    """Flat u8 host buffer -> (n_pixels, lanes) tensor on `device` (the
    card unless device="cpu"), the bytes copied once into a staged block
    (staged, upload)."""
    device = resolve_device(device)
    with trace.span("dtx.texture.upload"):
        return upload(staged(buf, (n_pixels, repr_lanes(fmt)),
                             repr_dtype(fmt), device), device)


def to_bytes(t: torch.Tensor) -> np.ndarray:
    """A tensor in the lane representation -> flat u8 host buffer
    (little-endian).

    A tensor on a card is copied into a pinned block of its shape and
    dtype from torch's caching host allocator, and only that copy is
    waited for (an event recorded after it), so a caller holding a lock
    over the tensor (graphs.run's `read`) has the bytes before it lets
    go.  Each call returns a block of its own, which the caller owns:
    when the array is freed the block goes back to the cache, and the
    next call of that size takes it again without a cudaHostAlloc.  A
    call that finds no free block (a size's first, or while callers hold
    every earlier one) pays a fresh cudaHostAlloc (PERF.md weighs it
    against the pageable copy it replaces).  So the pinned memory held is
    the peak of what callers hold at once plus one call's staging, each
    block rounded up to a power of two by the cache, which keeps freed
    blocks pinned until torch._C._host_emptyCache() (where torch has it).
    A CPU tensor's bytes are returned as its numpy view."""
    with trace.span("dtx.texture.copy_out"):
        t = t.contiguous()
        trace.count_copy(t, "cpu")
        if not t.is_cuda:
            return t.cpu().numpy().view(np.uint8).ravel()
        block = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        block.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(t.device))
        copied.synchronize()
        trace.count_pinned(block)
        return block.numpy().view(np.uint8).ravel()


def _u16(a: torch.Tensor) -> torch.Tensor:
    """int16 lanes -> int32 values 0..65535."""
    return a.to(torch.int32) & 0xFFFF


def _i16(x: torch.Tensor) -> torch.Tensor:
    """int32/int64 values 0..65535 -> int16 lanes with those bits."""
    x = x & 0xFFFF
    return torch.where(x >= 0x8000, x - 0x10000, x).to(torch.int16)


def _u32(a: torch.Tensor) -> torch.Tensor:
    """int32 lanes -> int64 values 0..2**32-1."""
    return a.to(torch.int64) & _U32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values 0..2**32-1 -> int32 lanes with those bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _f32(bits: torch.Tensor) -> torch.Tensor:
    """int64 values 0..2**32-1 -> float32 with those bits."""
    return _i32(bits).view(torch.float32)


def _bits(f: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 bit patterns 0..2**32-1."""
    return _u32(f.contiguous().view(torch.int32))


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """x rounded to float32 on the host, as a float32 0-d tensor on like's
    device.  The tensor is a fill on the device, not a copy from the host:
    a copy waits, and a captured conversion cannot hold one."""
    return like.new_full((), float(np.float32(x)), dtype=torch.float32)


# --- bit-exact float primitives on bit patterns ---------------------------


def f32_bits_to_f16_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 f32 bits -> int64 half bits (reference singles2halfp,
    half-float.c:102-180: round half up, denormals -> signed zero, NaN ->
    0xFE00)."""
    xs = x & 0x80000000
    xe = x & 0x7F800000
    xm = x & 0x007FFFFF
    hs = xs >> 16
    hes = (xe >> 23) - 127 + 15
    zero = (x & 0x7FFFFFFF) == 0
    denorm = (xe == 0) & ~zero
    inf_nan = xe == 0x7F800000
    inf = inf_nan & (xm == 0)
    nan = inf_nan & (xm != 0)
    # Underflow (hes <= 0): shift the mantissa right, with its round bit.
    sh = 14 - hes
    xmu = xm | 0x00800000
    hm_u = torch.where(sh > 24, 0, xmu >> torch.clamp(sh, 0, 31))
    rnd = torch.where(sh - 1 > 31, 0,
                      (xmu >> torch.clamp(sh - 1, 0, 31)) & 1)
    under_val = hs | torch.where(sh > 24, 0, hm_u + rnd)
    # Normal range: truncate to 10 bits, round half up through bit 12 (a
    # carry may run into the exponent, as Tursa's code intends).
    rounded = hs | (torch.clamp(hes, 0, 0x1F) << 10) | (xm >> 13)
    out = torch.where((xm & 0x1000) != 0, rounded + 1, rounded)
    out = torch.where(hes <= 0, under_val, out)
    out = torch.where(hes >= 0x1F, hs | 0x7C00, out)
    out = torch.where(denorm, hs, out)
    out = torch.where(zero, x >> 16, out)
    out = torch.where(inf, hs | 0x7C00, out)
    out = torch.where(nan, 0xFE00, out)
    return out & 0xFFFF


def f16_bits_to_f32_bits(a: torch.Tensor) -> torch.Tensor:
    """int16 half lanes -> int32 f32 bit patterns (reference halfp2singles,
    half-float.c:197-267): the half -> float cast is exact on the CPU and
    on CUDA, denormals included; NaN -> 0xFFC00000 as the reference
    gives it."""
    f = a.view(torch.float16).to(torch.float32)
    return torch.where(torch.isnan(f), -0x00400000, f.view(torch.int32))


def _bitlen(v: torch.Tensor) -> torch.Tensor:
    """Bit length of values 0..2**32-1 (0 -> 0), by binary search."""
    k = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = v >= (1 << s)
        k = k + torch.where(big, s, 0)
        v = torch.where(big, v >> s, v)
    return k + (v > 0).to(v.dtype)


def clamp01_f32_bits(b: torch.Tensor) -> torch.Tensor:
    """detexClamp0To1 on int64 f32 bits: NaN passes (both compares are
    false in the C macro); compared as bit patterns, so negative denormals
    clamp to 0 as the host oracle does."""
    mag = b & 0x7FFFFFFF
    nan = mag > 0x7F800000
    neg = ((b >> 31) != 0) & (mag != 0) & ~nan
    gt1 = ((b >> 31) == 0) & (mag > 0x3F800000) & ~nan
    return torch.where(gt1, 0x3F800000, torch.where(neg, 0, b))


def quantize_u16_downward(b: torch.Tensor) -> torch.Tensor:
    """Exact FE_DOWNWARD lrintf(c * 65535.0f + 0.5f) for int64 bits of a
    clamped [0, 1] f32 (half-float.c:306-311), as int64 0..65535.

    c = M * 2^(E-150) with M < 2^24; P = M * 65535 < 2^41 is held as
    hi * 2^16 + lo; the downward f32 product truncates P to 24 significant
    bits, and the +0.5 and the floor reduce to (P_t + 2^(s-1)) >> s with
    s = 150 - E >= 23, on the hi limb only.  NaN -> 0 (lrintf(NaN) is
    INT_MIN, whose low 16 bits are 0, as in the host oracle)."""
    e = (b >> 23) & 0xFF
    m = b & 0x7FFFFF
    mm = torch.where(e > 0, m | 0x800000, m)
    big_e = torch.clamp(e, min=1)
    hi = (mm >> 16) * 65535 + (((mm & 0xFFFF) * 65535) >> 16)
    lo = ((mm & 0xFFFF) * 65535) & 0xFFFF
    k = torch.where(hi > 0, _bitlen(hi) + 16, _bitlen(lo))
    sh = torch.clamp(k - 24, min=0)                          # <= 17
    hi_sh = torch.clamp(sh - 16, min=0)
    hi_t = (hi >> hi_sh) << hi_sh
    s = 150 - big_e                                          # >= 23
    res = (hi_t + (1 << torch.clamp(s - 17, 0, 31))) \
        >> torch.clamp(s - 16, 0, 31)
    res = torch.where(s >= 42, 0, res)
    nan = (b & 0x7FFFFFFF) > 0x7F800000
    return torch.where(nan, 0, res) & 0xFFFF


# --- downward-rounded f32 operations -------------------------------------------


def _nextbelow(f: torch.Tensor) -> torch.Tensor:
    """Largest f32 below f (+-0 -> -denorm_min, +inf -> FLT_MAX), as
    nextafterf(f, -inf)."""
    bits = _bits(f)
    stepped = torch.where((bits >> 31) != 0, bits + 1, bits - 1)
    return _f32(torch.where((bits & 0x7FFFFFFF) == 0, 0x80000001, stepped))


def _round_down(x64: torch.Tensor, over: torch.Tensor = None) -> torch.Tensor:
    """float64 values onto the f32 grid toward -inf: round to nearest, then
    step one ulp down where that rounded up (hdr._down32)."""
    y = x64.to(torch.float32)
    if over is None:
        over = y.to(torch.float64) > x64
    return torch.where(over, _nextbelow(y), y)


def down_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 a - b rounded toward -inf, as one FE_DOWNWARD subtraction
    (hdr._down_sub_f32): the float64 difference and its TwoSum residual
    give the exact result's side of each f32.  Exact for denormals too; a
    finite positive overflow gives FLT_MAX."""
    a64, c = a.to(torch.float64), -b.to(torch.float64)
    s = a64 + c
    bv = s - a64
    err = (a64 - (s - bv)) + (c - bv)
    y64 = s.to(torch.float32).to(torch.float64)
    return _round_down(s, (y64 > s) | ((y64 == s) & (err < 0)))


def down_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 a * b rounded toward -inf, as one FE_DOWNWARD multiply: the
    float64 product of two f32 values is exact, denormal results
    included."""
    return _round_down(a.to(torch.float64) * b.to(torch.float64))


# --- HDR maps --------------------------------------------------------------------


def _nan_passthrough(fbits, out):
    """NaN inputs keep their payload with the quiet bit set, as the host's
    arithmetic leaves them."""
    nan_in = (fbits & 0x7FFFFFFF) > 0x7F800000
    return torch.where(nan_in, fbits | 0x00400000, out)


def gamma1_constants(rmin: float, rmax: float) -> tuple:
    """The gamma 1 range map's two f32 prefactors (rmin, the downward
    reciprocal of the downward rmax - rmin), by the host oracle."""
    denom = np.float32(hdr_mod._down_sub_f32(np.float32(rmax),
                                             np.float32(rmin)))
    return np.float32(rmin), np.float32(hdr_mod._down_recip_f32(denom))


def gamma_f32_constants(p) -> tuple:
    """The gamma != 1 f32 map's prefactors (cmin, 1 / (cmax - cmin)), cmin
    and cmax the signed powf of the range."""
    inv_g = float(np.float32(1.0) / np.float32(p.gamma))
    cmin = np.float32(np.asarray(hdr_mod._signed_powf(
        np.float32(p.range_min), inv_g)).item())
    cmax = np.float32(np.asarray(hdr_mod._signed_powf(
        np.float32(p.range_max), inv_g)).item())
    return cmin, np.float32(1.0) / np.float32(cmax - cmin)


def _hdr_map_gamma1_bits(fbits: torch.Tensor, rmin: float,
                         rmax: float) -> torch.Tensor:
    """Gamma 1 range map under FE_DOWNWARD on int64 f32 bits
    (hdr.c:121-141, 171-186) -> clamped [0, 1] f32 bits.  The two scalar
    prefactors come from the host oracle."""
    if rmin == 0.0 and rmax == 1.0:
        return clamp01_f32_bits(fbits)
    lo, factor = gamma1_constants(rmin, rmax)
    f = _f32(fbits)
    u = down_mul(down_sub(f, _scalar(lo, f)), _scalar(factor, f))
    return _nan_passthrough(fbits, clamp01_f32_bits(_bits(u)))


def _hdr_map_gamma_f32_bits(fbits: torch.Tensor, p) -> torch.Tensor:
    """Gamma != 1 f32 map (hdr.c:188-206): clamp01((f - cmin) * factor)
    at FE_TONEAREST."""
    cmin, factor = gamma_f32_constants(p)
    f = _f32(fbits)
    u = (f - _scalar(cmin, f)) * _scalar(factor, f)
    return _nan_passthrough(fbits, clamp01_f32_bits(_bits(u)))


@functools.lru_cache(maxsize=8)
def _gamma_u16_lut_host(gamma: float, rmin: float, rmax: float) -> np.ndarray:
    """f16 bits -> u16 for gamma != 1 over all 65,536 inputs, by the host
    oracle (the reference's gamma-corrected table feeding the range map
    and the quantizer, hdr.c:46-60, 143-166, is a pure function of the
    16-bit input)."""
    bits = np.arange(65536, dtype=np.uint16)
    return np.asarray(hdr_mod.hdr_half_to_u16(
        bits, hdr_mod.HDRParams(gamma, rmin, rmax))).view(np.int16)


@functools.lru_cache(maxsize=8)
def _gamma_u16_lut(gamma: float, rmin: float, rmax: float,
                   device: torch.device) -> torch.Tensor:
    """The table above on `device`, built and uploaded once per HDR
    parameters and device.  The upload copies from pageable memory, which
    a capture cannot hold: a captured conversion fetches the table first
    (tables) and keeps it, so that the cache's eviction frees no table a
    graph reads."""
    return torch.from_numpy(_gamma_u16_lut_host(gamma, rmin, rmax).copy()) \
        .to(device)


def _hdr_f16_to_u16(a: torch.Tensor) -> torch.Tensor:
    p = hdr_mod.get_hdr_parameters()
    if p.gamma != 1.0:
        lut = _gamma_u16_lut(p.gamma, p.range_min, p.range_max, a.device)
        return lut[_u16(a).long()]
    c = _hdr_map_gamma1_bits(_u32(f16_bits_to_f32_bits(a)), p.range_min,
                             p.range_max)
    return _i16(quantize_u16_downward(c))


def _hdr_f32_to_f32(a: torch.Tensor) -> torch.Tensor:
    p = hdr_mod.get_hdr_parameters()
    if p.gamma != 1.0:
        return _i32(_hdr_map_gamma_f32_bits(_u32(a), p))
    return _i32(_hdr_map_gamma1_bits(_u32(a), p.range_min, p.range_max))


# --- the edges ---------------------------------------------------------------


def _noop(a):
    return a


def _swap_rb(a):
    # Slices, not a list index, which would copy its index from the host.
    return torch.cat([a[:, 2:3], a[:, 1:2], a[:, 0:1], a[:, 3:4]], 1)


def _lane(a, value):
    """An (n, 1) lane of a's dtype and device filled with `value`."""
    return torch.full((a.shape[0], 1), value, dtype=a.dtype, device=a.device)


def _rgb8_to_bgrx8(a):
    return torch.cat([a[:, 2:3], a[:, 1:2], a[:, 0:1], _lane(a, 0xFF)], 1)


def _offset(a):
    # + 128 (u8) / + 32768 (u16) wrapping, convert.c:783-790.
    return a ^ (0x80 if a.dtype == torch.uint8 else -0x8000)


def _take(dst_c):
    return lambda a: a[:, :dst_c]


def _expand_u8(src_c):
    def f(a):
        pad = torch.zeros((a.shape[0], 3 - src_c), dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, pad, _lane(a, 0xFF)], 1)
    return f


def _u16_to_u8(alpha_ff=False):
    def f(a):
        out = (((_u16(a) + 127) * 255) // 65535).to(torch.uint8)
        if alpha_ff:
            out[:, 3] = 0xFF
        return out
    return f


def _u8_to_u16(alpha_ffff=False):
    def f(a):
        out = _i16((a.to(torch.int32) * 65535) // 255)
        if alpha_ffff:
            out[:, 3] = -1
        return out
    return f


def _f32_to_f16(a):
    return _i16(f32_bits_to_f16_bits(_u32(a)))


def _f16_to_f32(a):
    return f16_bits_to_f32_bits(a)


def _f32_to_u16(a):
    return _i16(quantize_u16_downward(clamp01_f32_bits(_u32(a))))


def _u16_to_f16(rgbx_signed_quirk=False):
    def f(a):
        if rgbx_signed_quirk:
            # convert.c:564-566 reads the components as signed int16; the X
            # lane becomes f16(1.0).
            v = a.to(torch.float32) * _scalar(1 / 65535, a)
            v[:, 3] = 1.0
        else:
            v = _u16(a).to(torch.float32) * _scalar(1 / 65535, a)
        return _i16(f32_bits_to_f16_bits(_bits(v)))
    return f


def _f16_to_u16(a):
    return _i16(quantize_u16_downward(
        clamp01_f32_bits(_u32(f16_bits_to_f32_bits(a)))))


def _rgb16_to_rgbx16(a):
    return torch.cat([a, _lane(a, 0x3C00)], 1)            # f16(1.0)


def _rgb32_to_rgbx32(a):
    return torch.cat([a, _lane(a, 0x3F800000)], 1)        # f32(1.0)


# (src, dst) -> device function, one per host edge of convert.TABLE.
_DEV = {
    (F.RGBX8, F.RGBA8): _noop,
    (F.RGBA8, F.RGBX8): _noop,
    (F.BGRX8, F.BGRA8): _noop,
    (F.BGRA8, F.BGRX8): _noop,
    (F.RGBX8, F.BGRX8): _swap_rb,
    (F.BGRX8, F.RGBX8): _swap_rb,
    (F.RGBA8, F.BGRA8): _swap_rb,
    (F.BGRA8, F.RGBA8): _swap_rb,
    (F.FLOAT_RGBX16, F.FLOAT_BGRX16): _swap_rb,
    (F.FLOAT_BGRX16, F.FLOAT_RGBX16): _swap_rb,
    (F.RGB8, F.BGRX8): _rgb8_to_bgrx8,
    (F.R8, F.SIGNED_R8): _offset,
    (F.RG8, F.SIGNED_RG8): _offset,
    (F.SIGNED_R8, F.R8): _offset,
    (F.SIGNED_RG8, F.RG8): _offset,
    (F.R16, F.SIGNED_R16): _offset,
    (F.RG16, F.SIGNED_RG16): _offset,
    (F.SIGNED_R16, F.R16): _offset,
    (F.SIGNED_RG16, F.RG16): _offset,
    (F.RGBA8, F.R8): _take(1),
    (F.RGBA8, F.RG8): _take(2),
    (F.RGB8, F.R8): _take(1),
    (F.RGB8, F.RG8): _take(2),
    (F.R8, F.RGBX8): _expand_u8(1),
    (F.RG8, F.RGBX8): _expand_u8(2),
    (F.R16, F.R8): _u16_to_u8(),
    (F.RG16, F.RG8): _u16_to_u8(),
    (F.RGB16, F.RGB8): _u16_to_u8(),
    (F.RGBX16, F.RGBX8): _u16_to_u8(alpha_ff=True),
    (F.RGBA16, F.RGBA8): _u16_to_u8(),
    (F.R8, F.R16): _u8_to_u16(),
    (F.RG8, F.RG16): _u8_to_u16(),
    (F.RGB8, F.RGB16): _u8_to_u16(),
    (F.RGBX8, F.RGBX16): _u8_to_u16(alpha_ffff=True),
    (F.RGBA8, F.RGBA16): _u8_to_u16(),
    (F.R16, F.FLOAT_R16): _u16_to_f16(),
    (F.RG16, F.FLOAT_RG16): _u16_to_f16(),
    (F.RGB16, F.FLOAT_RGB16): _u16_to_f16(),
    (F.RGBX16, F.FLOAT_RGBX16): _u16_to_f16(rgbx_signed_quirk=True),
    (F.FLOAT_R16, F.R16): _f16_to_u16,
    (F.FLOAT_RG16, F.RG16): _f16_to_u16,
    (F.FLOAT_RGB16, F.RGB16): _f16_to_u16,
    (F.FLOAT_RGBX16, F.RGBX16): _f16_to_u16,
    (F.FLOAT_RGBA16, F.RGBA16): _f16_to_u16,
    (F.FLOAT_R16_HDR, F.R16): _hdr_f16_to_u16,
    (F.FLOAT_RG16_HDR, F.RG16): _hdr_f16_to_u16,
    (F.FLOAT_RGBX16_HDR, F.RGBX16): _hdr_f16_to_u16,
    (F.FLOAT_R32, F.FLOAT_R16): _f32_to_f16,
    (F.FLOAT_RG32, F.FLOAT_RG16): _f32_to_f16,
    (F.FLOAT_RGB32, F.FLOAT_RGB16): _f32_to_f16,
    (F.FLOAT_RGBX32, F.FLOAT_RGBX16): _f32_to_f16,
    (F.FLOAT_R32, F.R16): _f32_to_u16,
    (F.FLOAT_RG32, F.RG16): _f32_to_u16,
    (F.FLOAT_RGB32, F.RGB16): _f32_to_u16,
    (F.FLOAT_RGBX32, F.RGBX16): _f32_to_u16,
    (F.FLOAT_R16, F.FLOAT_R32): _f16_to_f32,
    (F.FLOAT_RG16, F.FLOAT_RG32): _f16_to_f32,
    (F.FLOAT_RGB16, F.FLOAT_RGB32): _f16_to_f32,
    (F.FLOAT_RGBX16, F.FLOAT_RGBX32): _f16_to_f32,
    (F.FLOAT_R32_HDR, F.FLOAT_R32): _hdr_f32_to_f32,
    (F.FLOAT_RG32_HDR, F.FLOAT_RG32): _hdr_f32_to_f32,
    (F.FLOAT_RGB32_HDR, F.FLOAT_RGB32): _hdr_f32_to_f32,
    (F.FLOAT_RGBX32_HDR, F.FLOAT_RGBX32): _hdr_f32_to_f32,
    (F.RGB8, F.RGBX8): _expand_u8(3),
    (F.RGBX8, F.RGB8): _take(3),
    (F.FLOAT_RGB16, F.FLOAT_RGBX16): _rgb16_to_rgbx16,
    (F.FLOAT_RGBX16, F.FLOAT_RGB16): _take(3),
    (F.FLOAT_RGB16_HDR, F.FLOAT_RGBX16_HDR): _rgb16_to_rgbx16,
    (F.FLOAT_RGBX16_HDR, F.FLOAT_RGB16_HDR): _take(3),
    (F.FLOAT_RGB32, F.FLOAT_RGBX32): _rgb32_to_rgbx32,
    (F.FLOAT_RGBX32, F.FLOAT_RGB32): _take(3),
    (F.FLOAT_RGB32_HDR, F.FLOAT_RGBX32_HDR): _rgb32_to_rgbx32,
    (F.FLOAT_RGBX32_HDR, F.FLOAT_RGB32_HDR): _take(3),
}

# Index-aligned with convert.TABLE: the host's path search picks the
# steps, the device runs them.
DEVICE_TABLE = [_DEV[(s, d)] for (s, d, _) in TABLE]


def convert_pixels_device(arr: torch.Tensor, src_fmt: int,
                          dst_fmt: int) -> torch.Tensor:
    """Convert an (n, lanes) tensor between formats on its device, along
    the host converter's path; raises ConversionError where there is
    none."""
    path = match_conversion(src_fmt, dst_fmt)
    if path is None:
        raise ConversionError(
            f"Unable to find conversion path "
            f"{F.format_name(src_fmt)} -> {F.format_name(dst_fmt)}")
    for step in path:
        arr = DEVICE_TABLE[step](arr)
    return arr.contiguous()


def hdr_params_key() -> tuple:
    """The HDR parameters a conversion reads when it runs.  A captured
    conversion bakes them in, so its cache key holds them, as JAX's
    _jitted_convert keys on them (detex_tpu/convert_device.py:602-611)."""
    p = hdr_mod.get_hdr_parameters()
    return (p.gamma, p.range_min, p.range_max)


def tables(src_fmt: int, dst_fmt: int, device: torch.device) -> tuple:
    """The device tables the conversion src_fmt -> dst_fmt reads under the
    current HDR parameters, uploaded here where they are not yet: the
    gamma != 1 half table of the HDR f16 -> u16 edges, or nothing.  A
    captured conversion calls this before its capture and keeps what it
    returns."""
    steps = [DEVICE_TABLE[i] for i in match_conversion(src_fmt, dst_fmt)
             or ()]
    p = hdr_mod.get_hdr_parameters()
    if _hdr_f16_to_u16 in steps and p.gamma != 1.0:
        return (_gamma_u16_lut(p.gamma, p.range_min, p.range_max, device),)
    return ()


def _owned(out: torch.Tensor, arr: torch.Tensor) -> torch.Tensor:
    """out, copied where it is arr itself (a path of no steps or of no-op
    edges): a captured conversion's output is then its own, not the
    input buffer."""
    return out.clone() if out.data_ptr() == arr.data_ptr() else out


def convert_pixels_torch(src: np.ndarray, n_pixels: int, src_fmt: int,
                         dst_fmt: int, device="cuda") -> np.ndarray:
    """convert.convert_pixels with the conversion run on `device` (the
    card unless device="cpu"): flat u8 host buffer in, flat u8 host buffer
    out.  On a card the conversion goes through convert_pixels_graphed,
    the counterpart of JAX's _jitted_convert; on the CPU it runs eagerly.
    A pair with no path raises ConversionError before anything runs."""
    arr = from_bytes(src, n_pixels, src_fmt, device)
    if match_conversion(src_fmt, dst_fmt) is None:
        raise ConversionError(
            f"Unable to find conversion path "
            f"{F.format_name(src_fmt)} -> {F.format_name(dst_fmt)}")
    if arr.device.type != "cuda":
        return to_bytes(convert_pixels_device(arr, src_fmt, dst_fmt))
    return convert_pixels_graphed(arr, src_fmt, dst_fmt, to_bytes)


def convert_pixels_graphed(arr: torch.Tensor, src_fmt: int, dst_fmt: int,
                           read=None):
    """convert_pixels_device on a CUDA tensor through the program of its
    key (formats, pixel count, HDR parameters, device; graphs.Program):
    the key's first call runs eagerly, its second captures a CUDA graph,
    and from there each call copies `arr` into the graph's buffer and
    replays.  The result is then the graph's output, which the key's next
    call overwrites, unless `read` (applied under graphs.run's lock)
    copies it out."""
    return graphs.run(
        ("convert", src_fmt, dst_fmt, arr.shape[0], hdr_params_key(),
         arr.device),
        lambda: graphs.Program(
            lambda a: _owned(convert_pixels_device(a, src_fmt, dst_fmt), a),
            keep=tables(src_fmt, dst_fmt, arr.device)), arr, read)
