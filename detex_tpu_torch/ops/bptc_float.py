"""BC6H (BPTC_FLOAT and BPTC_SIGNED_FLOAT) block decode: the CUDA kernel's
wrappers and their plain PyTorch versions.

`decode_bptc_float` and `decode_bptc_signed_float` launch the hand-written
kernel (csrc/bc6h.cu bc6h_kernel<Signed>, which replaces
detex_tpu/ops/pallas/bptc_float_pallas.py:_bc6h_kernel) for a CUDA tensor
and run the plain version (`decode_*_plain`) for a CPU tensor; see
ops/_cuda.py.

The plain versions compute what detex_tpu/ops/bptc_float.py computes
(reference decompress-bptc-float.c:110-644), in the order of the Pallas
kernel: each mode's field scatter gives the block's 12 raw endpoints as
(N,) tensors, which are selected by the block's mode; the delta,
unquantize and pixel arithmetic then run once with per-block constants
looked up by mode.  Semantics carried bit for bit:
  * 2-then-5-bit mode code (decompress-bptc-float.c:23-33); a reserved
    code (19, 23, 27, 31) decodes as mode 0 and marks the block invalid;
  * the reversed fields of modes 12 and 13 put the highest memory bit in
    the LSB, and mode 12's b0[11] is omitted (the reference's out-of-range
    shift folds it to 0; see _FIELDS);
  * delta endpoints are sign-extended, added mod 2^EPB and re-sign-extended
    when signed; unquantize saturates (signed: at |x| >= 2^(EPB-1) - 1) and
    is skipped at EPB 16;
  * interpolation ((64 - w) * e0 + w * e1 + 32) >> 6, then *31 >> 6
    (unsigned) or sign-magnitude *31 >> 5 (signed; a negative value that
    scales to 0 stays +0).

Input: (N, 4) little-endian int32 words.  Output: ((N, 32) int32 packed
FLOAT_RGBX16 payload, word 2i = R | G << 16 and word 2i + 1 = B (X = 0) for
pixel i, byte for byte the reference's pixel buffer; (N,) bool valid).
flags is accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from detex_tpu_torch.ops import _cuda
from detex_tpu_torch.ops.bitops import dyn_field, mask_bit, to_i32, u32

_FULL = 0xFFFFFFFF

# Launches of the CUDA kernel per variant in this process (plain-version
# calls are not counted).
KERNEL_LAUNCHES = {"bptc_float": 0, "bptc_signed_float": 0}

# decompress-bptc-float.c:23-26 (detex_tpu/ops/bptc_float.py:_MAP_MODE)
_MAP_MODE = np.array([
    0, 1, 2, 10, -1, -1, 3, 11, -1, -1, 4, 12, -1, -1, 5, 13,
    -1, -1, 6, -1, -1, -1, 7, -1, -1, -1, 8, -1, -1, -1, 9, -1,
], dtype=np.int32)

# Endpoint bits per mode (decompress-bptc-float.c:42-43).
_EPB = [10, 7, 11, 11, 11, 9, 8, 8, 8, 6, 10, 11, 12, 16]

# Delta bits (r, g, b) per mode; None: the endpoints are not deltas.
_DELTA = [
    (5, 5, 5), (6, 6, 6), (5, 4, 4), (4, 5, 4), (4, 4, 5),
    (5, 5, 5), (6, 5, 5), (5, 6, 5), (5, 5, 6), None,
    None, (9, 9, 9), (8, 8, 8), (4, 4, 4),
]

# Field scatter per mode: (dest, lo, hi, shift[, reversed]); lo..hi are
# inclusive bit positions in the 128-bit block, the field lands at bit
# `shift` of endpoint `dest`, and a reversed field maps bit hi to its LSB
# (decompress-bptc-float.c:128-485).  Mode 12 omits b0[11]: the reference
# reads it as detexGetBits64(data0, 63, 63) << 11, whose mask computes
# 1 << 64, and the compiled reference yields 0 there.
_FIELDS = [
    # mode 0
    [("g2", 2, 2, 4), ("b2", 3, 3, 4), ("b3", 4, 4, 4), ("r0", 5, 14, 0),
     ("g0", 15, 24, 0), ("b0", 25, 34, 0), ("r1", 35, 39, 0),
     ("g3", 40, 40, 4), ("g2", 41, 44, 0), ("g1", 45, 49, 0),
     ("b3", 50, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 1
    [("g2", 2, 2, 5), ("g3", 3, 3, 4), ("g3", 4, 4, 5), ("r0", 5, 11, 0),
     ("b3", 12, 12, 0), ("b3", 13, 13, 1), ("b2", 14, 14, 4),
     ("g0", 15, 21, 0), ("b2", 22, 22, 5), ("b3", 23, 23, 2),
     ("g2", 24, 24, 4), ("b0", 25, 31, 0), ("b3", 32, 32, 3),
     ("b3", 33, 33, 5), ("b3", 34, 34, 4), ("r1", 35, 40, 0),
     ("g2", 41, 44, 0), ("g1", 45, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 60, 0), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 70, 0), ("r3", 71, 76, 0)],
    # mode 2
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 39, 0), ("r0", 40, 40, 10), ("g2", 41, 44, 0),
     ("g1", 45, 48, 0), ("g0", 49, 49, 10), ("b3", 50, 50, 0),
     ("g3", 51, 54, 0), ("b1", 55, 58, 0), ("b0", 59, 59, 10),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 3
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 38, 0), ("r0", 39, 39, 10), ("g3", 40, 40, 4),
     ("g2", 41, 44, 0), ("g1", 45, 49, 0), ("g0", 50, 50, 10),
     ("g3", 51, 54, 0), ("b1", 55, 58, 0), ("b0", 59, 59, 10),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 68, 0), ("b3", 69, 69, 0), ("b3", 70, 70, 2),
     ("r3", 71, 74, 0), ("g2", 75, 75, 4), ("b3", 76, 76, 3)],
    # mode 4
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 38, 0), ("r0", 39, 39, 10), ("b2", 40, 40, 4),
     ("g2", 41, 44, 0), ("g1", 45, 48, 0), ("g0", 49, 49, 10),
     ("b3", 50, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b0", 60, 60, 10), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 68, 0), ("b3", 69, 69, 1), ("b3", 70, 70, 2),
     ("r3", 71, 74, 0), ("b3", 75, 75, 4), ("b3", 76, 76, 3)],
    # mode 5
    [("r0", 5, 13, 0), ("b2", 14, 14, 4), ("g0", 15, 23, 0),
     ("g2", 24, 24, 4), ("b0", 25, 33, 0), ("b3", 34, 34, 4),
     ("r1", 35, 39, 0), ("g3", 40, 40, 4), ("g2", 41, 44, 0),
     ("g1", 45, 49, 0), ("b3", 50, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 59, 0), ("b3", 60, 60, 1), ("b2", 61, 63, 0),
     ("b2", 64, 64, 3), ("r2", 65, 69, 0), ("b3", 70, 70, 2),
     ("r3", 71, 75, 0), ("b3", 76, 76, 3)],
    # mode 6
    [("r0", 5, 12, 0), ("g3", 13, 13, 4), ("b2", 14, 14, 4),
     ("g0", 15, 22, 0), ("b3", 23, 23, 2), ("g2", 24, 24, 4),
     ("b0", 25, 32, 0), ("b3", 33, 33, 3), ("b3", 34, 34, 4),
     ("r1", 35, 40, 0), ("g2", 41, 44, 0), ("g1", 45, 49, 0),
     ("b3", 50, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 70, 0), ("r3", 71, 76, 0)],
    # mode 7
    [("r0", 5, 12, 0), ("b3", 13, 13, 0), ("b2", 14, 14, 4),
     ("g0", 15, 22, 0), ("g2", 23, 23, 5), ("g2", 24, 24, 4),
     ("b0", 25, 32, 0), ("g3", 33, 33, 5), ("b3", 34, 34, 4),
     ("r1", 35, 39, 0), ("g3", 40, 40, 4), ("g2", 41, 44, 0),
     ("g1", 45, 50, 0), ("g3", 51, 54, 0), ("b1", 55, 59, 0),
     ("b3", 60, 60, 1), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 8
    [("r0", 5, 12, 0), ("b3", 13, 13, 1), ("b2", 14, 14, 4),
     ("g0", 15, 22, 0), ("b2", 23, 23, 5), ("g2", 24, 24, 4),
     ("b0", 25, 32, 0), ("b3", 33, 33, 5), ("b3", 34, 34, 4),
     ("r1", 35, 39, 0), ("g3", 40, 40, 4), ("g2", 41, 44, 0),
     ("g1", 45, 49, 0), ("b3", 50, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 60, 0), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 69, 0), ("b3", 70, 70, 2), ("r3", 71, 75, 0),
     ("b3", 76, 76, 3)],
    # mode 9
    [("r0", 5, 10, 0), ("g3", 11, 11, 4), ("b3", 12, 13, 0),
     ("b2", 14, 14, 4), ("g0", 15, 20, 0), ("g2", 21, 21, 5),
     ("b2", 22, 22, 5), ("b3", 23, 23, 2), ("g2", 24, 24, 4),
     ("b0", 25, 30, 0), ("g3", 31, 31, 5), ("b3", 32, 32, 3),
     ("b3", 33, 33, 5), ("b3", 34, 34, 4), ("r1", 35, 40, 0),
     ("g2", 41, 44, 0), ("g1", 45, 50, 0), ("g3", 51, 54, 0),
     ("b1", 55, 60, 0), ("b2", 61, 63, 0), ("b2", 64, 64, 3),
     ("r2", 65, 70, 0), ("r3", 71, 76, 0)],
    # mode 10
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 44, 0), ("g1", 45, 54, 0), ("b1", 55, 63, 0),
     ("b1", 64, 64, 9)],
    # mode 11
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 43, 0), ("r0", 44, 44, 10), ("g1", 45, 53, 0),
     ("g0", 54, 54, 10), ("b1", 55, 63, 0), ("b0", 64, 64, 10)],
    # mode 12 (reversed 2-bit fields; no b0[11], see above)
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 42, 0), ("r0", 43, 44, 10, True), ("g1", 45, 52, 0),
     ("g0", 53, 54, 10, True), ("b1", 55, 62, 0),
     ("b0", 64, 64, 10)],
    # mode 13 (reversed 5- and 6-bit fields)
    [("r0", 5, 14, 0), ("g0", 15, 24, 0), ("b0", 25, 34, 0),
     ("r1", 35, 38, 0), ("r0", 39, 44, 10, True), ("g1", 45, 48, 0),
     ("g0", 49, 54, 10, True), ("b1", 55, 58, 0),
     ("b0", 59, 63, 11, True), ("b0", 64, 64, 10)],
]

_KEYS = [f"{c}{i}" for c in "rgb" for i in range(4)]

_TABLES_NPZ = (Path(__file__).resolve().parents[2] / "detex_tpu" / "data"
               / "bptc_tables.npz")


@functools.cache
def _np_tables() -> dict:
    """Per-mode constants (indexed by mode 0..13) and the per-partition
    index layouts of the 32 two-subset partitions."""
    npz = np.load(_TABLES_NPZ)
    p2 = npz["P2"][:32].astype(np.int64)
    anchor2 = npz["anchor2"][:32].astype(np.int64)
    is_anchor = np.zeros((32, 16), bool)
    is_anchor[:, 0] = True
    is_anchor[np.arange(32), anchor2] = True
    before = np.cumsum(is_anchor, axis=1) - is_anchor
    # Index streams (decompress-bptc-float.c:543-564): two subsets, 3-bit
    # indices from bit 82; one subset, 4-bit indices from bit 65; an anchor
    # pixel stores one bit less.
    off1 = np.array([65 + 4 * i - (i > 0) for i in range(16)], np.int64)
    mask1 = np.array([7] + [15] * 15, np.int64)
    i16 = np.arange(16)
    weights = np.stack([(64 * i16 + 3) // 7, (64 * i16 + 7) // 15])
    epb = np.array(_EPB, np.int64)
    delta = np.array([d or (0, 0, 0) for d in _DELTA], np.int64)
    return {
        "map_mode": _MAP_MODE.astype(np.int64),
        "epb": epb,
        "has_delta": np.array([d is not None for d in _DELTA]),
        # (14, 3) delta-bit masks and halves; 1 where there is no delta,
        # so no shift is negative (those values are not selected).
        "dmask": (1 << delta) - 1,
        "dhalf": np.where(delta > 0, 1 << np.maximum(delta - 1, 0), 1),
        "subset": p2,
        "off": np.stack([3 * i16 + 82 - before,
                         np.broadcast_to(off1, (32, 16))]),
        "mask": np.stack([np.where(is_anchor, 3, 7),
                          np.broadcast_to(mask1, (32, 16))]),
        # Weights of 3-bit (row 0, first 8 entries) and 4-bit (row 1)
        # indices: floor((64 * idx + c) / d) (bptc-tables.c:190-201).
        "weights": weights.astype(np.int64),
    }


@functools.cache
def _tables(device: torch.device) -> dict:
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in _np_tables().items()}


def _raw_endpoints(words: torch.Tensor, mode: torch.Tensor) -> dict:
    """Each block's 12 raw endpoint fields under its own mode: {key: (N,)
    int64}.  Every mode's scatter runs over all blocks and a block keeps
    its mode's; keys a mode does not fill stay 0."""
    w = [u32(words[:, i]) for i in range(4)]
    cache = {}

    def bits(lo: int, width: int) -> torch.Tensor:
        if (lo, width) not in cache:
            wi, bit = divmod(lo, 32)
            v = w[wi] >> bit
            if bit + width > 32:
                v = v | (w[wi + 1] << (32 - bit))
            cache[lo, width] = v & ((1 << width) - 1)
        return cache[lo, width]

    raw = {k: torch.zeros_like(w[0]) for k in _KEYS}
    for m, fields in enumerate(_FIELDS):
        ep = {}
        for dest, lo, hi, shift, *rev in fields:
            if rev and rev[0]:
                val = sum(bits(hi - i, 1) << i for i in range(hi - lo + 1))
            else:
                val = bits(lo, hi - lo + 1)
            val = val << shift
            ep[dest] = ep[dest] | val if dest in ep else val
        sel = mode == m
        for k, v in ep.items():
            raw[k] = torch.where(sel, v, raw[k])
    return raw


def _decode_plain(words: torch.Tensor, mode_mask: int, signed: bool):
    t = _tables(words.device)
    n = words.shape[0]
    w0 = u32(words[:, 0])
    m2 = w0 & 3
    mode_raw = torch.where(m2 < 2, m2, t["map_mode"][w0 & 31])
    mode = torch.clamp(mode_raw, min=0)
    raw = _raw_endpoints(words, mode)

    epb = t["epb"][mode]
    emask = (1 << epb) - 1
    ehalf = 1 << (epb - 1)
    has_delta = t["has_delta"][mode]
    no_unq = epb >= 16                       # mode 13: no unquantize

    def sext(v, mask, half):
        return ((v & mask) ^ half) - half

    def unquantize(x):
        mag = x.abs() if signed else x
        unq = ((mag << 15) + 0x4000) >> (epb - 1)
        if signed:
            unq = torch.where(mag == 0, 0,
                              torch.where(mag >= ehalf - 1, 0x7FFF, unq))
            return torch.where(no_unq, x, torch.sign(x) * unq)
        unq = torch.where(x == 0, 0, torch.where(x == emask, 0xFFFF, unq))
        return torch.where(no_unq, x, unq)

    final = {}
    for ci, c in enumerate("rgb"):
        dmask = t["dmask"][mode, ci]
        dhalf = t["dhalf"][mode, ci]
        e0 = raw[f"{c}0"]
        if signed:
            e0 = sext(e0, emask, ehalf)
        ends = [e0]
        for i in range(1, 4):
            e = raw[f"{c}{i}"]
            dv = (e0 + sext(e, dmask, dhalf)) & emask
            if signed:
                dv = sext(dv, emask, ehalf)
                e = sext(e, emask, ehalf)
            ends.append(torch.where(has_delta, dv, e))
        for i, e in enumerate(ends):
            final[f"{c}{i}"] = unquantize(e)[:, None]

    # Pixels: subset, index and weight of each of the 16 pixels.
    one = (mode >= 10)[:, None]
    psid = (u32(words[:, 2]) >> 13) & 31            # bits 77-81
    layout = one.squeeze(1).long()
    off = t["off"][layout, psid]
    idx = dyn_field(words, off, 4).long() & t["mask"][layout, psid]
    wgt = t["weights"][layout[:, None], idx]
    sub_hi = ~one & (t["subset"][psid] == 1)

    vals = []
    for c in "rgb":
        e0 = torch.where(sub_hi, final[f"{c}2"], final[f"{c}0"])
        e1 = torch.where(sub_hi, final[f"{c}3"], final[f"{c}1"])
        v = ((64 - wgt) * e0 + wgt * e1 + 32) >> 6
        if signed:
            scaled = torch.where(v < 0, -((-v * 31) >> 5), (v * 31) >> 5)
            v = torch.where(scaled < 0, (-scaled) | 0x8000, scaled)
        else:
            v = (v * 31) >> 6
        vals.append(v)
    pix = torch.stack([vals[0] | (vals[1] << 16), vals[2]], 2)
    valid = (mode_raw >= 0) & mask_bit(mode_mask, mode_raw)
    return to_i32(pix.reshape(n, 32)), valid


def decode_bptc_float_plain(words: torch.Tensor, mode_mask: int = _FULL,
                            flags: int = 0):
    """Plain PyTorch BPTC_FLOAT decode (decompress-bptc-float.c:631-635)."""
    return _decode_plain(words, mode_mask, False)


def decode_bptc_signed_float_plain(words: torch.Tensor,
                                   mode_mask: int = _FULL, flags: int = 0):
    """Plain PyTorch BPTC_SIGNED_FLOAT decode
    (decompress-bptc-float.c:640-644)."""
    return _decode_plain(words, mode_mask, True)


_FLOAT = _cuda.Variant("bptc_float", "dtx_bc6h_decode", 0, 4, 32,
                       decode_bptc_float_plain)
_SIGNED_FLOAT = _cuda.Variant("bptc_signed_float", "dtx_bc6h_decode", 1, 4,
                              32, decode_bptc_signed_float_plain)


def decode_bptc_float(words: torch.Tensor, mode_mask: int = _FULL,
                      flags: int = 0):
    """BPTC_FLOAT: (N, 4) int32 words -> ((N, 32) packed FLOAT_RGBX16,
    (N,) valid)."""
    return _cuda.decode(_FLOAT, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_bptc_signed_float(words: torch.Tensor, mode_mask: int = _FULL,
                             flags: int = 0):
    """BPTC_SIGNED_FLOAT: (N, 4) int32 words -> ((N, 32) packed
    FLOAT_RGBX16, (N,) valid)."""
    return _cuda.decode(_SIGNED_FLOAT, KERNEL_LAUNCHES, words, mode_mask,
                        flags)
