"""Per-block mode introspection/surgery (GetMode/SetMode parity).

The port's own copy of detex_tpu/ops/modes.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

Batched numpy equivalents of the reference's per-format mode accessors,
used by external compressors to pin blocks to specific modes:
  BC1        decompress-bc.c:63-83
  ETC1       decompress-etc.c:183-198
  ETC2       decompress-etc.c:370-470 (incl. overflow-forcing surgery)
  ETC2_PUNCHTHROUGH decompress-etc.c:720-751
  ETC2_EAC   decompress-eac.c:89-96 (delegates to ETC2 on bytes 8-15)
  BPTC       decompress-bptc.c:603-622
  BPTC_FLOAT decompress-bptc-float.c:647-675

All functions take/return (N, block_bytes) uint8 arrays; set_mode
returns a modified copy.
"""

from __future__ import annotations

import numpy as np

from detex_tpu_torch import formats as F


def _u8(blocks):
    return np.ascontiguousarray(blocks, dtype=np.uint8)


# --- BC1 (decompress-bc.c:63-83) -------------------------------------------

def get_mode_bc1(blocks: np.ndarray) -> np.ndarray:
    b = _u8(blocks)
    colors = b[:, :4].copy().view("<u4")[:, 0]
    return np.where((colors & 0xFFFF) > (colors >> 16), 0, 1) \
        .astype(np.uint32)


def set_mode_bc1(blocks: np.ndarray, mode: int) -> np.ndarray:
    b = _u8(blocks).copy()
    colors = b[:, :4].copy().view("<u4")[:, 0]
    current = np.where((colors & 0xFFFF) > (colors >> 16), 0, 1)
    swapped = ((colors & 0xFFFF) << 16) | (colors >> 16)
    new = np.where(current != mode, swapped, colors).astype("<u4")
    b[:, :4] = new.view(np.uint8).reshape(-1, 4)
    return b


# --- ETC family (decompress-etc.c) ------------------------------------------

def _complement3(x):
    return np.where(x & 4, (x & 3) - 4, x).astype(np.int32)


def _etc2_overflow(b0, b1, b2):
    def over(byte):
        v = (byte & 0xF8).astype(np.int32) + (_complement3(byte & 7) << 3)
        return (v & 0xFF07) != 0
    return over(b0), over(b1), over(b2)


def get_mode_etc1(blocks: np.ndarray) -> np.ndarray:
    b = _u8(blocks)
    return ((b[:, 3] & 2) >> 1).astype(np.uint32)


def set_mode_etc1(blocks: np.ndarray, mode: int) -> np.ndarray:
    b = _u8(blocks).copy()
    if mode == 0:
        b[:, 3] &= np.uint8(~0x2 & 0xFF)
    else:
        b[:, 3] |= np.uint8(0x2)
    return b


def get_mode_etc2(blocks: np.ndarray) -> np.ndarray:
    b = _u8(blocks)
    r_over, g_over, b_over = _etc2_overflow(
        b[:, 0].astype(np.int32), b[:, 1].astype(np.int32),
        b[:, 2].astype(np.int32))
    individual = (b[:, 3] & 2) == 0
    mode = np.where(r_over, 2, np.where(g_over, 3,
                                        np.where(b_over, 4, 1)))
    return np.where(individual, 0, mode).astype(np.uint32)


def _set_mode_thp(b: np.ndarray, mode: int) -> None:
    """Force T/H/planar overflow via bit surgery on byte 0/1/2
    (reference SetModeETC2THP, decompress-etc.c:397-458), in place."""
    if mode not in (2, 3, 4):
        return
    byte_idx = mode - 2
    v = b[:, byte_idx].astype(np.int32)
    bits_5_to_7_clear = (v & 0x18) >> 3
    compl_bit2_clear = _complement3(v & 0x3)
    compl_bit2_set = _complement3((v & 0x3) | 0x4)
    use_high = bits_5_to_7_clear + 0x1C + compl_bit2_clear > 31
    use_low = bits_5_to_7_clear + compl_bit2_set < 0
    new_high = (v & ~0x04 & 0xFF) | 0xE0
    new_low = (v & ~0xE0 & 0xFF) | 0x04
    out = np.where(use_high, new_high, np.where(use_low, new_low, v))
    b[:, byte_idx] = out.astype(np.uint8)


def set_mode_etc2(blocks: np.ndarray, mode: int) -> np.ndarray:
    b = _u8(blocks).copy()
    if mode == 0:
        b[:, 3] &= np.uint8(~0x2 & 0xFF)
    else:
        b[:, 3] |= np.uint8(0x2)
        _set_mode_thp(b, mode)
    return b


def get_mode_etc2_punchthrough(blocks: np.ndarray) -> np.ndarray:
    b = _u8(blocks)
    r_over, g_over, b_over = _etc2_overflow(
        b[:, 0].astype(np.int32), b[:, 1].astype(np.int32),
        b[:, 2].astype(np.int32))
    return np.where(r_over, 2, np.where(g_over, 3,
                                        np.where(b_over, 4, 1))) \
        .astype(np.uint32)


def set_mode_etc2_punchthrough(blocks: np.ndarray, mode: int,
                               flags: int = 0) -> np.ndarray:
    """Bug-compatible with the reference (decompress-etc.c:744-751),
    which passes `flags` where SetModeETC2THP expects a mode."""
    b = _u8(blocks).copy()
    if flags & F.FLAG_NON_OPAQUE_ONLY:
        b[:, 3] &= np.uint8(~0x2 & 0xFF)
    if flags & F.FLAG_OPAQUE_ONLY:
        b[:, 3] |= np.uint8(0x2)
    _set_mode_thp(b, flags)
    return b


def get_mode_etc2_eac(blocks: np.ndarray) -> np.ndarray:
    return get_mode_etc2(_u8(blocks)[:, 8:16])


def set_mode_etc2_eac(blocks: np.ndarray, mode: int) -> np.ndarray:
    b = _u8(blocks).copy()
    b[:, 8:16] = set_mode_etc2(b[:, 8:16], mode)
    return b


# --- BPTC / BPTC_FLOAT -------------------------------------------------------

def get_mode_bptc(blocks: np.ndarray) -> np.ndarray:
    """First set bit of byte 0; none -> 0xFFFFFFFF
    (decompress-bptc.c:603-610)."""
    b0 = _u8(blocks)[:, 0].astype(np.int32)
    mode = np.full(b0.shape, 0xFFFFFFFF, np.uint32)
    for i in range(7, -1, -1):
        mode = np.where(b0 & (1 << i), np.uint32(i), mode)
    return mode


def set_mode_bptc(blocks: np.ndarray, mode: int) -> np.ndarray:
    """Clear bits below `mode`, set bit `mode`
    (decompress-bptc.c:612-622)."""
    b = _u8(blocks).copy()
    bit = 1 << mode
    b[:, 0] = (b[:, 0] & np.uint8(~(bit - 1) & 0xFF)) | np.uint8(bit)
    return b


_BPTC_FLOAT_MAP_MODE = np.array([
    0, 1, 2, 10, -1, -1, 3, 11, -1, -1, 4, 12, -1, -1, 5, 13,
    -1, -1, 6, -1, -1, -1, 7, -1, -1, -1, 8, -1, -1, -1, 9, -1,
], dtype=np.int64)

_BPTC_FLOAT_SET_MODE = np.array(
    [0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15], dtype=np.uint8)


def get_mode_bptc_float(blocks: np.ndarray) -> np.ndarray:
    """2-bit-then-5-bit mode code (decompress-bptc-float.c:28-33,
    647-654); unmappable -> 0xFFFFFFFF."""
    b0 = _u8(blocks)[:, 0].astype(np.int64)
    m2 = b0 & 3
    mapped = _BPTC_FLOAT_MAP_MODE[b0 & 0x1F]
    mode = np.where(m2 < 2, m2, mapped)
    return mode.astype(np.int64).astype(np.uint32)


def set_mode_bptc_float(blocks: np.ndarray, mode: int) -> np.ndarray:
    """reference detexSetModeBPTC_FLOAT (decompress-bptc-float.c:664-675)."""
    b = _u8(blocks).copy()
    if mode <= 1:
        b[:, 0] = (b[:, 0] & np.uint8(0xFC)) | np.uint8(mode)
    else:
        b[:, 0] = (b[:, 0] & np.uint8(0xE0)) | _BPTC_FLOAT_SET_MODE[mode]
    return b


# Named alias matching the reference's signed-variant prototype
# (detexGetModeBPTC_SIGNED_FLOAT, reference detex.h:547 — same
# mode-code layout as the unsigned variant; there is no signed
# SetMode in the reference, but the bit surgery is identical so the
# alias is provided for symmetry).
get_mode_bptc_signed_float = get_mode_bptc_float
set_mode_bptc_signed_float = set_mode_bptc_float


GET_MODE = {
    "BC1": get_mode_bc1,
    "ETC1": get_mode_etc1,
    "ETC2": get_mode_etc2,
    "ETC2_PUNCHTHROUGH": get_mode_etc2_punchthrough,
    "ETC2_EAC": get_mode_etc2_eac,
    "BPTC": get_mode_bptc,
    "BPTC_FLOAT": get_mode_bptc_float,
    "BPTC_SIGNED_FLOAT": get_mode_bptc_float,
}

SET_MODE = {
    "BC1": set_mode_bc1,
    "ETC1": set_mode_etc1,
    "ETC2": set_mode_etc2,
    "ETC2_EAC": set_mode_etc2_eac,
    "BPTC": set_mode_bptc,
    "BPTC_FLOAT": set_mode_bptc_float,
    "BPTC_SIGNED_FLOAT": set_mode_bptc_float,
}
