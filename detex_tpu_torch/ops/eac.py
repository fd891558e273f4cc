"""EAC (R11/RG11, unsigned and signed, and ETC2_EAC's alpha) block decode:
the CUDA kernels' wrappers and their plain PyTorch versions.

`decode_eac_r11`, `decode_eac_signed_r11` (csrc/etc_eac.cu eac_r11_kernel,
which replaces detex_tpu/ops/pallas/etc_eac_pallas.py:_eac_r11_kernel) and
`decode_eac_rg11`, `decode_eac_signed_rg11` (eac_rg11_kernel, replacing
_eac_rg11_kernel) launch the kernel for a CUDA tensor and run the plain
version (`decode_*_plain`) for a CPU tensor; see ops/_cuda.py.
`decode_eac_alpha` is the plain version of ETC2_EAC's alpha channel
(ops/etc.py; its kernel is etc2_eac_kernel).

The plain versions follow the jnp decoders of detex_tpu/ops/eac.py:
  * 16x8 modifier table (decompress-eac.c:21-38); output pixel j reads the
    3-bit code of the reference's pixel i = (j & 3) * 4 + (j >> 2) at bit
    45 - 3i of the block's big-endian 64-bit word (decompress-eac.c:44-48);
  * alpha: clamp(base + modifier * multiplier, 0, 255), a multiplier of 0
    giving the base (decompress-eac.c:54-86);
  * unsigned 11-bit: base * 8 + 4 + modifier * m with m = multiplier * 8, or
    1 when that is 0, clamped to [0, 2047] and replicated to 16 bits as
    (v << 5) | (v >> 6) (decompress-eac.c:111-128);
  * signed 11-bit: int8 base * 8, clamped to [-1023, 1023], magnitude
    replicated as (|v| << 5) | (|v| >> 5) under the sign; a base of -128
    marks the block invalid and still decodes (decompress-eac.c:159-202).

Input: (N, 2) (R11) or (N, 4) (RG11, R then G) little-endian int32 words.
Output: the packed payload, byte for byte the reference's pixel buffer
(etc_eac_pallas.py:546-570), and (N,) bool valid:
  r11, signed_r11    (N, 8)  (SIGNED_)R16, 2 pixels per word
  rg11, signed_rg11  (N, 16) (SIGNED_)RG16, R | G << 16
mode_mask and flags are accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from detex_tpu import formats as F
from detex_tpu_torch.ops import _cuda
from detex_tpu_torch.ops.bitops import field, has_flag, pack_u16x2, u32

_FULL = 0xFFFFFFFF

# decompress-eac.c:21-38 (detex_tpu/ops/eac.py:EAC_MODIFIER_TABLE)
EAC_MODIFIER_TABLE = np.array([
    [-3, -6, -9, -15, 2, 5, 8, 14],
    [-3, -7, -10, -13, 2, 6, 9, 12],
    [-2, -5, -8, -13, 1, 4, 7, 12],
    [-2, -4, -6, -13, 1, 3, 5, 12],
    [-3, -6, -8, -12, 2, 5, 7, 11],
    [-3, -7, -9, -11, 2, 6, 8, 10],
    [-4, -7, -8, -11, 3, 6, 7, 10],
    [-3, -5, -8, -11, 2, 4, 7, 10],
    [-2, -6, -8, -10, 1, 5, 7, 9],
    [-2, -5, -8, -10, 1, 4, 7, 9],
    [-2, -4, -8, -10, 1, 3, 7, 9],
    [-2, -5, -7, -10, 1, 4, 6, 9],
    [-3, -4, -7, -10, 2, 3, 6, 9],
    [-1, -2, -3, -10, 0, 1, 2, 9],
    [-4, -6, -8, -9, 3, 5, 7, 8],
    [-3, -5, -7, -9, 2, 4, 6, 8],
], dtype=np.int32)

# Output pixel j <- the reference's loop variable i (the column-major
# transpose is an involution).
_J = np.arange(16)
SRC_I = (_J & 3) * 4 + (_J >> 2)

# Launches of the CUDA kernel per variant in this process (plain-version
# calls are not counted).
KERNEL_LAUNCHES = {"eac_r11": 0, "eac_signed_r11": 0, "eac_rg11": 0,
                   "eac_signed_rg11": 0}


def bswap32(w: torch.Tensor) -> torch.Tensor:
    """(N,) int32 words, byte-swapped, as int64 values 0..2**32-1."""
    x = u32(w)
    return ((x >> 24) | ((x >> 8) & 0xFF00) | ((x & 0xFF00) << 8)
            | ((x & 0xFF) << 24))


def _modifiers(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """(N, 16) modifiers table[byte 1 low nibble][code], int64, in output
    pixel order."""
    # Only bits below 48 of the big-endian qword hold codes.
    q = ((bswap32(w0) & 0xFFFF) << 32) | bswap32(w1)
    shift = torch.from_numpy(45 - 3 * SRC_I).to(w0.device)
    code = (q[:, None] >> shift) & 7
    tab = torch.from_numpy(EAC_MODIFIER_TABLE).to(w0.device).long()
    return tab[field(w0, 8, 4).long()[:, None], code]


def decode_eac_alpha(w0: torch.Tensor, w1: torch.Tensor, flags: int = 0):
    """ETC2_EAC's 8-bit alpha from the (N,) words of its alpha block:
    ((N, 16) values 0..255, int64; (N,) bool valid).  FLAG_ENCODE (0x1)
    rejects a multiplier of 0."""
    base = field(w0, 0, 8).long()[:, None]
    mult = field(w0, 12, 4).long()
    val = torch.clamp(base + _modifiers(w0, w1) * mult[:, None], 0, 255)
    valid = torch.ones(w0.shape[0], dtype=torch.bool, device=w0.device)
    if has_flag(flags, F.FLAG_ENCODE):
        valid = valid & (mult != 0)
    return val, valid


def _mult8(w0: torch.Tensor) -> torch.Tensor:
    m = field(w0, 12, 4).long() << 3
    return torch.where(m == 0, 1, m)[:, None]


def _unsigned11(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """One unsigned 11-bit channel -> (N, 16) values 0..65535, int64."""
    base = ((field(w0, 0, 8).long() << 3) | 4)[:, None]
    v = torch.clamp(base + _modifiers(w0, w1) * _mult8(w0), 0, 2047)
    return (v << 5) | (v >> 6)


def _signed11(w0: torch.Tensor, w1: torch.Tensor):
    """One signed 11-bit channel -> ((N, 16) values -32767..32767, int64;
    (N,) bool valid)."""
    base = field(w0, 0, 8).long()
    base = base - 256 * (base >= 128)
    v = torch.clamp((base * 8)[:, None] + _modifiers(w0, w1) * _mult8(w0),
                    -1023, 1023)
    mag = v.abs()
    return torch.sign(v) * ((mag << 5) | (mag >> 5)), base != -128


def _ones(words: torch.Tensor) -> torch.Tensor:
    return torch.ones(words.shape[0], dtype=torch.bool, device=words.device)


def decode_eac_r11_plain(words: torch.Tensor, mode_mask: int = _FULL,
                         flags: int = 0):
    """Plain PyTorch EAC_R11 decode (decompress-eac.c:132-140)."""
    return pack_u16x2(_unsigned11(words[:, 0], words[:, 1])), _ones(words)


def decode_eac_signed_r11_plain(words: torch.Tensor, mode_mask: int = _FULL,
                                flags: int = 0):
    """Plain PyTorch EAC_SIGNED_R11 decode (decompress-eac.c:206-213)."""
    vals, valid = _signed11(words[:, 0], words[:, 1])
    return pack_u16x2(vals), valid


def decode_eac_rg11_plain(words: torch.Tensor, mode_mask: int = _FULL,
                          flags: int = 0):
    """Plain PyTorch EAC_RG11 decode (decompress-eac.c:144-157)."""
    r = _unsigned11(words[:, 0], words[:, 1])
    g = _unsigned11(words[:, 2], words[:, 3])
    return (pack_u16x2(torch.stack([r, g], 2).reshape(-1, 32)),
            _ones(words))


def decode_eac_signed_rg11_plain(words: torch.Tensor, mode_mask: int = _FULL,
                                 flags: int = 0):
    """Plain PyTorch EAC_SIGNED_RG11 decode (decompress-eac.c:217-231)."""
    r, valid_r = _signed11(words[:, 0], words[:, 1])
    g, valid_g = _signed11(words[:, 2], words[:, 3])
    return (pack_u16x2(torch.stack([r, g], 2).reshape(-1, 32)),
            valid_r & valid_g)


_R11 = _cuda.Variant("eac_r11", "dtx_eac_r11_decode", 0, 2, 8,
                     decode_eac_r11_plain)
_SIGNED_R11 = _cuda.Variant("eac_signed_r11", "dtx_eac_r11_decode", 1, 2, 8,
                            decode_eac_signed_r11_plain)
_RG11 = _cuda.Variant("eac_rg11", "dtx_eac_rg11_decode", 0, 4, 16,
                      decode_eac_rg11_plain)
_SIGNED_RG11 = _cuda.Variant("eac_signed_rg11", "dtx_eac_rg11_decode", 1, 4,
                             16, decode_eac_signed_rg11_plain)


def decode_eac_r11(words: torch.Tensor, mode_mask: int = _FULL,
                   flags: int = 0):
    """EAC_R11: (N, 2) int32 words -> ((N, 8) packed R16, (N,) valid)."""
    return _cuda.decode(_R11, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_eac_signed_r11(words: torch.Tensor, mode_mask: int = _FULL,
                          flags: int = 0):
    """EAC_SIGNED_R11: (N, 2) int32 words -> ((N, 8) packed SIGNED_R16,
    (N,) valid)."""
    return _cuda.decode(_SIGNED_R11, KERNEL_LAUNCHES, words, mode_mask,
                        flags)


def decode_eac_rg11(words: torch.Tensor, mode_mask: int = _FULL,
                    flags: int = 0):
    """EAC_RG11: (N, 4) int32 words -> ((N, 16) packed RG16, (N,)
    valid)."""
    return _cuda.decode(_RG11, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_eac_signed_rg11(words: torch.Tensor, mode_mask: int = _FULL,
                           flags: int = 0):
    """EAC_SIGNED_RG11: (N, 4) int32 words -> ((N, 16) packed
    SIGNED_RG16, (N,) valid)."""
    return _cuda.decode(_SIGNED_RG11, KERNEL_LAUNCHES, words, mode_mask,
                        flags)
