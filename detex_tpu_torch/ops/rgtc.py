"""RGTC (BC4/BC5, unsigned and signed) block decode: the CUDA kernels'
wrappers and their plain PyTorch versions.

`decode_rgtc1`, `decode_signed_rgtc1` (csrc/bc.cu rgtc1_kernel, which
replaces detex_tpu/ops/pallas/bc_pallas.py:_rgtc1_kernel) and
`decode_rgtc2`, `decode_signed_rgtc2` (rgtc2_kernel, replacing
_rgtc2_kernel) launch the kernel for a CUDA tensor and run the plain
version (`decode_*_plain`) for a CPU tensor; see ops/_cuda.py.

The plain versions follow the jnp decoders of detex_tpu/ops/rgtc.py:
  * unsigned: 8-entry palette, 7 steps (truncating /7) when lum0 > lum1,
    else 5 steps (truncating /5) plus 0 and 255
    (decompress-rgtc.c:35-56);
  * signed: int8 endpoints, -128 clamped to -127, the (lum0, lum1) =
    (-127, -128) pair marks the block invalid (decompress-rgtc.c:90-96),
    division truncates toward zero (detex.h:966-982), and the result maps
    [-127, 127] -> [-32768, 32767] as (r + 127) * 65535 // 254 - 32768
    (decompress-rgtc.c:124-126).

Input: (N, 2) (RGTC1) or (N, 4) (RGTC2) little-endian int32 words.
Output: the packed payload, byte for byte the reference's pixel buffer
(bc_pallas.py:382-394), and (N,) bool valid:
  rgtc1         (N, 4)  R8, 4 pixels per word
  signed_rgtc1  (N, 8)  SIGNED_R16, 2 pixels per word
  rgtc2         (N, 8)  RG8, 2 pixels per word
  signed_rgtc2  (N, 16) SIGNED_RG16, 1 pixel per word
mode_mask and flags are accepted and ignored, as in the JAX package.
"""

from __future__ import annotations

import torch

from detex_tpu_torch.ops import _cuda
from detex_tpu_torch.ops.bitops import (div_trunc, field, pack_u8x4,
                                        pack_u16x2, u32)

_FULL = 0xFFFFFFFF

# Launches of the CUDA kernel per variant in this process (plain-version
# calls are not counted).
KERNEL_LAUNCHES = {"rgtc1": 0, "signed_rgtc1": 0, "rgtc2": 0,
                   "signed_rgtc2": 0}


def codes3(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """(N,) int32 word pairs -> (N, 16) 3-bit codes of the 48-bit stream
    at bit 16 of the 64-bit block (decompress-rgtc.c:29-58), int64."""
    stream = (u32(w0) >> 16) | (u32(w1) << 16)          # < 2**48
    shift = 3 * torch.arange(16, device=w0.device)
    return (stream[:, None] >> shift) & 7


def unsigned_channel(w0: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """One 8-byte unsigned channel (RGTC, or BC3's alpha) -> (N, 16)
    values 0..255, int64."""
    l0 = field(w0, 0, 8).long()[:, None]
    l1 = field(w0, 8, 8).long()[:, None]
    code = codes3(w0, w1)
    # Codes 0 and 1 (and 6, 7 of the 5-step palette) are selected below;
    # the interpolants are computed for every code and discarded there.
    v7 = ((8 - code) * l0 + (code - 1) * l1) // 7
    v5 = ((6 - code) * l0 + (code - 1) * l1) // 5
    v5 = torch.where(code == 6, 0, torch.where(code == 7, 0xFF, v5))
    v = torch.where(l0 > l1, v7, v5)
    return torch.where(code == 0, l0, torch.where(code == 1, l1, v))


def _signed_channel(w0: torch.Tensor, w1: torch.Tensor):
    """One 8-byte signed channel -> ((N, 16) values -32768..32767, int64;
    (N,) bool valid)."""
    l0 = field(w0, 0, 8).long()
    l1 = field(w0, 8, 8).long()
    l0 = l0 - 256 * (l0 >= 128)
    l1 = l1 - 256 * (l1 >= 128)
    valid = ~((l0 == -127) & (l1 == -128))
    l0 = torch.clamp(l0, min=-127)[:, None]
    l1 = torch.clamp(l1, min=-127)[:, None]
    code = codes3(w0, w1)
    v7 = div_trunc((8 - code) * l0 + (code - 1) * l1, 7)
    v5 = div_trunc((6 - code) * l0 + (code - 1) * l1, 5)
    v5 = torch.where(code == 6, -127, torch.where(code == 7, 127, v5))
    v = torch.where(l0 > l1, v7, v5)
    v = torch.where(code == 0, l0, torch.where(code == 1, l1, v))
    return (v + 127) * 65535 // 254 - 32768, valid


def _ones(words: torch.Tensor) -> torch.Tensor:
    return torch.ones(words.shape[0], dtype=torch.bool, device=words.device)


def decode_rgtc1_plain(words: torch.Tensor, mode_mask: int = _FULL,
                       flags: int = 0):
    """Plain PyTorch RGTC1 (BC4) decode (decompress-rgtc.c:64-68)."""
    vals = unsigned_channel(words[:, 0], words[:, 1])
    return pack_u8x4(vals), _ones(words)


def decode_signed_rgtc1_plain(words: torch.Tensor, mode_mask: int = _FULL,
                              flags: int = 0):
    """Plain PyTorch signed RGTC1 decode (decompress-rgtc.c:134-137)."""
    vals, valid = _signed_channel(words[:, 0], words[:, 1])
    return pack_u16x2(vals), valid


def decode_rgtc2_plain(words: torch.Tensor, mode_mask: int = _FULL,
                       flags: int = 0):
    """Plain PyTorch RGTC2 (BC5) decode: R and G interleaved per pixel
    (decompress-rgtc.c:72-77)."""
    r = unsigned_channel(words[:, 0], words[:, 1])
    g = unsigned_channel(words[:, 2], words[:, 3])
    return pack_u8x4(torch.stack([r, g], 2).reshape(-1, 32)), _ones(words)


def decode_signed_rgtc2_plain(words: torch.Tensor, mode_mask: int = _FULL,
                              flags: int = 0):
    """Plain PyTorch signed RGTC2 decode (decompress-rgtc.c:141-147)."""
    r, valid_r = _signed_channel(words[:, 0], words[:, 1])
    g, valid_g = _signed_channel(words[:, 2], words[:, 3])
    return (pack_u16x2(torch.stack([r, g], 2).reshape(-1, 32)),
            valid_r & valid_g)


_RGTC1 = _cuda.Variant("rgtc1", "dtx_rgtc1_decode", 0, 2, 4,
                       decode_rgtc1_plain)
_SIGNED_RGTC1 = _cuda.Variant("signed_rgtc1", "dtx_rgtc1_decode", 1, 2, 8,
                              decode_signed_rgtc1_plain)
_RGTC2 = _cuda.Variant("rgtc2", "dtx_rgtc2_decode", 0, 4, 8,
                       decode_rgtc2_plain)
_SIGNED_RGTC2 = _cuda.Variant("signed_rgtc2", "dtx_rgtc2_decode", 1, 4, 16,
                              decode_signed_rgtc2_plain)


def decode_rgtc1(words: torch.Tensor, mode_mask: int = _FULL,
                 flags: int = 0):
    """RGTC1: (N, 2) int32 words -> ((N, 4) packed R8, (N,) valid)."""
    return _cuda.decode(_RGTC1, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_signed_rgtc1(words: torch.Tensor, mode_mask: int = _FULL,
                        flags: int = 0):
    """Signed RGTC1: (N, 2) int32 words -> ((N, 8) packed SIGNED_R16,
    (N,) valid)."""
    return _cuda.decode(_SIGNED_RGTC1, KERNEL_LAUNCHES, words, mode_mask,
                        flags)


def decode_rgtc2(words: torch.Tensor, mode_mask: int = _FULL,
                 flags: int = 0):
    """RGTC2: (N, 4) int32 words -> ((N, 8) packed RG8, (N,) valid)."""
    return _cuda.decode(_RGTC2, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_signed_rgtc2(words: torch.Tensor, mode_mask: int = _FULL,
                        flags: int = 0):
    """Signed RGTC2: (N, 4) int32 words -> ((N, 16) packed SIGNED_RG16,
    (N,) valid)."""
    return _cuda.decode(_SIGNED_RGTC2, KERNEL_LAUNCHES, words, mode_mask,
                        flags)
