"""BC1/BC1A/BC2/BC3 (S3TC) block decode: the CUDA kernels' wrappers and
their plain PyTorch versions.

`decode_bc1`, `decode_bc1a` (csrc/bc.cu bc1_kernel, which replaces
detex_tpu/ops/pallas/bc_pallas.py:_bc1_kernel) and `decode_bc2`,
`decode_bc3` (bc23_kernel, replacing _bc23_kernel) launch the kernel for a
CUDA tensor and run the plain version (`decode_*_plain`) for a CPU tensor;
see ops/_cuda.py.

The plain versions follow the jnp decoders of detex_tpu/ops/bc.py:
  * 565 endpoints expand by shifts only (decompress-bc.c:34-39);
  * 4-colour entries are truncating (2a + b) / 3 and (a + 2b) / 3; BC1's
    3-colour mode (c0 <= c1) has (a + b) / 2 and black
    (decompress-bc.c:41-53), transparent black in BC1A;
  * BC2 alpha is 4 bits * 17 (= * 255 / 15); BC3 alpha is the 8-entry
    palette of the RGTC channel (ops/rgtc.py).
Validity: BC1A with flag 0x4 rejects opaque blocks and with 0x2
non-opaque ones; BC2/BC3 with 0x1 reject c0 <= c1; BC3 with 0x2 rejects
a0 > a1.  mode_mask is ignored, as in the JAX package.

Input: (N, 2) (BC1, BC1A) or (N, 4) (BC2, BC3) little-endian int32 words.
Output: ((N, 16) int32 packed RGBA8, (N,) bool valid).
"""

from __future__ import annotations

import torch

from detex_tpu_torch import formats as F
from detex_tpu_torch.ops import _cuda
from detex_tpu_torch.ops.bitops import field, has_flag, pack_rgba8, u32
from detex_tpu_torch.ops.rgtc import unsigned_channel

_FULL = 0xFFFFFFFF

# Launches of the CUDA kernel per variant in this process (plain-version
# calls are not counted).
KERNEL_LAUNCHES = {"bc1": 0, "bc1a": 0, "bc2": 0, "bc3": 0}


def _expand_565(colors: torch.Tensor):
    """Two RGB565 endpoints of one int32 word -> r0, g0, b0, r1, g1, b1."""
    return (field(colors, 11, 5) << 3, field(colors, 5, 6) << 2,
            field(colors, 0, 5) << 3, field(colors, 27, 5) << 3,
            field(colors, 21, 6) << 2, field(colors, 16, 5) << 3)


def _opaque(colors: torch.Tensor) -> torch.Tensor:
    """c0 > c1: the 4-colour palette."""
    return field(colors, 0, 16) > field(colors, 16, 16)


def _palette(colors: torch.Tensor, four: torch.Tensor):
    """Per channel, the 4 palette entries (each (N,)); entries 2 and 3
    use the 4-colour rule where `four` holds, else the 3-colour one."""
    r0, g0, b0, r1, g1, b1 = _expand_565(colors)

    def mix(a, b):
        c2 = torch.where(four, (2 * a + b) // 3, (a + b) // 2)
        c3 = torch.where(four, (a + 2 * b) // 3, 0)
        return (a, b, c2, c3)

    return mix(r0, r1), mix(g0, g1), mix(b0, b1)


def _select(idx: torch.Tensor, entries) -> torch.Tensor:
    """(N, 16) 2-bit indices into a 4-entry palette of (N,) tensors."""
    return torch.gather(torch.stack(entries, 1), 1, idx)


def _indices(word: torch.Tensor) -> torch.Tensor:
    """(N,) int32 word -> (N, 16) 2-bit colour indices, pixel i at bits
    2i..2i+1 (int64)."""
    shift = 2 * torch.arange(16, device=word.device)
    return (u32(word)[:, None] >> shift) & 3


def _rgb(colors: torch.Tensor, idx_word: torch.Tensor, four: torch.Tensor):
    idx = _indices(idx_word)
    r, g, b = _palette(colors, four)
    return idx, _select(idx, r), _select(idx, g), _select(idx, b)


def decode_bc1_plain(words: torch.Tensor, mode_mask: int = _FULL,
                     flags: int = 0):
    """Plain PyTorch BC1 decode, alpha 0xFF
    (detexDecompressBlockBC1, decompress-bc.c:23-61)."""
    colors = words[:, 0]
    idx, r, g, b = _rgb(colors, words[:, 1], _opaque(colors))
    pix = pack_rgba8(r, g, b, torch.full_like(idx, 0xFF))
    return pix, torch.ones(words.shape[0], dtype=torch.bool,
                           device=words.device)


def decode_bc1a_plain(words: torch.Tensor, mode_mask: int = _FULL,
                      flags: int = 0):
    """Plain PyTorch BC1A decode: index 3 is transparent black in 3-colour
    blocks (detexDecompressBlockBC1A, decompress-bc.c:87-132)."""
    colors = words[:, 0]
    opaque = _opaque(colors)
    idx, r, g, b = _rgb(colors, words[:, 1], opaque)
    a = torch.where((idx == 3) & ~opaque[:, None], 0, 0xFF)
    valid = torch.ones_like(opaque)
    if has_flag(flags, F.FLAG_NON_OPAQUE_ONLY):
        valid = valid & ~opaque
    if has_flag(flags, F.FLAG_OPAQUE_ONLY):
        valid = valid & opaque
    return pack_rgba8(r, g, b, a), valid


def _bc23(words: torch.Tensor, alpha: torch.Tensor, flags: int):
    """BC2/BC3 colour half (always 4 colours) under the given alpha."""
    colors = words[:, 2]
    four = torch.ones(words.shape[0], dtype=torch.bool, device=words.device)
    _, r, g, b = _rgb(colors, words[:, 3], four)
    valid = four
    if has_flag(flags, F.FLAG_ENCODE):
        valid = valid & _opaque(colors)
    return pack_rgba8(r, g, b, alpha), valid


def decode_bc2_plain(words: torch.Tensor, mode_mask: int = _FULL,
                     flags: int = 0):
    """Plain PyTorch BC2 decode: explicit 4-bit alpha, pixels 0-7 in word
    0 (detexDecompressBlockBC2, decompress-bc.c:136-171)."""
    i = torch.arange(16, device=words.device)
    word = torch.where(i < 8, u32(words[:, 0:1]), u32(words[:, 1:2]))
    a4 = (word >> (4 * i % 32)) & 0xF
    return _bc23(words, a4 * 17, flags)


def decode_bc3_plain(words: torch.Tensor, mode_mask: int = _FULL,
                     flags: int = 0):
    """Plain PyTorch BC3 decode: interpolated alpha
    (detexDecompressBlockBC3, decompress-bc.c:175-240)."""
    alpha = unsigned_channel(words[:, 0], words[:, 1])
    pix, valid = _bc23(words, alpha, flags)
    if has_flag(flags, F.FLAG_OPAQUE_ONLY):
        valid = valid & ~(field(words[:, 0], 0, 8)
                          > field(words[:, 0], 8, 8))
    return pix, valid


_BC1 = _cuda.Variant("bc1", "dtx_bc1_decode", 0, 2, 16, decode_bc1_plain)
_BC1A = _cuda.Variant("bc1a", "dtx_bc1_decode", 1, 2, 16, decode_bc1a_plain)
_BC2 = _cuda.Variant("bc2", "dtx_bc23_decode", 0, 4, 16, decode_bc2_plain)
_BC3 = _cuda.Variant("bc3", "dtx_bc23_decode", 1, 4, 16, decode_bc3_plain)


def decode_bc1(words: torch.Tensor, mode_mask: int = _FULL, flags: int = 0):
    """BC1: (N, 2) int32 words -> ((N, 16) packed RGBA8, (N,) valid)."""
    return _cuda.decode(_BC1, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_bc1a(words: torch.Tensor, mode_mask: int = _FULL,
                flags: int = 0):
    """BC1A: (N, 2) int32 words -> ((N, 16) packed RGBA8, (N,) valid)."""
    return _cuda.decode(_BC1A, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_bc2(words: torch.Tensor, mode_mask: int = _FULL, flags: int = 0):
    """BC2: (N, 4) int32 words -> ((N, 16) packed RGBA8, (N,) valid)."""
    return _cuda.decode(_BC2, KERNEL_LAUNCHES, words, mode_mask, flags)


def decode_bc3(words: torch.Tensor, mode_mask: int = _FULL, flags: int = 0):
    """BC3: (N, 4) int32 words -> ((N, 16) packed RGBA8, (N,) valid)."""
    return _cuda.decode(_BC3, KERNEL_LAUNCHES, words, mode_mask, flags)
