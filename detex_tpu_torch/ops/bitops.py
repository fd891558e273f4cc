"""Bit-manipulation helpers on int32 words, for the plain versions of the
block decoders (ops/bptc.py, ops/bc.py, ops/rgtc.py).

Counterpart of detex_tpu/ops/bitops.py, cut to what those modules need.
Blocks are (N, 4) int32 little-endian words.  Torch's `>>` on int32 is an
arithmetic shift and its int32 products can overflow, so every shift that
may touch bit 31 runs on int64 copies holding the unsigned 32-bit value,
and results go back to int32 through `to_i32`, which wraps explicitly.
"""

from __future__ import annotations

import numpy as np
import torch

_U32 = 0xFFFFFFFF


def words_from_bytes(blocks_u8: np.ndarray) -> np.ndarray:
    """(N, 4*k) uint8 blocks -> (N, k) int32 little-endian words (numpy,
    bit-preserving; a new writable array, so torch.from_numpy takes it)."""
    blocks_u8 = np.ascontiguousarray(blocks_u8, dtype=np.uint8)
    return blocks_u8.view(np.int32).reshape(blocks_u8.shape[0], -1).copy()


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor -> int64 tensor holding the same bits as 0..2**32-1."""
    return x.to(torch.int64) & _U32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of values in [0, 2**32) -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def shr(x: torch.Tensor, n) -> torch.Tensor:
    """Logical right shift of int32 `x` by `n` in [0, 31] (an int or a
    tensor broadcasting against x)."""
    if isinstance(n, torch.Tensor):
        n = n.to(torch.int64)
    return to_i32(u32(x) >> n)


def field(x: torch.Tensor, start: int, width: int) -> torch.Tensor:
    """Static bit field [start, start + width) of int32 `x`, as int32."""
    assert 0 <= start and start + width <= 32 and width <= 31
    return ((u32(x) >> start) & ((1 << width) - 1)).to(torch.int32)


def div_trunc(num: torch.Tensor, den: int) -> torch.Tensor:
    """Integer division rounding toward zero, as C's `/` and the signed
    division tables of the reference (detex.h:966-982) do; torch's `//`
    rounds toward minus infinity."""
    return torch.sign(num) * (torch.abs(num) // den)


def dyn_field(words: torch.Tensor, start: torch.Tensor,
              width: int) -> torch.Tensor:
    """`width` (<= 31) bits of each row of `words` (N, k) int32 at a
    per-element bit offset `start` (N, ...) in [0, 32k - 1].

    Reads the word holding `start` and the next one (the last word pairs
    with itself, as in the JAX version), so bits past the end of the block
    are not zero; callers mask fields that lie within the block."""
    k = words.shape[-1]
    start = start.to(torch.int64)
    extra = start.dim() - (words.dim() - 1)
    w = u32(words)
    for _ in range(extra):
        w = w.unsqueeze(-2)
    w = w.expand(*start.shape, k)
    w0 = start >> 5
    bit = start & 31
    lo = torch.gather(w, -1, w0.unsqueeze(-1)).squeeze(-1)
    hi = torch.gather(w, -1, torch.clamp(w0 + 1, max=k - 1).unsqueeze(-1)) \
        .squeeze(-1)
    mask = (1 << width) - 1
    # hi's low `width` bits are all that can land in the result; masking
    # first keeps hi << (32 - bit) below 2**63.  At bit == 0 they land at
    # bit 32 and above, outside the mask.
    out = (lo >> bit) | ((hi & mask) << (32 - bit))
    return (out & mask).to(torch.int32)


def dyn_field_vw(words: torch.Tensor, start: torch.Tensor,
                 width: torch.Tensor, max_width: int) -> torch.Tensor:
    """Dynamic start and dynamic width (0 <= width <= max_width <= 16)."""
    raw = dyn_field(words, start, max_width)
    return raw & ((1 << width.to(torch.int32)) - 1)


def mask_bit(mask: int, bit_index: torch.Tensor) -> torch.Tensor:
    """`(mask >> bit_index) & 1 != 0` for a uint32 `mask` given as a
    Python int (0xFFFFFFFF or -1 alike) and bit_index clipped to [0, 31]."""
    idx = torch.clamp(bit_index.to(torch.int64), 0, 31)
    return ((int(mask) & _U32) >> idx) & 1 != 0


def has_flag(flags: int, bit: int) -> bool:
    """Whether `bit` is set in the uint32 `flags`."""
    return (int(flags) & _U32 & bit) != 0


def pack_rgba8(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               a: torch.Tensor) -> torch.Tensor:
    """Pack 8-bit components into little-endian RGBA8 words as int32
    (reference detexPack32RGBA8, detex.h:1006-1016)."""
    c = [x.to(torch.int64) & 0xFF for x in (r, g, b, a)]
    return to_i32(c[0] | (c[1] << 8) | (c[2] << 16) | (c[3] << 24))


def pack_u8x4(vals: torch.Tensor) -> torch.Tensor:
    """(N, 4k) 8-bit values -> (N, k) int32 words, four little-endian
    bytes each."""
    v = (vals.to(torch.int64) & 0xFF).reshape(vals.shape[0], -1, 4)
    return to_i32(v[..., 0] | (v[..., 1] << 8) | (v[..., 2] << 16)
                  | (v[..., 3] << 24))


def pack_u16x2(vals: torch.Tensor) -> torch.Tensor:
    """(N, 2k) 16-bit values (signed or not) -> (N, k) int32 words, two
    little-endian halves each."""
    v = (vals.to(torch.int64) & 0xFFFF).reshape(vals.shape[0], -1, 2)
    return to_i32(v[..., 0] | (v[..., 1] << 16))
