"""Plain BC7 (BPTC) block decode in PyTorch: the benchmark's reference for
the format named BPTC (a texture cell finds reference/<format>.py by name).

It follows the reference decoder's semantics (detex decompress-bptc.c,
mode_mask all modes, flags 0): the mode is the lowest set bit of byte 0,
a block with no mode decodes to zeros and is invalid, mode 6's second
p-bit reads 0 (the reference reads both from the same bit).  Blocks are
decoded one mode at a time, with that mode's static bit layout, on
whatever device the blocks are on.  The partition, anchor and weight
tables are a frozen copy (bptc_tables.json) of the published BC7 tables.

`random_blocks` makes the format's test blocks (random bytes behind a valid
mode prefix) and `texture` gives a texture's pixels in a pixel format; with control=True
the endpoints are interpolated with bfloat16 products and sums, the
control's lower precision, which breaks the bit-exactness the texture
configuration states.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import torch

from dtxbench.traffic import bc7_blocks as random_blocks  # noqa: F401

_NS = [3, 2, 3, 2, 1, 1, 1, 2]       # subsets
_PB = [4, 6, 6, 6, 0, 0, 0, 6]       # partition bits
_RB = [0, 0, 0, 0, 2, 2, 0, 0]       # rotation bits
_ISB = [0, 0, 0, 0, 1, 0, 0, 0]      # index-selection bit
_CP = [4, 6, 5, 7, 5, 7, 7, 5]       # colour bits
_CPP = [5, 7, 5, 8, 5, 7, 8, 6]      # colour bits with the p-bit
_AP = [0, 0, 0, 0, 6, 8, 7, 5]       # alpha bits
_APP = [0, 0, 0, 0, 6, 8, 8, 6]      # alpha bits with the p-bit
_IB = [3, 3, 2, 2, 2, 2, 4, 2]       # primary index bits
_IB2 = [0, 0, 0, 0, 3, 2, 0, 0]      # secondary index bits
_HAS_PB = [1, 1, 0, 1, 0, 0, 1, 1]


@functools.cache
def _tables() -> dict:
    path = Path(__file__).with_name("bptc_tables.json")
    return json.loads(path.read_text())


def exact_interp(e0: torch.Tensor, e1: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """The format's interpolation of int64 endpoints by weights 0..64."""
    return ((64 - w) * e0 + w * e1 + 32) >> 6


def bf16_interp(e0: torch.Tensor, e1: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The same interpolation with its products and sum rounded to
    bfloat16: the control's lower precision."""
    bf = torch.bfloat16
    s = ((64 - w).to(bf) * e0.to(bf) + w.to(bf) * e1.to(bf)) + 32
    return torch.floor(s.float() / 64).to(torch.int64).clamp(0, 255)


def _bits(blocks: torch.Tensor) -> torch.Tensor:
    """(n, 16) uint8 -> (n, 128) int64 bits, least significant first."""
    b = blocks.to(torch.int64)
    shifts = torch.arange(8, device=blocks.device)
    return ((b[:, :, None] >> shifts) & 1).reshape(b.shape[0], 128)


def _field(bits: torch.Tensor, pos, width: int) -> torch.Tensor:
    """The `width`-bit field at `pos` (an int, or an (n,) / (n, k) tensor
    of positions) of each block."""
    if width == 0:
        return torch.zeros(bits.shape[0], dtype=torch.int64,
                           device=bits.device)
    if isinstance(pos, int):
        cols = bits[:, pos:pos + width]
        weights = 1 << torch.arange(width, device=bits.device)
        return (cols * weights).sum(dim=1)
    out = torch.zeros_like(pos)
    for k in range(width):
        out |= torch.gather(bits, 1, pos + k) << k
    return out


def _decode_mode(bits: torch.Tensor, mode: int, interp) -> torch.Tensor:
    """(n, 128) bits of mode-`mode` blocks -> (n, 16, 4) int64 RGBA."""
    t = _tables()
    dev = bits.device
    n = bits.shape[0]
    ns, cp, ap = _NS[mode], _CP[mode], _AP[mode]
    cur = mode + 1
    psid = _field(bits, cur, _PB[mode])
    cur += _PB[mode]
    rot = _field(bits, cur, _RB[mode])
    cur += _RB[mode]
    isb = _field(bits, cur, _ISB[mode])
    cur += _ISB[mode]

    ep = torch.zeros((n, 3, 2, 4), dtype=torch.int64, device=dev)
    for c in range(3):
        for j in range(ns):
            for k in range(2):
                ep[:, j, k, c] = _field(bits, cur, cp)
                cur += cp
    if ap:
        for j in range(ns):
            for k in range(2):
                ep[:, j, k, 3] = _field(bits, cur, ap)
                cur += ap

    pbit = torch.zeros((n, 3, 2), dtype=torch.int64, device=dev)
    if _HAS_PB[mode]:
        if mode == 1:
            for j in range(2):
                pbit[:, j, :] = _field(bits, cur, 1)[:, None]
                cur += 1
        else:
            for j in range(ns):
                for k in range(2):
                    pbit[:, j, k] = _field(bits, cur, 1)
                    cur += 1
            if mode == 6:
                pbit[:, 0, 1] = 0
    for c in range(4):
        if c == 3 and not ap:
            ep[..., 3] = 0xFF
            continue
        prec = ap if c == 3 else cp
        precp = _APP[mode] if c == 3 else _CPP[mode]
        v = ep[..., c]
        if precp > prec:
            v = (v << 1) | pbit
        v = v << (8 - precp)
        ep[..., c] = v | (v >> precp)
    if mode <= 3:
        ep[..., 3] = 0xFF

    # Subset of each pixel and the anchors (pixel 0 always).
    pix = torch.arange(16, device=dev)
    if ns == 1:
        subset = torch.zeros((n, 16), dtype=torch.int64, device=dev)
        anchor = (pix == 0).expand(n, 16)
    else:
        part = torch.tensor(t["p2" if ns == 2 else "p3"], device=dev) \
            .reshape(64, 16)
        subset = part[psid]
        a1 = torch.tensor(t["anchor2" if ns == 2 else "anchor2of3"],
                          device=dev)[psid]
        anchor = (pix == 0) | (pix == a1[:, None])
        if ns == 3:
            a2 = torch.tensor(t["anchor3"], device=dev)[psid]
            anchor = anchor | (pix == a2[:, None])

    def stream(start: int, width: int):
        widths = width - anchor.to(torch.int64)
        offs = start + torch.cumsum(widths, dim=1) - widths
        out = torch.zeros((n, 16), dtype=torch.int64, device=dev)
        for k in range(width):
            bit = torch.gather(bits, 1, (offs + k).clamp(max=127))
            out |= torch.where(k < widths, bit, 0) << k
        return out, start + 16 * width - ns

    ib, ib2 = _IB[mode], _IB2[mode]
    prim, cur = stream(cur, ib)
    cidx, cbits, aidx, abits = prim, ib, prim, ib
    if ib2:
        sec, cur = stream(cur, ib2)
        use_sec = (isb == 1)[:, None]
        cidx = torch.where(use_sec, sec, prim)
        aidx = torch.where(use_sec, prim, sec)
        cbits = abits = None
    weights = {b: torch.tensor(t[f"weight{b}"], device=dev)
               for b in (2, 3, 4)}

    def weight(idx, nbits, alpha: bool):
        if nbits is not None:
            return weights[nbits][idx]
        # Mode 4/5: which stream (and so which width) feeds which channel
        # depends on the index-selection bit.
        sel = (isb == 1)[:, None]
        if alpha:
            w_sel, w_not = weights[ib][idx.clamp(max=(1 << ib) - 1)], \
                weights[ib2][idx.clamp(max=(1 << ib2) - 1)]
        else:
            w_sel, w_not = weights[ib2][idx.clamp(max=(1 << ib2) - 1)], \
                weights[ib][idx.clamp(max=(1 << ib) - 1)]
        return torch.where(sel, w_sel, w_not)

    wc = weight(cidx, cbits, False)
    wa = weight(aidx, abits, True)
    e = torch.gather(ep, 1, subset[:, :, None, None].expand(n, 16, 2, 4))
    e0, e1 = e[:, :, 0, :], e[:, :, 1, :]
    w = torch.stack([wc, wc, wc, wa], dim=-1)
    px = interp(e0, e1, w)
    if _RB[mode]:
        swapped = px.clone()
        for r in (1, 2, 3):
            sel = (rot == r)[:, None]
            swapped[..., r - 1] = torch.where(sel, px[..., 3],
                                              swapped[..., r - 1])
            swapped[..., 3] = torch.where(sel, px[..., r - 1],
                                          swapped[..., 3])
        px = swapped
    return px


def decode(blocks: torch.Tensor, interp=exact_interp):
    """(n, 16) uint8 BC7 blocks -> ((n, 16, 4) uint8 RGBA pixels, pixels
    row-major in a block, (n,) bool valid)."""
    bits = _bits(blocks)
    b0 = blocks[:, 0].to(torch.int64)
    lowest = b0 & -b0
    out = torch.zeros((blocks.shape[0], 16, 4), dtype=torch.int64,
                      device=blocks.device)
    for mode in range(8):
        rows = torch.nonzero(lowest == (1 << mode)).flatten()
        if rows.numel():
            out[rows] = _decode_mode(bits[rows], mode, interp)
    return out.to(torch.uint8), b0 != 0


def assemble(pixels: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """(hb * wb, 16, 4) block pixels in row-major block order -> (height,
    width, 4) image (sides that are multiples of 4)."""
    hb, wb = height // 4, width // 4
    return pixels.reshape(hb, wb, 4, 4, 4).permute(0, 2, 1, 3, 4) \
        .reshape(height, width, 4)


def texture(blocks: torch.Tensor, width: int, height: int,
            pixel_format: str, control: bool = False) -> torch.Tensor:
    """(n, 16) uint8 blocks of a width x height texture -> its row-major
    pixel bytes, flat uint8, in `pixel_format` (RGBA8, the format's own)."""
    if pixel_format != "RGBA8":
        raise ValueError(f"no reference conversion of BC7 to {pixel_format}")
    pix, _ = decode(blocks, bf16_interp if control else exact_interp)
    return assemble(pix, width, height).reshape(-1)
