"""BC7 (BPTC) block decode: the CUDA kernel's wrapper and its plain
PyTorch version.

`decode_bptc` launches the hand-written kernel (csrc/bc7.cu, which
replaces detex_tpu/ops/pallas/bptc_pallas.py:_bc7_kernel) for a CUDA
tensor and runs the plain version, `decode_bptc_plain`, for a CPU tensor.
There is no fallback between the two: on a CUDA tensor the kernel
launches or the call raises.

The plain version follows the single-pass algorithm of
detex_tpu/ops/bptc_fast.py (every per-mode constant is a table indexed by
the block's mode) with the tables and layouts of detex_tpu/ops/bptc.py.

Input: (N, 4) little-endian int32 words.  Output: ((N, 16) int32 packed
RGBA8, (N,) bool valid).  Blocks with no mode (byte 0 == 0) are decoded
as mode 0, and blocks rejected by mode_mask/flags are decoded too; only
`valid` marks them.
"""

from __future__ import annotations

import functools
from pathlib import Path

import numpy as np
import torch

from detex_tpu_torch import formats as F
from detex_tpu_torch.ops import _cuda
from detex_tpu_torch.ops.bitops import (dyn_field, dyn_field_vw, has_flag,
                                        mask_bit, pack_rgba8)

_FULL = 0xFFFFFFFF

# Launches of the CUDA kernel in this process (plain-version calls are not
# counted).
KERNEL_LAUNCHES = 0

# Per-mode static layout (decompress-bptc.c:45-71, 195-267).
_NS = [3, 2, 3, 2, 1, 1, 1, 2]          # subsets
_PB = [4, 6, 6, 6, 0, 0, 0, 6]          # partition bits
_RB = [0, 0, 0, 0, 2, 2, 0, 0]          # rotation bits
_ISB = [0, 0, 0, 0, 1, 0, 0, 0]         # index-selection bit (mode 4)
_CP = [4, 6, 5, 7, 5, 7, 7, 5]          # color precision (no p-bit)
_CPP = [5, 7, 5, 8, 5, 7, 8, 6]         # color precision incl. p-bit
_AP = [0, 0, 0, 0, 6, 8, 7, 5]          # alpha precision
_APP = [0, 0, 0, 0, 6, 8, 8, 6]         # alpha precision incl. p-bit
_IB = [3, 3, 2, 2, 2, 2, 4, 2]          # primary index bits
_IB2 = [0, 0, 0, 0, 3, 2, 0, 0]         # secondary index bits
_HAS_PBITS = [1, 1, 0, 1, 0, 0, 1, 1]

_TABLES_NPZ = (Path(__file__).resolve().parents[1] / "data"
               / "bptc_tables.npz")


def _mode_layout(mode: int) -> dict:
    """Static stream start offsets for one mode."""
    pos = mode + 1                       # unary prefix
    pb_start = pos
    pos += _PB[mode]
    rb_start = pos
    pos += _RB[mode]
    isb_start = pos
    pos += _ISB[mode]
    ep_start = pos
    pos += _CP[mode] * _NS[mode] * 2 * 3
    alpha_start = pos
    pos += _AP[mode] * _NS[mode] * 2
    pbit_start = pos
    pos += (2 if mode == 1 else _NS[mode] * 2) * _HAS_PBITS[mode]
    return dict(pb=pb_start, rb=rb_start, isb=isb_start, ep=ep_start,
                alpha=alpha_start, pbit=pbit_start, index=pos)


@functools.cache
def _np_tables() -> dict:
    """Per-mode tables (indexed by mode 0..7) and partition tables."""
    npz = np.load(_TABLES_NPZ)
    lay = [_mode_layout(m) for m in range(8)]
    t = {
        "ns": _NS, "pb": _PB, "rb": _RB, "cp": _CP, "cpp": _CPP,
        "ap": _AP, "app": _APP, "ib": _IB, "ib2": _IB2,
        "pb_start": [lay[m]["pb"] for m in range(8)],
        "rb_start": [lay[m]["rb"] for m in range(8)],
        "isb_start": [lay[m]["isb"] for m in range(8)],
        "index_start": [lay[m]["index"] for m in range(8)],
        # The secondary stream follows the primary one, which stores
        # IB*16 bits less one per anchor (one anchor per subset).
        "sec_start": [lay[m]["index"] + _IB[m] * 16 - _NS[m]
                      for m in range(8)],
    }
    t = {k: np.asarray(v, np.int32) for k, v in t.items()}

    # Endpoint bit offsets: (8, 4 channels, 3 subsets, 2 endpoints).
    ep_off = np.zeros((8, 4, 3, 2), np.int32)
    # P-bit offsets and a zero-force mask: (8, 3 subsets, 2 endpoints).
    pbit_off = np.zeros((8, 3, 2), np.int32)
    pbit_zero = np.ones((8, 3, 2), bool)
    for m in range(8):
        ns = _NS[m]
        for j in range(ns):
            for k in range(2):
                for c in range(3):
                    ep_off[m, c, j, k] = (lay[m]["ep"] + c * ns * 2 * _CP[m]
                                          + (j * 2 + k) * _CP[m])
                if _AP[m]:
                    ep_off[m, 3, j, k] = lay[m]["alpha"] + (j * 2 + k) * _AP[m]
                if not _HAS_PBITS[m]:
                    continue
                if m == 1:
                    # shared per subset (decompress-bptc.c:297-306)
                    pbit_off[m, j, k] = lay[m]["pbit"] + j
                    pbit_zero[m, j, k] = False
                elif m == 6 and k == 1:
                    # the reference reads both mode-6 p-bits from
                    # data0 >> 63, so the second is always 0
                    # (decompress-bptc.c:142-146)
                    pbit_zero[m, j, k] = True
                else:
                    pbit_off[m, j, k] = lay[m]["pbit"] + j * 2 + k
                    pbit_zero[m, j, k] = False
    t["ep_off"] = ep_off
    t["pbit_off"] = pbit_off
    t["pbit_zero"] = pbit_zero
    # Subset of each pixel for NS = 1, 2, 3: (3, 64, 16).
    t["subset"] = np.stack([np.zeros((64, 16), np.int32),
                            npz["P2"].astype(np.int32),
                            npz["P3"].astype(np.int32)])
    # Anchor positions per partition (bptc-tables.c:157-188): (64, 3) =
    # [second of two, second of three, third of three].
    t["anchors"] = np.stack([npz["anchor2"], npz["anchor2of3"],
                             npz["anchor3"]], axis=1).astype(np.int32)
    return t


@functools.cache
def _tables(device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device)
            for k, v in _np_tables().items()}


def _extract_mode(words: torch.Tensor) -> torch.Tensor:
    """Lowest set bit of byte 0 = mode; none -> -1
    (decompress-bptc.c:229-237)."""
    b0 = words[:, 0] & 0xFF
    mode = torch.full_like(b0, -1)
    for i in range(7, -1, -1):
        mode = torch.where(b0 & (1 << i) != 0, i, mode)
    return mode


def _weights(idx: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Interpolation weight floor((64*idx + c) / d): the aWeight tables
    (bptc-tables.c:190-201) for 2, 3 and 4 index bits."""
    c = torch.where(bits == 2, 1, torch.where(bits == 3, 3, 7))
    d = torch.where(bits == 2, 3, torch.where(bits == 3, 7, 15))
    return (64 * idx + c[:, None]) // d[:, None]


def decode_bptc_plain(words: torch.Tensor, mode_mask: int = _FULL,
                      flags: int = 0, pre: torch.Tensor | None = None):
    """Plain PyTorch BC7 decode on any device; same contract as
    decode_bptc.  `pre`, (N, 2) int32 [sub32, pos] per block, replaces the
    partition tables as bc7.cuh's PreGatheredPartition does: sub32 is the
    subset word (2 bits per pixel) for every subset count, pos the anchors
    (bits 0-3 the second of two subsets, 4-7 and 8-11 the second and third
    of three)."""
    n = words.shape[0]
    t = _tables(words.device)
    mode_raw = _extract_mode(words)
    mode = torch.clamp(mode_raw, min=0).long()

    def g(name):
        return t[name][mode]

    ns = g("ns")
    psid = dyn_field_vw(words, g("pb_start"), g("pb"), 6)
    rot = dyn_field_vw(words, g("rb_start"), g("rb"), 2)
    isb = torch.where(mode == 4, dyn_field(words, g("isb_start"), 1), 0)

    # --- endpoints: (N, 4, 3, 2) -----------------------------------------
    def per_channel(color, alpha):
        return torch.cat([color[:, None, None, None].expand(n, 3, 3, 2),
                          alpha[:, None, None, None].expand(n, 1, 3, 2)], 1)

    p = per_channel(g("cp"), g("ap"))
    pp = per_channel(g("cpp"), g("app"))
    raw = dyn_field_vw(words, t["ep_off"][mode], p, 8)
    pbit = dyn_field(words, t["pbit_off"][mode], 1)
    pbit = torch.where(t["pbit_zero"][mode], 0, pbit)
    v = torch.where(pp > p, (raw << 1) | pbit[:, None], raw)
    v = v << (8 - pp)
    v = v | (v >> pp)                      # v >= 0: arithmetic == logical
    no_alpha = (g("ap") == 0)[:, None, None, None]
    ep = torch.cat([v[:, :3], torch.where(no_alpha, 0xFF, v[:, 3:4])], 1)

    # --- subsets and index streams ----------------------------------------
    # Each anchor pixel stores one bit less, so the offset of pixel i in a
    # stream is width*i minus the anchor pixels before i.  An anchor counts
    # once per pixel: pre-gathered anchors may be pixel 0 or equal, as in
    # tools/mxu_probe.py:_bc7_kernel_pre (its anchor bitmask).
    i16 = torch.arange(16, dtype=torch.int32, device=words.device)[None, :]
    if pre is None:
        subset = t["subset"][ns.long() - 1, psid.long()]       # (N, 16)
        anchors = t["anchors"][psid.long()]                    # (N, 3)
        a2 = torch.where(ns == 2, anchors[:, 0], anchors[:, 1])[:, None]
        a3 = anchors[:, 2][:, None]
    else:
        sub32 = pre[:, :1].long() & _FULL
        subset = ((sub32 >> (2 * i16)) & 3).int()
        pos = pre[:, 1]
        a2 = torch.where(ns == 2, pos & 0xF, (pos >> 4) & 0xF)[:, None]
        a3 = ((pos >> 8) & 0xF)[:, None]
    has2 = (ns >= 2)[:, None] & (a2 != 0)
    has3 = (ns == 3)[:, None] & (a3 != 0) & (a3 != a2)
    is_anchor = (i16 == 0) | (has2 & (i16 == a2)) | (has3 & (i16 == a3))
    before = ((i16 > 0).int() + (has2 & (a2 < i16)).int()
              + (has3 & (a3 < i16)).int())
    # Bits past 127 read 0: with fewer distinct anchors a stream runs past
    # the block, and a stream of width 0 (no second stream) starts at 128.
    padded = torch.cat([words, torch.zeros_like(words[:, :1])], 1)

    def stream(start, width):
        off = start[:, None] + width[:, None] * i16 - before
        full = (1 << width)[:, None] - 1
        anch = (1 << torch.clamp(width - 1, min=0))[:, None] - 1
        return dyn_field(padded, off, 4) & torch.where(is_anchor, anch, full)

    ib, ib2 = g("ib"), g("ib2")
    prim = stream(g("index_start"), ib)
    sec = stream(g("sec_start"), ib2)

    has_sec = (ib2 > 0)[:, None]
    isb_m = (isb != 0)[:, None]
    color_idx = torch.where(has_sec & isb_m, sec, prim)
    alpha_idx = torch.where(has_sec, torch.where(isb_m, prim, sec), prim)
    color_bits = torch.where((ib2 > 0) & (isb != 0), ib2, ib + isb)
    alpha_bits = torch.where(ib2 > 0, torch.where(isb != 0, ib, ib2), ib)

    # --- interpolate ---------------------------------------------------------
    w_c = _weights(color_idx, color_bits)
    w_a = _weights(alpha_idx, alpha_bits)
    sub = subset.long()

    def chan(c, w):
        e0 = torch.gather(ep[:, c, :, 0], 1, sub)
        e1 = torch.gather(ep[:, c, :, 1], 1, sub)
        return ((64 - w) * e0 + w * e1 + 32) >> 6

    r, gr, b, a = chan(0, w_c), chan(1, w_c), chan(2, w_c), chan(3, w_a)

    # Rotation swaps alpha with R, G or B after interpolation.
    rotm = rot[:, None]
    new_r = torch.where(rotm == 1, a, r)
    new_g = torch.where(rotm == 2, a, gr)
    new_b = torch.where(rotm == 3, a, b)
    new_a = torch.where(rotm == 1, r, torch.where(
        rotm == 2, gr, torch.where(rotm == 3, b, a)))
    pix = pack_rgba8(new_r, new_g, new_b, new_a)

    valid = (mode_raw >= 0) & mask_bit(mode_mask, mode_raw)
    if has_flag(flags, F.FLAG_OPAQUE_ONLY):
        valid = valid & (mode_raw < 4)
    if has_flag(flags, F.FLAG_NON_OPAQUE_ONLY):
        valid = valid & (mode_raw >= 4)
    return pix, valid


def _decode_bptc_cuda(words: torch.Tensor, mode_mask: int, flags: int):
    global KERNEL_LAUNCHES
    out = _cuda.launch("BC7", "dtx_bc7_decode", words, 4, 16, mode_mask,
                       flags)
    if words.shape[0]:
        KERNEL_LAUNCHES += 1
    return out


def decode_bptc(words: torch.Tensor, mode_mask: int = _FULL,
                flags: int = 0):
    """BC7 decode (reference detexDecompressBlockBPTC,
    decompress-bptc.c:354-512): (N, 4) int32 words -> ((N, 16) int32
    packed RGBA8, (N,) bool valid).

    mode_mask is a uint32 bit set of accepted modes (0xFFFFFFFF and -1
    alike); flags 0x2 rejects modes >= 4, 0x4 rejects modes < 4.  A CUDA
    tensor goes through the CUDA kernel, a CPU tensor through
    decode_bptc_plain."""
    if words.device.type == "cuda":
        return _decode_bptc_cuda(words, mode_mask, flags)
    if words.device.type == "cpu":
        return decode_bptc_plain(words, mode_mask, flags)
    raise ValueError(f"no BC7 decoder for device {words.device}")
