"""Minimal host-side BC7 encoders for synthetic-data generation.

The port's own copy of detex_tpu/ops/bptc_encode.py, so that the port
imports nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

The reference library has NO compressor (detex is decode-only); these
exist so the training/control environments can emit *real* BC7
bitstrings whose in-graph decode (ops/pallas/bptc_pallas.py, reference
decompress-bptc.c:354-512) is the observation path — the north-star
architecture trains and controls through the same perception code.

Two tiny encoders, both exact under the BC7 spec (so decode is a known
deterministic function of the input image):

  * encode_bc7_mode6_gray: per-pixel 4-bit grayscale detail.  Mode 6
    (7-bit endpoints + per-endpoint p-bit, one subset, 4-bit indices):
    endpoints are 0 and 254; each pixel's index is its luminance
    quantized to 4 bits.  Decoded value =
    ((64-w)*0 + w*254 + 32) >> 6 with w = aWeight4[idx]
    (decompress-bptc.c:182-193, bptc-tables.c:190-201).  Both p-bits
    are written 0: mode 6's P1 sits at bit 64 and the reference's
    p-bit extraction never crosses the data0/data1 boundary
    (decompress-bptc.c:141-152 reads it as 0), so writing 0 keeps
    spec-conformant decoders and this stack bit-identical.
  * encode_bc7_mode5_solid: one RGBA color per 4x4 block (7-bit RGB
    + 8-bit alpha endpoints, 2-bit indices all zero -> exact endpoint
    color everywhere).

Pure numpy, host-side; not a rate-distortion compressor.
"""

from __future__ import annotations

import numpy as np

# aWeight4 (bptc-tables.c:199-201)
_W4 = np.array([0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55,
                60, 64], np.int64)
# aWeight2 (bptc-tables.c:190-192)
_W2 = np.array([0, 21, 43, 64], np.int64)


def _pack_bits(fields) -> np.ndarray:
    """fields: list of (value_array (N,), n_bits) LSB-first ->
    (N, 2) uint64 [data0, data1]."""
    n = fields[0][0].shape[0]
    out = np.zeros((n, 2), np.uint64)
    pos = 0
    for val, nb in fields:
        val = np.asarray(val, np.uint64) & ((np.uint64(1) << np.uint64(nb))
                                            - np.uint64(1))
        lo_word, lo_bit = pos // 64, pos % 64
        out[:, lo_word] |= val << np.uint64(lo_bit)
        if lo_bit + nb > 64 and lo_word == 0:
            out[:, 1] |= val >> np.uint64(64 - lo_bit)
        pos += nb
    assert pos == 128, pos
    return out


def _words_from_u64(packed: np.ndarray) -> np.ndarray:
    """(N, 2) uint64 -> (N, 4) int32 little-endian words."""
    return np.ascontiguousarray(packed).view(np.uint32).astype(
        np.int64).astype(np.int32).reshape(-1, 4)


def decode_mode6_gray_value(idx: np.ndarray) -> np.ndarray:
    """Decoded 8-bit value for a 4-bit index under the mode-6 gray
    encoding (endpoints 0 and 254)."""
    w = _W4[np.asarray(idx, np.int64)]
    return (((64 - w) * 0 + w * 254 + 32) >> 6).astype(np.uint8)


def encode_bc7_mode6_gray(img: np.ndarray) -> np.ndarray:
    """(H, W) uint8 grayscale -> (H/4 * W/4, 4) int32 BC7 words.

    Decoded RGBA8: r=g=b=decode_mode6_gray_value(pix >> 4), a = 254
    everywhere (both alpha endpoints are 254).  Block raster order is
    row-major (texture.c:115-143 linear walk)."""
    h, w = img.shape
    assert h % 4 == 0 and w % 4 == 0, (h, w)
    blocks = img.reshape(h // 4, 4, w // 4, 4).transpose(0, 2, 1, 3) \
        .reshape(-1, 16)
    idx = (blocks >> 4).astype(np.uint64)          # 4-bit indices
    # Anchor: pixel 0's stored index has 3 bits (MSB implicitly 0).
    idx[:, 0] = np.minimum(idx[:, 0], 7)
    n = idx.shape[0]
    ones = np.full(n, np.uint64(0xFFFFFFFF), np.uint64)
    zeros = np.zeros(n, np.uint64)
    fields = [(np.full(n, 0x40, np.uint64), 7)]    # mode 6 = bit 6 set
    # R0,R1,G0,G1,B0,B1,A0,A1: endpoint0=0, endpoint1=127 (7-bit);
    # alpha0=127 (p0=0 -> 254), alpha1=127 (p1=1 -> 255).
    for _ in range(3):
        fields.append((zeros, 7))
        fields.append((ones, 7))
    fields.append((ones, 7))
    fields.append((ones, 7))
    fields.append((zeros, 1))                      # P0
    fields.append((zeros, 1))                      # P1
    fields.append((idx[:, 0], 3))                  # anchored index
    for i in range(1, 16):
        fields.append((idx[:, i], 4))
    return _words_from_u64(_pack_bits(fields))


def encode_bc7_mode5_solid(rgba: np.ndarray) -> np.ndarray:
    """(N, 4) uint8 solid block colors -> (N, 4) int32 BC7 words.

    Mode 5, rotation 0, both color endpoints = color>>1 (7-bit), both
    alpha endpoints = alpha (8-bit), all indices 0: every pixel decodes
    to ((c>>1)<<1 | (c>>7), a) exactly."""
    rgba = np.asarray(rgba, np.uint8)
    n = rgba.shape[0]
    zeros = np.zeros(n, np.uint64)
    c7 = (rgba[:, :3].astype(np.uint64) >> 1)
    a8 = rgba[:, 3].astype(np.uint64)
    fields = [(np.full(n, 0x20, np.uint64), 6),    # mode 5 = bit 5 set
              (zeros, 2)]                          # rotation
    for comp in range(3):
        fields.append((c7[:, comp], 7))
        fields.append((c7[:, comp], 7))
    fields.append((a8, 8))
    fields.append((a8, 8))
    fields.append((zeros, 31))                     # color indices (2-bit,
    fields.append((zeros, 31))                     # anchored) + alpha idx
    return _words_from_u64(_pack_bits(fields))


def decode_mode5_solid_value(rgba: np.ndarray) -> np.ndarray:
    """The exact decoded color for encode_bc7_mode5_solid input."""
    rgba = np.asarray(rgba, np.uint8)
    out = rgba.copy()
    out[:, :3] = ((rgba[:, :3] >> 1) << 1) | (rgba[:, :3] >> 7)
    return out
