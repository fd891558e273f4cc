"""Texture decode engine of the port: batched block decode, pixel-format
conversion and assembly of the linear or tiled image.

Counterpart of detex_tpu/engine.py (reference texture engine,
texture.c:27-145).  Every block of a texture is decoded by one kernel
launch; the image is assembled with a reshape and a permute, with no
per-block loop.

Layers:
  decode_blocks_device : (N, k) int32 word tensor -> the decoder's packed
      payload and valid flags, on the tensor's device
  decode_blocks        : (N, block bytes) u8 blocks -> per-block pixel
      bytes on the host, byte for byte the reference's pixel buffers
  decompress_texture_linear / _tiled : the whole texture in a pixel format,
      with partial edge blocks cropped and invalid blocks zero in the
      target format (texture.c:90-93, 125-127)

Backends of the texture calls:
  "device": decode, zero and assemble on `device`; only the identity and
      the R/B swaps among RGBA8, RGBX8, BGRA8 and BGRX8 convert there, any
      other conversion raises ConversionError (device pixel conversion is
      not ported yet);
  "torch":  decode on `device`, convert with the host converter
      detex_tpu.convert.convert_pixels;
  "native": the multithreaded C++ host runtime, detex_tpu.native.
The device is explicit: a CUDA device runs the CUDA kernels, the CPU runs
their plain PyTorch versions, and nothing falls back from one to the other.
Families whose kernel is not ported yet raise NotImplementedError.
"""

from __future__ import annotations

import numpy as np
import torch

from detex_tpu import convert as C
from detex_tpu import formats as F
from detex_tpu.texture import Texture
from detex_tpu_torch.ops import bc, bptc, eac, etc, rgtc
from detex_tpu_torch.ops.bitops import words_from_bytes

_FULL = 0xFFFFFFFF
BACKENDS = ("device", "torch", "native")

# Backend of the last texture call that succeeded ("device", "torch" or
# "native"); set only after the call has produced its result.
LAST_BACKEND: str = ""

# compressed-format index -> (module, wrapper, packer kind).  The wrapper
# is looked up at call time.  Every kind is the little-endian byte stream
# of the reference's pixel buffer (detex.h:879-930):
#   u32  : (N, 16) packed RGBA8 pixels
#   p8   : (N, 4) words of 4 R8 pixels
#   p8x2 : (N, 8) words of 2 RG8 pixels
#   p16  : (N, 8) words of 2 16-bit pixels
#   p16x2: (N, 16) words of one R | G << 16 pixel
_DECODERS = {
    F.IDX_BC1: (bc, "decode_bc1", "u32"),
    F.IDX_BC1A: (bc, "decode_bc1a", "u32"),
    F.IDX_BC2: (bc, "decode_bc2", "u32"),
    F.IDX_BC3: (bc, "decode_bc3", "u32"),
    F.IDX_RGTC1: (rgtc, "decode_rgtc1", "p8"),
    F.IDX_SIGNED_RGTC1: (rgtc, "decode_signed_rgtc1", "p16"),
    F.IDX_RGTC2: (rgtc, "decode_rgtc2", "p8x2"),
    F.IDX_SIGNED_RGTC2: (rgtc, "decode_signed_rgtc2", "p16x2"),
    F.IDX_BPTC: (bptc, "decode_bptc", "u32"),
    F.IDX_ETC1: (etc, "decode_etc1", "u32"),
    F.IDX_ETC2: (etc, "decode_etc2", "u32"),
    F.IDX_ETC2_PUNCHTHROUGH: (etc, "decode_etc2_punchthrough", "u32"),
    F.IDX_ETC2_EAC: (etc, "decode_etc2_eac", "u32"),
    F.IDX_EAC_R11: (eac, "decode_eac_r11", "p16"),
    F.IDX_EAC_SIGNED_R11: (eac, "decode_eac_signed_r11", "p16"),
    F.IDX_EAC_RG11: (eac, "decode_eac_rg11", "p16x2"),
    F.IDX_EAC_SIGNED_RG11: (eac, "decode_eac_signed_rg11", "p16x2"),
}

# compressed-format index -> row of the TPU kernel table in PERF.md whose
# port the family waits for.
_NOT_PORTED = {F.IDX_BPTC_FLOAT: 12, F.IDX_BPTC_SIGNED_FLOAT: 12}

# 8-bit, 4-lane formats whose mutual conversions are no-ops and R/B swaps
# (convert.c:768-778).
_PACKED32 = frozenset({F.RGBA8, F.RGBX8, F.BGRA8, F.BGRX8})


def _decoder(tex_fmt: int):
    """The decode wrapper of a compressed format."""
    idx = F.compressed_index(tex_fmt)
    if idx in _NOT_PORTED:
        raise NotImplementedError(
            f"{F.BY_FORMAT[tex_fmt].name} decode is not ported to the GPU "
            f"yet (PERF.md TPU kernel table, row {_NOT_PORTED[idx]})")
    if idx not in _DECODERS:
        raise ValueError(f"not a compressed format: {tex_fmt:#x}")
    module, name, _ = _DECODERS[idx]
    return getattr(module, name)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for, but "
                           "torch.cuda.is_available() is false (pass "
                           "device='cpu' to run the plain versions)")
    return device


def _words(blocks_u8: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(words_from_bytes(blocks_u8)).to(device)


def decode_blocks_device(tex_fmt: int, words: torch.Tensor,
                         mode_mask=_FULL, flags=0):
    """Decode an (N, k) int32 word tensor on its device.  Returns the
    decoder's packed payload and (N,) bool valid, on that device."""
    return _decoder(tex_fmt)(words, mode_mask, flags)


def decode_blocks(tex_fmt: int, blocks_u8: np.ndarray, mode_mask=_FULL,
                  flags=0, backend: str = "torch", device="cuda"):
    """Decode (N, block_bytes) u8 blocks to per-block pixel bytes
    ((N, 16 * pixel size) u8, on the host) and (N,) bool valid.  Invalid
    blocks are not zeroed here: callers zero them in the target format.

    backend "torch" and "device" decode on `device`; "native" runs
    detex_tpu.native (which zero-fills invalid blocks itself)."""
    if backend == "native":
        from detex_tpu import native
        return native.decode(F.BY_FORMAT[tex_fmt].name, blocks_u8,
                             int(mode_mask), int(flags))
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    pix, valid = decode_blocks_device(
        tex_fmt, _words(blocks_u8, _device(device)), mode_mask, flags)
    out = pix.cpu().numpy().view(np.uint8).reshape(pix.shape[0], -1)
    return out, valid.cpu().numpy()


def _swap_on_device(src_fmt: int, dst_fmt: int) -> bool:
    """Whether the device path swaps R and B to convert src_fmt to
    dst_fmt; raises ConversionError where it has no such conversion."""
    if src_fmt == dst_fmt:
        return False
    if src_fmt in _PACKED32 and dst_fmt in _PACKED32:
        return F.is_bgr(src_fmt) != F.is_bgr(dst_fmt)
    raise C.ConversionError(
        f"conversion {F.format_name(src_fmt)} -> {F.format_name(dst_fmt)} "
        "has no device path in the port yet; use backend='torch'")


def _swap_rb(px: torch.Tensor) -> torch.Tensor:
    """(..., 4k) bytes of 4-byte pixels with R and B exchanged."""
    shape = px.shape
    return px.reshape(-1, 4)[:, [2, 1, 0, 3]].reshape(shape)


def _tiles_device(tex: Texture, pixel_format: int, mode_mask, flags,
                  device) -> torch.Tensor:
    """Decode, convert and zero invalid blocks on the device:
    (n_blocks, 16 * pixel size) uint8 tensor."""
    fn = _decoder(tex.format)
    swap = _swap_on_device(F.texture_pixel_format(tex.format), pixel_format)
    blocks = tex.data.reshape(tex.n_blocks, tex.block_size)
    pix, valid = fn(_words(blocks, _device(device)), mode_mask, flags)
    px = pix.view(torch.uint8)
    if swap:
        px = _swap_rb(px)
    return torch.where(valid[:, None], px, 0)


def _tiles_host(tex: Texture, pixel_format: int, mode_mask, flags,
                backend: str, device) -> np.ndarray:
    """Decode on `device` (or natively), convert on the host, zero
    invalid blocks: (n_blocks, 16 * pixel size) uint8."""
    blocks = tex.data.reshape(tex.n_blocks, tex.block_size)
    native, valid = decode_blocks(tex.format, blocks, mode_mask, flags,
                                  backend, device)
    n = native.shape[0]
    converted = C.convert_pixels(native.ravel(), n * 16,
                                 F.texture_pixel_format(tex.format),
                                 pixel_format).reshape(n, -1)
    return np.where(valid[:, None], converted, 0).astype(np.uint8)


def _assemble(tiles: torch.Tensor, tex: Texture, ps: int) -> np.ndarray:
    """(n_blocks, 16 * ps) per-block pixel bytes -> (height * width * ps,)
    row-major bytes on the host, partial edge blocks cropped
    (texture.c:115-143)."""
    hb, wb = tex.height_in_blocks, tex.width_in_blocks
    img = tiles.reshape(hb, wb, 4, 4, ps).permute(0, 2, 1, 3, 4) \
        .reshape(hb * 4, wb * 4, ps)[:tex.height, :tex.width]
    return img.contiguous().cpu().numpy().ravel()


def decompress_texture_linear(tex: Texture, pixel_format: int = None,
                              mode_mask=_FULL, flags=0,
                              backend: str = "torch",
                              device="cuda") -> np.ndarray:
    """Decode a whole texture row-major (reference
    detexDecompressTextureLinear, texture.c:105-145).  Returns flat u8
    bytes of width * height pixels in `pixel_format` (default: the
    format's decoded pixel format)."""
    global LAST_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    src_fmt = F.texture_pixel_format(tex.format)
    if pixel_format is None:
        pixel_format = src_fmt
    ps = F.pixel_size(pixel_format)
    if not F.is_compressed(tex.format):
        if backend == "device":
            swap = _swap_on_device(src_fmt, pixel_format)
            px = torch.from_numpy(tex.data.copy()).to(_device(device))
            out = (_swap_rb(px) if swap else px).cpu().numpy()
        else:
            out = C.convert_pixels(tex.data, tex.width * tex.height,
                                   src_fmt, pixel_format)
    elif backend == "device":
        out = _assemble(_tiles_device(tex, pixel_format, mode_mask, flags,
                                      device), tex, ps)
    else:
        tiles = _tiles_host(tex, pixel_format, mode_mask, flags, backend,
                            device)
        out = _assemble(torch.from_numpy(tiles), tex, ps)
    LAST_BACKEND = backend
    return out


def decompress_texture_tiled(tex: Texture, pixel_format: int = None,
                             mode_mask=_FULL, flags=0,
                             backend: str = "torch",
                             device="cuda") -> np.ndarray:
    """Decode into per-block tiles (reference detexDecompressTextureTiled,
    texture.c:77-98): blocks of 16 converted pixels, one after another."""
    global LAST_BACKEND
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if not F.is_compressed(tex.format):
        raise ValueError("Cannot handle uncompressed texture format")
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    if backend == "device":
        out = _tiles_device(tex, pixel_format, mode_mask, flags, device) \
            .cpu().numpy().ravel()
    else:
        out = _tiles_host(tex, pixel_format, mode_mask, flags, backend,
                          device).ravel()
    LAST_BACKEND = backend
    return out
