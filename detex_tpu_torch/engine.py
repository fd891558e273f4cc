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
  decompress_texture_linear_device / _tiled_device : the whole texture,
      decoded, converted (convert_device), zeroed and assembled on the
      device, returned as a device tensor
  decompress_texture_linear / _tiled : the whole texture in a pixel format
      as host bytes, with partial edge blocks cropped and invalid blocks
      zero in the target format (texture.c:90-93, 125-127)

Backends of the texture calls:
  "device": decode, convert, zero and assemble on `device`, then copy the
      image to the host;
  "torch":  decode on `device`, convert with the host converter
      detex_tpu.convert.convert_pixels;
  "native": the multithreaded C++ host runtime, detex_tpu.native.
The device is explicit: a CUDA device runs the CUDA kernels, the CPU runs
their plain PyTorch versions, and nothing falls back from one to the other.
A format pair with no conversion path raises ConversionError on every
backend.
"""

from __future__ import annotations

import numpy as np
import torch

from detex_tpu import convert as C
from detex_tpu import formats as F
from detex_tpu.texture import Texture
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch.ops import bc, bptc, bptc_float, eac, etc, rgtc
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
#   p16x4: (N, 32) words, R | G << 16 then B | X << 16 per pixel
_DECODERS = {
    F.IDX_BC1: (bc, "decode_bc1", "u32"),
    F.IDX_BC1A: (bc, "decode_bc1a", "u32"),
    F.IDX_BC2: (bc, "decode_bc2", "u32"),
    F.IDX_BC3: (bc, "decode_bc3", "u32"),
    F.IDX_RGTC1: (rgtc, "decode_rgtc1", "p8"),
    F.IDX_SIGNED_RGTC1: (rgtc, "decode_signed_rgtc1", "p16"),
    F.IDX_RGTC2: (rgtc, "decode_rgtc2", "p8x2"),
    F.IDX_SIGNED_RGTC2: (rgtc, "decode_signed_rgtc2", "p16x2"),
    F.IDX_BPTC_FLOAT: (bptc_float, "decode_bptc_float", "p16x4"),
    F.IDX_BPTC_SIGNED_FLOAT: (bptc_float, "decode_bptc_signed_float",
                              "p16x4"),
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

def _decoder(tex_fmt: int):
    """The decode wrapper of a compressed format."""
    idx = F.compressed_index(tex_fmt)
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


def _tiles_device(tex: Texture, pixel_format: int, mode_mask, flags,
                  device) -> torch.Tensor:
    """Decode, convert and zero invalid blocks on the device:
    (n_blocks, 16, lanes) in convert_device's lane representation of
    pixel_format.  Raises ConversionError where there is no conversion
    path."""
    src_fmt = F.texture_pixel_format(tex.format)
    blocks = tex.data.reshape(tex.n_blocks, tex.block_size)
    pix, valid = _decoder(tex.format)(_words(blocks, _device(device)),
                                      mode_mask, flags)
    n = pix.shape[0]
    # The payload is the reference's pixel buffer: its bytes viewed as
    # lanes are the decoded format's lane representation.
    typed = pix.view(CD.repr_dtype(src_fmt)).reshape(
        n * 16, CD.repr_lanes(src_fmt))
    conv = CD.convert_pixels_device(typed, src_fmt, pixel_format)
    return torch.where(valid[:, None, None], conv.reshape(n, 16, -1), 0)


def _assemble(tiles: torch.Tensor, tex: Texture) -> torch.Tensor:
    """(n_blocks, 16, lanes) per-block pixels -> (height, width, lanes)
    row-major image on the same device, partial edge blocks cropped
    (texture.c:115-143)."""
    hb, wb = tex.height_in_blocks, tex.width_in_blocks
    lanes = tiles.shape[2]
    img = tiles.reshape(hb, wb, 4, 4, lanes).permute(0, 2, 1, 3, 4) \
        .reshape(hb * 4, wb * 4, lanes)[:tex.height, :tex.width]
    return img.contiguous()


def decompress_texture_tiled_device(tex: Texture, pixel_format: int = None,
                                    mode_mask=_FULL, flags=0,
                                    device="cuda") -> torch.Tensor:
    """Per-block tiles decoded, converted and zeroed on `device` and left
    there (texture.c:77-98): (n_blocks, 16, lanes) in convert_device's lane
    representation of pixel_format.  Their bytes equal the host path's."""
    if not F.is_compressed(tex.format):
        raise ValueError("device path requires a compressed texture")
    if pixel_format is None:
        pixel_format = F.texture_pixel_format(tex.format)
    return _tiles_device(tex, pixel_format, mode_mask, flags, device)


def decompress_texture_linear_device(tex: Texture, pixel_format: int = None,
                                     mode_mask=_FULL, flags=0,
                                     device="cuda") -> torch.Tensor:
    """The whole texture as decompress_texture_tiled_device's pixels,
    assembled row-major on `device`: (height, width, lanes)."""
    return _assemble(decompress_texture_tiled_device(
        tex, pixel_format, mode_mask, flags, device), tex)


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
    if not F.is_compressed(tex.format):
        n_px = tex.width * tex.height
        if backend == "device":
            out = CD.convert_pixels_torch(tex.data, n_px, src_fmt,
                                          pixel_format, _device(device))
        else:
            out = C.convert_pixels(tex.data, n_px, src_fmt, pixel_format)
    elif backend == "device":
        out = CD.to_bytes(decompress_texture_linear_device(
            tex, pixel_format, mode_mask, flags, device))
    else:
        tiles = _tiles_host(tex, pixel_format, mode_mask, flags, backend,
                            device)
        out = CD.to_bytes(_assemble(
            torch.from_numpy(tiles).reshape(tex.n_blocks, 16, -1), tex))
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
        out = CD.to_bytes(decompress_texture_tiled_device(
            tex, pixel_format, mode_mask, flags, device))
    else:
        out = _tiles_host(tex, pixel_format, mode_mask, flags, backend,
                          device).ravel()
    LAST_BACKEND = backend
    return out
