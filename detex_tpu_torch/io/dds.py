"""DDS reader/writer (host-side numpy).

The port's own copy of detex_tpu/io/dds.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

TPU-rebuild equivalent of the reference DDS I/O
(reference: dds.c:32-142 load, dds.c:163-296 save).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from detex_tpu_torch import formats as F
from detex_tpu_torch.io import registry
from detex_tpu_torch.io.ktx import TextureFileError
from detex_tpu_torch.texture import Texture


def load_dds(filename: str, max_mipmaps: int = 32) -> List[Texture]:
    """Load a .dds file (reference detexLoadDDSFileWithMipmaps,
    dds.c:32-142)."""
    with open(filename, "rb") as f:
        raw = f.read()
    if raw[:4] != b"DDS ":
        raise TextureFileError("Couldn't find DDS signature")
    header = raw[4:128]
    if len(header) < 124:
        raise TextureFileError(f"DDS file too short: {filename}")
    height = struct.unpack_from("<I", header, 8)[0]
    width = struct.unpack_from("<I", header, 12)[0]
    pixel_format_flags = struct.unpack_from("<I", header, 76)[0]
    bitcount = struct.unpack_from("<I", header, 84)[0]
    red_mask = struct.unpack_from("<I", header, 88)[0]
    green_mask = struct.unpack_from("<I", header, 92)[0]
    blue_mask = struct.unpack_from("<I", header, 96)[0]
    alpha_mask = struct.unpack_from("<I", header, 100)[0]
    four_cc = header[80:84].decode("latin-1")
    pos = 128
    dx10_format = 0
    if four_cc[:4] == "DX10":
        dx10_format, resource_dimension = struct.unpack_from(
            "<II", raw, pos)[:2]
        if resource_dimension != 3:
            raise TextureFileError(
                "Only 2D textures supported for .dds files")
        pos += 20
    info = registry.by_dds(four_cc, dx10_format, pixel_format_flags,
                           bitcount, red_mask, green_mask, blue_mask,
                           alpha_mask)
    if info is None:
        raise TextureFileError(
            f"Unsupported format in .dds file (fourCC = {four_cc}, "
            f"DX10 format = {dx10_format})")
    fmt = info.texture_format
    bytes_per_block = (F.block_size_bytes(fmt) if F.is_compressed(fmt)
                       else F.pixel_size(fmt))
    bw, bh = info.block_width, info.block_height
    flags = struct.unpack_from("<I", header, 4)[0]
    n_file_mipmaps = 1
    if flags & 0x20000:
        n_file_mipmaps = struct.unpack_from("<I", header, 24)[0]
    n_mipmaps = min(n_file_mipmaps, max_mipmaps)
    textures = []
    for _ in range(n_mipmaps):
        ew = (width + bw - 1) // bw * bw
        eh = (height + bh - 1) // bh * bh
        n = (eh // bh) * (ew // bw)
        data = np.frombuffer(raw, dtype=np.uint8, count=n * bytes_per_block,
                             offset=pos).copy()
        if data.size < n * bytes_per_block:
            raise TextureFileError(f"Error reading file {filename}")
        pos += n * bytes_per_block
        textures.append(Texture(fmt, data, width, height,
                                ew // bw, eh // bh))
        width >>= 1
        height >>= 1
    return textures


def save_dds(textures: List[Texture], filename: str) -> None:
    """Save a .dds file (reference detexSaveDDSFileWithMipmaps,
    dds.c:163-296)."""
    info = registry.by_format(textures[0].format)
    if info is None or not info.dds_support:
        raise TextureFileError(
            "Could not match texture format with DDS file format")
    tex0 = textures[0]
    fmt = tex0.format
    if F.is_compressed(fmt):
        n = tex0.width_in_blocks * tex0.height_in_blocks
        block_size = F.block_size_bytes(fmt)
    else:
        n = tex0.width * tex0.height
        block_size = F.pixel_size(fmt)
    header = bytearray(124)
    struct.pack_into("<I", header, 0, 124)
    flags = 0x1007
    if len(textures) > 1:
        flags |= 0x20000
    flags |= 0x8 if not F.is_compressed(fmt) else 0x80000
    struct.pack_into("<I", header, 4, flags)
    struct.pack_into("<I", header, 8, tex0.height)
    struct.pack_into("<I", header, 12, tex0.width)
    struct.pack_into("<I", header, 16,
                     tex0.width * F.pixel_size(fmt)
                     if not F.is_compressed(fmt) else n * block_size)
    struct.pack_into("<I", header, 24, len(textures))
    struct.pack_into("<I", header, 72, 32)
    struct.pack_into("<I", header, 76, 0x4)     # fourCC present
    dx10_header = None
    if info.dx_four_cc == "DX10":
        dx10_header = bytearray(20)
        struct.pack_into("<I", dx10_header, 0, info.dx10_format)
        struct.pack_into("<I", dx10_header, 4, 3)    # 2D
        struct.pack_into("<I", dx10_header, 12, 1)   # array size
    if not F.is_compressed(fmt):
        r, g, b, a = registry.component_masks(fmt)
        bitcount = F.num_components(fmt) * F.component_size(fmt) * 8
        struct.pack_into("<I", header, 84, bitcount)
        struct.pack_into("<I", header, 88, r & 0xFFFFFFFF)
        struct.pack_into("<I", header, 92, g & 0xFFFFFFFF)
        struct.pack_into("<I", header, 96, b & 0xFFFFFFFF)
        struct.pack_into("<I", header, 100, a & 0xFFFFFFFF)
        pixel_format_flags = 0x40
        if info.dx_four_cc:
            pixel_format_flags |= 0x04
        if F.has_alpha(fmt):
            pixel_format_flags |= 0x01
        struct.pack_into("<I", header, 76, pixel_format_flags)
    if info.dx_four_cc:
        header[80:80 + len(info.dx_four_cc[:4])] = \
            info.dx_four_cc[:4].encode("latin-1")
    caps = 0x1000
    if len(textures) > 1:
        caps |= 0x400008
    struct.pack_into("<I", header, 104, caps)
    out = bytearray(b"DDS ") + header
    if dx10_header is not None:
        out += dx10_header
    for tex in textures:
        out += tex.data.tobytes()
    with open(filename, "wb") as f:
        f.write(out)
