"""KTX 1.1 reader/writer (host-side numpy).

The port's own copy of detex_tpu/io/ktx.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

TPU-rebuild equivalent of the reference KTX I/O
(reference: ktx.c:36-176 load, ktx.c:207-327 save).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from detex_tpu_torch import formats as F
from detex_tpu_torch.io import registry
from detex_tpu_torch.texture import Texture

KTX_ID = bytes([0xAB, 0x4B, 0x54, 0x58, 0x20, 0x31, 0x31, 0xBB,
                0x0D, 0x0A, 0x1A, 0x0A])


class TextureFileError(Exception):
    pass


def load_ktx(filename: str, max_mipmaps: int = 32) -> List[Texture]:
    """Load a .ktx file (reference detexLoadKTXFileWithMipmaps,
    ktx.c:36-176)."""
    with open(filename, "rb") as f:
        raw = f.read()
    if len(raw) < 64:
        raise TextureFileError(f"KTX file too short: {filename}")
    if raw[:12] != KTX_ID:
        raise TextureFileError("Couldn't find KTX signature")
    header = np.frombuffer(raw[:64], dtype="<u4").copy()
    wrong_endian = header[3] == 0x01020304
    if wrong_endian:
        header[3:] = header[3:].byteswap()
    gl_type = int(header[4])
    gl_format = int(header[6])
    gl_internal_format = int(header[7])
    info = registry.by_gl(gl_internal_format, gl_format, gl_type)
    if info is None:
        raise TextureFileError(
            f"Unsupported format in .ktx file "
            f"(glInternalFormat = 0x{gl_internal_format:04X})")
    fmt = info.texture_format
    bytes_per_block = (F.block_size_bytes(fmt) if F.is_compressed(fmt)
                       else F.pixel_size(fmt))
    bw, bh = info.block_width, info.block_height
    width, height = int(header[9]), int(header[10])
    n_file_mipmaps = int(header[14])
    n_mipmaps = min(n_file_mipmaps, max_mipmaps)
    pos = 64 + int(header[15])          # skip metadata (ktx.c:99-107)
    textures = []
    for level in range(n_mipmaps):
        ew = (width + bw - 1) // bw * bw
        eh = (height + bh - 1) // bh * bh
        (image_size,) = struct.unpack_from("<I", raw, pos)
        if wrong_endian:
            image_size = struct.unpack_from(">I", raw, pos)[0]
        pos += 4
        n = (eh // bh) * (ew // bw)
        if image_size != n * bytes_per_block:
            raise TextureFileError(
                f"Image size field of mipmap level {level} does not match "
                f"({image_size} vs {n * bytes_per_block})")
        data = np.frombuffer(raw, dtype=np.uint8, count=n * bytes_per_block,
                             offset=pos).copy()
        pos += n * bytes_per_block
        textures.append(Texture(fmt, data, width, height,
                                ew // bw, eh // bh))
        width >>= 1
        height >>= 1
        if level + 1 < n_mipmaps:
            pos += 3 - ((image_size + 3) % 4)   # mipPadding (ktx.c:160-170)
    return textures


# KTXorientation metadata values (reference ktx.c:190-204).
ORIENTATION_DOWN = 1
ORIENTATION_UP = 2

_ORIENTATION_KEY = {
    ORIENTATION_DOWN: b"KTXorientation\x00S=r,T=d\x00\x00",
    ORIENTATION_UP: b"KTXorientation\x00S=r,T=u\x00\x00",
}


def save_ktx(textures: List[Texture], filename: str,
             orientation: int = 0) -> None:
    """Save a .ktx file (reference detexSaveKTXFileWithMipmaps,
    ktx.c:207-327).  `orientation`: 0 = no metadata (the reference's
    compiled-in default, ktx.c:242), ORIENTATION_DOWN/UP write the
    28-byte KTXorientation key block (ktx.c:252-272)."""
    info = registry.by_format(textures[0].format)
    if info is None or not info.ktx_support:
        raise TextureFileError(
            "Could not match texture format with KTX file format")
    header = np.zeros(16, dtype="<u4")
    header_bytes = bytearray(64)
    header_bytes[:12] = KTX_ID
    header[3] = 0x04030201
    header[4] = info.gl_type
    header[5] = 1                        # glTypeSize
    header[6] = info.gl_format
    header[7] = info.gl_internal_format
    header[9] = textures[0].width
    header[10] = textures[0].height
    header[11] = 0
    header[13] = 1                       # faces
    header[14] = len(textures)
    header[15] = 28 if orientation else 0   # key/value metadata bytes
    hb = header.tobytes()
    out = bytearray(header_bytes[:12] + hb[12:])
    if orientation:
        out += struct.pack("<I", 27)     # key+value size (ktx.c:258)
        out += _ORIENTATION_KEY[orientation]
    for tex in textures:
        fmt = tex.format
        pixel_size = F.pixel_size(fmt)
        if F.is_compressed(fmt):
            n = tex.width_in_blocks * tex.height_in_blocks
            block_size = F.block_size_bytes(fmt)
        else:
            n = tex.width * tex.height
            block_size = pixel_size
        if F.is_compressed(fmt) or (pixel_size & 3) == 0:
            out += struct.pack("<I", n * block_size)
            out += tex.data.tobytes()
        else:
            # 32-bit row alignment for odd pixel sizes (ktx.c:301-323).
            row_size = (tex.width * pixel_size + 3) & ~3
            out += struct.pack("<I", tex.height * row_size)
            rows = tex.data.reshape(tex.height, tex.width * pixel_size)
            padded = np.zeros((tex.height, row_size), dtype=np.uint8)
            padded[:, :tex.width * pixel_size] = rows
            out += padded.tobytes()
    with open(filename, "wb") as f:
        f.write(out)
