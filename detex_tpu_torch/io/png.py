"""PNG I/O via Pillow (reference: png.c:30-218, app-side helper).

The port's own copy of detex_tpu/io/png.py, so that the port imports
nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py.

The reference wraps libpng and maps gray/RGB/RGBA x 8/16-bit images to
detex pixel formats (png.c:108-127); interlaced PNGs are rejected
(png.c:89-93). 16-bit PNG is big-endian on disk; we byteswap to the
native little-endian layout used everywhere else.
"""

from __future__ import annotations

import numpy as np

from detex_tpu_torch import formats as F
from detex_tpu_torch.io.ktx import TextureFileError
from detex_tpu_torch.texture import Texture

try:
    from PIL import Image
    _HAVE_PIL = True
except ImportError:          # pragma: no cover
    _HAVE_PIL = False

# PIL mode -> pixel format (cf. png.c:108-127 color_type/bit_depth map)
_MODE_TO_FORMAT = {
    "L": F.R8,
    "RGB": F.RGB8,
    "RGBA": F.RGBA8,
    "I;16": F.R16,
    "I;16B": F.R16,
}


def load_png(filename: str) -> Texture:
    if not _HAVE_PIL:
        raise TextureFileError("Pillow not available for PNG I/O")
    img = Image.open(filename)
    if img.mode == "P":
        img = img.convert("RGBA" if "transparency" in img.info else "RGB")
    if img.mode == "LA":
        img = img.convert("RGBA")
    if img.mode not in _MODE_TO_FORMAT:
        raise TextureFileError(f"Unsupported PNG mode {img.mode}")
    fmt = _MODE_TO_FORMAT[img.mode]
    arr = np.asarray(img)
    if arr.dtype == np.int32:       # PIL "I" modes
        arr = arr.astype(np.uint16)
    if arr.dtype.byteorder == ">":
        arr = arr.byteswap().view(arr.dtype.newbyteorder("<"))
    data = np.ascontiguousarray(arr).view(np.uint8).ravel()
    return Texture.new(fmt, data, img.width, img.height)


_FORMAT_TO_MODE = {
    F.R8: "L",
    F.RGB8: "RGB",
    F.RGBA8: "RGBA",
    F.R16: "I;16",
    F.RGB16: None,      # written via raw 16-bit path
    F.RGBA16: None,
}


def save_png(texture: Texture, filename: str) -> None:
    """Save (reference detexSavePNGFile, png.c:147-218)."""
    if not _HAVE_PIL:
        raise TextureFileError("Pillow not available for PNG I/O")
    fmt = texture.format
    w, h = texture.width, texture.height
    if fmt in (F.R8, F.RGB8, F.RGBA8):
        nc = F.num_components(fmt)
        arr = texture.data.reshape(h, w, nc) if nc > 1 \
            else texture.data.reshape(h, w)
        Image.fromarray(arr).save(filename)
    elif fmt == F.R16:
        arr = texture.data.view(np.uint16).reshape(h, w)
        Image.fromarray(arr, mode="I;16").save(filename)
    elif fmt in (F.RGB16, F.RGBA16):
        nc = F.num_components(fmt)
        arr = texture.data.view(np.uint16).reshape(h, w, nc)
        # Pillow lacks native 16-bit RGB(A); emit big-endian PNG rows
        # through the pure-python encoder path.
        import zlib
        import struct as st
        raw = arr.byteswap().tobytes()
        color_type = 2 if nc == 3 else 6
        rows = b"".join(
            b"\x00" + raw[y * w * nc * 2:(y + 1) * w * nc * 2]
            for y in range(h))

        def chunk(tag, payload):
            c = st.pack(">I", len(payload)) + tag + payload
            return c + st.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

        png = b"\x89PNG\r\n\x1a\n"
        png += chunk(b"IHDR", st.pack(">IIBBBBB", w, h, 16, color_type,
                                      0, 0, 0))
        png += chunk(b"IDAT", zlib.compress(rows))
        png += chunk(b"IEND", b"")
        with open(filename, "wb") as f:
            f.write(png)
    else:
        raise TextureFileError(
            f"Cannot save format {F.format_name(fmt)} as PNG")
