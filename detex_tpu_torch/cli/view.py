"""dtx-view on the port: texture viewer, headless (renders to PNG).

    python -m detex_tpu_torch.cli.view [--device cuda|cpu] \
        [--backend device|torch|native] [-z ZOOM] [-o out.png] input

Counterpart of detex_tpu/cli/view.py.  The reference viewer
(detex-view.c) decompresses any supported file to BGRA8/BGRX8 and paints
it in a GTK window with nearest-filter zoom (detex-view.c:126-183); here
the texture is decoded through the same path and written as a
(nearest-zoomed) PNG, with its size and format on stdout.

The route to RGBA8 is chosen by format: where the host converter has a
path from the texture's pixel format to RGBA8, the engine decodes and
converts to RGBA8 on --backend (the default, device, decodes, converts and
assembles on --device: the CUDA kernels on a card, their plain versions on
the CPU; uncompressed input is converted there too); otherwise the
decoded pixels are read as HDR and mapped to RGBX16, then RGBA8, on the
host.  A format with neither path exits with the converter's message.
Nothing else is caught: a kernel that fails to build or launch fails the
call.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from detex_tpu_torch import convert as C
from detex_tpu_torch import engine
from detex_tpu_torch import formats as F
from detex_tpu_torch import io as tio
from detex_tpu_torch import resolve_device
from detex_tpu_torch.io import registry
from detex_tpu_torch.texture import Texture


def to_rgba8(tex: Texture, backend: str = "device",
             device="cuda") -> np.ndarray:
    """The texture as flat RGBA8 bytes, by the route its format takes
    (module docstring); raises ConversionError where there is none."""
    src = F.texture_pixel_format(tex.format)
    if C.match_conversion(src, F.RGBA8) is not None:
        if tex.format == F.RGBA8:
            return tex.data
        return engine.decompress_texture_linear(tex, F.RGBA8,
                                                backend=backend,
                                                device=device)
    n_px = tex.width * tex.height
    native = engine.decompress_texture_linear(tex, backend=backend,
                                              device=device)
    u16 = C.convert_pixels(native, n_px, src | F.HDR, F.RGBX16)
    return C.convert_pixels(u16, n_px, F.RGBX16, F.RGBA8)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dtx-view",
                                description="View a texture file")
    p.add_argument("input_file")
    p.add_argument("-o", "--output", default=None,
                   help="output PNG (default: <input>.view.png)")
    p.add_argument("-z", "--zoom", type=int, default=1,
                   help="integer nearest-neighbour zoom factor")
    p.add_argument("--backend", choices=engine.BACKENDS, default="device",
                   help="decode backend: device (decode, convert and "
                        "assemble on --device; the default), torch "
                        "(decode on --device, convert on the host), or "
                        "native (multithreaded C++ host runtime)")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    textures = tio.load_texture_file(args.input_file, max_mipmaps=1)
    tex = textures[0]
    info = registry.by_format(tex.format)
    name = info.text1 if info else f"0x{tex.format:08X}"
    print(f"{args.input_file}: {tex.width}x{tex.height} {name}")

    # RGBA8, where the reference draws BGRA8 because cairo wants it.
    try:
        pixels = to_rgba8(tex, args.backend, device)
    except C.ConversionError as e:
        raise SystemExit(f"dtx-view: cannot show {name}: {e}")
    img = np.asarray(pixels).reshape(tex.height, tex.width, 4)
    if args.zoom > 1:
        img = np.repeat(np.repeat(img, args.zoom, 0), args.zoom, 1)
    out_name = args.output or f"{args.input_file}.view.png"
    out_tex = Texture.new(F.RGBA8, img.ravel(), img.shape[1], img.shape[0])
    tio.save_png(out_tex, out_name)
    print(f"wrote {out_name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
