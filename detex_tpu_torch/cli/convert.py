"""dtx-convert on the port: texture file converter/decompressor CLI.

    python -m detex_tpu_torch.cli.convert [-d] [--device cuda|cpu] \
        [--backend device|torch|native] input.ktx output.ktx

Counterpart of detex_tpu/cli/convert.py, with the same arguments and
messages (reference: detex-convert.c):
  -f/--format, -o/--output-format : output format by name
  -i/--input-format               : override detected input format
  -d/--decompress                 : decompress to the native pixel format
  -q/--quiet
Decompressed RGBX8 is saved as RGB8 and FLOAT_RGBX16 as FLOAT_RGB16
because KTX/DDS don't carry X-padded formats (detex-convert.c:283-286).
Decoding runs through detex_tpu_torch.engine on --device: the CUDA
kernels on a card, their plain PyTorch versions on the CPU; by default the
pixel conversion and assembly run there too (--backend device).
"""

from __future__ import annotations

import argparse
import sys

import torch

from detex_tpu_torch import formats as F
from detex_tpu_torch import io as tio
from detex_tpu_torch.io import registry
from detex_tpu_torch.texture import Texture
from detex_tpu_torch import engine

_FILE_TYPES = {"ktx": "ktx", "dds": "dds", "raw": "raw", "png": "png"}


def _file_type(name: str) -> str:
    ext = name.rsplit(".", 1)[-1].lower() if "." in name else ""
    return _FILE_TYPES.get(ext, "none")


def _parse_format(s: str) -> int:
    info = registry.by_name(s)
    if info is None:
        raise SystemExit(f"Fatal error: Format {s} not recognized")
    return info.texture_format


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="dtx-convert",
        description="Convert and decompress texture files "
                    "(KTX, DDS, raw, PNG)")
    p.add_argument("-f", "--format", dest="output_format")
    p.add_argument("-o", "--output-format", dest="output_format")
    p.add_argument("-i", "--input-format")
    p.add_argument("-d", "--decompress", action="store_true")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--backend", choices=engine.BACKENDS, default="device",
                   help="decode backend: device (decode, convert and "
                        "assemble on --device; the default), torch "
                        "(decode on --device, convert on the host), or "
                        "native (multithreaded C++ host runtime)")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    p.add_argument("input_file")
    p.add_argument("output_file")
    args = p.parse_args(argv)

    def message(*a):
        if not args.quiet:
            print(*a)

    device = torch.device(args.device)
    if args.backend != "native" and device.type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available; use --device cpu")

    # Parse format names before touching any file (parity with
    # ParseArguments running before the load, detex-convert.c:232-245).
    requested_output = (_parse_format(args.output_format)
                        if args.output_format else None)
    requested_input = (_parse_format(args.input_format)
                       if args.input_format else None)

    in_type = _file_type(args.input_file)
    out_type = _file_type(args.output_file)
    if in_type == "raw":
        raise SystemExit("Cannot handle RAW type input texture file")
    if in_type == "none":
        raise SystemExit("Input file extension not recognized")
    if out_type == "none":
        raise SystemExit("Do not recognize output file type")

    textures = tio.load_texture_file(args.input_file, max_mipmaps=32)
    input_format = textures[0].format
    if requested_input is not None:
        input_format = requested_input
        for t in textures:
            t.format = input_format
    message(f"Input file: {args.input_file}, format "
            f"{registry.format_text(input_format)}")

    if requested_output is not None:
        output_format = requested_output
    elif args.decompress or (F.is_compressed(input_format)
                             and out_type == "png"):
        if not F.is_compressed(input_format):
            raise SystemExit("Cannot decompress uncompressed texture")
        output_format = F.texture_pixel_format(input_format)
        # KTX/DDS don't carry X-padded formats (detex-convert.c:283-286).
        if output_format == F.RGBX8:
            output_format = F.RGB8
        elif output_format == F.FLOAT_RGBX16:
            output_format = F.FLOAT_RGB16
    else:
        output_format = input_format
    message(f"Output file: {args.output_file}, format "
            f"{registry.format_text(output_format)}")

    if output_format == input_format:
        out_textures = textures
    else:
        if F.is_compressed(output_format):
            raise SystemExit(
                f"Cannot convert to output format "
                f"{registry.format_text(output_format)} "
                f"(dtx-convert does not support compression)")
        out_textures = []
        for t in textures:
            pixels = engine.decompress_texture_linear(
                t, output_format, backend=args.backend, device=device)
            out_textures.append(Texture.new(output_format, pixels,
                                            t.width, t.height))

    if out_type == "raw":
        if len(out_textures) != 1:
            raise SystemExit(
                "Cannot write to RAW format with more than one mipmap "
                "level")
        tio.save_raw(out_textures[0], args.output_file)
    elif out_type == "png":
        if len(out_textures) > 1:
            message(f"Saving only first mipmap level of "
                    f"{len(out_textures)} levels")
        tio.save_png(out_textures[0], args.output_file)
    else:
        tio.save_texture_file(out_textures, args.output_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
