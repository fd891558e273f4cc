"""dtx-validate on the port: corpus validation harness.

    python -m detex_tpu_torch.cli.validate --corpus DIR [--fuzz N] \
        [--device cuda|cpu] [--backend device|torch|native] [-o sheet.png]

Counterpart of detex_tpu/cli/validate.py.  The reference validate.c loads
25 test textures, decodes them and shows them in a GTK grid for a human to
eyeball (validate.c:31-57, 220-222).  Here every corpus texture in DIR is
decoded through the engine on --backend and --device (the CUDA kernels on
a card, their plain versions on the CPU) and compared bit for bit with the
committed golden vectors (tests/golden/<FAMILY>.npz); the HDR synthetic
textures run through the HDR pipeline as validate.c:138-186 does; and a
contact-sheet PNG is still written for a visual check.

--corpus has no default: the caller names the directory
(write_golden_corpus writes one from the goldens' corpus_blocks).  Files
it lacks are tolerated, as validate.c:194 does.

--fuzz N decodes N random blocks per family on --device and bit-compares
them with the native C++ oracle (valid masks everywhere, pixel bytes on
valid blocks, since the oracle zero-fills invalid BC7 blocks).  Its blocks
come from fuzz_blocks, which tools/mass_fuzz.py draws from too: random
bytes behind a valid BC7 mode prefix, and BC6H mode codes drawn uniformly
from the 14 modes and the 4 reserved codes.

Exit code 0 if every check passes, 1 otherwise.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from detex_tpu_torch import convert as C
from detex_tpu_torch import engine
from detex_tpu_torch import formats as F
from detex_tpu_torch import hdr
from detex_tpu_torch import io as tio
from detex_tpu_torch import resolve_device
from detex_tpu_torch.texture import Texture

# validate.c:31-57 file list (two files are absent from the reference
# tree; SURVEY.md section 2 item 26).
CORPUS_FILES = [
    ("test-texture-BC1.ktx", "BC1"),
    ("test-texture-BC1A.ktx", "BC1A"),
    ("test-texture-BC2.ktx", "BC2"),
    ("test-texture-BC3.ktx", "BC3"),
    ("test-texture-RGTC1.ktx", "RGTC1"),
    ("test-texture-SIGNED_RGTC1.ktx", "SIGNED_RGTC1"),
    ("test-texture-RGTC2.ktx", "RGTC2"),
    ("test-texture-SIGNED_RGTC2.ktx", "SIGNED_RGTC2"),
    ("test-texture-BPTC.ktx", "BPTC"),
    ("test-texture-BPTC_FLOAT.ktx", "BPTC_FLOAT"),
    ("test-texture-ETC1.ktx", "ETC1"),
    ("test-texture-ETC2.ktx", "ETC2"),
    ("test-texture-ETC2_PUNCHTHROUGH.ktx", "ETC2_PUNCHTHROUGH"),
    ("test-texture-ETC2_EAC.ktx", "ETC2_EAC"),
    ("test-texture-EAC_R11.ktx", "EAC_R11"),
    ("test-texture-EAC_SIGNED_R11.ktx", "EAC_SIGNED_R11"),
    ("test-texture-EAC_RG11.ktx", "EAC_RG11"),
    ("test-texture-RGB8.ktx", None),
    ("test-texture-RGBA8.ktx", None),
    ("test-texture-RGB8.dds", None),
    ("test-texture-RGBA8.dds", None),
    ("test-texture-FLOAT_RGB16.ktx", None),
    ("test-texture-FLOAT_RGBA16.ktx", None),
    ("test-texture.png", None),
    ("test-texture-transparent.png", None),
]

GOLDEN_DIR = Path(__file__).resolve().parent.parent.parent / "tests" \
    / "golden"

FUZZ_FAMILIES = [
    "BC1", "BC1A", "BC2", "BC3", "RGTC1", "SIGNED_RGTC1", "RGTC2",
    "SIGNED_RGTC2", "BPTC", "BPTC_FLOAT", "BPTC_SIGNED_FLOAT", "ETC1",
    "ETC2", "ETC2_PUNCHTHROUGH", "ETC2_EAC", "EAC_R11",
    "EAC_SIGNED_R11", "EAC_RG11", "EAC_SIGNED_RG11"]
FUZZ_SEED = 20260821

# Low bits of byte 0 of each BC6H mode (decompress-bptc-float.c:23-33):
# modes 0 and 1 by their 2-bit code, 2-13 by their 5-bit one, then the 4
# reserved 5-bit codes.
BC6H_CODES = ((0, 2), (1, 2)) + tuple((c, 5) for c in (
    2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31))


def bc6h_mode_blocks(n: int, rng) -> np.ndarray:
    """n random BC6H blocks whose mode code is drawn uniformly from the 14
    modes and the 4 reserved codes (random bytes put half the blocks in
    modes 0 and 1)."""
    b = rng.integers(0, 256, (n, 16), np.uint8)
    pick = rng.integers(0, len(BC6H_CODES), n)
    code = np.array([c for c, _ in BC6H_CODES], np.uint8)[pick]
    keep = np.array([0xFF ^ ((1 << w) - 1) for _, w in BC6H_CODES],
                    np.uint8)[pick]
    b[:, 0] = (b[:, 0] & keep) | code
    return b


def fuzz_blocks(family: str, n: int, rng) -> np.ndarray:
    """n random blocks of `family`: random bytes, behind a valid mode
    prefix for BC7 (a random prefix would mostly be invalid) and with
    bc6h_mode_blocks' mode codes for BC6H."""
    if family in ("BPTC_FLOAT", "BPTC_SIGNED_FLOAT"):
        return bc6h_mode_blocks(n, rng)
    blocks = rng.integers(0, 256, (n, F.block_size_bytes(
        F.BY_NAME[family].fmt)), np.uint8)
    if family == "BPTC":
        modes = rng.integers(0, 8, n)
        blocks[:, 0] = ((1 << modes)
                        | (blocks[:, 0] & (0xFF << (modes + 1)))
                        ).astype(np.uint8)
    return blocks


def fuzz_compare(family: str, blocks: np.ndarray, device) -> tuple:
    """Decode `blocks` on `device` and with the native oracle: (the number
    of blocks whose valid flags differ, the number of the oracle's valid
    blocks whose pixel bytes differ, the oracle's valid mask)."""
    fmt = F.BY_NAME[family].fmt
    ours, ov = engine.decode_blocks(fmt, blocks, device=device)
    want, wv = engine.decode_blocks(fmt, blocks, backend="native")
    return (int(np.sum(ov != wv)),
            int(np.any(ours[wv] != want[wv], axis=1).sum()), wv)


def fuzz_families(n_blocks: int, message, chunk: int = 1 << 18,
                  seed: int = FUZZ_SEED, device="cuda") -> int:
    """Decode n_blocks random blocks (fuzz_blocks) per family on `device`
    and bit-compare them with the native C++ oracle (valid masks
    everywhere, pixel bytes on valid blocks).  Returns the number of
    failing families."""
    rng = np.random.default_rng(seed)
    n_fail = 0
    for name in FUZZ_FAMILIES:
        done, ok = 0, True
        while done < n_blocks and ok:
            n = min(chunk, n_blocks - done)
            n_valid, n_pixels, _ = fuzz_compare(
                name, fuzz_blocks(name, n, rng), device)
            ok = n_valid == 0 and n_pixels == 0
            done += n
        n_fail += not ok
        message(f"  fuzz {name:20s} {done:>9,d} blocks "
                f"{'BIT-EXACT' if ok else 'MISCOMPARE'}")
    return n_fail


def write_golden_corpus(directory) -> list:
    """Write the compressed files of CORPUS_FILES into `directory`, each
    the 64x64 texture of its golden's corpus_blocks (the C reference's
    corpus textures); returns their names."""
    names = []
    for name, family in CORPUS_FILES:
        if family is not None:
            blocks = np.load(GOLDEN_DIR / f"{family}.npz")["corpus_blocks"]
            tio.save_ktx([Texture.new(F.BY_NAME[family].fmt, blocks, 64,
                                      64)], str(Path(directory) / name))
            names.append(name)
    return names


def _to_rgba8(tex: Texture, backend: str, device) -> np.ndarray:
    """Decode any texture to an (H, W, 4) RGBA8 view for the sheet."""
    fmt = F.texture_pixel_format(tex.format)
    n_px = tex.width * tex.height
    if F.is_float(fmt):
        native = engine.decompress_texture_linear(tex, backend=backend,
                                                  device=device)
        if fmt == F.FLOAT_RGBA16:
            # FLOAT_RGBA16 carries the HDR bit already (the reference
            # header swap, formats.py): normalize via RGBA16.
            u16 = C.convert_pixels(native, n_px, fmt, F.RGBA16)
            rgba = C.convert_pixels(u16, n_px, F.RGBA16, F.RGBA8)
        else:
            u16 = C.convert_pixels(native, n_px, fmt | F.HDR, F.RGBX16)
            rgba = C.convert_pixels(u16, n_px, F.RGBX16, F.RGBA8)
    elif F.is_signed(fmt):
        native = engine.decompress_texture_linear(tex, backend=backend,
                                                  device=device)
        # signed 16-bit -> unsigned -> RGBA8
        if fmt == F.SIGNED_R16:
            u = C.convert_pixels(native, n_px, F.SIGNED_R16, F.R16)
            rgba = C.convert_pixels(u, n_px, F.R16, F.RGBA8)
        else:
            u = C.convert_pixels(native, n_px, F.SIGNED_RG16, F.RG16)
            rgba = C.convert_pixels(u, n_px, F.RG16, F.RGBA8)
    else:
        rgba = engine.decompress_texture_linear(tex, F.RGBA8,
                                                backend=backend,
                                                device=device)
    return rgba.reshape(tex.height, tex.width, 4)


def _synth_hdr_textures():
    """Synthetic HDR gradients like validate.c:138-174."""
    h = w = 64
    x = np.linspace(0.0, 2.0, w, dtype=np.float32)[None, :]
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    vals = (x * (0.5 + 0.5 * y)).astype(np.float32)
    rgb32 = np.stack([vals, vals * 0.75, vals * 0.5, vals * 0 + 1.0],
                     axis=-1).astype(np.float32)
    f16 = C.float_to_half(rgb32.ravel())
    tex16 = Texture.new(F.FLOAT_RGBX16, f16.view(np.uint8), w, h)
    tex32 = Texture.new(F.FLOAT_RGBX32,
                        np.frombuffer(rgb32.tobytes(), np.uint8), w, h)
    return tex16, tex32


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dtx-validate")
    p.add_argument("--corpus", required=True,
                   help="directory of the corpus textures (validate.c's "
                        "file names)")
    p.add_argument("-o", "--output", default="validate-sheet.png")
    p.add_argument("-q", "--quiet", action="store_true")
    p.add_argument("--fuzz", type=int, default=0, metavar="N",
                   help="also decode N random blocks per family on "
                        "--device and bit-compare them with the native "
                        "C++ oracle")
    p.add_argument("--backend", choices=engine.BACKENDS, default="device",
                   help="the corpus textures' decode backend (default "
                        "device: decode, convert and assemble on "
                        "--device)")
    p.add_argument("--device", default="cuda",
                   help="torch device to decode on (default cuda; cpu "
                        "runs the kernels' plain PyTorch versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    def message(*a):
        if not args.quiet:
            print(*a)

    tiles = []
    n_fail = 0
    for fname, family in CORPUS_FILES:
        path = Path(args.corpus) / fname
        label_ok = "----"
        if not path.exists():
            message(f"  {fname:44s} MISSING (tolerated, validate.c:194)")
            tiles.append(np.zeros((64, 64, 4), np.uint8))
            continue
        try:
            tex = tio.load_texture_file(str(path))[0]
            rgba = _to_rgba8(tex, args.backend, device)
            tiles.append(rgba)
            if family is not None:
                g = dict(np.load(GOLDEN_DIR / f"{family}.npz"))
                ours = engine.decompress_texture_linear(
                    tex, backend=args.backend, device=device)
                ok = np.array_equal(ours, g["texture_native"])
                label_ok = "BIT-EXACT" if ok else "MISMATCH"
                n_fail += not ok
            else:
                label_ok = "decoded"
        except Exception as e:  # noqa: BLE001 - counted as a failure
            message(f"  {fname:44s} ERROR: {e}")
            tiles.append(np.zeros((64, 64, 4), np.uint8))
            n_fail += 1
            continue
        message(f"  {fname:44s} {label_ok}")

    # HDR pipeline (validate.c:176-186 uses detexSetHDRParameters(1,0,2))
    hdr.set_hdr_parameters(1.0, 0.0, 2.0)
    try:
        tex16, tex32 = _synth_hdr_textures()
        for tex, fmt_hdr in ((tex16, F.FLOAT_RGBX16_HDR),
                             (tex32, F.FLOAT_RGBX32_HDR)):
            n_px = tex.width * tex.height
            if fmt_hdr == F.FLOAT_RGBX16_HDR:
                u16 = C.convert_pixels(tex.data, n_px, fmt_hdr, F.RGBX16)
                rgba = C.convert_pixels(u16, n_px, F.RGBX16, F.RGBA8)
            else:
                f32 = C.convert_pixels(tex.data, n_px, fmt_hdr,
                                       F.FLOAT_RGBX32)
                u16 = C.convert_pixels(f32, n_px, F.FLOAT_RGBX32,
                                       F.RGBX16)
                rgba = C.convert_pixels(u16, n_px, F.RGBX16, F.RGBA8)
            tiles.append(rgba.reshape(64, 64, 4))
        message("  HDR synthetic textures                       decoded")
    finally:
        hdr.set_hdr_parameters(1.0, 0.0, 1.0)

    # Contact sheet: 7 tiles per row.
    cols = 7
    rows = (len(tiles) + cols - 1) // cols
    sheet = np.zeros((rows * 68, cols * 68, 4), np.uint8)
    for i, tile in enumerate(tiles):
        r, c = divmod(i, cols)
        th, tw = tile.shape[:2]
        sheet[r * 68 + 2:r * 68 + 2 + th, c * 68 + 2:c * 68 + 2 + tw] = \
            tile
    sheet_tex = Texture.new(F.RGBA8, sheet.ravel(), sheet.shape[1],
                            sheet.shape[0])
    tio.save_png(sheet_tex, args.output)
    message(f"wrote {args.output}")

    if args.fuzz > 0:
        n_fail += fuzz_families(args.fuzz, message, device=device)

    message("PASS" if n_fail == 0 else f"FAIL ({n_fail})")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
