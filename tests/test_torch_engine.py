"""The port's texture engine and dtx-convert CLI (detex_tpu_torch.engine,
detex_tpu_torch.cli.convert) against the JAX package's
(detex_tpu.engine with backend="jax" or "device", detex_tpu.cli.convert
--backend jax) and the golden textures, bit-exact, for the 8 BC/RGTC, the 8
ETC/EAC and the 2 BC6H variants, run on the CPU through the kernels' plain
versions; the port's device backend converts on the device
(detex_tpu_torch.convert_device).

The `corpus_dir` fixture writes each family's 64x64 corpus texture from
tests/golden/<FAMILY>.npz as test-texture-<FAMILY>.ktx with
detex_tpu.io.save_ktx (EAC_SIGNED_RG11, whose golden has no corpus, gets a
random one), so these tests need nothing outside the repo.

Tests marked `cuda` run the engine on a card and skip here; the card's
machine has no JAX, so this module imports the JAX package only inside
fixtures.
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detex_tpu import convert as C
from detex_tpu import formats as F
from detex_tpu import io as tio
from detex_tpu.texture import Texture
from detex_tpu_torch import engine
from detex_tpu_torch.cli import convert as port_cli

_REPO = Path(__file__).resolve().parent.parent
_GOLDEN_DIR = _REPO / "tests" / "golden"
_FULL = 0xFFFFFFFF
_FAMILIES = ["BC1", "BC1A", "BC2", "BC3", "RGTC1", "SIGNED_RGTC1", "RGTC2",
             "SIGNED_RGTC2", "ETC1", "ETC2", "ETC2_PUNCHTHROUGH", "ETC2_EAC",
             "EAC_R11", "EAC_SIGNED_R11", "EAC_RG11", "EAC_SIGNED_RG11",
             "BPTC_FLOAT", "BPTC_SIGNED_FLOAT"]
_UNSIGNED = [f for f in _FAMILIES if "SIGNED" not in f]
# Families whose golden holds the decoded 64x64 corpus texture.
_WITH_TEXTURE = [f for f in _FAMILIES
                 if "texture_native" in np.load(_GOLDEN_DIR / f"{f}.npz")]
# Target pixel formats: the decoded format (None), RGBA8 and BGRA8.
_TARGETS = {"native": None, "RGBA8": F.RGBA8, "BGRA8": F.BGRA8}
# (mode_mask, flags) that invalidate some blocks of each family (the full
# mask and flags 0 where nothing can).
_INVALIDATING = {"BC1": (_FULL, 0), "BC1A": (_FULL, 0x2),
                 "BC2": (_FULL, 0x1), "BC3": (_FULL, 0x3),
                 "RGTC1": (_FULL, 0), "SIGNED_RGTC1": (_FULL, 0),
                 "RGTC2": (_FULL, 0), "SIGNED_RGTC2": (_FULL, 0),
                 "ETC1": (0x1, 0), "ETC2": (0x1A, 0),
                 "ETC2_PUNCHTHROUGH": (_FULL, 0x4), "ETC2_EAC": (_FULL, 0x1),
                 "EAC_R11": (_FULL, 0), "EAC_SIGNED_R11": (_FULL, 0),
                 "EAC_RG11": (_FULL, 0), "EAC_SIGNED_RG11": (_FULL, 0),
                 "BPTC_FLOAT": (_FULL, 0), "BPTC_SIGNED_FLOAT": (0x2AAA, 0)}
_ALWAYS_VALID = ("BC1", "RGTC1", "RGTC2", "EAC_R11", "EAC_RG11")


def _golden(family):
    return np.load(_GOLDEN_DIR / f"{family}.npz")


def _fmt(family):
    return F.BY_NAME[family].fmt


def _corpus_texture(family, width=None, height=None):
    """The golden corpus texture, or a width x height crop built from the
    first of its blocks (partial edge blocks included).  A family whose
    golden has no corpus (EAC_SIGNED_RG11, BPTC_SIGNED_FLOAT) takes its
    random blocks, 64x64 by default."""
    g = _golden(family)
    blocks = g["corpus_blocks"] if "corpus_blocks" in g else \
        g["random_blocks"]
    width = width or (int(g["width"]) if "width" in g else 64)
    height = height or (int(g["height"]) if "height" in g else 64)
    n = ((width + 3) // 4) * ((height + 3) // 4)
    return Texture.new(_fmt(family), blocks[:n], width, height)


def _random_texture(family, width, height, seed):
    """A texture of random blocks; in signed RGTC every 7th block starts
    with the invalid endpoint pair (-127, -128), in signed EAC with the
    invalid base -128."""
    rng = np.random.default_rng(seed)
    n = ((width + 3) // 4) * ((height + 3) // 4)
    bs = F.block_size_bytes(_fmt(family))
    blocks = rng.integers(0, 256, (n, bs), np.uint8)
    if family.startswith("SIGNED"):
        blocks[::7, :2] = (0x81, 0x80)
    if family.startswith("EAC_SIGNED"):
        blocks[::7, 0] = 0x80
    return Texture.new(_fmt(family), blocks, width, height)


@pytest.fixture(scope="module")
def jx():
    from detex_tpu import engine as jengine
    from detex_tpu.cli import convert as jcli
    return SimpleNamespace(engine=jengine, cli=jcli)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """test-texture-<FAMILY>.ktx for every family, from the goldens."""
    d = tmp_path_factory.mktemp("corpus")
    for family in _FAMILIES:
        tio.save_ktx([_corpus_texture(family)],
                     str(d / f"test-texture-{family}.ktx"))
    return d


def _outcome(fn):
    """fn()'s bytes, or the type of the exception it raised."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - compared by type below
        return type(e)


# --- decode_blocks ------------------------------------------------------------


@pytest.mark.parametrize("family", _FAMILIES)
def test_decode_blocks_vs_jax(jx, family):
    g = _golden(family)
    for blocks in (g[k] for k in ("corpus_blocks", "random_blocks")
                   if k in g):
        for flags in (0, 1, 2, 4):
            out0, v0 = jx.engine.decode_blocks(_fmt(family), blocks,
                                               flags=flags, backend="jax")
            out1, v1 = engine.decode_blocks(_fmt(family), blocks,
                                            flags=flags, device="cpu")
            assert out1.dtype == np.uint8
            np.testing.assert_array_equal(v0, v1)
            np.testing.assert_array_equal(out0, out1)


@pytest.mark.parametrize("family", _FAMILIES)
def test_decode_blocks_native_backend(family):
    from detex_tpu import native
    g = _golden(family)
    got = engine.decode_blocks(_fmt(family), g["random_blocks"],
                               backend="native")
    want = native.decode(family, g["random_blocks"])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("family", _FAMILIES)
def test_decode_blocks_device_payload_widths(family):
    """The packed payload of each packer kind is the true pixel size:
    16 pixels * pixel size bytes per block."""
    blocks = _corpus_texture(family).data.reshape(256, -1)
    words = torch.from_numpy(
        np.ascontiguousarray(blocks).view(np.int32).copy())
    pix, valid = engine.decode_blocks_device(_fmt(family), words)
    ps = F.pixel_size(F.texture_pixel_format(_fmt(family)))
    kind = engine._DECODERS[F.compressed_index(_fmt(family))][2]
    words_out = {"u32": 16, "p8": 4, "p8x2": 8, "p16": 8, "p16x2": 16,
                 "p16x4": 32}
    assert pix.dtype == torch.int32 and pix.shape == (256, 4 * ps)
    assert pix.shape[1] == words_out[kind]
    assert valid.dtype == torch.bool and valid.shape == (256,)


# --- whole textures --------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "device"])
@pytest.mark.parametrize("target", list(_TARGETS))
@pytest.mark.parametrize("family", _FAMILIES)
def test_linear_cropped_vs_jax(jx, family, target, backend):
    """A 61x37 texture of corpus blocks (partial edge blocks cropped).
    The torch backend matches JAX's host conversion, errors included; the
    device backend, where it converts other than by the identity or an R/B
    swap, matches JAX's device backend."""
    tex = _corpus_texture(family, 61, 37)
    pf = _TARGETS[target]
    src = F.texture_pixel_format(tex.format)
    jax_backend = "device" if backend == "device" and pf not in (
        None, src) and src not in (F.RGBA8, F.RGBX8) else "jax"
    want = _outcome(lambda: jx.engine.decompress_texture_linear(
        tex, pf, backend=jax_backend))
    got = _outcome(lambda: engine.decompress_texture_linear(
        tex, pf, backend=backend, device="cpu"))
    if isinstance(want, type):
        assert got is want
        return
    assert got.dtype == np.uint8
    ps = F.pixel_size(pf or src)
    assert got.shape == (61 * 37 * ps,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["torch", "device"])
@pytest.mark.parametrize("target", list(_TARGETS))
@pytest.mark.parametrize("family", _FAMILIES)
def test_tiled_vs_jax(jx, family, target, backend):
    """As test_linear_cropped_vs_jax, for the tiled layout."""
    tex = _corpus_texture(family, 61, 37)
    pf = _TARGETS[target]
    src = F.texture_pixel_format(tex.format)
    jax_backend = "device" if backend == "device" and pf not in (
        None, src) and src not in (F.RGBA8, F.RGBX8) else "jax"
    want = _outcome(lambda: jx.engine.decompress_texture_tiled(
        tex, pf, backend=jax_backend))
    got = _outcome(lambda: engine.decompress_texture_tiled(
        tex, pf, backend=backend, device="cpu"))
    if isinstance(want, type):
        assert got is want
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["torch", "device"])
@pytest.mark.parametrize("family", _FAMILIES)
def test_invalid_blocks_zeroed(jx, family, backend):
    """Invalid blocks come out zero in the target format, as in JAX."""
    tex = _random_texture(family, 62, 34, seed=len(family))
    mode_mask, flags = _INVALIDATING[family]
    want = jx.engine.decompress_texture_linear(tex, mode_mask=mode_mask,
                                               flags=flags, backend="jax")
    got = engine.decompress_texture_linear(tex, mode_mask=mode_mask,
                                           flags=flags, backend=backend,
                                           device="cpu")
    np.testing.assert_array_equal(got, want)
    blocks = tex.data.reshape(tex.n_blocks, -1)
    _, valid = engine.decode_blocks(tex.format, blocks, mode_mask, flags,
                                    device="cpu")
    if family in _ALWAYS_VALID:
        assert valid.all()
    else:
        assert not valid.all()
        tiles = engine.decompress_texture_tiled(
            tex, mode_mask=mode_mask, flags=flags, backend=backend,
            device="cpu")
        tiles = tiles.reshape(tex.n_blocks, -1)
        assert not tiles[~valid].any() and tiles[valid].any()


@pytest.mark.parametrize("backend", ["torch", "device"])
@pytest.mark.parametrize("family", _WITH_TEXTURE)
def test_golden_textures(family, backend):
    g = _golden(family)
    tex = _corpus_texture(family)
    got = engine.decompress_texture_linear(tex, backend=backend,
                                           device="cpu")
    np.testing.assert_array_equal(got, g["texture_native"])
    assert engine.LAST_BACKEND == backend
    if "texture_rgba8" in g:
        got = engine.decompress_texture_linear(tex, F.RGBA8, backend=backend,
                                               device="cpu")
        np.testing.assert_array_equal(got, g["texture_rgba8"])


def test_device_backend_raises_where_not_ported():
    """The one refusal left: a pair with no conversion path raises
    ConversionError on the device and torch backends alike, linear and
    tiled; nothing falls back, and LAST_BACKEND keeps the last call that
    succeeded.  BC6H, once refused, now decodes on both."""
    engine.decompress_texture_linear(_corpus_texture("BC1"), backend="torch",
                                     device="cpu")
    assert engine.LAST_BACKEND == "torch"
    rgtc1 = _corpus_texture("RGTC1")
    assert C.match_conversion(F.R8, F.FLOAT_RGBA32) is None
    for backend in ("device", "torch"):
        for fn in (engine.decompress_texture_linear,
                   engine.decompress_texture_tiled):
            with pytest.raises(C.ConversionError):
                fn(rgtc1, F.FLOAT_RGBA32, backend=backend, device="cpu")
    with pytest.raises(C.ConversionError):
        engine.decompress_texture_linear_device(rgtc1, F.FLOAT_RGBA32,
                                                device="cpu")
    uncompressed = Texture.new(F.R8, np.zeros(16, np.uint8), 4, 4)
    with pytest.raises(C.ConversionError):
        engine.decompress_texture_linear(uncompressed, F.FLOAT_RGBA32,
                                         backend="device", device="cpu")
    assert engine.LAST_BACKEND == "torch"
    bc6h = _corpus_texture("BPTC_FLOAT", 16, 16)
    for backend in ("device", "torch"):
        out = engine.decompress_texture_linear(bc6h, backend=backend,
                                               device="cpu")
        assert out.shape == (16 * 16 * 8,) and engine.LAST_BACKEND == backend
    with pytest.raises(ValueError):
        engine.decompress_texture_linear(rgtc1, backend="jax", device="cpu")


_DEVICE_TENSOR_TARGETS = {
    "BC3": (None, F.BGRA8, F.RGBA16), "RGTC1": (None, F.RGBA8, F.R16),
    "SIGNED_RGTC2": (None, F.RG16, F.RG8),
    "EAC_RG11": (None, F.RG8, F.SIGNED_RG16),
    "BPTC_FLOAT": (None, F.RGBX16, F.BGRA8)}


@pytest.mark.parametrize("family", list(_DEVICE_TENSOR_TARGETS))
def test_device_tensors_vs_jax(jx, family):
    """decompress_texture_linear_device / _tiled_device leave the image on
    the device in the lane representation of the target format; their
    bytes equal JAX's device pipeline's."""
    from detex_tpu_torch import convert_device as CD
    tex = _corpus_texture(family, 61, 37)
    for pf in _DEVICE_TENSOR_TARGETS[family]:
        want = jx.engine.decompress_texture_linear(tex, pf, backend="device")
        img = engine.decompress_texture_linear_device(tex, pf, device="cpu")
        fmt = pf or F.texture_pixel_format(tex.format)
        assert isinstance(img, torch.Tensor)
        assert img.shape == (37, 61, CD.repr_lanes(fmt))
        assert img.dtype == CD.repr_dtype(fmt)
        np.testing.assert_array_equal(CD.to_bytes(img), want)
        tiles = engine.decompress_texture_tiled_device(tex, pf, device="cpu")
        assert tiles.shape == (tex.n_blocks, 16, CD.repr_lanes(fmt))
        np.testing.assert_array_equal(
            CD.to_bytes(tiles),
            jx.engine.decompress_texture_tiled(tex, pf, backend="device"))


@pytest.mark.parametrize("params", [(2.2, 0.0, 4.0), (1.0, 0.25, 2.0)])
def test_hdr_texture_vs_jax(jx, params):
    """BPTC_FLOAT read as FLOAT_RGBX16_HDR to RGBX16 under non-default HDR
    parameters: the device backend equals JAX's device backend, the torch
    backend and JAX's host path."""
    from detex_tpu import hdr
    g = _golden("BPTC_FLOAT")
    tex = Texture.new(F.BPTC_FLOAT | F.HDR, g["corpus_blocks"][:160], 61, 37)
    hdr.set_hdr_parameters(*params)
    try:
        got = engine.decompress_texture_linear(tex, F.RGBX16,
                                               backend="device", device="cpu")
        for want in (
                engine.decompress_texture_linear(tex, F.RGBX16,
                                                 backend="torch",
                                                 device="cpu"),
                jx.engine.decompress_texture_linear(tex, F.RGBX16,
                                                    backend="device"),
                jx.engine.decompress_texture_linear(tex, F.RGBX16,
                                                    backend="jax")):
            np.testing.assert_array_equal(got, want)
    finally:
        hdr.set_hdr_parameters(1.0, 0.0, 1.0)


def test_native_backend_texture(jx):
    tex = _corpus_texture("BC3", 61, 37)
    got = engine.decompress_texture_linear(tex, F.BGRA8, backend="native")
    want = jx.engine.decompress_texture_linear(tex, F.BGRA8, backend="jax")
    np.testing.assert_array_equal(got, want)
    assert engine.LAST_BACKEND == "native"


@pytest.mark.parametrize("backend", ["torch", "device"])
def test_uncompressed_texture(backend):
    rng = np.random.default_rng(3)
    tex = Texture.new(F.RGBA8, rng.integers(0, 256, 13 * 7 * 4, np.uint8),
                      13, 7)
    for pf in (F.RGBA8, F.RGBX8, F.BGRA8, F.BGRX8, F.RGB8, F.RGBA16, F.R8,
               F.FLOAT_RGBX16):
        got = engine.decompress_texture_linear(tex, pf, backend=backend,
                                               device="cpu")
        want = C.convert_pixels(tex.data, 13 * 7, F.RGBA8, pf)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        engine.decompress_texture_tiled(tex, backend=backend, device="cpu")


def test_cuda_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.decompress_texture_linear(_corpus_texture("BC1"),
                                         backend="device", device="cuda")


# --- the CLI -----------------------------------------------------------------


def _cli_pair(jx, src, out_dir, ext, extra=()):
    """Run the port's CLI on the CPU and JAX's with --backend jax; return
    the two outputs (bytes, or the exception type raised)."""
    def run(main, tag, args):
        out = out_dir / f"{tag}.{ext}"
        return _outcome(lambda: (main(["-q", "-d", *extra, *args, str(src),
                                       str(out)]), out.read_bytes())[1])

    port = run(port_cli.main, "port", ["--device", "cpu"])
    ref = run(jx.cli.main, "jax", ["--backend", "jax"])
    return port, ref


@pytest.mark.parametrize("family", _FAMILIES)
def test_cli_decompress_ktx_vs_jax(jx, corpus_dir, tmp_path, family):
    """KTX has no signed half-float RGBX format: for BPTC_SIGNED_FLOAT both
    CLIs raise the same error."""
    port, ref = _cli_pair(jx, corpus_dir / f"test-texture-{family}.ktx",
                          tmp_path, "ktx")
    if family == "BPTC_SIGNED_FLOAT":
        assert port is ref is tio.TextureFileError
        return
    assert isinstance(port, bytes) and port == ref
    tex = tio.load_ktx(str(tmp_path / "port.ktx"))[0]
    assert tex.width == 64 and tex.height == 64


@pytest.mark.parametrize("family", _UNSIGNED)
def test_cli_decompress_png_vs_jax(jx, corpus_dir, tmp_path, family):
    """RG8 (RGTC2), RG16 (EAC_RG11) and FLOAT_RGB16 (BPTC_FLOAT) have no
    PNG form: both CLIs raise the same error."""
    port, ref = _cli_pair(jx, corpus_dir / f"test-texture-{family}.ktx",
                          tmp_path, "png")
    if family in ("RGTC2", "EAC_RG11", "BPTC_FLOAT"):
        assert port is ref is tio.TextureFileError
    else:
        assert isinstance(port, bytes) and port == ref


@pytest.mark.parametrize("family,ext", [("BPTC_FLOAT", "ktx"),
                                        ("BPTC_SIGNED_FLOAT", "raw")])
def test_cli_bc6h_backends_vs_jax(jx, corpus_dir, tmp_path, family, ext):
    """dtx-convert -d on a BC6H .ktx (BPTC_FLOAT written as a FLOAT_RGB16
    .ktx, the signed one, which no KTX format holds, as .raw): the default
    device backend, --backend torch and JAX's CLI with --backend jax give
    the same file."""
    src = corpus_dir / f"test-texture-{family}.ktx"
    port, ref = _cli_pair(jx, src, tmp_path, ext)
    assert isinstance(port, bytes) and port == ref
    out = tmp_path / f"torch.{ext}"
    assert port_cli.main(["-q", "-d", "--backend", "torch", "--device",
                          "cpu", str(src), str(out)]) == 0
    assert out.read_bytes() == port
    if ext == "ktx":
        tex = tio.load_ktx(str(tmp_path / "port.ktx"))[0]
        assert tex.format == F.FLOAT_RGB16 and tex.data.size == 64 * 64 * 6
    else:
        assert len(port) == 64 * 64 * 8


def test_cli_explicit_format_and_device_backend(jx, corpus_dir, tmp_path):
    src = corpus_dir / "test-texture-BC1.ktx"
    port, ref = _cli_pair(jx, src, tmp_path, "ktx", ["-f", "RGBA8"])
    assert isinstance(port, bytes) and port == ref
    out = tmp_path / "dev.ktx"
    assert port_cli.main(["-q", "-f", "RGBA8", "--backend", "device",
                          "--device", "cpu", str(src), str(out)]) == 0
    assert out.read_bytes() == port


def test_cli_needs_cuda_for_the_default_device(monkeypatch, corpus_dir,
                                               tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        port_cli.main(["-q", "-d", str(corpus_dir / "test-texture-BC1.ktx"),
                       str(tmp_path / "out.ktx")])


def test_cli_runs_as_module(corpus_dir, tmp_path):
    out = tmp_path / "out.ktx"
    proc = subprocess.run(
        [sys.executable, "-m", "detex_tpu_torch.cli.convert", "-d",
         "--device", "cpu", str(corpus_dir / "test-texture-RGTC1.ktx"),
         str(out)], cwd=_REPO, capture_output=True, text=True, check=True)
    assert "Output file:" in proc.stdout
    tex = tio.load_ktx(str(out))[0]
    np.testing.assert_array_equal(tex.data, _golden("RGTC1")["texture_native"])


# --- on a card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", _FAMILIES)
def test_cuda_engine_vs_cpu(cuda, family):
    tex = _random_texture(family, 253, 190, seed=7)
    mode_mask, flags = _INVALIDATING[family]
    for pf in (None, F.BGRA8, F.RGBA16):
        for fn in (engine.decompress_texture_linear,
                   engine.decompress_texture_tiled):
            want = _outcome(lambda: fn(tex, pf, mode_mask, flags,
                                       backend="device", device="cpu"))
            got = _outcome(lambda: fn(tex, pf, mode_mask, flags,
                                      backend="device", device=cuda))
            if isinstance(want, type):
                assert got is want
            else:
                np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_cuda_golden_textures(cuda):
    for family in _WITH_TEXTURE:
        got = engine.decompress_texture_linear(_corpus_texture(family),
                                               backend="device", device=cuda)
        np.testing.assert_array_equal(got, _golden(family)["texture_native"])
