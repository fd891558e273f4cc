"""The port's last host modules and user-facing checks against the JAX
package's, on the CPU: ops/modes (GetMode/SetMode), the engine's
words-on-the-device pipeline (engine._device_pipeline), dtx-view,
dtx-validate with its fuzz, and tools/mass_fuzz.py.

Byte for byte against detex_tpu (ops.modes, engine, cli.view,
cli.validate) and the goldens (tests/golden/*.npz); the corpus directory
is written from the goldens' corpus_blocks with the port's io.save_ktx, so
nothing outside the repo is needed.  The fuzz is held to the native C++
oracle; a wrapper patched to miscompare must fail it.

Tests marked `cuda` run on a card and skip here; the card's machine has no
JAX, so this module imports the JAX package only inside fixtures and
tests that are not so marked.
"""

import contextlib
import io
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detex_tpu_torch import convert as C
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch import engine
from detex_tpu_torch import formats as F
from detex_tpu_torch import io as tio
from detex_tpu_torch.cli import validate as PV
from detex_tpu_torch.cli import view as PVW
from detex_tpu_torch.ops import bc, modes as PM
from detex_tpu_torch.texture import Texture
from detex_tpu_torch.tools import mass_fuzz

_REPO = Path(__file__).resolve().parent.parent
_GOLDEN_DIR = _REPO / "tests" / "golden"
_N_MODES = 2048
# The compressed corpus files of validate.c's list, by family.
_CORPUS = {fam: name for name, fam in PV.CORPUS_FILES if fam is not None}


def _golden(family):
    return np.load(_GOLDEN_DIR / f"{family}.npz")


def _corpus_texture(family) -> Texture:
    return Texture.new(F.BY_NAME[family].fmt, _golden(family)["corpus_blocks"],
                       64, 64)


def write_corpus(d: Path) -> Path:
    """validate.c's 17 compressed corpus files from the goldens, and an
    uncompressed RGBA8 KTX and PNG (the decoded BC3 texture)."""
    assert sorted(PV.write_golden_corpus(d)) == sorted(_CORPUS.values())
    rgba = Texture.new(F.RGBA8, _golden("BC3")["texture_rgba8"], 64, 64)
    tio.save_ktx([rgba], str(d / "test-texture-RGBA8.ktx"))
    tio.save_png(rgba, str(d / "test-texture.png"))
    return d


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def jx():
    from detex_tpu import engine as jengine
    from detex_tpu.cli import validate as jvalidate
    from detex_tpu.cli import view as jview
    from detex_tpu.ops import modes as jmodes
    return SimpleNamespace(engine=jengine, validate=jvalidate, view=jview,
                           modes=jmodes)


def _run(main, argv) -> tuple:
    """main(argv)'s return value and its stdout lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue().splitlines()


# --- ops/modes ---------------------------------------------------------------


def _modes_cases():
    from test_modes import CASES
    return CASES


def _blocks(family, seed):
    bs = F.block_size_bytes(F.BY_NAME[family].fmt)
    return np.random.default_rng(seed).integers(0, 256, (_N_MODES, bs),
                                                np.uint8)


def test_modes_tables(jx):
    """The same GET_MODE and SET_MODE entries, quirks included:
    ETC2_PUNCHTHROUGH has no SET_MODE entry; the BPTC_FLOAT tables equal."""
    assert sorted(PM.GET_MODE) == sorted(jx.modes.GET_MODE)
    assert sorted(PM.SET_MODE) == sorted(jx.modes.SET_MODE)
    assert "ETC2_PUNCHTHROUGH" not in PM.SET_MODE
    for name in ("_BPTC_FLOAT_MAP_MODE", "_BPTC_FLOAT_SET_MODE"):
        np.testing.assert_array_equal(getattr(PM, name),
                                      getattr(jx.modes, name))


@pytest.mark.parametrize("family", sorted(PM.GET_MODE))
def test_get_mode_vs_jax(jx, family):
    blocks = _blocks(family, 99)
    got = PM.GET_MODE[family](blocks)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jx.modes.GET_MODE[family](blocks))


@pytest.mark.parametrize("family", sorted(PM.SET_MODE))
def test_set_mode_vs_jax(jx, family):
    """Every mode tests/test_modes.py tries (BPTC_SIGNED_FLOAT, not there,
    takes BPTC_FLOAT's), on 2,048 random blocks; the input is not
    modified."""
    cases = _modes_cases()
    modes = cases.get(family, cases["BPTC_FLOAT"])[2]
    blocks = _blocks(family, 7)
    before = blocks.copy()
    for mode in modes:
        got = PM.SET_MODE[family](blocks, mode)
        np.testing.assert_array_equal(
            got, jx.modes.SET_MODE[family](blocks, mode),
            err_msg=f"mode {mode}")
    np.testing.assert_array_equal(blocks, before)


def test_set_mode_etc2_punchthrough_vs_jax(jx):
    """The reference's flags-as-mode bug, kept (decompress-etc.c:744-751)."""
    blocks = _blocks("ETC2_PUNCHTHROUGH", 7)
    for flags in (F.FLAG_OPAQUE_ONLY, F.FLAG_NON_OPAQUE_ONLY, 2 | 4, 0, 3):
        np.testing.assert_array_equal(
            PM.set_mode_etc2_punchthrough(blocks, 0, flags),
            jx.modes.set_mode_etc2_punchthrough(blocks, 0, flags),
            err_msg=f"flags={flags}")


# --- engine._device_pipeline -------------------------------------------------


_WITH_TEXTURE = sorted(f for f in F.BY_NAME
                       if "texture_native" in _golden(f))


def _pipeline_bytes(tex, pf, device):
    pipeline = engine._device_pipeline(
        tex.format, pf, tex.width_in_blocks, tex.height_in_blocks,
        tex.width, tex.height)
    words = engine._words(tex.data.reshape(tex.n_blocks, -1), device)
    return CD.to_bytes(pipeline(words, 0xFFFFFFFF, 0))


@pytest.mark.parametrize("family", _WITH_TEXTURE)
def test_device_pipeline_vs_jax(jx, family):
    """The pipeline from words on the device: byte-equal to
    decompress_texture_linear_device, to the JAX engine and to the golden
    texture, in the decoded format."""
    tex = _corpus_texture(family)
    pf = F.texture_pixel_format(tex.format)
    got = _pipeline_bytes(tex, pf, torch.device("cpu"))
    np.testing.assert_array_equal(got, _golden(family)["texture_native"])
    np.testing.assert_array_equal(
        got, CD.to_bytes(engine.decompress_texture_linear_device(
            tex, device="cpu")))
    np.testing.assert_array_equal(
        got, jx.engine.decompress_texture_linear(tex))


def test_device_pipeline_etc2_eac_rgba8(jx):
    """ETC2_EAC -> RGBA8, the config the pipelines bench times, on a
    cropped texture of random words (invalid blocks zeroed), against JAX's
    device pipeline and the native decode."""
    words = np.random.default_rng(1).integers(
        -2**31, 2**31, (16 * 16, 4), np.int64).astype(np.int32)
    tex = Texture.new(F.ETC2_EAC, words.view(np.uint8), 61, 63)
    got = _pipeline_bytes(tex, F.RGBA8, torch.device("cpu"))
    np.testing.assert_array_equal(
        got, jx.engine.decompress_texture_linear(tex, F.RGBA8,
                                                 backend="device"))
    np.testing.assert_array_equal(
        got, engine.decompress_texture_linear(tex, F.RGBA8,
                                              backend="native"))


def test_device_pipeline_refuses_before_decoding(monkeypatch):
    """A pair with no conversion path raises ConversionError when the
    pipeline is made, before any decode; an uncompressed format raises
    ValueError."""
    from detex_tpu_torch.ops import bptc_float
    monkeypatch.setattr(bptc_float, "decode_bptc_signed_float", None)
    with pytest.raises(C.ConversionError):
        engine._device_pipeline(F.BPTC_SIGNED_FLOAT, F.RGBA8, 1, 1, 4, 4)
    with pytest.raises(ValueError):
        engine._device_pipeline(F.RGBA8, F.RGBA8, 1, 1, 4, 4)


# --- dtx-view ----------------------------------------------------------------


@pytest.mark.parametrize("zoom", [1, 3])
@pytest.mark.parametrize("family", ["BPTC", "BPTC_FLOAT"])
def test_view_vs_jax(jx, corpus_dir, tmp_path, family, zoom):
    src = str(corpus_dir / _CORPUS[family])
    outs = {}
    for tag, main, extra in (("port", PVW.main, ["--device", "cpu"]),
                             ("jax", jx.view.main, [])):
        out = tmp_path / f"{tag}.png"
        rc, lines = _run(main, [src, "-o", str(out), "-z", str(zoom),
                                *extra])
        assert rc == 0
        outs[tag] = (out.read_bytes(), lines[0])
    assert outs["port"] == outs["jax"]
    img = tio.load_png(str(tmp_path / "port.png"))
    assert (img.width, img.height) == (64 * zoom, 64 * zoom)


@pytest.mark.parametrize("backend", ["torch", "native"])
def test_view_backends(corpus_dir, tmp_path, backend):
    """Every backend gives the device backend's PNG; uncompressed input
    (a PNG) is shown through the device converter."""
    for name in (_CORPUS["ETC2_EAC"], _CORPUS["EAC_SIGNED_R11"],
                 "test-texture.png"):
        pngs = []
        for b in ("device", backend):
            out = tmp_path / f"{b}.png"
            assert _run(PVW.main, [str(corpus_dir / name), "-o", str(out),
                                   "--backend", b, "--device", "cpu"])[0] == 0
            pngs.append(out.read_bytes())
        assert pngs[0] == pngs[1], name


def test_view_hdr_route():
    """A format with no path to RGBA8 but one from HDR to RGBX16
    (FLOAT_RGB32_HDR) goes through the HDR map, as the JAX viewer's
    fallback does (detex_tpu/cli/view.py:47-56)."""
    from detex_tpu import convert as JC
    px = np.random.default_rng(4).random(8 * 8 * 3, np.float32) * 2
    tex = Texture.new(F.FLOAT_RGB32_HDR, px.view(np.uint8), 8, 8)
    assert C.match_conversion(F.FLOAT_RGB32_HDR, F.RGBA8) is None
    u16 = JC.convert_pixels(tex.data, 64, F.FLOAT_RGB32_HDR, F.RGBX16)
    np.testing.assert_array_equal(
        PVW.to_rgba8(tex, device="cpu"),
        JC.convert_pixels(u16, 64, F.RGBX16, F.RGBA8))


def test_view_format_without_a_route(tmp_path):
    """BPTC_SIGNED_FLOAT has no path to RGBA8 and none through HDR: the
    viewer exits with the converter's message."""
    g = _golden("BPTC_SIGNED_FLOAT")
    src = tmp_path / "s.dds"
    tio.save_dds([Texture.new(F.BPTC_SIGNED_FLOAT, g["random_blocks"][:16],
                              16, 16)], str(src))
    with pytest.raises(SystemExit, match="cannot show"):
        _run(PVW.main, [str(src), "--device", "cpu",
                        "-o", str(tmp_path / "s.png")])


# --- dtx-validate ------------------------------------------------------------


def test_validate_vs_jax(jx, corpus_dir, tmp_path):
    """Both exit 0 with the same line for every corpus file (17 BIT-EXACT,
    2 decoded, 6 MISSING) and the HDR textures, and write the same contact
    sheet."""
    port = _run(PV.main, ["--corpus", str(corpus_dir), "--device", "cpu",
                          "-o", str(tmp_path / "p.png")])
    ref = _run(jx.validate.main, ["--corpus", str(corpus_dir),
                                  "-o", str(tmp_path / "j.png")])
    assert port[0] == ref[0] == 0
    assert port[1][:26] == ref[1][:26]
    assert sum("BIT-EXACT" in x for x in port[1]) == 17
    assert sum(x.endswith(" decoded") for x in port[1]) == 3
    assert port[1][-1] == "PASS"
    assert (tmp_path / "p.png").read_bytes() == \
        (tmp_path / "j.png").read_bytes()


def test_validate_fuzz(corpus_dir, tmp_path):
    rc, lines = _run(PV.main, ["--corpus", str(corpus_dir), "--fuzz", "4096",
                               "--device", "cpu", "-o",
                               str(tmp_path / "s.png")])
    fuzz = [x for x in lines if x.strip().startswith("fuzz ")]
    assert rc == 0 and len(fuzz) == 19
    assert all(x.endswith("4,096 blocks BIT-EXACT") for x in fuzz)


@pytest.mark.parametrize("fault", ["pixels", "truncated"])
def test_validate_fails_on_a_corrupt_file(corpus_dir, tmp_path, fault):
    d = tmp_path / "corpus"
    d.mkdir()
    for p in corpus_dir.iterdir():
        (d / p.name).write_bytes(p.read_bytes())
    path = d / _CORPUS["ETC2"]
    data = bytearray(path.read_bytes())
    if fault == "pixels":
        for k in range(1, 33):    # the last 4 blocks' bytes inverted
            data[-k] ^= 0xFF
    else:
        del data[len(data) // 2:]
    path.write_bytes(bytes(data))
    rc, lines = _run(PV.main, ["--corpus", str(d), "--device", "cpu",
                               "-o", str(tmp_path / "s.png")])
    assert rc == 1 and lines[-1] == "FAIL (1)"
    line = next(x for x in lines if _CORPUS["ETC2"] in x)
    assert ("MISMATCH" if fault == "pixels" else "ERROR") in line


def test_fuzz_blocks_draw_every_mode():
    """BC7 blocks always carry a valid mode prefix; BC6H blocks draw all 18
    mode codes, the 4 reserved among them; other families are random
    bytes of their block size."""
    rng = np.random.default_rng(0)
    bc7 = PV.fuzz_blocks("BPTC", 4096, rng)
    assert bc7.shape == (4096, 16) and (bc7[:, 0] != 0).all()
    assert set(PM.get_mode_bptc(bc7)) == set(range(8))
    bc6h = PV.fuzz_blocks("BPTC_SIGNED_FLOAT", 4096, rng)
    b0 = bc6h[:, 0]
    codes = set(np.where((b0 & 2) == 0, b0 & 1, b0 & 0x1F).tolist())
    assert codes == {c for c, _ in PV.BC6H_CODES}
    assert {19, 23, 27, 31} <= codes
    assert PV.fuzz_blocks("EAC_R11", 8, rng).shape == (8, 8)


# --- mass_fuzz ---------------------------------------------------------------


def test_mass_fuzz_cpu():
    rc, lines = _run(mass_fuzz.main, ["--blocks", "4096", "--chunk", "2048",
                                      "--device", "cpu"])
    assert rc == 0
    assert sum("BIT-EXACT" in x for x in lines) == 20
    assert lines[-1].startswith("ALL BIT-EXACT: 77,824 random blocks across "
                                "19 families")


def _miscompare(monkeypatch):
    """BC1's wrapper with one pixel bit flipped on every block."""
    decode = bc.decode_bc1

    def wrong(words, mode_mask=0xFFFFFFFF, flags=0):
        pix, valid = decode(words, mode_mask, flags)
        return pix ^ 1, valid
    monkeypatch.setattr(bc, "decode_bc1", wrong)


def test_mass_fuzz_fails_on_a_miscompare(monkeypatch):
    _miscompare(monkeypatch)
    rc, lines = _run(mass_fuzz.main, ["--blocks", "1024", "--device", "cpu",
                                      "BC1A", "BC1", "BC2"])
    assert rc == 1
    assert "BIT-EXACT" in lines[0] and "MISCOMPARE" in lines[1]
    assert len(lines) == 3 and lines[-1] == \
        "FAILED: [('BC1', 'pixels', 1024)]"


def test_validate_fuzz_fails_on_a_miscompare(monkeypatch, corpus_dir,
                                             tmp_path):
    _miscompare(monkeypatch)
    rc, lines = _run(PV.main, ["--corpus", str(corpus_dir), "--fuzz", "256",
                               "--device", "cpu", "-o",
                               str(tmp_path / "s.png")])
    assert rc == 1
    assert any("fuzz BC1 " in x and "MISCOMPARE" in x for x in lines)
    assert any("test-texture-BC1.ktx" in x and "MISMATCH" in x
               for x in lines)


# --- the card ----------------------------------------------------------------


@pytest.mark.parametrize("main,argv", [
    (PVW.main, ["x.ktx"]), (PV.main, ["--corpus", "."]),
    (mass_fuzz.main, [])])
def test_entry_points_default_to_the_card(monkeypatch, main, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", _WITH_TEXTURE)
def test_cuda_device_pipeline_vs_cpu(cuda, family):
    tex = _corpus_texture(family)
    for pf in (None, F.RGBA8):
        pf = pf or F.texture_pixel_format(tex.format)
        if C.match_conversion(F.texture_pixel_format(tex.format),
                              pf) is None:
            continue
        np.testing.assert_array_equal(
            _pipeline_bytes(tex, pf, cuda),
            _pipeline_bytes(tex, pf, torch.device("cpu")))


@pytest.mark.cuda
def test_cuda_mass_fuzz(cuda):
    rc, lines = _run(mass_fuzz.main, ["--blocks", "65536"])
    assert rc == 0 and lines[-1].startswith("ALL BIT-EXACT")


@pytest.mark.cuda
def test_cuda_validate_and_view(cuda, corpus_dir, tmp_path):
    rc, lines = _run(PV.main, ["--corpus", str(corpus_dir), "--fuzz", "4096",
                               "-o", str(tmp_path / "s.png")])
    assert rc == 0 and lines[-1] == "PASS"
    for family in ("BPTC", "BPTC_FLOAT"):
        pngs = []
        for extra in ([], ["--device", "cpu"]):
            out = tmp_path / f"v{len(pngs)}.png"
            assert _run(PVW.main, [str(corpus_dir / _CORPUS[family]),
                                   "-o", str(out), *extra])[0] == 0
            pngs.append(out.read_bytes())
        assert pngs[0] == pngs[1]
