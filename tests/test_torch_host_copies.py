"""The port's own copies of the JAX package's host modules behave exactly as
their originals: formats, texture, hdr, convert (the host converter), io
(KTX, DDS, raw, PNG), native (the C++ host oracle, built from the port's
copy of its sources), the BPTC tables npz, ops/bptc_encode, utils/metrics
and ops/modes (whose every GetMode/SetMode entry is held byte-equal in
tests/test_torch_cli_tools.py).  The port imports none of
detex_tpu; these tests are the only place the two meet.
"""

import dataclasses
import filecmp
from pathlib import Path

import numpy as np
import pytest

import detex_tpu.convert as JC
import detex_tpu.formats as JF
import detex_tpu.hdr as JH
import detex_tpu.io as JIO
import detex_tpu.native as JN
import detex_tpu.texture as JT
import detex_tpu_torch.convert as PC
import detex_tpu_torch.formats as PF
import detex_tpu_torch.hdr as PH
import detex_tpu_torch.io as PIO
import detex_tpu_torch.native as PN
import detex_tpu_torch.texture as PT

_REPO = Path(__file__).resolve().parent.parent
_GOLDEN = _REPO / "tests" / "golden"


def _values(module):
    """Module-level data of `module`: everything but functions, classes
    and modules."""
    return {k: v for k, v in vars(module).items()
            if not k.startswith("__") and not callable(v)
            and type(v).__name__ != "module"}


def _plain(v):
    """A value with dataclass instances turned into dicts, to compare
    across the two packages' (distinct) classes."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


_FORMAT_NAMES = sorted(_values(JF))
_PIXEL_FORMATS = sorted(JF._PIXEL_FORMAT_NAMES)
_TEXTURE_FORMATS = sorted(JF.BY_FORMAT)
_ALL_FORMATS = _PIXEL_FORMATS + _TEXTURE_FORMATS + [0, 0x7FFF, 1 << 30]
_FORMAT_FNS = sorted(k for k, v in vars(JF).items()
                     if callable(v) and not isinstance(v, type)
                     and v.__module__ == JF.__name__ and k != "_pf"
                     and k != "_tf")


# --- formats, texture -----------------------------------------------------------


def test_formats_same_names():
    assert sorted(_values(PF)) == _FORMAT_NAMES
    assert _FORMAT_FNS == sorted(
        k for k, v in vars(PF).items() if callable(v)
        and not isinstance(v, type) and v.__module__ == PF.__name__
        and k not in ("_pf", "_tf"))


@pytest.mark.parametrize("name", _FORMAT_NAMES)
def test_formats_constant(name):
    assert _plain(getattr(PF, name)) == _plain(getattr(JF, name))


def _outcome(fn, *args):
    try:
        return _plain(fn(*args))
    except Exception as e:            # the same class name, either package
        return type(e).__name__


@pytest.mark.parametrize("name", _FORMAT_FNS)
def test_formats_function(name):
    for fmt in _ALL_FORMATS:
        assert _outcome(getattr(PF, name), fmt) == \
            _outcome(getattr(JF, name), fmt), (name, hex(fmt))
    if name == "lookup":
        for info in JF.BY_NAME.values():
            assert _plain(PF.lookup(info.name)) == _plain(JF.lookup(info.name))


def test_texture():
    data = np.arange(5 * 4 * 8, dtype=np.uint8)
    for fmt, w, h in ((JF.BC1, 17, 13), (JF.RGBA8, 3, 5), (JF.BPTC, 8, 8)):
        pt = PT.Texture.new(fmt, data, w, h)
        jt = JT.Texture.new(fmt, data, w, h)
        assert dataclasses.asdict(pt).keys() == dataclasses.asdict(jt).keys()
        for f in ("format", "width", "height", "width_in_blocks",
                  "height_in_blocks", "n_blocks", "block_size"):
            assert getattr(pt, f) == getattr(jt, f), f
        assert pt.expected_data_size() == jt.expected_data_size()
        np.testing.assert_array_equal(pt.data, jt.data)


# --- convert ------------------------------------------------------------------


def test_convert_table():
    assert [(s, d) for s, d, _ in PC.TABLE] == [(s, d) for s, d, _ in JC.TABLE]
    assert [getattr(f, "__name__", repr(f)) for _, _, f in PC.TABLE] == \
        [getattr(f, "__name__", repr(f)) for _, _, f in JC.TABLE]


@pytest.fixture
def hdr_params():
    """Sets the HDR parameters of both packages; the defaults come back in
    both after the test, failing or not."""
    def set_both(*params):
        JH.set_hdr_parameters(*params)
        PH.set_hdr_parameters(*params)
    yield set_both
    set_both(1.0, 0.0, 1.0)


@pytest.mark.parametrize("src", _PIXEL_FORMATS)
def test_match_and_convert_every_pair(hdr_params, src):
    """match_conversion for every (src, dst) pair, and convert_pixels along
    every path that exists, at gamma 1 and gamma 2.2."""
    rng = np.random.default_rng(src & 0xFFFF)
    n = 37
    buf = rng.integers(0, 256, n * JF.pixel_size(src), np.uint8)
    for params in ((1.0, 0.0, 1.0), (2.2, -0.5, 4.0)):
        hdr_params(*params)
        for dst in _PIXEL_FORMATS:
            path = JC.match_conversion(src, dst)
            assert PC.match_conversion(src, dst) == path, (src, dst)
            if path is None:
                with pytest.raises(PC.ConversionError):
                    PC.convert_pixels(buf, n, src, dst)
                continue
            np.testing.assert_array_equal(
                PC.convert_pixels(buf, n, src, dst),
                JC.convert_pixels(buf, n, src, dst),
                err_msg=f"{JF.format_name(src)} -> {JF.format_name(dst)}")


def test_half_float_helpers():
    halves = np.arange(65536, dtype=np.uint16)
    f32 = JC.half_to_float(halves)
    np.testing.assert_array_equal(PC.half_to_float(halves), f32)
    rng = np.random.default_rng(1)
    floats = np.concatenate([f32[np.isfinite(f32)], rng.standard_normal(
        4096).astype(np.float32) * 1e3]).astype(np.float32)
    np.testing.assert_array_equal(PC.float_to_half(floats),
                                  JC.float_to_half(floats))
    unit = rng.random(4096).astype(np.float32)
    np.testing.assert_array_equal(PC.normalized_float_to_u16(unit),
                                  JC.normalized_float_to_u16(unit))
    np.testing.assert_array_equal(PC.normalized_half_to_u16(halves),
                                  JC.normalized_half_to_u16(halves))


# --- hdr ----------------------------------------------------------------------


@pytest.mark.parametrize("case", range(int(np.load(_GOLDEN / "convert.npz")
                                           ["n_hdr"])))
def test_hdr_at_golden_parameters(hdr_params, case):
    g = np.load(_GOLDEN / "convert.npz")
    hdr_params(*map(float, g[f"hdr{case}_params"]))
    assert dataclasses.asdict(PH.get_hdr_parameters()) == \
        dataclasses.asdict(JH.get_hdr_parameters())
    halves = np.arange(65536, dtype=np.uint16)
    np.testing.assert_array_equal(PH.hdr_half_to_u16(halves),
                                  JH.hdr_half_to_u16(halves))
    f32 = g[f"hdr{case}_src32"].view(np.float32)
    np.testing.assert_array_equal(
        PH.hdr_float_to_float(f32).view(np.uint32),
        JH.hdr_float_to_float(f32).view(np.uint32))
    for fmt, buf in ((JF.FLOAT_RGBX16, g[f"hdr{case}_src"]),
                     (JF.FLOAT_RGBX32, g[f"hdr{case}_src32"])):
        np.testing.assert_array_equal(    # NaN where the range has one
            PH.calculate_dynamic_range(buf, fmt),
            JH.calculate_dynamic_range(buf, fmt))


# --- io -----------------------------------------------------------------------


_FAMILIES = sorted(JF.BY_NAME)


def _textures(family):
    """The family's golden corpus texture (a random one where the golden
    has none), in both packages."""
    g = np.load(_GOLDEN / f"{family}.npz")
    info = JF.BY_NAME[family]
    if "corpus_blocks" in g:
        blocks = g["corpus_blocks"]
    else:
        blocks = np.random.default_rng(5).integers(
            0, 256, (256, info.block_bytes), np.uint8)
    w = h = 4 * int(np.sqrt(len(blocks)))
    data = blocks[:(w // 4) * (h // 4)]
    return (JT.Texture.new(info.fmt, data, w, h),
            PT.Texture.new(info.fmt, data, w, h))


def _fields(t):
    return (t.format, t.width, t.height, t.width_in_blocks,
            t.height_in_blocks, t.data.dtype.str, t.data.tobytes())


def _round_trip(kind, tmp_path, jtex, ptex):
    """Save with each package, load each file with the other: the bytes
    and the textures are equal, or both packages raise alike."""
    jfile, pfile = tmp_path / f"j.{kind}", tmp_path / f"p.{kind}"
    if kind == "raw":
        jsave, psave = (lambda t, f: JIO.save_raw(t, f)), \
            (lambda t, f: PIO.save_raw(t, f))
        jload = lambda f: [JIO.load_raw(f, jtex)]           # noqa: E731
        pload = lambda f: [PIO.load_raw(f, ptex)]           # noqa: E731
    else:
        jsave = lambda t, f: getattr(JIO, f"save_{kind}")([t], f)  # noqa
        psave = lambda t, f: getattr(PIO, f"save_{kind}")([t], f)  # noqa
        jload = getattr(JIO, f"load_{kind}")
        pload = getattr(PIO, f"load_{kind}")
    j = _outcome(jsave, jtex, str(jfile))
    p = _outcome(psave, ptex, str(pfile))
    assert (j is None) == (p is None) and (j is None or j == p), (j, p)
    if j is not None:
        return
    assert jfile.read_bytes() == pfile.read_bytes()
    got = _outcome(lambda f: [_fields(t) for t in pload(f)], str(jfile))
    assert got == _outcome(lambda f: [_fields(t) for t in jload(f)],
                           str(pfile))


@pytest.mark.parametrize("kind", ["ktx", "dds", "raw"])
@pytest.mark.parametrize("family", _FAMILIES)
def test_io_round_trip(tmp_path, family, kind):
    _round_trip(kind, tmp_path, *_textures(family))


@pytest.mark.parametrize("fmt", [JF.RGBA8, JF.RGB8, JF.R8, JF.RG8, JF.R16,
                                 JF.RGBA16, JF.FLOAT_RGBX16])
def test_io_uncompressed_round_trip(tmp_path, fmt):
    rng = np.random.default_rng(fmt & 0xFFFF)
    data = rng.integers(0, 256, 13 * 7 * JF.pixel_size(fmt), np.uint8)
    for kind in ("ktx", "dds", "raw", "png"):
        _round_trip(kind, tmp_path, JT.Texture.new(fmt, data, 13, 7),
                    PT.Texture.new(fmt, data, 13, 7))


def test_io_registry():
    from detex_tpu.io import registry as JR
    from detex_tpu_torch.io import registry as PR
    assert _plain(PR.TABLE) == _plain(JR.TABLE)
    assert sorted(_values(PR)) == sorted(_values(JR))
    for name, v in _values(JR).items():
        assert _plain(getattr(PR, name)) == _plain(v), name


# --- native, the BPTC tables ----------------------------------------------------


@pytest.mark.parametrize("family", sorted(JN.FAMILIES))
def test_native_decode(family):
    assert PN.FAMILIES == JN.FAMILIES
    assert PN.available() and JN.available()
    bb, ob = JN.family_info(family)
    assert PN.family_info(family) == (bb, ob)
    blocks = np.random.default_rng(JN.FAMILIES[family]).integers(
        0, 256, (4096, bb), np.uint8)
    for mm, fl in ((0xFFFFFFFF, 0), (0xFFFFFFFF, 2), (0xFFFFFFFF, 4),
                   (0x5, 0), (0xFFFFFFFF, 1)):
        p_out, p_valid = PN.decode(family, blocks, mm, fl)
        j_out, j_valid = JN.decode(family, blocks, mm, fl)
        np.testing.assert_array_equal(p_valid, j_valid)
        np.testing.assert_array_equal(p_out, j_out)
    out, _ = JN.decode(family, blocks)
    np.testing.assert_array_equal(
        PN.assemble_linear(out, 64, 64, 253, 250, ob // 16),
        JN.assemble_linear(out, 64, 64, 253, 250, ob // 16))


def test_native_sources_and_tables_are_copies():
    csrc = _REPO / "detex_tpu_torch" / "csrc" / "native"
    for name in ("dtxnative.cpp", "dtx_tables.h"):
        assert filecmp.cmp(csrc / name, _REPO / "native" / name,
                           shallow=False), name
    assert filecmp.cmp(_REPO / "detex_tpu_torch" / "data" / "bptc_tables.npz",
                       _REPO / "detex_tpu" / "data" / "bptc_tables.npz",
                       shallow=False)


# --- bptc_encode, metrics ---------------------------------------------------------


def test_bptc_encode_copy():
    """The synthetic-data encoders of the training envs: the same tables,
    and the same words and predicted values for the same images; the
    port's BC7 decode of its words gives the predicted values."""
    import torch

    import detex_tpu.ops.bptc_encode as JE
    import detex_tpu_torch.ops.bptc_encode as PE
    from detex_tpu_torch.ops import bptc

    assert sorted(_values(PE)) == sorted(_values(JE))
    for name, v in _values(JE).items():
        np.testing.assert_array_equal(getattr(PE, name), v)
    rng = np.random.default_rng(12)
    for size in (4, 16, 64):
        img = rng.integers(0, 256, (size, size), np.uint8)
        words = PE.encode_bc7_mode6_gray(img)
        np.testing.assert_array_equal(words, JE.encode_bc7_mode6_gray(img))
        pix, valid = bptc.decode_bptc(torch.from_numpy(words))
        assert bool(valid.all())
        blocks = img.reshape(size // 4, 4, size // 4, 4) \
            .transpose(0, 2, 1, 3).reshape(-1, 16)
        idx = (blocks >> 4).astype(np.int64)
        idx[:, 0] = np.minimum(idx[:, 0], 7)
        gray = PE.decode_mode6_gray_value(idx)
        np.testing.assert_array_equal(gray, JE.decode_mode6_gray_value(idx))
        np.testing.assert_array_equal(pix.numpy() & 0xFF, gray)
    rgba = rng.integers(0, 256, (37, 4), np.uint8)
    np.testing.assert_array_equal(PE.encode_bc7_mode5_solid(rgba),
                                  JE.encode_bc7_mode5_solid(rgba))
    np.testing.assert_array_equal(PE.decode_mode5_solid_value(rgba),
                                  JE.decode_mode5_solid_value(rgba))


def test_metrics_copy():
    import io
    import json

    import detex_tpu.utils.metrics as JM
    import detex_tpu_torch.utils.metrics as PM

    lines = []
    for mod in (JM, PM):
        buf = io.StringIO()
        log = mod.MetricsLogger(buf)
        with mod.Timer() as t:
            pass
        log.log(3, loss=np.float32(1.5), name="x", step_s=t.elapsed_s)
        rec = json.loads(buf.getvalue())
        assert rec.pop("t") >= 0 and rec.pop("step_s") >= 0
        lines.append(rec)
    assert lines[0] == lines[1] == {"step": 3, "loss": 1.5, "name": "x"}


def test_modes_copy():
    """ops/modes: the same functions, tables and entries, quirks included
    (no SET_MODE entry for ETC2_PUNCHTHROUGH; the signed BPTC_FLOAT
    aliases)."""
    import detex_tpu.ops.modes as JMO
    import detex_tpu_torch.ops.modes as PMO

    def functions(m):
        return sorted(k for k, v in vars(m).items() if callable(v)
                      and getattr(v, "__module__", None) == m.__name__)

    assert functions(PMO) == functions(JMO)
    assert sorted(_values(PMO)) == sorted(_values(JMO))
    for name in ("GET_MODE", "SET_MODE"):
        port, ref = getattr(PMO, name), getattr(JMO, name)
        assert {k: f.__name__ for k, f in port.items()} == \
            {k: f.__name__ for k, f in ref.items()}
    for name in ("_BPTC_FLOAT_MAP_MODE", "_BPTC_FLOAT_SET_MODE"):
        np.testing.assert_array_equal(getattr(PMO, name), getattr(JMO, name))
    assert PMO.get_mode_bptc_signed_float is PMO.get_mode_bptc_float
    assert PMO.set_mode_bptc_signed_float is PMO.set_mode_bptc_float
