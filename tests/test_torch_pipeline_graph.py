"""The texture engine's one-program form (engine._device_pipeline and
_pipeline_body; convert_device.convert_pixels_torch and
convert_pixels_graphed; graphs.Program): on the CPU, the pipelines and the
uncompressed conversion staying eager, the tiled pipeline against the
native runtime, and the pieces changed so that a capture can hold a
conversion (the constants of convert_device._scalar, filled on the device,
bit-equal to the host copies they replace; the R/B swap by slices; the HDR
table fetched before a capture).  Tests marked `cuda` hold every graphed
texture call to the eager pipeline on a card and skip here.

Tolerance: none.  Every decode and conversion is bit-exact, so graphed,
eager and native bytes are equal.
"""

import collections
import contextlib

import numpy as np
import pytest
import torch

from detex_tpu_torch import convert as C
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch import engine, graphs, hdr
from detex_tpu_torch import formats as F
from detex_tpu_torch.texture import Texture

_FAMILIES = ("BC1", "BC1A", "BC2", "BC3", "RGTC1", "SIGNED_RGTC1", "RGTC2",
             "SIGNED_RGTC2", "BPTC_FLOAT", "BPTC_SIGNED_FLOAT", "BPTC",
             "ETC1", "ETC2", "ETC2_PUNCHTHROUGH", "ETC2_EAC", "EAC_R11",
             "EAC_SIGNED_R11", "EAC_RG11", "EAC_SIGNED_RG11")
# The HDR parameter sets of tests/test_torch_convert_device.py.
_HDR_SETS = ((1.0, 0.1, 2.0), (1.0, -1.0, 1.0), (1.0, 0.0, 2.0),
             (2.2, 0.0, 4.0), (0.5, -1.0, 3.0))
_TARGETS = (F.BGRA8, F.RGBA8, F.RGBX16, F.FLOAT_RGB16, F.R16, F.RG16, F.R8)


def _texture(family, width, height, seed):
    fmt = F.BY_NAME[family].fmt
    n = -(-width // 4) * -(-height // 4)
    words = np.random.default_rng(seed).integers(
        0, 256, (n, F.block_size_bytes(fmt)), np.uint8)
    return Texture.new(fmt, words, width, height)


def _target(fmt):
    """A pixel format other than fmt's own that fmt converts to, or None
    (signed half floats convert to nothing)."""
    src = F.texture_pixel_format(fmt)
    return next((t for t in _TARGETS
                 if t != src and C.match_conversion(src, t) is not None),
                None)


@contextlib.contextmanager
def _hdr(params):
    if params is None:
        yield
        return
    hdr.set_hdr_parameters(*params)
    try:
        yield
    finally:
        hdr.set_hdr_parameters(1.0, 0.0, 1.0)


def _eager(tex, pf, mode_mask=0xFFFFFFFF, flags=0, tiled=False,
           device="cpu"):
    """The eager pipeline's bytes."""
    pf = pf or F.texture_pixel_format(tex.format)
    body = engine._pipeline_body(tex.format, pf, tex.width_in_blocks,
                                 tex.height_in_blocks, tex.width, tex.height,
                                 tiled, mode_mask, flags)
    return CD.to_bytes(body(engine._texture_words(tex, device)))


@pytest.fixture
def no_graphs(monkeypatch):
    def refuse(key, make, *args):
        raise AssertionError(f"a graph on the CPU: {key}")
    monkeypatch.setattr(graphs, "program", refuse)
    monkeypatch.setattr(graphs, "run", refuse)


@pytest.mark.parametrize("family", ["BC1", "ETC2_EAC", "BPTC_FLOAT"])
def test_cpu_pipelines_stay_eager(no_graphs, family):
    """On the CPU the texture calls and the pipeline from words run the
    eager body, linear and tiled, native and converted."""
    tex = _texture(family, 29, 14, 1)
    for pf in (None, _target(tex.format)):
        for tiled, fn in ((False, engine.decompress_texture_linear),
                          (True, engine.decompress_texture_tiled)):
            got = fn(tex, pf, backend="device", device="cpu")
            np.testing.assert_array_equal(got, _eager(tex, pf, tiled=tiled))
        pipeline = engine._device_pipeline(
            tex.format, pf or F.texture_pixel_format(tex.format),
            tex.width_in_blocks, tex.height_in_blocks, tex.width,
            tex.height)
        np.testing.assert_array_equal(
            CD.to_bytes(pipeline(engine._texture_words(tex, "cpu"))),
            _eager(tex, pf))


@pytest.mark.parametrize("family", ["BC3", "EAC_SIGNED_RG11", "BPTC"])
def test_tiled_pipeline_vs_native(family):
    tex = _texture(family, 21, 10, 2)
    pf = _target(tex.format)
    pipeline = engine._device_pipeline(
        tex.format, pf, tex.width_in_blocks, tex.height_in_blocks,
        tex.width, tex.height, tiled=True)
    tiles = pipeline(engine._texture_words(tex, "cpu"))
    assert tuple(tiles.shape[:2]) == (tex.n_blocks, 16)
    np.testing.assert_array_equal(
        CD.to_bytes(tiles),
        engine.decompress_texture_tiled(tex, pf, backend="native"))


def test_cpu_conversion_stays_eager(no_graphs):
    buf = np.random.default_rng(3).integers(0, 256, 64 * 8, np.uint8)
    np.testing.assert_array_equal(
        CD.convert_pixels_torch(buf, 64, F.RGBX16, F.FLOAT_RGBX16, "cpu"),
        C.convert_pixels(buf, 64, F.RGBX16, F.FLOAT_RGBX16))


def test_scalar_constants_bit_equal_to_host_copies():
    """_scalar fills its constant on the device; each constant of the HDR
    maps (for every parameter set the tests use) and of the u16 -> f16
    edges is bit-equal to the host copy it replaces,
    torch.tensor(np.float32(x))."""
    consts = [1 / 65535]
    for gamma, lo, hi in _HDR_SETS:
        if gamma == 1.0:
            consts += CD.gamma1_constants(lo, hi)
        else:
            consts += CD.gamma_f32_constants(hdr.HDRParams(gamma, lo, hi))
    like = torch.zeros(3, dtype=torch.int64)
    for x in consts:
        got = CD._scalar(x, like)
        want = torch.tensor(np.float32(x), dtype=torch.float32)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.view(torch.int32) == want.view(torch.int32), x


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int16])
def test_swap_rb_equals_the_list_index(dtype):
    a = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (37, 4), np.uint8)).to(dtype) * 3
    assert torch.equal(CD._swap_rb(a), a[:, [2, 1, 0, 3]])


def test_tables_before_a_capture(monkeypatch):
    """The HDR f16 -> u16 edge at gamma != 1 reads the table tables()
    returns (the same tensor the conversion gathers from); at gamma 1 and
    on other paths there is none."""
    with _hdr((2.2, 0.0, 4.0)):
        (lut,) = CD.tables(F.FLOAT_RGBX16_HDR, F.RGBX16,
                           torch.device("cpu"))
        p = hdr.get_hdr_parameters()
        assert lut is CD._gamma_u16_lut(p.gamma, p.range_min, p.range_max,
                                        torch.device("cpu"))
        assert CD.hdr_params_key() == (2.2, 0.0, 4.0)
        assert CD.tables(F.FLOAT_RGBX16, F.RGBX16, "cpu") == ()
    assert CD.tables(F.FLOAT_RGBX16_HDR, F.RGBX16, "cpu") == ()
    assert CD.tables(F.RGBA8, F.BGRA8, "cpu") == ()


def test_owned_copies_only_the_input_itself():
    a = torch.arange(8)
    assert CD._owned(a, a) is not a and torch.equal(CD._owned(a, a), a)
    b = a + 1
    assert CD._owned(b, a) is b


def test_program_refuses_another_shape():
    def captured():
        prog = graphs.Program(lambda a: a)
        prog.calls, prog.input = 1, torch.zeros((4, 2), dtype=torch.int32)
        return prog
    with pytest.raises(ValueError, match="expected"):
        captured()(torch.zeros((4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="expected"):
        captured()(torch.zeros((4, 2), dtype=torch.int64))


def test_program_runs_its_first_call_eagerly():
    """A program's first call is fn(x), fresh and with no graph (a key
    called once keeps no pool); its second needs a card to capture."""
    prog = graphs.Program(lambda a: a * 2)
    x = torch.arange(6, dtype=torch.int32)
    assert torch.equal(prog(x), x * 2)
    assert prog.graph is None and prog.input is None
    with pytest.raises(ValueError, match="CUDA"):
        prog(x)


def test_run_reads_under_the_lock(monkeypatch):
    """run() makes the key's program once, calls it and applies read to
    its result while it holds the lock that every texture call takes."""
    monkeypatch.setattr(graphs, "_PROGRAMS", collections.OrderedDict())
    made = []

    def make():
        made.append(1)
        return graphs.Program(lambda a: a + 1)

    def read(out):
        assert graphs._LOCK._is_owned()
        return out.tolist()
    x = torch.arange(3)
    assert graphs.run("k", make, x, read) == [1, 2, 3]
    assert torch.equal(graphs.run("j", make, x), x + 1)
    assert len(made) == 2 and graphs._PROGRAMS["k"].calls == 1


# --- on a card -------------------------------------------------------------


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs have no CPU mode)")
    monkeypatch.setattr(graphs, "_PROGRAMS", collections.OrderedDict())
    return torch.device("cuda")


def _calls(family):
    """(label, texture, pixel format, HDR parameters): native and
    converted at 1024^2, BC6H also through the HDR map at gamma 2.2, and
    native cropped to 4093 x 4090."""
    tex = _texture(family, 1024, 1024, 7)
    calls = [("native", tex, None, None)]
    if _target(tex.format) is not None:
        calls.append(("converted", tex, _target(tex.format), None))
    if family == "BPTC_FLOAT":
        calls.append(("HDR", Texture.new(tex.format | F.HDR, tex.data, 1024,
                                         1024), F.RGBX16, (2.2, 0.0, 4.0)))
    calls.append(("cropped", _texture(family, 4093, 4090, 8), None, None))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("family", _FAMILIES)
def test_cuda_graphed_texture_calls_vs_eager(cuda, family):
    """Each call, linear and tiled, three times: the key's first call
    eager (one launch), its second the capture (GRAPH_WARMUP warm-ups and
    a replay), its third a replay (one launch); each byte-equal to the
    eager pipeline on the card and, natively, to the native runtime."""
    for label, tex, pf, params in _calls(family):
        with _hdr(params):
            for tiled, fn in ((False, engine.decompress_texture_linear),
                              (True, engine.decompress_texture_tiled)):
                before = sum(graphs.launch_counts().values())
                got = [fn(tex, pf, backend="device", device=cuda)
                       for _ in range(3)]
                launched = sum(graphs.launch_counts().values()) - before
                assert launched == graphs.GRAPH_WARMUP + 3, (label, tiled)
                assert graphs._PROGRAMS[next(reversed(graphs._PROGRAMS))] \
                    .graph.graph is not None
                want = _eager(tex, pf, tiled=tiled, device=cuda)
                for out in got:
                    np.testing.assert_array_equal(out, want, err_msg=label)
                got = got[0]
                if pf is None:
                    np.testing.assert_array_equal(
                        got, fn(tex, pf, backend="native"), err_msg=label)


@pytest.mark.cuda
def test_cuda_new_words_and_owned_results(cuda):
    """Calls of one key with new words give the new image; a _device
    result is the caller's and survives later calls (the key's capture
    and replays), while the pipeline's own result, once the key is
    captured, is the graph's output, which the next call overwrites."""
    t1, t2 = (_texture("ETC2_EAC", 64, 60, s) for s in (1, 2))
    a = engine.decompress_texture_linear_device(t1, F.RGBA8, device=cuda)
    b = engine.decompress_texture_linear_device(t2, F.RGBA8, device=cuda)
    tiles = engine.decompress_texture_tiled_device(t1, F.RGBA8, device=cuda)
    engine.decompress_texture_tiled_device(t2, F.RGBA8, device=cuda)
    engine.decompress_texture_tiled_device(t2, F.RGBA8, device=cuda)
    pipeline = engine._device_pipeline(t1.format, F.RGBA8, 16, 15, 64, 60)
    first = pipeline(engine._texture_words(t1, cuda))
    np.testing.assert_array_equal(CD.to_bytes(first), _eager(t1, F.RGBA8))
    second = pipeline(engine._texture_words(t2, cuda))
    assert first.data_ptr() == second.data_ptr()
    np.testing.assert_array_equal(CD.to_bytes(first), _eager(t2, F.RGBA8))
    np.testing.assert_array_equal(CD.to_bytes(a), _eager(t1, F.RGBA8))
    np.testing.assert_array_equal(CD.to_bytes(b), _eager(t2, F.RGBA8))
    np.testing.assert_array_equal(CD.to_bytes(tiles),
                                  _eager(t1, F.RGBA8, tiled=True))


@pytest.mark.cuda
def test_cuda_key_changes_capture_new_graphs(cuda):
    """A change of HDR parameters, mode_mask or flags makes a new program
    (its key holds them), captured at its second call, each call
    byte-equal to the eager pipeline; the cache keeps graphs.PROGRAMS_KEPT
    of them."""
    tex = _texture("BPTC_FLOAT", 64, 64, 3)
    hdr_tex = Texture.new(tex.format | F.HDR, tex.data, 64, 64)
    cases = [(hdr_tex, F.RGBX16, 0xFFFFFFFF, 0, (1.0, 0.0, 1.0)),
             (hdr_tex, F.RGBX16, 0xFFFFFFFF, 0, (2.2, 0.0, 4.0)),
             (hdr_tex, F.RGBX16, 0xFFFFFFFF, 0, (1.0, 0.1, 2.0)),
             (tex, F.RGBA8, 0x1555, 0, None),
             (_texture("ETC2_EAC", 64, 64, 3), F.RGBA8, 0xFFFFFFFF, 0x1,
              None),
             (_texture("ETC2_EAC", 64, 64, 3), F.RGBA8, 0xFFFFFFFF, 0,
              None)]
    for i, (t, pf, mm, fl, params) in enumerate(cases):
        with _hdr(params):
            for _ in range(2):
                got = engine.decompress_texture_linear(t, pf, mm, fl,
                                                       backend="device",
                                                       device=cuda)
                np.testing.assert_array_equal(got, _eager(t, pf, mm, fl))
        assert len(graphs._PROGRAMS) == min(i + 1, graphs.PROGRAMS_KEPT)
        assert graphs._PROGRAMS[next(reversed(graphs._PROGRAMS))] \
            .graph.graph is not None


@pytest.mark.cuda
def test_cuda_replays_under_sync_debug(cuda):
    """A BC6H -> RGBA8 pipeline replay and a u16 -> f16 conversion replay
    enqueue nothing that waits for the card."""
    tex = _texture("BPTC_FLOAT", 256, 256, 4)
    pipeline = engine._device_pipeline(tex.format, F.RGBA8, 64, 64, 256, 256)
    words = engine._texture_words(tex, cuda)
    buf = np.random.default_rng(6).integers(0, 256, 4096 * 8, np.uint8)
    arr = CD.from_bytes(buf, 4096, F.RGBX16, cuda)
    for _ in range(2):      # the eager call, then the capture
        pipeline(words)
        CD.convert_pixels_graphed(arr, F.RGBX16, F.FLOAT_RGBX16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        img = pipeline(words)
        half = CD.convert_pixels_graphed(arr, F.RGBX16, F.FLOAT_RGBX16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_array_equal(CD.to_bytes(img), _eager(tex, F.RGBA8))
    np.testing.assert_array_equal(
        CD.to_bytes(half), C.convert_pixels(buf, 4096, F.RGBX16,
                                            F.FLOAT_RGBX16))


@pytest.mark.cuda
@pytest.mark.parametrize("src,dst", [(F.RGBA8, F.RGBA8), (F.RGBA8, F.BGRA8),
                                     (F.FLOAT_RGBX16_HDR, F.RGBX16)])
def test_cuda_graphed_conversion_vs_host(cuda, src, dst):
    """The uncompressed route, eager, then captured, then replayed:
    byte-equal to the host converter, the identity path too (the graph
    copies its input)."""
    n = 5000
    buf = np.random.default_rng(9).integers(0, 256, n * F.pixel_size(src),
                                            np.uint8)
    with _hdr((2.2, 0.0, 4.0)):
        for _ in range(3):
            np.testing.assert_array_equal(
                CD.convert_pixels_torch(buf, n, src, dst, cuda),
                C.convert_pixels(buf, n, src, dst))
