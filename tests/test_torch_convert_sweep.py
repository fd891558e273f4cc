"""Every pixel conversion the host converter allows (tools/convert_sweep:
449 pairs of 34 formats, the 73 edges and every path of two to four
steps), run through the port's device conversion
(convert_device.convert_pixels_torch) and held bit-equal to the host
converter of the JAX package (detex_tpu.convert.convert_pixels, the
oracle golden-tested against the compiled reference), under the default
HDR parameters and under gamma 2.2 on [0, 4].  Each source format's buffer
holds NaN, +-inf, denormal and signed-zero patterns in every float lane
(0, the largest value and the signed limits in every integer lane) before
its random pixels; the buffers are made by tools/convert_sweep.py from
seeds.

The `cuda` test runs the same pairs on a card and skips here:
    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_convert_sweep.py
"""

import numpy as np
import pytest
import torch

import detex_tpu.convert as C
import detex_tpu.formats as F
import detex_tpu.hdr as H
from detex_tpu_torch import convert as PC
from detex_tpu_torch import hdr as PH
from detex_tpu_torch.tools import convert_sweep as CS

_FORMATS = CS.formats()
_IDS = [F.format_name(f) for f in _FORMATS]


def _set_both(*params):
    """The HDR parameters of the host oracle (detex_tpu.hdr) and of the
    port (detex_tpu_torch.hdr, which convert_device reads)."""
    H.set_hdr_parameters(*params)
    PH.set_hdr_parameters(*params)


@pytest.fixture
def both_hdr():
    yield _set_both
    _set_both(1.0, 0.0, 1.0)


def _check(device, src, set_hdr):
    out = CS.sweep(device, [src], oracle=C.convert_pixels, set_hdr=set_hdr)
    assert out["pairs"] == len(CS.pairs([src])) > 0
    assert out["differing"] == []


def test_sweep_covers_every_pair():
    """449 pairs over 34 formats, the host oracle's and the port's
    match_conversion agreeing on each path."""
    assert _FORMATS == sorted({s for s, _, _ in C.TABLE}
                              | {d for _, d, _ in C.TABLE})
    every = CS.pairs()
    assert len(_FORMATS) == 34 and len(every) == 449
    assert every == [(s, d) for s in _FORMATS for d in _FORMATS
                     if s != d and C.match_conversion(s, d) is not None]
    steps = [len(C.match_conversion(s, d)) for s, d in every]
    assert [steps.count(k) for k in (1, 2, 3, 4)] == [73, 115, 138, 123]
    assert all(PC.match_conversion(s, d) == C.match_conversion(s, d)
               for s, d in every)


@pytest.mark.parametrize("fmt", _FORMATS, ids=_IDS)
def test_sweep_buffer_forces_every_pattern(fmt):
    """Each special value fills every lane of one row, and the rotated rows
    put it beside the others; the buffer is the same for the same seed."""
    buf, n = CS.sweep_buffer(fmt, 5)
    size = F.component_size(fmt)
    lanes = F.pixel_size(fmt) // size
    assert buf.dtype == np.uint8 and buf.size == n * F.pixel_size(fmt)
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[size]
    px = buf.view(dtype).reshape(n, lanes)
    sp = CS._specials(fmt)
    for k, v in enumerate(sp):
        assert (px[k] == v).all()
    for lane in range(lanes):
        assert set(px[:2 * sp.size, lane]) == set(sp)
    again, _ = CS.sweep_buffer(fmt, 5)
    np.testing.assert_array_equal(buf, again)


@pytest.mark.parametrize("src", _FORMATS, ids=_IDS)
def test_every_pair_bit_equal_to_host(src, both_hdr):
    _check("cpu", src, both_hdr)


def test_sweep_names_a_differing_pair(monkeypatch, both_hdr):
    """A conversion that is off by one byte on one pair is reported with
    its pair and HDR parameters, and leaves the HDR parameters as found."""
    convert_pixels = CS.CD.convert_pixels_torch

    def wrong(buf, n, src, dst, device):
        out = convert_pixels(buf, n, src, dst, device)
        if (src, dst) == (F.FLOAT_RGBX16, F.RGBA8):
            out = out.copy()
            out[0] ^= 1
        return out
    monkeypatch.setattr(CS.CD, "convert_pixels_torch", wrong)
    both_hdr(1.8, 0.0, 2.0)
    out = CS.sweep("cpu", [F.FLOAT_RGBX16], oracle=C.convert_pixels,
                   set_hdr=both_hdr)
    assert out["differing"] == [
        ["FLOAT_RGBX16", "RGBA8", list(p), 1] for p in CS.HDR_SETTINGS]
    p = PH.get_hdr_parameters()
    assert (p.gamma, p.range_min, p.range_max) == (1.8, 0.0, 2.0)


def test_main_on_the_cpu(capsys):
    row = CS.main(["--device", "cpu", "RGBA8", "FLOAT_R16"])
    assert row["pairs"] == len(CS.pairs([F.RGBA8, F.FLOAT_R16]))
    assert row["differing"] == [] and row["device"] == "cpu"


def test_sweep_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CS.main([])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the conversion runs there)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("src", _FORMATS, ids=_IDS)
def test_cuda_every_pair_bit_equal_to_host(cuda, src, both_hdr):
    _check(cuda, src, both_hdr)
