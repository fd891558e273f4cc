"""Device pixel conversion of the PyTorch port (detex_tpu_torch.
convert_device), run here on the CPU, against the host oracle
(detex_tpu.convert and detex_tpu.hdr, golden-tested against the compiled
reference) and the JAX package's detex_tpu.convert_device, byte for byte.

Denormals: XLA flushes f32 denormals, so JAX's device conversion is held
to the host oracle only outside the pixels whose HDR f32 chain passes
through the denormal range (tests/test_convert_device.py _ftz_pixels).  On
the f32 HDR cases of tests/golden/convert.npz JAX's edges differ from the
compiled reference on 51, 54 and 17 pixels of three parameter sets, all of
them inside that filter.  The port needs no such exclusion: torch keeps
denormals and its downward-rounded f32 operations are computed exactly in
float64, as the oracle computes them, so it is held to the host oracle and
the goldens on every pixel of every edge, and to JAX's edges outside the
pixels `_ftz_pixels` excludes.

The `cuda` tests run the same edges on a card against the host oracle;
they skip here and need no JAX:
    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_convert_device.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import detex_tpu.convert as C
import detex_tpu.formats as F
import detex_tpu.hdr as H
from detex_tpu_torch import convert_device as CD

_GOLDEN = Path(__file__).resolve().parent / "golden" / "convert.npz"
_N = 2048
with np.load(_GOLDEN) as _g:
    _N_PAIRS, _N_HDR = int(_g["n_pairs"]), int(_g["n_hdr"])


def _random_buf(rng, src_fmt, n):
    """Random pixels with float special values injected, as
    tests/test_convert_device.py draws them (repeated here: the card's
    machine has no JAX)."""
    buf = rng.integers(0, 256, size=n * F.pixel_size(src_fmt),
                       dtype=np.uint8)
    if F.is_float(src_fmt):
        if F.component_size(src_fmt) == 2:
            sp = np.array([0x0000, 0x8000, 0x3C00, 0x7C00, 0xFC00, 0x7E00,
                           0xFFFF, 0x0001, 0x8001, 0x03FF, 0x7BFF],
                          np.uint16)
            buf.view(np.uint16)[:sp.size] = sp
        else:
            sp = np.array([0, 0x80000000, 0x3F800000, 0x7F800000,
                           0xFF800000, 0x7FC00000, 0x7F7FFFFF, 0x3F000000],
                          np.uint32)
            buf.view(np.uint32)[:sp.size] = sp
    return buf


@pytest.fixture(scope="module")
def jx():
    """JAX's device conversion (detex_tpu.convert_device) and the pixel
    filter of its tests (tests/test_convert_device.py _ftz_pixels)."""
    import jax
    import detex_tpu.convert_device as jcd
    from test_convert_device import _ftz_pixels
    return jax, jcd, _ftz_pixels


def _port_edge(i, buf, n, device="cpu"):
    src = C.TABLE[i][0]
    return CD.to_bytes(CD.DEVICE_TABLE[i](CD.from_bytes(buf, n, src, device)))


def _jax_edge(jx, i, buf, n):
    jax, jcd, _ = jx
    fn = jax.jit(lambda a: jcd.DEVICE_TABLE[i](a))
    return jcd.to_bytes(np.asarray(fn(jcd.from_bytes(buf, n, C.TABLE[i][0]))))


@pytest.fixture
def hdr_params():
    """Sets detex_tpu.hdr's parameters; the defaults come back after the
    test, failing or not."""
    yield H.set_hdr_parameters
    H.set_hdr_parameters(1.0, 0.0, 1.0)


@pytest.mark.parametrize("edge_i", range(len(C.TABLE)),
                         ids=[f"{F.format_name(s)}->{F.format_name(d)}"
                              for s, d, _ in C.TABLE])
def test_edge_parity(jx, edge_i):
    """Each edge matches its host edge and JAX's device edge bit for
    bit."""
    src, _, host_fn = C.TABLE[edge_i]
    buf = _random_buf(np.random.default_rng(edge_i), src, _N)
    host = np.ascontiguousarray(host_fn(buf, _N), np.uint8)
    port = _port_edge(edge_i, buf, _N)
    np.testing.assert_array_equal(port, host)
    np.testing.assert_array_equal(port, _jax_edge(jx, edge_i, buf, _N))


def _hdr_edges():
    return [i for i, (s, _, _) in enumerate(C.TABLE) if F.is_hdr(s)]


def _check_hdr_edges(jx, seed0, cmin, span, device="cpu"):
    """Every HDR edge: the port equal to the host oracle on every pixel,
    and to JAX's edge outside the pixels its tests exclude (f32 chains
    through the denormal range; cmin and span are the range map's offset
    and scale)."""
    for i in _hdr_edges():
        src, dst, host_fn = C.TABLE[i]
        name = f"{F.format_name(src)}->{F.format_name(dst)}"
        buf = _random_buf(np.random.default_rng(seed0 + i), src, _N)
        host = np.ascontiguousarray(host_fn(buf, _N), np.uint8)
        port = _port_edge(i, buf, _N, device)
        np.testing.assert_array_equal(port, host, err_msg=name)
        if jx is None:
            continue
        mism = (port != _jax_edge(jx, i, buf, _N)).reshape(_N, -1)
        mism &= ~jx[2](buf, src, cmin, span, _N)[:, None]
        assert not mism.any(), (name, int(mism.sum()))


def _gamma_range(gamma, rmin, rmax):
    """The f32 range map's offset and span at gamma != 1: the range
    endpoints raised to 1 / gamma (hdr.c:188-206)."""
    inv_g = float(np.float32(1.0) / np.float32(gamma))
    cmin, cmax = (float(np.asarray(H._signed_powf(np.float32(r), inv_g))
                        .item()) for r in (rmin, rmax))
    return cmin, cmax - cmin


@pytest.mark.parametrize("rmin,rmax", [(0.1, 2.0), (-1.0, 1.0),
                                       (0.0, 2.0)])
def test_hdr_edges_range_params(jx, hdr_params, rmin, rmax):
    """Gamma 1 with other ranges: the FE_DOWNWARD range map matches the
    host oracle on every pixel, denormal ones included."""
    hdr_params(1.0, rmin, rmax)
    _check_hdr_edges(jx, 1000, rmin,
                     float(np.float32(rmax) - np.float32(rmin)))


@pytest.mark.parametrize("gamma,rmin,rmax", [(2.2, 0.0, 1.0),
                                             (2.2, 0.0, 4.0),
                                             (0.5, -1.0, 3.0),
                                             (1.8, 0.25, 2.0)])
def test_hdr_edges_special_gamma(jx, hdr_params, gamma, rmin, rmax):
    """Gamma != 1: the half edges gather the host-built table, the f32 ones
    are FE_TONEAREST arithmetic; both exact on every pixel."""
    hdr_params(gamma, rmin, rmax)
    _check_hdr_edges(jx, 2000, *_gamma_range(gamma, rmin, rmax))


def test_gamma_table_cached_per_parameters(hdr_params):
    """The gamma != 1 table is built and uploaded once per HDR parameters
    and device, not per edge or per call."""
    hdr_params(2.2, 0.0, 4.0)
    buf = np.random.default_rng(5).integers(0, 256, 64 * 8, np.uint8)
    CD.convert_pixels_torch(buf, 64, F.FLOAT_RGBX16_HDR, F.RGBX16)
    builds = CD._gamma_u16_lut_host.cache_info().misses
    uploads = CD._gamma_u16_lut.cache_info().misses
    out = CD.convert_pixels_torch(buf, 64, F.FLOAT_RGBX16_HDR, F.RGBX16)
    assert CD._gamma_u16_lut_host.cache_info().misses == builds
    assert CD._gamma_u16_lut.cache_info().misses == uploads
    np.testing.assert_array_equal(
        out, C.convert_pixels(buf, 64, F.FLOAT_RGBX16_HDR, F.RGBX16))
    hdr_params(1.8, 0.0, 4.0)
    CD.convert_pixels_torch(buf, 64, F.FLOAT_RGBX16_HDR, F.RGBX16)
    assert CD._gamma_u16_lut_host.cache_info().misses == builds + 1


@pytest.mark.parametrize("dst", [F.FLOAT_R32, F.R16],
                         ids=["FLOAT_R32", "R16"])
def test_every_half_value(dst):
    """The half edges on all 65,536 half values, denormals, infinities and
    NaNs included, against the host oracle (the port casts half to float
    natively)."""
    buf = np.arange(65536, dtype=np.uint16).view(np.uint8)
    np.testing.assert_array_equal(
        CD.convert_pixels_torch(buf, 65536, F.FLOAT_R16, dst),
        C.convert_pixels(buf, 65536, F.FLOAT_R16, dst))


def test_multi_step_path_parity(jx):
    """A conversion of several steps runs the host's step sequence (path
    identity is part of bit-exactness, convert.c:888-1048)."""
    jcd = jx[1]
    rng = np.random.default_rng(7)
    for src, dst in [(F.RGB8, F.RGBA16), (F.FLOAT_RGB32, F.RGBX16),
                     (F.RGBA8, F.FLOAT_RGBX16), (F.SIGNED_R16, F.FLOAT_R16),
                     (F.FLOAT_RGBX16, F.RGBA8), (F.FLOAT_RGBX16, F.BGRA8)]:
        buf = _random_buf(rng, src, _N)
        host = C.convert_pixels(buf, _N, src, dst)
        np.testing.assert_array_equal(
            CD.convert_pixels_torch(buf, _N, src, dst), host)
        np.testing.assert_array_equal(
            jcd.convert_pixels_jax(buf, _N, src, dst), host)


def test_down_ops_positive_overflow_yields_flt_max():
    """FE_DOWNWARD positive overflow from finite inputs is +FLT_MAX (round
    to nearest gives +inf, and the step down from it FLT_MAX); infinite
    inputs stay inf."""
    fmax = float(np.finfo(np.float32).max)

    def f32(x):
        return torch.tensor([x], dtype=torch.float32)

    assert float(CD.down_sub(f32(3.0e38), f32(-3.0e38))) == fmax
    assert float(CD.down_mul(f32(2e19), f32(2e19))) == fmax
    assert float(H._down_sub_f32(np.float32(3.0e38),
                                 np.float32(-3.0e38))) == fmax
    assert np.isinf(float(CD.down_sub(f32(np.inf), f32(1.0))))


def test_down_ops_round_toward_minus_infinity():
    """down_sub and down_mul against the host's float64 emulation on
    random operands from 1e-45 to 1e37 (denormal results included; a third
    of the products round down)."""
    rng = np.random.default_rng(11)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-22, 18, 4096)) \
        .astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.integers(-22, 18, 4096)) \
        .astype(np.float32)
    want_sub = H._down_sub_f32(a, b)
    want_mul = H._down32(a.astype(np.float64) * b.astype(np.float64))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(CD.down_sub(ta, tb).numpy(), want_sub)
    np.testing.assert_array_equal(CD.down_mul(ta, tb).numpy(), want_mul)
    assert (want_mul < (a.astype(np.float64) * b)).mean() > 0.3


def test_all_edges_supported_any_gamma(hdr_params):
    """Every path the host can take runs on the device for any HDR
    parameters; a pair with no path raises ConversionError, as the host
    converter does."""
    for gamma in (1.0, 2.2):
        hdr_params(gamma, 0.0, 2.0)
        for src, dst, _ in C.TABLE:
            assert C.match_conversion(src, dst) is not None
    assert C.match_conversion(F.A8, F.FLOAT_RGBA32) is None
    with pytest.raises(C.ConversionError):
        CD.convert_pixels_torch(np.zeros(4, np.uint8), 4, F.A8,
                                F.FLOAT_RGBA32)


def test_representation():
    """Lanes: uint8 for 8-bit components, int16 for 16-bit integer and
    half formats, int32 for f32 (as bits); bytes round-trip."""
    rng = np.random.default_rng(3)
    for fmt, dtype in ((F.RGBA8, torch.uint8), (F.R16, torch.int16),
                       (F.FLOAT_RGBX16, torch.int16),
                       (F.FLOAT_RGB32, torch.int32)):
        buf = rng.integers(0, 256, 5 * F.pixel_size(fmt), np.uint8)
        t = CD.from_bytes(buf, 5, fmt)
        assert t.dtype == dtype == CD.repr_dtype(fmt)
        assert t.shape == (5, CD.repr_lanes(fmt))
        np.testing.assert_array_equal(CD.to_bytes(t), buf)
        np.testing.assert_array_equal(
            CD.convert_pixels_torch(buf, 5, fmt, fmt), buf)


@pytest.mark.parametrize("pair", range(_N_PAIRS))
def test_golden_pairs(pair):
    """The 85 format pairs of tests/golden/convert.npz (the compiled
    reference's output), each along its whole path."""
    g = np.load(_GOLDEN)
    src, dst = int(g[f"pair{pair}_src_fmt"]), int(g[f"pair{pair}_dst_fmt"])
    out = CD.convert_pixels_torch(g[f"pair{pair}_src"], int(g["n_pixels"]),
                                  src, dst)
    np.testing.assert_array_equal(
        out, g[f"pair{pair}_out"],
        err_msg=f"{F.format_name(src)}->{F.format_name(dst)}")


@pytest.mark.parametrize("case", range(_N_HDR))
def test_golden_hdr(hdr_params, case):
    """The 5 HDR parameter sets of tests/golden/convert.npz: FLOAT_RGBX16_HDR
    -> RGBX16 and FLOAT_RGBX32_HDR -> FLOAT_RGBX32."""
    g = np.load(_GOLDEN)
    gamma, rmin, rmax = (float(x) for x in g[f"hdr{case}_params"])
    hdr_params(gamma, rmin, rmax)
    n = int(g["n_pixels"])
    np.testing.assert_array_equal(
        CD.convert_pixels_torch(g[f"hdr{case}_src"], n, F.FLOAT_RGBX16_HDR,
                                F.RGBX16), g[f"hdr{case}_out"])
    np.testing.assert_array_equal(
        CD.convert_pixels_torch(g[f"hdr{case}_src32"], n,
                                F.FLOAT_RGBX32_HDR, F.FLOAT_RGBX32),
        g[f"hdr{case}_out32"])


# --- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA path has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("edge_i", range(len(C.TABLE)),
                         ids=[f"{F.format_name(s)}->{F.format_name(d)}"
                              for s, d, _ in C.TABLE])
def test_cuda_edge_vs_host(cuda, edge_i):
    """Each edge on the card equals the host oracle byte for byte (CUDA's
    elementwise kernels keep denormals, as the CPU does)."""
    src, _, host_fn = C.TABLE[edge_i]
    buf = _random_buf(np.random.default_rng(edge_i), src, _N)
    np.testing.assert_array_equal(
        _port_edge(edge_i, buf, _N, cuda),
        np.ascontiguousarray(host_fn(buf, _N), np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("gamma,rmin,rmax", [(1.0, 0.1, 2.0),
                                             (1.0, -1.0, 1.0),
                                             (1.0, 0.0, 2.0),
                                             (2.2, 0.0, 4.0),
                                             (0.5, -1.0, 3.0)])
def test_cuda_hdr_edges_vs_host(cuda, hdr_params, gamma, rmin, rmax):
    hdr_params(gamma, rmin, rmax)
    _check_hdr_edges(None, 3000, None, None, cuda)
