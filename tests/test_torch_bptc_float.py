"""BC6H (BPTC_FLOAT and BPTC_SIGNED_FLOAT) in the PyTorch port: the plain
versions (the wrappers on CPU tensors) and the CUDA kernel's own per-block
code (csrc/bc6h.cuh, built for the host with g++) must be bit-exact
(tolerance 0) to the JAX package's Pallas kernel (through the Pallas
interpreter), to its jnp decoder, to the golden vectors and to the native
C++ runtime, on every payload word and valid flag, under several mode
masks.

The blocks are random, then drawn with their mode code uniform over the 14
modes and the 4 reserved codes (chip_smoke.bc6h_mode_blocks, which the
card's smoke run uses too), so every mode, reversed fields and invalid
blocks are covered.

The CUDA kernel itself runs only on a card: those tests are marked `cuda`
and skip here.  The card's machine has no JAX, so this module imports the
JAX package only inside fixtures; run the card's tests there with
    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_bptc_float.py
"""

import ctypes
import re
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import bc6h_mode_blocks
from detex_tpu_torch.ops import bitops, bptc_float

_REPO = Path(__file__).resolve().parent.parent
_CSRC = _REPO / "detex_tpu_torch" / "csrc"
_GOLDEN_DIR = _REPO / "tests" / "golden"
_FULL = 0xFFFFFFFF
# (mode_mask, flags): all modes, every other mode (two ways), single
# modes; flags are ignored by BC6H, one setting shows it.
_SETTINGS = [(_FULL, 0), (0x3FFF, 0), (0x2AAA, 0), (0x1555, 0), (0x1000, 0),
             (0x2000, 0), (0x0001, 0), (_FULL, 0x6)]
_SETTING_IDS = [f"mask{mm:x}-flags{fl}" for mm, fl in _SETTINGS]

# variant -> (wrapper, golden family, instantiation of the host build)
_VARIANTS = {
    "bptc_float": ("decode_bptc_float", "BPTC_FLOAT", 0),
    "bptc_signed_float": ("decode_bptc_signed_float", "BPTC_SIGNED_FLOAT",
                          1),
}
_NAMES = list(_VARIANTS)


def _wrapper(variant):
    return getattr(bptc_float, _VARIANTS[variant][0])


def _plain(variant):
    return getattr(bptc_float, _VARIANTS[variant][0] + "_plain")


def _blocks(variant):
    """1024 random blocks, then 1024 with uniform mode codes (fixed
    seed)."""
    rng = np.random.default_rng(_NAMES.index(variant) + 61)
    return np.concatenate([rng.integers(0, 256, (1024, 16), np.uint8),
                           bc6h_mode_blocks(1024, rng)])


def _words(blocks_u8):
    return bitops.words_from_bytes(blocks_u8)


def _twin(variant, blocks_u8, mode_mask=_FULL, flags=0):
    """The wrapper on a CPU tensor: the plain version."""
    pix, valid = _wrapper(variant)(torch.from_numpy(_words(blocks_u8)),
                                   mode_mask, flags)
    return pix.numpy(), valid.numpy()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's BC6H decoders as functions of (variant, blocks,
    mode_mask, flags) returning (packed payload, valid) numpy arrays:
    `pallas` runs the Pallas kernel in interpret mode, `jnp` the jnp
    decoder packed as the kernel packs; results are cached per call."""
    from detex_tpu import native
    from detex_tpu.ops import bptc_float as bfj
    from detex_tpu.ops.pallas import bptc_float_pallas as bfp

    cache = {}

    def cached(kind, fn):
        def run(variant, blocks, mm=_FULL, fl=0):
            key = (kind, variant, blocks.tobytes(), mm, fl)
            if key not in cache:
                pix, valid = fn(variant, _words(blocks), mm, fl)
                cache[key] = (np.asarray(pix), np.asarray(valid))
            return cache[key]
        return run

    def pallas(variant, w, mm, fl):
        fn = (bfp.decode_bptc_signed_float_packed if variant.startswith(
            "bptc_signed") else bfp.decode_bptc_float_packed)
        return fn(w, mm, fl, interpret=True, tile=128)

    def jnp_packed(variant, w, mm, fl):
        return bfp._jnp_packed(w, mm, fl, variant.startswith("bptc_signed"))

    return SimpleNamespace(pallas=cached("pallas", pallas),
                           jnp=cached("jnp", jnp_packed), native=native,
                           bfj=bfj, bfp=bfp)


# --- the plain versions against the JAX package --------------------------


@pytest.mark.parametrize("setting", _SETTINGS, ids=_SETTING_IDS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_bit_exact_vs_pallas_interpret(jx, variant, setting):
    blocks = _blocks(variant)
    p0, v0 = jx.pallas(variant, blocks, *setting)
    p1, v1 = _twin(variant, blocks, *setting)
    assert p1.shape == (len(blocks), 32) and p1.dtype == np.int32
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("setting", _SETTINGS, ids=_SETTING_IDS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_bit_exact_vs_jnp(jx, variant, setting):
    blocks = _blocks(variant)
    p0, v0 = jx.jnp(variant, blocks, *setting)
    p1, v1 = _twin(variant, blocks, *setting)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("setting", _SETTINGS, ids=_SETTING_IDS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_vs_native(jx, variant, setting):
    """detex_tpu.native zero-fills invalid blocks, so pixels are compared
    on valid blocks only; valid flags on every block."""
    blocks = _blocks(variant)
    out0, v0 = jx.native.decode(_VARIANTS[variant][1], blocks, *setting)
    p1, v1 = _twin(variant, blocks, *setting)
    out1 = np.ascontiguousarray(p1).view(np.uint8).reshape(len(blocks), -1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(out0[v0], out1[v1])


def _golden_cases(g):
    """(name, blocks, mode_mask, flags, want_out, want_valid) of a golden
    npz: corpus (where the family has one), random and each mask/flags
    variant."""
    for s in ("corpus", "random"):
        if f"{s}_blocks" in g:
            yield s, g[f"{s}_blocks"], _FULL, 0, g[f"{s}_out"], \
                g[f"{s}_valid"]
    vi = 0
    while f"variant{vi}_out" in g:
        mm, fl = int(g[f"variant{vi}_mask"]), int(g[f"variant{vi}_flags"])
        yield f"variant{vi}", g["random_blocks"], mm, fl, \
            g[f"variant{vi}_out"], g[f"variant{vi}_valid"]
        yield f"variant{vi}_corpus", g["corpus_blocks"], mm, fl, \
            g[f"variant{vi}_corpus_out"], g[f"variant{vi}_corpus_valid"]
        vi += 1


def _check_golden(decode, variant):
    """Golden outputs hold zeros for invalid blocks (the C reference does
    not write them), as tests/test_pallas.py does."""
    g = np.load(_GOLDEN_DIR / f"{_VARIANTS[variant][1]}.npz")
    n = 0
    for name, blocks, mm, fl, want_out, want_valid in _golden_cases(g):
        pix, valid = decode(variant, blocks, mm, fl)
        out = np.ascontiguousarray(pix).view(np.uint8).reshape(len(pix), -1)
        out = np.where(valid[:, None], out, 0).astype(np.uint8)
        np.testing.assert_array_equal(valid, want_valid, err_msg=name)
        np.testing.assert_array_equal(out, want_out, err_msg=name)
        n += 1
    assert n == {"BPTC_FLOAT": 6, "BPTC_SIGNED_FLOAT": 1}[
        _VARIANTS[variant][1]]


@pytest.mark.parametrize("variant", _NAMES)
def test_twin_goldens(variant):
    _check_golden(_twin, variant)


def test_mode_blocks_reach_every_mode():
    """The drawn blocks reach each of the 14 modes and each reserved code
    (>= 32 blocks each), and the reserved ones are invalid."""
    w = _words(_blocks("bptc_float")[1024:])
    code5 = w[:, 0] & 31
    m2 = code5 & 3
    mode = np.where(m2 < 2, m2, bptc_float._MAP_MODE[code5])
    for m in range(14):
        assert (mode == m).sum() >= 32, m
    for code in (19, 23, 27, 31):
        assert (code5 == code).sum() >= 32, code
    _, valid = _twin("bptc_float", _blocks("bptc_float")[1024:])
    np.testing.assert_array_equal(valid, mode >= 0)


def test_twin_decodes_invalid_blocks():
    """Blocks rejected by their valid flag (reserved codes, masked modes)
    are still decoded, reserved codes as mode 0: only `valid` says so (the
    engine zeroes them in the target format)."""
    blocks = _blocks("bptc_signed_float")
    p, v = _twin("bptc_signed_float", blocks)
    assert (~v).sum() >= 128 and (p[~v] != 0).any()
    p_a, v_a = _twin("bptc_float", blocks, 0x2AAA)
    p_b, v_b = _twin("bptc_float", blocks, 0x1555)
    np.testing.assert_array_equal(p_a, p_b)
    assert not (v_a & v_b).any()
    # Code 19 (0b10011) and code 16 (mode 0, whose fields read bits 2-4 of
    # byte 0) share bits 2-7.
    reserved = blocks.copy()
    reserved[:, 0] = (reserved[:, 0] & 0xE0) | 19
    as_mode0 = reserved.copy()
    as_mode0[:, 0] &= 0xFC
    p_r, v_r = _twin("bptc_float", reserved)
    p_0, v_0 = _twin("bptc_float", as_mode0)
    assert not v_r.any() and v_0.all()
    np.testing.assert_array_equal(p_r, p_0)


@pytest.mark.parametrize("variant", _NAMES)
def test_twin_rejects_unknown_device(variant):
    words = torch.zeros((4, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        _wrapper(variant)(words)


def test_twin_launch_counts_untouched_on_cpu():
    before = dict(bptc_float.KERNEL_LAUNCHES)
    for variant in _NAMES:
        _twin(variant, _blocks(variant)[:8])
    assert bptc_float.KERNEL_LAUNCHES == before


def _header_cases():
    """{mode: (epb, (dr, dg, db), [(dest, lo, hi, shift, reversed)])} from
    the switch of csrc/bc6h.cuh."""
    src = (_CSRC / "bc6h.cuh").read_text()
    body = src[src.index("switch (mode_raw"):src.index("#undef FLD")]
    cases = {}
    for m, text in re.findall(r"case (\d+):(.*?)break;", body, re.S):
        epb = int(re.search(r"epb = (\d+);", text).group(1))
        delta = tuple(int(x) for x in re.search(
            r"dr = (\d+), dg = (\d+), db = (\d+);", text).groups())
        fields = [(d, int(lo), int(hi), int(sh), kind == "REV")
                  for kind, d, lo, hi, sh in re.findall(
                      r"(FLD|REV)\((\w+), (\d+), (\d+), (\d+)\)", text)]
        cases[int(m)] = (epb, delta, fields)
    return cases


def test_tables_match_jax(jx):
    """The plain versions' tables and the kernel's (bc6h.cuh: the switch's
    per-mode field scatters, EPB and delta bits; kBc6hSubAnc) against the
    JAX package's."""
    np.testing.assert_array_equal(bptc_float._MAP_MODE, jx.bfj._MAP_MODE)
    assert bptc_float._EPB == jx.bfj._EPB
    assert bptc_float._DELTA == jx.bfj._DELTA
    assert bptc_float._FIELDS == jx.bfj._FIELDS
    cases = _header_cases()
    assert sorted(cases) == list(range(14))
    for m, (epb, delta, fields) in cases.items():
        assert epb == jx.bfj._EPB[m]
        assert delta == (jx.bfj._DELTA[m] or (0, 0, 0))
        want = [(f[0], f[1], f[2], f[3], len(f) > 4 and f[4])
                for f in jx.bfj._FIELDS[m]]
        assert fields == want, m
    src = (_CSRC / "bc6h.cuh").read_text()
    body = re.search(r"DTX_TABLE\(kBc6hSubAnc,(.*?)\)", src, re.S).group(1)
    subanc = [int(v.rstrip("u"), 16) for v in re.findall(r"0x[0-9a-f]+u",
                                                         body)]
    want = np.asarray(jx.bfp._SUBANC).astype(np.int64) & 0xFFFFFFFF
    assert subanc == want.tolist()


# --- the kernel's own code, built for the host -----------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/bc6h.cuh's per-block decode compiled with g++ through the
    csrc/bc6h_host.cpp shim."""
    so = tmp_path_factory.mktemp("bc6h_host") / "libbc6h_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-Wall", "-Wextra",
                    "-Werror", "-shared", "-fPIC", "-o", str(so),
                    str(_CSRC / "bc6h_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.dtx_bc6h_decode_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = None

    def decode(variant, blocks_u8, mode_mask=_FULL, flags=0):
        words = _words(blocks_u8)
        n = len(words)
        pix = np.zeros((n, 32), np.int32)
        valid = np.zeros(n, np.uint8)
        fn(words.ctypes.data, n, int(mode_mask) & _FULL, int(flags) & _FULL,
           _VARIANTS[variant][2], pix.ctypes.data, valid.ctypes.data)
        return pix, valid.astype(bool)

    return decode


@pytest.mark.parametrize("setting", _SETTINGS, ids=_SETTING_IDS)
@pytest.mark.parametrize("variant", _NAMES)
def test_host_kernel_bit_exact_vs_twin(host_kernel, variant, setting):
    blocks = _blocks(variant)
    p0, v0 = _twin(variant, blocks, *setting)
    p1, v1 = host_kernel(variant, blocks, *setting)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("setting", _SETTINGS[:4], ids=_SETTING_IDS[:4])
@pytest.mark.parametrize("variant", _NAMES)
def test_host_kernel_vs_jax(jx, host_kernel, variant, setting):
    """The host build against the Pallas kernel, the jnp decoder and, on
    valid blocks, the native runtime."""
    blocks = _blocks(variant)
    p1, v1 = host_kernel(variant, blocks, *setting)
    for p0, v0 in (jx.pallas(variant, blocks, *setting),
                   jx.jnp(variant, blocks, *setting)):
        np.testing.assert_array_equal(v0, v1)
        np.testing.assert_array_equal(p0, p1)
    out0, v0 = jx.native.decode(_VARIANTS[variant][1], blocks, *setting)
    out1 = p1.view(np.uint8).reshape(len(blocks), -1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(out0[v0], out1[v1])


@pytest.mark.parametrize("variant", _NAMES)
def test_host_kernel_goldens(host_kernel, variant):
    _check_golden(host_kernel, variant)


# --- the CUDA kernel (on a card only) ---------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", _NAMES)
def test_cuda_kernel_bit_exact_vs_twin(cuda, variant):
    rng = np.random.default_rng(13)
    words = torch.from_numpy(_words(bc6h_mode_blocks(1 << 16, rng)))
    words = words.to(cuda)
    before = bptc_float.KERNEL_LAUNCHES[variant]
    for mm, fl in _SETTINGS:
        p0, v0 = _plain(variant)(words, mm, fl)
        p1, v1 = _wrapper(variant)(words, mm, fl)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1), (mm, fl)
    assert bptc_float.KERNEL_LAUNCHES[variant] == before + len(_SETTINGS)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", _NAMES)
def test_cuda_kernel_goldens(cuda, variant):
    def decode(variant, blocks, mm, fl):
        words = torch.from_numpy(_words(blocks)).to(cuda)
        pix, valid = _wrapper(variant)(words, mm, fl)
        return pix.cpu().numpy(), valid.cpu().numpy()

    _check_golden(decode, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", _NAMES)
def test_cuda_wrapper_rejects_bad_input(cuda, variant):
    fn = _wrapper(variant)
    with pytest.raises(ValueError):                 # width
        fn(torch.zeros((8, 5), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):                 # dtype
        fn(torch.zeros((8, 4), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):                 # contiguity
        fn(torch.zeros((4, 8), dtype=torch.int32, device=cuda).T)
    with pytest.raises(ValueError):                 # alignment
        fn(torch.zeros((37,), dtype=torch.int32, device=cuda)[1:].view(9, 4))
    pix, valid = fn(torch.zeros((0, 4), dtype=torch.int32, device=cuda))
    assert pix.shape == (0, 32) and valid.shape == (0,)
