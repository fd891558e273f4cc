"""ETC1, ETC2, ETC2_PUNCHTHROUGH, ETC2_EAC and EAC R11/RG11 (signed and
unsigned) in the PyTorch port: the plain versions (the wrappers on CPU
tensors) and the CUDA kernels' own per-block code (csrc/etc_eac.cuh, built
for the host with g++) must be bit-exact (tolerance 0) to the JAX
package's Pallas kernels (through the Pallas interpreter), to its jnp
decoders, to the golden vectors and to the native C++ runtime, on every
payload word and valid flag, under flags {0, 1, 2, 4} at the full mode
mask and under mode masks {1, 2, 4, 8, 0x10, 0x1A} at flags 0.

The blocks are random with eighths forced into the rare branches
(chip_smoke.etc_branch_blocks, which the card's smoke run uses too).

The CUDA kernels themselves run only on a card: those tests are marked
`cuda` and skip here.  The card's machine has no JAX, so this module
imports the JAX package only inside fixtures; run the card's tests there
with
    python -m pytest -p no:cacheprovider --noconftest -m cuda \\
        tests/test_torch_etc.py
"""

import ctypes
import re
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import etc_branch_blocks
from detex_tpu_torch.ops import bitops, eac, etc

_REPO = Path(__file__).resolve().parent.parent
_CSRC = _REPO / "detex_tpu_torch" / "csrc"
_GOLDEN_DIR = _REPO / "tests" / "golden"
_FULL = 0xFFFFFFFF
# (mode_mask, flags): every flag at the full mask, then single modes and
# a mixed mask at flags 0.
_SETTINGS = [(_FULL, 0), (_FULL, 1), (_FULL, 2), (_FULL, 4), (0x1, 0),
             (0x2, 0), (0x4, 0), (0x8, 0), (0x10, 0), (0x1A, 0)]
_SETTING_IDS = [f"mask{mm:x}-flags{fl}" for mm, fl in _SETTINGS]

# variant -> (module, wrapper, golden family, block bytes, words out,
#             host entry point, instantiation)
_VARIANTS = {
    "etc1": (etc, "decode_etc1", "ETC1", 8, 16, "dtx_etc_decode_host", 0),
    "etc2": (etc, "decode_etc2", "ETC2", 8, 16, "dtx_etc_decode_host", 1),
    "etc2_punchthrough": (etc, "decode_etc2_punchthrough",
                          "ETC2_PUNCHTHROUGH", 8, 16, "dtx_etc_decode_host",
                          2),
    "etc2_eac": (etc, "decode_etc2_eac", "ETC2_EAC", 16, 16,
                 "dtx_etc2_eac_decode_host", 0),
    "eac_r11": (eac, "decode_eac_r11", "EAC_R11", 8, 8,
                "dtx_eac_r11_decode_host", 0),
    "eac_signed_r11": (eac, "decode_eac_signed_r11", "EAC_SIGNED_R11", 8, 8,
                       "dtx_eac_r11_decode_host", 1),
    "eac_rg11": (eac, "decode_eac_rg11", "EAC_RG11", 16, 16,
                 "dtx_eac_rg11_decode_host", 0),
    "eac_signed_rg11": (eac, "decode_eac_signed_rg11", "EAC_SIGNED_RG11",
                        16, 16, "dtx_eac_rg11_decode_host", 1),
}
_NAMES = list(_VARIANTS)


def _wrapper(variant):
    module, name = _VARIANTS[variant][:2]
    return getattr(module, name)


def _plain(variant):
    module, name = _VARIANTS[variant][:2]
    return getattr(module, name + "_plain")


def _blocks(variant):
    """1024 random blocks, then 1024 with forced branches (fixed seed)."""
    rng = np.random.default_rng(_NAMES.index(variant) + 31)
    bs = _VARIANTS[variant][3]
    return np.concatenate([rng.integers(0, 256, (1024, bs), np.uint8),
                           etc_branch_blocks(variant, 1024, rng)])


def _words(blocks_u8):
    return bitops.words_from_bytes(blocks_u8)


def _twin(variant, blocks_u8, mode_mask=_FULL, flags=0):
    """The wrapper on a CPU tensor: the plain version."""
    pix, valid = _wrapper(variant)(torch.from_numpy(_words(blocks_u8)),
                                   mode_mask, flags)
    return pix.numpy(), valid.numpy()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's decoders for each variant, as functions of numpy
    words returning (packed payload, valid) numpy arrays: `pallas` runs
    the Pallas kernel in interpret mode, `jnp` the jnp decoder (EAC packed
    with etc_eac_pallas's packer)."""
    from detex_tpu import native
    from detex_tpu.ops import eac as eacj
    from detex_tpu.ops import etc as etcj
    from detex_tpu.ops.pallas import etc_eac_pallas as ep

    def packed(fn):
        def run(w, mm, fl):
            vals, valid = fn(w, mm, fl)
            return ep._pack_u16x2(vals.reshape(vals.shape[0], -1)), valid
        return run

    pallas = {
        "etc1": ep.decode_etc1, "etc2": ep.decode_etc2,
        "etc2_punchthrough": ep.decode_etc2_punchthrough,
        "etc2_eac": ep.decode_etc2_eac,
        "eac_r11": ep.decode_eac_r11_packed,
        "eac_signed_r11": ep.decode_eac_signed_r11_packed,
        "eac_rg11": ep.decode_eac_rg11_packed,
        "eac_signed_rg11": ep.decode_eac_signed_rg11_packed,
    }
    jnp_fns = {
        "etc1": etcj.decode_etc1, "etc2": etcj.decode_etc2,
        "etc2_punchthrough": etcj.decode_etc2_punchthrough,
        "etc2_eac": etcj.decode_etc2_eac,
        "eac_r11": packed(eacj.decode_eac_r11),
        "eac_signed_r11": packed(eacj.decode_eac_signed_r11),
        "eac_rg11": packed(eacj.decode_eac_rg11),
        "eac_signed_rg11": packed(eacj.decode_eac_signed_rg11),
    }

    def np_out(fn):
        def run(w, mm=_FULL, fl=0, **kw):
            pix, valid = fn(w, mm, fl, **kw)
            return np.asarray(pix), np.asarray(valid)
        return run

    return SimpleNamespace(
        pallas={v: np_out(f) for v, f in pallas.items()},
        jnp={v: np_out(f) for v, f in jnp_fns.items()},
        native=native, etcj=etcj, eacj=eacj)


# --- the plain versions against the JAX package --------------------------


@pytest.mark.parametrize("setting", _SETTINGS, ids=_SETTING_IDS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_bit_exact_vs_pallas_interpret(jx, variant, setting):
    blocks = _blocks(variant)
    p0, v0 = jx.pallas[variant](_words(blocks), *setting, interpret=True,
                                tile=128)
    p1, v1 = _twin(variant, blocks, *setting)
    assert p1.shape == (len(blocks), _VARIANTS[variant][4])
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("setting", _SETTINGS, ids=_SETTING_IDS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_bit_exact_vs_jnp(jx, variant, setting):
    blocks = _blocks(variant)
    p0, v0 = jx.jnp[variant](_words(blocks), *setting)
    p1, v1 = _twin(variant, blocks, *setting)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("setting", _SETTINGS, ids=_SETTING_IDS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_vs_native(jx, variant, setting):
    """detex_tpu.native zero-fills invalid blocks, so pixels are compared
    on valid blocks only; valid flags on every block."""
    blocks = _blocks(variant)
    out0, v0 = jx.native.decode(_VARIANTS[variant][2], blocks, *setting)
    p1, v1 = _twin(variant, blocks, *setting)
    out1 = np.ascontiguousarray(p1).view(np.uint8).reshape(len(blocks), -1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(out0[v0], out1[v1])


def _golden_cases(g):
    """(name, blocks, mode_mask, flags, want_out, want_valid) of a golden
    npz: corpus (where the family has one), random and each mask/flags
    variant."""
    sets = [s for s in ("corpus", "random") if f"{s}_blocks" in g]
    for s in sets:
        yield s, g[f"{s}_blocks"], _FULL, 0, g[f"{s}_out"], g[f"{s}_valid"]
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
    g = np.load(_GOLDEN_DIR / f"{_VARIANTS[variant][2]}.npz")
    n = 0
    for name, blocks, mm, fl, want_out, want_valid in _golden_cases(g):
        pix, valid = decode(variant, blocks, mm, fl)
        out = np.ascontiguousarray(pix).view(np.uint8).reshape(len(pix), -1)
        out = np.where(valid[:, None], out, 0).astype(np.uint8)
        np.testing.assert_array_equal(valid, want_valid, err_msg=name)
        np.testing.assert_array_equal(out, want_out, err_msg=name)
        n += 1
    assert n == {"ETC2": 6, "ETC2_PUNCHTHROUGH": 6,
                 "EAC_SIGNED_RG11": 1}.get(_VARIANTS[variant][2], 2)


@pytest.mark.parametrize("variant", _NAMES)
def test_twin_goldens(variant):
    _check_golden(_twin, variant)


def test_branch_blocks_reach_every_branch():
    """The forced eighths reach every ETC2 mode, both opacities and flip
    values, ETC1's differential overflow, an EAC multiplier of 0 and a
    signed base of -128 in each channel."""
    w = _words(_blocks("etc2_punchthrough")[1024:])
    b3 = (w[:, 0] >> 24) & 0xFF
    diff = torch.from_numpy((b3 & 2) != 0)
    _, mode, _ = etc._etc2_pixels(torch.from_numpy(w[:, 0]),
                                  torch.from_numpy(w[:, 1]),
                                  punchthrough=True)
    mode = mode[:, 0]
    for m in (1, 2, 3, 4):
        assert (diff & (mode == m)).sum() >= 32
        assert (~diff & (mode == m)).sum() >= 32
    assert len(set((b3 & 1).tolist())) == 2
    _, valid = _twin("etc1", _blocks("etc1")[1024:])
    assert (~valid).sum() >= 128
    w = _words(_blocks("eac_signed_rg11")[1024:])
    assert (((w[:, 0] >> 12) & 0xF) == 0).sum() >= 128
    for k in (0, 2):
        assert ((w[:, k] & 0xFF) == 0x80).sum() >= 128


def test_twin_decodes_invalid_blocks():
    """Blocks rejected by their valid flag are still decoded: only valid
    says so (the engine zeroes them in the target format)."""
    blocks = _blocks("etc1")
    p, v = _twin("etc1", blocks)
    assert (~v).sum() >= 128 and (p[~v] != 0).any()
    p_a, v_a = _twin("etc2_punchthrough", blocks, flags=2)
    p_b, v_b = _twin("etc2_punchthrough", blocks, flags=4)
    np.testing.assert_array_equal(p_a, p_b)
    assert not (v_a & v_b).any() and (~v_a).sum() > 128
    p, v = _twin("eac_signed_r11", _blocks("eac_signed_r11"))
    assert (~v).sum() >= 128 and (p[~v] != 0).any()


@pytest.mark.parametrize("variant", _NAMES)
def test_twin_rejects_unknown_device(variant):
    words = torch.zeros((4, _VARIANTS[variant][3] // 4), dtype=torch.int32,
                        device="meta")
    with pytest.raises(ValueError):
        _wrapper(variant)(words)


def test_twin_launch_counts_untouched_on_cpu():
    before = {**etc.KERNEL_LAUNCHES, **eac.KERNEL_LAUNCHES}
    for variant in _NAMES:
        _twin(variant, _blocks(variant)[:8])
    assert {**etc.KERNEL_LAUNCHES, **eac.KERNEL_LAUNCHES} == before


def test_tables_match_jax(jx):
    """The plain versions' tables and the kernels' packed ones
    (etc_eac.cuh: kEtcA, kEtcB, kEtcDist, kEacRows) against the JAX
    package's."""
    np.testing.assert_array_equal(etc.ETC_MODIFIER_TABLE,
                                  jx.etcj.ETC_MODIFIER_TABLE)
    np.testing.assert_array_equal(etc.PUNCHTHROUGH_MODIFIER_TABLE,
                                  jx.etcj.PUNCHTHROUGH_MODIFIER_TABLE)
    np.testing.assert_array_equal(etc.ETC2_DISTANCE_TABLE,
                                  jx.etcj.ETC2_DISTANCE_TABLE)
    np.testing.assert_array_equal(eac.EAC_MODIFIER_TABLE,
                                  jx.eacj.EAC_MODIFIER_TABLE)
    src = (_CSRC / "etc_eac.cuh").read_text()

    def const(name):
        return int(re.search(rf"{name} = (0x[0-9a-f]+)ull", src).group(1),
                   16)

    def fields(x, width, n=8):
        return [(x >> (width * k)) & ((1 << width) - 1) for k in range(n)]

    tab = jx.etcj.ETC_MODIFIER_TABLE
    assert fields(const("kEtcA"), 6) == tab[:, 0].tolist()
    assert fields(const("kEtcB"), 8) == tab[:, 1].tolist()
    assert fields(const("kEtcDist"), 8) == \
        jx.etcj.ETC2_DISTANCE_TABLE.tolist()
    body = re.search(r"DTX_TABLE\(kEacRows,(.*?)\)", src, re.S).group(1)
    rows = [int(v.rstrip("u"), 16) for v in re.findall(r"0x[0-9a-f]+u",
                                                         body)]
    eac_tab = jx.eacj.EAC_MODIFIER_TABLE
    want = [[(r >> (5 * c)) % 32 - 16 for c in range(4)] for r in rows]
    assert want == eac_tab[:, :4].tolist()
    assert np.array_equal(eac_tab[:, 4:], -eac_tab[:, :4] - 1)


# --- the kernels' own code, built for the host -----------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/etc_eac.cuh's per-block decodes compiled with g++ through the
    csrc/etc_eac_host.cpp shim."""
    so = tmp_path_factory.mktemp("etc_eac_host") / "libetc_eac_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-Wall", "-Wextra",
                    "-Werror", "-shared", "-fPIC", "-o", str(so),
                    str(_CSRC / "etc_eac_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))

    def decode(variant, blocks_u8, mode_mask=_FULL, flags=0):
        *_, words_out, entry, inst = _VARIANTS[variant]
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                       ctypes.c_uint32, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = None
        words = _words(blocks_u8)
        n = len(words)
        pix = np.zeros((n, words_out), np.int32)
        valid = np.zeros(n, np.uint8)
        fn(words.ctypes.data, n, int(mode_mask) & _FULL, int(flags) & _FULL,
           inst, pix.ctypes.data, valid.ctypes.data)
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


@pytest.mark.parametrize("variant", _NAMES)
def test_host_kernel_goldens(host_kernel, variant):
    _check_golden(host_kernel, variant)


# --- the CUDA kernels (on a card only) --------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", _NAMES)
def test_cuda_kernel_bit_exact_vs_twin(cuda, variant):
    rng = np.random.default_rng(11)
    words = torch.from_numpy(_words(etc_branch_blocks(variant, 1 << 16,
                                                      rng)))
    words = words.to(cuda)
    counts = _VARIANTS[variant][0].KERNEL_LAUNCHES
    before = counts[variant]
    for mm, fl in _SETTINGS:
        p0, v0 = _plain(variant)(words, mm, fl)
        p1, v1 = _wrapper(variant)(words, mm, fl)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1), (mm, fl)
    assert counts[variant] == before + len(_SETTINGS)


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
    k = _VARIANTS[variant][3] // 4
    fn = _wrapper(variant)
    with pytest.raises(ValueError):                 # width
        fn(torch.zeros((8, k + 1), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):                 # dtype
        fn(torch.zeros((8, k), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):                 # contiguity
        fn(torch.zeros((k, 8), dtype=torch.int32, device=cuda).T)
    with pytest.raises(ValueError):                 # alignment
        fn(torch.zeros((9 * k + 1,), dtype=torch.int32,
                       device=cuda)[1:].view(9, k))
    pix, valid = fn(torch.zeros((0, k), dtype=torch.int32, device=cuda))
    assert pix.shape == (0, _VARIANTS[variant][4]) and valid.shape == (0,)
