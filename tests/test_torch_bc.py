"""BC1/BC1A/BC2/BC3 and RGTC1/RGTC2 (signed and unsigned) in the PyTorch
port: the plain versions (the wrappers on CPU tensors) and the CUDA
kernels' own per-block code (csrc/bc.cuh, built for the host with g++)
must be bit-exact (tolerance 0) to the JAX package's Pallas kernels
(through the Pallas interpreter), to its jnp decoders, to the golden
vectors and to the native C++ runtime, on every payload word and valid
flag, under every flag setting.

The CUDA kernels themselves run only on a card: those tests are marked
`cuda` and skip here.  The card's machine has no JAX, so this module
imports the JAX package only inside fixtures; run the card's tests there
with
    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_bc.py tests/test_torch_engine.py
"""

import ctypes
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from detex_tpu_torch.ops import bc, bitops, rgtc

_REPO = Path(__file__).resolve().parent.parent
_CSRC = _REPO / "detex_tpu_torch" / "csrc"
_GOLDEN_DIR = _REPO / "tests" / "golden"
_FULL = 0xFFFFFFFF
_FLAGS = [0, 1, 2, 4]

# variant -> (module, wrapper, golden family, block bytes, words out,
#             host entry point, template flag)
_VARIANTS = {
    "bc1": (bc, "decode_bc1", "BC1", 8, 16, "dtx_bc1_decode_host", 0),
    "bc1a": (bc, "decode_bc1a", "BC1A", 8, 16, "dtx_bc1_decode_host", 1),
    "bc2": (bc, "decode_bc2", "BC2", 16, 16, "dtx_bc23_decode_host", 0),
    "bc3": (bc, "decode_bc3", "BC3", 16, 16, "dtx_bc23_decode_host", 1),
    "rgtc1": (rgtc, "decode_rgtc1", "RGTC1", 8, 4, "dtx_rgtc1_decode_host",
              0),
    "signed_rgtc1": (rgtc, "decode_signed_rgtc1", "SIGNED_RGTC1", 8, 8,
                     "dtx_rgtc1_decode_host", 1),
    "rgtc2": (rgtc, "decode_rgtc2", "RGTC2", 16, 8, "dtx_rgtc2_decode_host",
              0),
    "signed_rgtc2": (rgtc, "decode_signed_rgtc2", "SIGNED_RGTC2", 16, 16,
                     "dtx_rgtc2_decode_host", 1),
}
_NAMES = list(_VARIANTS)


def _wrapper(variant):
    module, name = _VARIANTS[variant][:2]
    return getattr(module, name)


def _plain(variant):
    module, name = _VARIANTS[variant][:2]
    return getattr(module, name + "_plain")


def branch_blocks(variant, n, rng):
    """n random blocks of `variant` whose eighths are forced into the
    branches random bytes rarely reach: colour endpoints c0 <= c1 and
    c0 == c1, channel endpoints l0 <= l1 (as int8 when signed) and
    l0 == l1, and for signed RGTC the invalid (-127, -128) pair and -128
    endpoints."""
    bs = _VARIANTS[variant][3]
    b = rng.integers(0, 256, (n, bs), np.uint8)
    e = [slice(k * n // 8, (k + 1) * n // 8) for k in range(8)]
    color = {"bc1": 0, "bc1a": 0, "bc2": 8, "bc3": 8}.get(variant)
    if color is not None:
        c = b[:, color:color + 4].view(np.uint16)
        c[e[1]] = np.sort(c[e[1]], axis=1)
        c[e[2], 1] = c[e[2], 0]
    signed = variant.startswith("signed")
    for off in {"bc3": [0], "rgtc1": [0], "signed_rgtc1": [0],
                "rgtc2": [0, 8], "signed_rgtc2": [0, 8]}.get(variant, []):
        pair = b[:, off:off + 2].view(np.int8 if signed else np.uint8)
        pair[e[3]] = np.sort(pair[e[3]], axis=1)
        pair[e[4], 1] = pair[e[4], 0]
        if signed:
            b[e[5], off:off + 2] = (0x81, 0x80)       # (-127, -128)
            b[e[6], off] = 0x80
            b[e[7], off + 1] = 0x80
    return b


def _blocks(variant):
    """1024 random blocks, then 512 with forced branches (fixed seed)."""
    rng = np.random.default_rng(_NAMES.index(variant) + 21)
    bs = _VARIANTS[variant][3]
    return np.concatenate([rng.integers(0, 256, (1024, bs), np.uint8),
                           branch_blocks(variant, 512, rng)])


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
    the Pallas kernel in interpret mode, `jnp` the jnp decoder packed with
    bc_pallas's packers."""
    from detex_tpu import native
    from detex_tpu.ops import bc as bcj
    from detex_tpu.ops import rgtc as rgj
    from detex_tpu.ops.pallas import bc_pallas as bp

    def rg(fn, pack):
        def run(w, mm, fl):
            vals, valid = fn(w, mm, fl)
            return pack(vals.reshape(vals.shape[0], -1)), valid
        return run

    pallas = {
        "bc1": bp.decode_bc1, "bc1a": bp.decode_bc1a,
        "bc2": bp.decode_bc2, "bc3": bp.decode_bc3,
        "rgtc1": bp.decode_rgtc1_packed,
        "signed_rgtc1": bp.decode_signed_rgtc1_packed,
        "rgtc2": bp.decode_rgtc2_packed,
        "signed_rgtc2": bp.decode_signed_rgtc2_packed,
    }
    jnp_fns = {
        "bc1": bcj.decode_bc1, "bc1a": bcj.decode_bc1a,
        "bc2": bcj.decode_bc2, "bc3": bcj.decode_bc3,
        "rgtc1": rg(rgj.decode_rgtc1, bp._pack_u8x4),
        "signed_rgtc1": rg(rgj.decode_signed_rgtc1, bp._pack_u16x2),
        "rgtc2": rg(rgj.decode_rgtc2, bp._pack_u8x4),
        "signed_rgtc2": rg(rgj.decode_signed_rgtc2, bp._pack_u16x2),
    }

    def np_out(fn):
        def run(w, mm=_FULL, fl=0, **kw):
            pix, valid = fn(w, mm, fl, **kw)
            return np.asarray(pix), np.asarray(valid)
        return run

    return SimpleNamespace(
        pallas={v: np_out(f) for v, f in pallas.items()},
        jnp={v: np_out(f) for v, f in jnp_fns.items()},
        native=native, pack_u8x4=bp._pack_u8x4, pack_u16x2=bp._pack_u16x2)


# --- the plain versions against the JAX package --------------------------


@pytest.mark.parametrize("flags", _FLAGS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_bit_exact_vs_pallas_interpret(jx, variant, flags):
    blocks = _blocks(variant)
    p0, v0 = jx.pallas[variant](_words(blocks), _FULL, flags,
                                interpret=True, tile=128)
    p1, v1 = _twin(variant, blocks, _FULL, flags)
    assert p1.shape == (len(blocks), _VARIANTS[variant][4])
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("flags", _FLAGS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_bit_exact_vs_jnp(jx, variant, flags):
    blocks = _blocks(variant)
    p0, v0 = jx.jnp[variant](_words(blocks), _FULL, flags)
    p1, v1 = _twin(variant, blocks, _FULL, flags)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("flags", _FLAGS)
@pytest.mark.parametrize("variant", _NAMES)
def test_twin_vs_native(jx, variant, flags):
    """detex_tpu.native zero-fills invalid blocks, so pixels are compared
    on valid blocks only; valid flags on every block."""
    blocks = _blocks(variant)
    out0, v0 = jx.native.decode(_VARIANTS[variant][2], blocks, _FULL, flags)
    p1, v1 = _twin(variant, blocks, _FULL, flags)
    out1 = np.ascontiguousarray(p1).view(np.uint8).reshape(len(blocks), -1)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(out0[v0], out1[v1])


def _golden_cases(g):
    """(name, blocks, mode_mask, flags, want_out, want_valid) of a golden
    npz: corpus, random and each mask/flags variant."""
    yield "corpus", g["corpus_blocks"], _FULL, 0, g["corpus_out"], \
        g["corpus_valid"]
    yield "random", g["random_blocks"], _FULL, 0, g["random_out"], \
        g["random_valid"]
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
    assert n >= 2


@pytest.mark.parametrize("variant", _NAMES)
def test_twin_goldens(variant):
    _check_golden(_twin, variant)


def test_twin_decodes_invalid_blocks():
    """Blocks rejected by their valid flag are still decoded: only valid
    says so (the engine zeroes them in the target format)."""
    blocks = _blocks("signed_rgtc2")
    p, v = _twin("signed_rgtc2", blocks)
    assert (~v).sum() >= 64 and (p[~v] != 0).any()
    p_a, v_a = _twin("bc1a", _blocks("bc1a"), flags=2)
    p_b, v_b = _twin("bc1a", _blocks("bc1a"), flags=4)
    np.testing.assert_array_equal(p_a, p_b)
    assert not (v_a & v_b).any() and (v_a | v_b).all()


@pytest.mark.parametrize("variant", _NAMES)
def test_twin_rejects_unknown_device(variant):
    words = torch.zeros((4, _VARIANTS[variant][3] // 4), dtype=torch.int32,
                        device="meta")
    with pytest.raises(ValueError):
        _wrapper(variant)(words)


def test_twin_launch_counts_untouched_on_cpu():
    before = {**bc.KERNEL_LAUNCHES, **rgtc.KERNEL_LAUNCHES}
    for variant in _NAMES:
        _twin(variant, _blocks(variant)[:8])
    assert {**bc.KERNEL_LAUNCHES, **rgtc.KERNEL_LAUNCHES} == before


# --- bit helpers and identities -------------------------------------------


def test_bitops_vs_jax(jx):
    from detex_tpu.ops import bitops as jbitops
    rng = np.random.default_rng(5)
    blocks = rng.integers(0, 256, (300, 16), np.uint8)
    words = bitops.words_from_bytes(blocks)
    assert words.dtype == np.int32 and words.flags.writeable
    np.testing.assert_array_equal(
        words, np.asarray(jbitops.words_from_bytes(blocks)))
    x = torch.from_numpy(words[:, 0])
    for start, width in ((0, 5), (5, 6), (11, 5), (16, 16), (27, 5),
                         (24, 8), (1, 31)):
        np.testing.assert_array_equal(
            bitops.field(x, start, width).numpy(),
            np.asarray(jbitops.field(words[:, 0], start, width)))
    vals8 = rng.integers(0, 256, (300, 32)).astype(np.int32)
    vals16 = rng.integers(-32768, 32768, (300, 32)).astype(np.int32)
    np.testing.assert_array_equal(
        bitops.pack_u8x4(torch.from_numpy(vals8)).numpy(),
        np.asarray(jx.pack_u8x4(vals8)))
    np.testing.assert_array_equal(
        bitops.pack_u16x2(torch.from_numpy(vals16)).numpy(),
        np.asarray(jx.pack_u16x2(vals16)))


def test_div_trunc_rounds_toward_zero():
    num = torch.arange(-1785, 1786)
    for d in (5, 7):
        want = [int(n / d) for n in num.tolist()]     # C's `/`
        assert bitops.div_trunc(num, d).tolist() == want
    assert (num // 7 != bitops.div_trunc(num, 7)).any()   # floor differs


def test_kernel_identities():
    """The multiply-shift divisions and the signed map of csrc/bc.cuh,
    exhaustively over the ranges the decoders reach."""
    x = np.arange(2048)
    assert np.array_equal((x * 683) >> 11, x // 3)
    x = np.arange(1786)
    assert np.array_equal((x * 9363) >> 16, x // 7)
    x = np.arange(1276)
    assert np.array_equal((x * 13108) >> 16, x // 5)
    assert np.array_equal(np.arange(16) * 17, np.arange(16) * 255 // 15)
    k = np.arange(255)
    assert np.array_equal(k * 65535 // 254,
                          258 * k + (k >= 85) + (k >= 170) + (k >= 254))


# --- the kernels' own code, built for the host -----------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/bc.cuh's per-block decodes compiled with g++ through the
    csrc/bc_host.cpp shim."""
    so = tmp_path_factory.mktemp("bc_host") / "libbc_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-Wall", "-Wextra",
                    "-Werror", "-shared", "-fPIC", "-o", str(so),
                    str(_CSRC / "bc_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))

    def decode(variant, blocks_u8, mode_mask=_FULL, flags=0):
        *_, words_out, entry, flag = _VARIANTS[variant]
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
           flag, pix.ctypes.data, valid.ctypes.data)
        return pix, valid.astype(bool)

    return decode


@pytest.mark.parametrize("flags", _FLAGS)
@pytest.mark.parametrize("variant", _NAMES)
def test_host_kernel_bit_exact_vs_twin(host_kernel, variant, flags):
    blocks = _blocks(variant)
    p0, v0 = _twin(variant, blocks, _FULL, flags)
    p1, v1 = host_kernel(variant, blocks, _FULL, flags)
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
    words = torch.from_numpy(_words(branch_blocks(variant, 1 << 16, rng)))
    words = words.to(cuda)
    counts = _VARIANTS[variant][0].KERNEL_LAUNCHES
    before = counts[variant]
    for fl in _FLAGS:
        p0, v0 = _plain(variant)(words, _FULL, fl)
        p1, v1 = _wrapper(variant)(words, _FULL, fl)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1)
    assert counts[variant] == before + len(_FLAGS)


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


_T = chip_smoke._BC_TILE
_TILED = ["bc1", "bc1a", "bc2", "bc3"]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, _T - 1, _T, _T + 1, 3 * _T + 5])
@pytest.mark.parametrize("variant", _TILED)
def test_cuda_tile_edge_sizes(cuda, variant, n):
    """bc1_kernel's and bc23_kernel's tile: N below one tile, whole tiles
    and a ragged last tile, under every flag setting."""
    rng = np.random.default_rng(17)
    words = torch.from_numpy(_words(branch_blocks(variant, n, rng)))
    words = words.to(cuda)
    for fl in _FLAGS:
        p0, v0 = _plain(variant)(words, _FULL, fl)
        p1, v1 = _wrapper(variant)(words, _FULL, fl)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1), fl


@pytest.mark.cuda
@pytest.mark.parametrize("variant", _TILED)
def test_cuda_tile_shuffled_batch(cuda, variant):
    """Branch-forced blocks shuffled by row, so every warp mixes the forced
    branches, under every flag setting."""
    rng = np.random.default_rng(19)
    blocks = branch_blocks(variant, 3 * _T + 5, rng)
    words = torch.from_numpy(_words(blocks[rng.permutation(len(blocks))]))
    words = words.to(cuda)
    for fl in _FLAGS:
        p0, v0 = _plain(variant)(words, _FULL, fl)
        p1, v1 = _wrapper(variant)(words, _FULL, fl)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1), fl
