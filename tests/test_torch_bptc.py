"""BC7 in the PyTorch port: the plain version (decode_bptc on CPU tensors)
and the CUDA kernel's own per-block code (csrc/bc7.cuh, built for the host
with g++) must be bit-exact to the JAX package's Pallas kernel (through
the Pallas interpreter), to its jnp single-pass decoder and to the golden
vectors, on every pixel and valid flag, invalid blocks included.

The CUDA kernel itself runs only on a card: its tests are marked `cuda`
and skip here.  The card's machine has no JAX, so this module imports the
JAX package only inside the `jx` fixture; run the card's tests there with
    python -m pytest -p no:cacheprovider --noconftest -m cuda \
        tests/test_torch_bptc.py tests/test_torch_control_step.py
"""

import ast
import ctypes
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from detex_tpu_torch.ops import bitops, bptc

_REPO = Path(__file__).resolve().parent.parent
_CSRC = _REPO / "detex_tpu_torch" / "csrc"
_GOLDEN = _REPO / "tests" / "golden" / "BPTC.npz"
_FULL = 0xFFFFFFFF


@pytest.fixture(scope="module")
def jx():
    """The JAX package's BC7 decoders and bit helpers."""
    import jax

    from detex_tpu.ops import bitops as jbitops
    from detex_tpu.ops import bptc_fast
    from detex_tpu.ops.pallas import bptc_pallas
    # mode_mask and flags are traced, so one compile serves every variant.
    return SimpleNamespace(fast=jax.jit(bptc_fast.decode_bptc_fast),
                           pallas=bptc_pallas, bitops=jbitops)


def _prefix_blocks(rng, n_per_mode=64):
    """Random blocks forced to each of the 8 unary mode prefixes, plus
    blocks whose byte 0 is 0 (no mode: decoded as mode 0, invalid)."""
    out = []
    for mode in range(8):
        b = rng.integers(0, 256, (n_per_mode, 16), np.uint8)
        b[:, 0] = (b[:, 0] | (1 << mode)) & (0xFF ^ ((1 << mode) - 1))
        out.append(b)
    b = rng.integers(0, 256, (n_per_mode, 16), np.uint8)
    b[:, 0] = 0
    out.append(b)
    return np.concatenate(out)


def _partition_blocks(rng):
    """Every partition id of every 2- and 3-subset mode
    (tests/test_pallas.py:197-220)."""
    blocks = []
    for mode, pb_bits in ((0, 4), (1, 6), (2, 6), (3, 6), (7, 6)):
        for psid in range(1 << pb_bits):
            b = rng.integers(0, 256, 16, np.uint8)
            bits = (1 << mode) | (psid << (mode + 1))
            b[0] = bits & 0xFF
            if mode + 1 + pb_bits > 8:
                b[1] = (bits >> 8) & 0xFF
            blocks.append(b)
    return np.stack(blocks)


def _blocks(kind):
    rng = np.random.default_rng({"random": 7, "prefixes": 8,
                                 "partitions": 9}[kind])
    if kind == "random":
        return rng.integers(0, 256, (4096, 16), np.uint8)
    if kind == "prefixes":
        return _prefix_blocks(rng)
    return _partition_blocks(rng)


def _words_np(blocks_u8):
    """(N, 16) uint8 blocks -> (N, 4) int32 little-endian words."""
    return np.ascontiguousarray(blocks_u8).view(np.int32).copy()


def _torch_words(blocks_u8):
    return torch.from_numpy(_words_np(blocks_u8))


def _twin(blocks_u8, mode_mask=_FULL, flags=0):
    pix, valid = bptc.decode_bptc(_torch_words(blocks_u8), mode_mask, flags)
    return pix.numpy(), valid.numpy()


# --- the plain version against the JAX package --------------------------


@pytest.mark.parametrize("kind", ["random", "prefixes", "partitions"])
def test_twin_bit_exact_vs_pallas_interpret(jx, kind):
    blocks = _blocks(kind)
    p0, v0 = jx.pallas.decode_bptc(_words_np(blocks), interpret=True,
                                   tile=128)
    p1, v1 = _twin(blocks)
    np.testing.assert_array_equal(np.asarray(v0), v1)
    np.testing.assert_array_equal(np.asarray(p0), p1)


@pytest.mark.parametrize("mode_mask,flags", [
    (_FULL, 0), (0x55, 0), (_FULL, 2), (_FULL, 4), (0xAA, 6), (0, 0),
    (-1, 0)])
@pytest.mark.parametrize("kind", ["random", "prefixes", "partitions"])
def test_twin_bit_exact_vs_fast(jx, kind, mode_mask, flags):
    blocks = _blocks(kind)
    p0, v0 = jx.fast(_words_np(blocks), np.uint32(mode_mask & _FULL),
                     np.uint32(flags))
    p1, v1 = _twin(blocks, mode_mask, flags)
    np.testing.assert_array_equal(np.asarray(v0), v1)
    np.testing.assert_array_equal(np.asarray(p0), p1)


def _golden_cases(g):
    """(name, blocks, mode_mask, flags, want_out, want_valid) of
    tests/golden/BPTC.npz: corpus, random and each mask/flags variant."""
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


def _check_golden(decode, g):
    """Golden outputs zero the pixels of invalid blocks (the C reference
    does not write them), as tests/test_pallas.py:34-42 does."""
    n = 0
    for name, blocks, mm, fl, want_out, want_valid in _golden_cases(g):
        pix, valid = decode(blocks, mm, fl)
        out = np.ascontiguousarray(pix).view(np.uint8).reshape(len(pix), -1)
        out = np.where(valid[:, None], out, 0).astype(np.uint8)
        np.testing.assert_array_equal(valid, want_valid, err_msg=name)
        np.testing.assert_array_equal(out, want_out, err_msg=name)
        n += 1
    assert n >= 4


def test_twin_goldens():
    _check_golden(_twin, np.load(_GOLDEN))


def test_twin_decodes_invalid_blocks():
    """Blocks without a mode and blocks rejected by mode_mask are still
    fully decoded (the control step feeds every pixel to the encoder);
    only valid is False."""
    blocks = _blocks("prefixes")
    p_all, v_all = _twin(blocks)
    p_none, v_none = _twin(blocks, mode_mask=0)
    assert not v_none.any()
    np.testing.assert_array_equal(p_all, p_none)
    no_mode = blocks[:, 0] == 0
    assert no_mode.any() and not v_all[no_mode].any()
    assert (p_all[no_mode] != 0).any()


def test_twin_rejects_unknown_device():
    with pytest.raises(ValueError):
        bptc.decode_bptc(torch.zeros((4, 4), dtype=torch.int32,
                                     device="meta"))


# --- bit helpers against detex_tpu.ops.bitops ----------------------------


def test_bitops_vs_jax(jx):
    jbitops = jx.bitops
    rng = np.random.default_rng(3)
    words = rng.integers(-2**31, 2**31, (257, 4), np.int64).astype(np.int32)
    tw = torch.from_numpy(words)
    x = torch.from_numpy(words[:, 0])
    for n in (0, 1, 5, 31):
        np.testing.assert_array_equal(
            bitops.shr(x, n).numpy(), np.asarray(jbitops.shr(words[:, 0], n)))
    start = rng.integers(0, 128 - 16, (257, 16)).astype(np.int32)
    for width in (1, 4, 8, 16):
        got = bitops.dyn_field(tw, torch.from_numpy(start), width)
        want = jbitops.dyn_field(words, start, width)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    width = rng.integers(0, 9, (257, 16)).astype(np.int32)
    got = bitops.dyn_field_vw(tw, torch.from_numpy(start),
                              torch.from_numpy(width), 8)
    want = jbitops.dyn_field_vw(words, start, width, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    c = [rng.integers(0, 256, 300).astype(np.int32) for _ in range(4)]
    np.testing.assert_array_equal(
        bitops.pack_rgba8(*map(torch.from_numpy, c)).numpy(),
        np.asarray(jbitops.pack_rgba8(*c)))
    idx = np.arange(-2, 34, dtype=np.int32)
    for mask in (0, 0x55, 0x80000001, _FULL):
        np.testing.assert_array_equal(
            bitops.mask_bit(mask, torch.from_numpy(idx)).numpy(),
            np.asarray(jbitops.mask_bit(mask, idx)))
    assert bitops.has_flag(6, 2) and not bitops.has_flag(4, 2)


# --- the kernel's own code, built for the host ----------------------------


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/bc7.cuh's per-block decode compiled with g++ through the
    csrc/bc7_host.cpp shim."""
    so = tmp_path_factory.mktemp("bc7_host") / "libbc7_host.so"
    subprocess.run(["g++", "-std=c++17", "-O2", "-Wall", "-Werror",
                    "-shared", "-fPIC", "-o", str(so),
                    str(_CSRC / "bc7_host.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.dtx_bc7_decode_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                   ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None

    def decode(blocks_u8, mode_mask=_FULL, flags=0):
        words = np.ascontiguousarray(blocks_u8).view(np.uint32)
        n = len(words)
        pix = np.zeros((n, 16), np.int32)
        valid = np.zeros(n, np.uint8)
        fn(words.ctypes.data, n, int(mode_mask) & _FULL, int(flags) & _FULL,
           pix.ctypes.data, valid.ctypes.data)
        return pix, valid.astype(bool)

    return decode


@pytest.mark.parametrize("mode_mask,flags", [
    (_FULL, 0), (0x55, 2), (0xAA, 4), (0, 0)])
@pytest.mark.parametrize("kind", ["random", "prefixes", "partitions"])
def test_host_kernel_bit_exact_vs_twin(host_kernel, kind, mode_mask, flags):
    blocks = _blocks(kind)
    p0, v0 = _twin(blocks, mode_mask, flags)
    p1, v1 = host_kernel(blocks, mode_mask, flags)
    np.testing.assert_array_equal(v0, v1)
    np.testing.assert_array_equal(p0, p1)


def test_host_kernel_goldens(host_kernel):
    _check_golden(host_kernel, np.load(_GOLDEN))


def _mode_forced(mode, n=256, seed=21):
    """n random blocks forced to `mode` (byte 0's lowest set bit), or with
    byte 0 == 0 for mode 8 (no mode: decoded as mode 0, invalid)."""
    b = np.random.default_rng(seed + mode).integers(0, 256, (n, 16), np.uint8)
    b[:, 0] = 0 if mode == 8 else \
        (b[:, 0] | (1 << mode)) & (0xFF ^ ((1 << mode) - 1))
    return b


@pytest.mark.parametrize("mode_mask,flags", [
    (_FULL, 0), (0x55, 2), (0xAA, 4), (0, 0)])
@pytest.mark.parametrize("mode", range(9),
                         ids=[f"mode{m}" for m in range(8)] + ["no_mode"])
def test_host_kernel_per_mode(jx, host_kernel, mode, mode_mask, flags):
    """Each bc7_decode_mode<M> instantiation of bc7.cuh (and byte0 == 0,
    which the dispatcher sends to mode 0) against the plain version and
    the JAX package's jnp decoder, tolerance 0."""
    blocks = _mode_forced(mode)
    p1, v1 = host_kernel(blocks, mode_mask, flags)
    for p0, v0 in (_twin(blocks, mode_mask, flags),
                   jx.fast(_words_np(blocks), np.uint32(mode_mask & _FULL),
                           np.uint32(flags))):
        np.testing.assert_array_equal(np.asarray(v0), v1)
        np.testing.assert_array_equal(np.asarray(p0), p1)
    assert v1.any() == (mode < 8 and bool((mode_mask >> mode) & 1)
                        and not (flags & 2 and mode >= 4)
                        and not (flags & 4 and mode < 4))


def test_tile_sizes_match_sources():
    """The tile sizes the card's tests and chip_smoke use for edge cases are
    the kernels' own: 128 threads x kRounds blocks in bc7.cu, bc7_pre.cu,
    bc6h.cu, etc_eac.cu (etc_kernel, eac_rg11_kernel) and bc.cu
    (bc1_kernel, bc23_kernel)."""
    hd = (_CSRC / "dtx_hd.cuh").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", hd).group(1))
    for name, tile in (("bc7.cu", chip_smoke._BC7_TILE),
                       ("bc7_pre.cu", chip_smoke._BC7_TILE),
                       ("bc6h.cu", chip_smoke._BC6H_TILE),
                       ("etc_eac.cu", chip_smoke._ETC_TILE),
                       ("bc.cu", chip_smoke._BC_TILE)):
        rounds = int(re.search(r"constexpr int kRounds = (\d+);",
                               (_CSRC / name).read_text()).group(1))
        assert threads * rounds == tile, name


# --- the CUDA kernel (on a card only) --------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "prefixes", "partitions"])
def test_cuda_kernel_bit_exact_vs_twin(cuda, kind):
    blocks = _blocks(kind)
    words = _torch_words(blocks).to(cuda)
    before = bptc.KERNEL_LAUNCHES
    for mm, fl in ((_FULL, 0), (0x55, 2), (0xAA, 4)):
        p0, v0 = bptc.decode_bptc_plain(words, mm, fl)
        p1, v1 = bptc.decode_bptc(words, mm, fl)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1)
    assert bptc.KERNEL_LAUNCHES == before + 3


@pytest.mark.cuda
def test_cuda_kernel_goldens(cuda):
    def decode(blocks, mm, fl):
        pix, valid = bptc.decode_bptc(_torch_words(blocks).to(cuda), mm, fl)
        return pix.cpu().numpy(), valid.cpu().numpy()

    _check_golden(decode, np.load(_GOLDEN))


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_input(cuda):
    with pytest.raises(ValueError):
        bptc.decode_bptc(torch.zeros((8, 3), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError):
        bptc.decode_bptc(torch.zeros((8, 4), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        bptc.decode_bptc(torch.zeros((4, 8), dtype=torch.int32,
                                     device=cuda).T)
    before = bptc.KERNEL_LAUNCHES
    pix, valid = bptc.decode_bptc(torch.zeros((0, 4), dtype=torch.int32,
                                              device=cuda))
    assert pix.shape == (0, 16) and valid.shape == (0,)
    assert bptc.KERNEL_LAUNCHES == before          # N = 0 launches nothing


_T = chip_smoke._BC7_TILE


def _mixed_words(n, seed=5):
    return _torch_words(chip_smoke.MP.tool_blocks(n, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, _T - 1, _T, _T + 1, 256, 3 * _T + 5])
def test_cuda_kernel_edge_sizes(cuda, n):
    """Whole tiles, a ragged last tile and N below one tile."""
    words = _mixed_words(n).to(cuda)
    for mm, fl in ((_FULL, 0), (0x55, 2), (0xAA, 4)):
        p0, v0 = bptc.decode_bptc_plain(words, mm, fl)
        p1, v1 = bptc.decode_bptc(words, mm, fl)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1), (n, mm, fl)


def _bc7_batches():
    blocks = chip_smoke.MP.tool_blocks(3 * _T + 5, 6)
    return chip_smoke._mode_batches(
        blocks, chip_smoke._BC7_MODE[blocks[:, 0]],
        [(1 << m, m + 1) for m in range(8)])


@pytest.mark.cuda
@pytest.mark.parametrize("batch", ["mixed", "sorted"]
                         + [f"mode{m}" for m in range(8)])
def test_cuda_kernel_mode_batches(cuda, batch):
    """Modes mixed, sorted, and one mode per batch (every warp of one
    mode)."""
    words = _torch_words(_bc7_batches()[batch]).to(cuda)
    p0, v0 = bptc.decode_bptc_plain(words)
    p1, v1 = bptc.decode_bptc(words)
    torch.cuda.synchronize()
    assert torch.equal(v0, v1) and torch.equal(p0, p1)


# --- the package imports no jax and nothing of detex_tpu ----------------------


def test_port_imports_no_jax():
    """Every module of the port (tools included) and chip_smoke import
    neither jax nor any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import detex_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    detex_tpu_torch.__path__, 'detex_tpu_torch.')]\n"
        "assert {'detex_tpu_torch.engine', 'detex_tpu_torch.tools.mxu_probe',\n"
        "        'detex_tpu_torch.tools.interleave_probe',\n"
        "        'detex_tpu_torch.tools.profile_sections',\n"
        "        'detex_tpu_torch.mpc.ilqr', 'detex_tpu_torch.mpc.parallel_lqr',\n"
        "        'detex_tpu_torch.mpc.train_loop', 'detex_tpu_torch.cli.train',\n"
        "        'detex_tpu_torch.utils.guards',\n"
        "        'detex_tpu_torch.utils.checkpoint',\n"
        "        'detex_tpu_torch.utils.metrics',\n"
        "        'detex_tpu_torch.ops.bptc_encode',\n"
        "        'detex_tpu_torch.parallel.mesh',\n"
        "        'detex_tpu_torch.parallel.distributed',\n"
        "        'detex_tpu_torch.parallel.launch',\n"
        "        'detex_tpu_torch.tools.bench_scaling',\n"
        "        'detex_tpu_torch.tools.diag_mppi_gap',\n"
        "        'detex_tpu_torch.ops.modes', 'detex_tpu_torch.cli.view',\n"
        "        'detex_tpu_torch.cli.validate',\n"
        "        'detex_tpu_torch.tools.mass_fuzz',\n"
        "        'detex_tpu_torch.tools.bench_control_step',\n"
        "        'detex_tpu_torch.tools.bench_train_step',\n"
        "        'detex_tpu_torch.tools.bench_pipelines'} <= set(names)\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'detex_tpu'\n"
        "             or m.startswith('detex_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=_REPO,
                         capture_output=True, text=True).stdout
    assert int(out) >= 30


# A citation of the counterpart, `detex_tpu/<path>.py:<line>`, is allowed in
# code; any other mention of the JAX package's directory is a path into it.
_CITATION = re.compile(r"detex_tpu/[\w/]+\.py:\d+")
_JAX_PACKAGE = re.compile(r"(?<![\w/])detex_tpu(?![\w])")


def _docstring_nodes(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant):
            yield node.body[0].value


def _python_faults(path):
    tree = ast.parse(path.read_text(), str(path))
    docs = {id(n) for n in _docstring_nodes(tree)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            if _JAX_PACKAGE.search(_CITATION.sub("", node.value)):
                yield f"{path.name}:{node.lineno}: {node.value!r}"
            continue
        else:
            continue
        for name in names:
            if name == "detex_tpu" or name.startswith("detex_tpu."):
                yield f"{path.name}:{node.lineno}: imports {name}"


def _cpp_faults(path):
    for n, line in enumerate(path.read_text().splitlines(), 1):
        code = line.split("//")[0]
        if _JAX_PACKAGE.search(code):
            yield f"{path.name}:{n}: {line.strip()}"


def test_port_sources_name_no_jax_package():
    """No file of the port, and not chip_smoke.py, imports detex_tpu or
    names a path into detex_tpu/ (outside comments, docstrings and
    file:line citations)."""
    root = _REPO / "detex_tpu_torch"
    files = [p for p in root.rglob("*") if p.is_file()
             and "build" not in p.relative_to(root).parts
             and p.suffix in (".py", ".cu", ".cuh", ".cpp", ".h")]
    assert len(files) >= 40
    assert {root / name for name in (
        "ops/modes.py", "cli/view.py", "cli/validate.py",
        "tools/mass_fuzz.py", "tools/bench_control_step.py",
        "tools/bench_train_step.py", "tools/bench_pipelines.py")} \
        <= set(files)
    faults = []
    for path in files + [_REPO / "chip_smoke.py"]:
        faults += list(_python_faults(path) if path.suffix == ".py"
                       else _cpp_faults(path))
    assert not faults, faults
