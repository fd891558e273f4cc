"""The port's probe tools (detex_tpu_torch/tools/) against the JAX
package's (tools/mxu_probe.py, interleave_probe.py, profile_sections.py),
run here on the CPU: each TPU tool kernel in a pallas_call with the tool's
BlockSpecs and interpret=True, against the port's plain version and the
CUDA kernel's own code (csrc/bc7.cuh, interleave.cuh, mix_probe.cuh) built
for the host with g++, bit for bit (tolerance 0).  Also the census copy,
the schedule and the generated csrc/mix_sched.h against the JAX tool.

The tools are imported from tools/ with importlib and are not edited.
Tests marked `cuda` run the kernels on a card and skip here; the card's
machine has no JAX, so this module imports the JAX tools only inside the
`jt` fixture.
"""

import ctypes
import functools
import importlib.util
import json
import os
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detex_tpu_torch.ops import bptc
from detex_tpu_torch.tools import interleave_probe as IP
from detex_tpu_torch.tools import mxu_probe as MP
from detex_tpu_torch.tools import profile_sections as PS

_REPO = Path(__file__).resolve().parent.parent
_CSRC = _REPO / "detex_tpu_torch" / "csrc"
_FULL = 0xFFFFFFFF
_N = 1024                    # blocks of the bc7_pre and mix-probe checks
_TILE = 128
_SETTINGS = [(_FULL, 0), (_FULL, 2), (_FULL, 4), (0x0F, 0)]


@functools.cache
def _load_tool(name):
    """tools/<name>.py as a module; the environment variable it sets on
    import (a JAX cache directory) is put back."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", _REPO / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    saved = dict(os.environ)
    try:
        spec.loader.exec_module(module)
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return module


@pytest.fixture(scope="module")
def jt():
    """The JAX tools (the card's machine has no JAX: only this fixture and
    the _jax_* helpers it guards import them)."""
    import jax.numpy as jnp
    return SimpleNamespace(mxu=_load_tool("mxu_probe"),
                           ps=_load_tool("profile_sections"), jnp=jnp)


def _closure(fn, name):
    """The value `name` that closure `fn` captured."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _host_lib(tmp_path_factory, shim, opt="-O2"):
    so = tmp_path_factory.mktemp(shim) / f"lib{shim}.so"
    subprocess.run(["g++", "-std=c++17", opt, "-Wall", "-Werror", "-shared",
                    "-fPIC", "-o", str(so), str(_CSRC / f"{shim}.cpp")],
                   check=True)
    return ctypes.CDLL(str(so))


# --- the BC7 pre-gathered-partition probe -----------------------------------


def _bc7_blocks():
    """The tool's forced-mode blocks, random blocks and blocks with byte 0
    = 0 (no mode): _N in all."""
    rng = np.random.default_rng(11)
    zero = rng.integers(0, 256, (128, 16), np.uint8)
    zero[:, 0] = 0
    return np.concatenate([MP.tool_blocks(_N - 256, seed=12),
                           rng.integers(0, 256, (128, 16), np.uint8), zero])


def _words(blocks):
    return np.ascontiguousarray(blocks).view(np.int32).copy()


def _jax_bc7_pre_on(words, pre, mode_mask, flags):
    """tools/mxu_probe.py:_bc7_kernel_pre in decode_mxu's pallas_call (its
    BlockSpecs, tile 128, interpret=True) on (N, 4) words and (N, 2)
    pre-gathered words, N a multiple of 1024: ((N, 16) pixels, (N,)
    valid)."""
    t = _load_tool("mxu_probe")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    n = len(words)
    ell = n // 8
    scal = jnp.asarray(np.array([mode_mask, flags], np.uint32)
                       .view(np.int32))
    pix, valid = pl.pallas_call(
        t._bc7_kernel_pre, grid=(ell // _TILE,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec((4, 8, _TILE), lambda i: (0, 0, i),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((2, 8, _TILE), lambda i: (0, 0, i),
                               memory_space=pltpu.VMEM)],
        out_specs=[pl.BlockSpec((16, 8, _TILE), lambda i: (0, 0, i),
                                memory_space=pltpu.VMEM),
                   pl.BlockSpec((8, _TILE), lambda i: (0, i),
                                memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((16, 8, ell), jnp.int32),
                   jax.ShapeDtypeStruct((8, ell), jnp.int32)],
        interpret=True,
    )(scal, jnp.asarray(words.T.reshape(4, 8, ell)),
      jnp.asarray(pre.T.reshape(2, 8, ell)))
    return (np.asarray(pix).reshape(16, n).T,
            np.asarray(valid).reshape(n) != 0)


@functools.cache
def _jax_bc7_pre(mode_mask, flags):
    """_jax_bc7_pre_on(_bc7_blocks()) with the tool's own pregather."""
    import jax.numpy as jnp
    words = _words(_bc7_blocks())
    pre = np.asarray(_load_tool("mxu_probe").pregather(
        jnp.asarray(words.T.copy()))).T
    return _jax_bc7_pre_on(words, pre, mode_mask, flags)


@pytest.fixture(scope="module")
def bc7_host(tmp_path_factory):
    """bc7.cuh's decode with pre-gathered words, built with g++."""
    fn = _host_lib(tmp_path_factory, "bc7_host").dtx_bc7_pre_decode_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_uint32, ctypes.c_uint32, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = None

    def decode(words, pre, mode_mask, flags):
        words, pre = np.ascontiguousarray(words), np.ascontiguousarray(pre)
        n = len(words)
        pix = np.zeros((n, 16), np.int32)
        valid = np.zeros(n, np.uint8)
        fn(words.ctypes.data, pre.ctypes.data, n, mode_mask & _FULL,
           flags & _FULL, pix.ctypes.data, valid.ctypes.data)
        return pix, valid.astype(bool)

    return decode


def test_pregather_vs_jax(jt):
    words = _words(_bc7_blocks())
    want = np.asarray(jt.mxu.pregather(jt.jnp.asarray(words.T.copy()))).T
    np.testing.assert_array_equal(
        MP.pregather(torch.from_numpy(words)).numpy(), want)
    np.testing.assert_array_equal(MP._np_table(), jt.mxu._TABLE)


@pytest.mark.parametrize("mode_mask,flags", _SETTINGS)
def test_bc7_pre_plain_vs_jax_interpret(jt, mode_mask, flags):
    words = torch.from_numpy(_words(_bc7_blocks()))
    pix, valid = MP.decode_bc7_pre(words, MP.pregather(words), mode_mask,
                                   flags)
    want_pix, want_valid = _jax_bc7_pre(mode_mask, flags)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(pix.numpy(), want_pix)


@pytest.mark.parametrize("mode_mask,flags", _SETTINGS)
def test_bc7_pre_host_kernel_vs_jax_interpret(jt, bc7_host, mode_mask,
                                              flags):
    words = _words(_bc7_blocks())
    pre = MP.pregather(torch.from_numpy(words)).numpy()
    pix, valid = bc7_host(words, pre, mode_mask, flags)
    want_pix, want_valid = _jax_bc7_pre(mode_mask, flags)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(pix, want_pix)


def _any_pre(blocks, anchors):
    """(N, 2) pre-gathered words that no table gives: random subset words
    (each pixel in one of its mode's subsets) with random anchors, or with
    degenerate ones: the anchor at pixel 0, or (three subsets) both at
    pixel 0, one at 0, both equal, and both at pixel 15, where pixel 15's
    index would run past bit 127."""
    rng = np.random.default_rng(31)
    b0 = blocks[:, 0].astype(np.int64)
    mode = np.where(b0 == 0, 0, np.log2(np.maximum(b0 & -b0, 1)).astype(int))
    ns = np.array([3, 2, 3, 2, 1, 1, 1, 2])[mode]
    sub = (rng.integers(0, 3, (len(blocks), 16)) % ns[:, None]) \
        << (2 * np.arange(16))
    pos = rng.integers(0, 0x1000, len(blocks))
    if anchors == "degenerate":
        # a0 (two subsets) = pos & 0xF; a1, a2 (three) = pos >> 4 & 0xF,
        # pos >> 8.  Each keeps a0 = 0.
        a = rng.integers(0, 16, len(blocks))
        kind = rng.integers(0, 4, len(blocks))
        pos = np.choose(kind, [a << 4, a << 8, a * 0x110,
                               np.full_like(a, 0xFF0)])
    return np.stack([sub.sum(1), pos], 1).astype(np.uint32).view(np.int32)


@functools.cache
def _jax_bc7_any_pre(anchors, mode_mask, flags):
    blocks = _bc7_blocks()
    return _jax_bc7_pre_on(_words(blocks), _any_pre(blocks, anchors),
                           mode_mask, flags)


@pytest.mark.parametrize("mode_mask,flags", _SETTINGS)
@pytest.mark.parametrize("anchors", ["random", "degenerate"])
def test_bc7_pre_host_kernel_any_words(jt, bc7_host, anchors, mode_mask,
                                       flags):
    """Pre-gathered words that no table gives (_any_pre), through the host
    build of the kernel's decode (whose pixel-by-pixel stream serves the
    anchors its bit insertion cannot express) and the plain version,
    against the JAX tool's kernel in interpret mode, tolerance 0."""
    blocks = _bc7_blocks()
    words, pre = _words(blocks), _any_pre(blocks, anchors)
    want_pix, want_valid = _jax_bc7_any_pre(anchors, mode_mask, flags)
    pix, valid = bc7_host(words, pre, mode_mask, flags)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(pix, want_pix)
    pix, valid = MP.decode_bc7_pre_plain(
        torch.from_numpy(words), torch.from_numpy(pre), mode_mask, flags)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(pix.numpy(), want_pix)


@pytest.mark.parametrize("mode_mask,flags", _SETTINGS)
def test_bc7_pre_equals_production_decode(mode_mask, flags):
    """The tool's own check (tools/mxu_probe.py:361-367), on the CPU."""
    words = torch.from_numpy(_words(_bc7_blocks()))
    got = MP.decode_mxu(words, mode_mask, flags)
    want = bptc.decode_bptc(words, mode_mask, flags)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


# --- the lane-interleave probe ----------------------------------------------

_LANES = 512                 # two of the tool's 256-lane tiles


def _il_input():
    return IP.tool_input(8 * _LANES, seed=3)


@functools.cache
def _jax_interleave(mode):
    """The tool's kernel of `mode` in run_once's pallas_call (its
    BlockSpecs), interpreted, on _il_input()."""
    t = _load_tool("interleave_probe")
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    tile = t.TILE
    if mode == "planar":
        kern, shape, block = t._kernel_planar, (16, 8, _LANES), (16, 8, tile)
    else:
        kern = t._kernel_rows_strided if mode == "strided" else \
            functools.partial(t._kernel_rows, interleave={
                "stack": t._interleave_stack,
                "repeat": t._interleave_repeat}[mode])
        shape, block = (4, 8, 4 * _LANES), (4, 8, 4 * tile)
    out = pl.pallas_call(
        kern, grid=(_LANES // tile,),
        in_specs=[pl.BlockSpec((16, 8, tile), lambda i: (0, 0, i),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(block, lambda i: (0, 0, i),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(shape, jnp.int32),
        interpret=True)(jnp.asarray(_il_input()))
    return np.asarray(out)


@pytest.fixture(scope="module")
def il_host(tmp_path_factory):
    """interleave.cuh's functions, built with g++."""
    lib = _host_lib(tmp_path_factory, "interleave_host")
    fns = {}
    for mode, name in (("planar", "dtx_planar_add1_host"),
                       ("rows", "dtx_rows_interleave_host")):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = None
        fns[mode] = fn

    def run(mode, xh):
        lanes = xh.shape[2]
        out = np.zeros((16, 8, lanes) if mode == "planar"
                       else (4, 8, 4 * lanes), np.int32)
        fns[mode](xh.ctypes.data, lanes, out.ctypes.data)
        return out

    return run


_JAX_MODES = [("planar", "planar"), ("stack", "rows"), ("repeat", "rows"),
              ("strided", "rows")]


@pytest.mark.parametrize("jax_mode,mode", _JAX_MODES)
def test_interleave_plain_vs_jax_interpret(jt, jax_mode, mode):
    x = torch.from_numpy(_il_input())
    fn = IP.planar_add1 if mode == "planar" else IP.rows_interleave
    np.testing.assert_array_equal(fn(x).numpy(), _jax_interleave(jax_mode))


@pytest.mark.parametrize("jax_mode,mode", _JAX_MODES)
def test_interleave_host_kernel_vs_jax_interpret(jt, il_host, jax_mode,
                                                 mode):
    np.testing.assert_array_equal(il_host(mode, _il_input()),
                                  _jax_interleave(jax_mode))


def test_interleave_wraps_and_ragged_lanes(il_host):
    """int32 wrap-around at 0x7FFFFFFF, and a lane count that is no
    multiple of 4, in the plain versions and the host build alike."""
    xh = np.random.default_rng(4).integers(-2**31, 2**31, (16, 8, 7),
                                           np.int64).astype(np.int32)
    xh[0, 0, 0] = 0x7FFFFFFF
    x = torch.from_numpy(xh)
    np.testing.assert_array_equal(IP.planar_add1(x).numpy(),
                                  il_host("planar", xh))
    np.testing.assert_array_equal(IP.rows_interleave(x).numpy(),
                                  il_host("rows", xh))
    np.testing.assert_array_equal(IP.rows_interleave(x).numpy(),
                                  IP.numpy_rows(xh))
    assert IP.planar_add1(x)[0, 0, 0] == -2**31


# --- the ALU mix probe --------------------------------------------------------


@pytest.mark.parametrize("family", PS.FAMILIES)
def test_census_copy_vs_op_census(jt, family):
    assert tuple(jt.ps.op_census(family).items()) == PS.CENSUS[family]


@pytest.mark.parametrize("family", PS.FAMILIES)
def test_schedule_vs_jax_tool(jt, family):
    call = jt.ps._mix_probe_kernel(dict(PS.CENSUS[family]), _TILE)
    want = _closure(_closure(call, "kernel"), "sched")
    assert PS.schedule(PS.CENSUS[family]) == want


def test_header_is_generated():
    assert (_CSRC / "mix_sched.h").read_text() == PS.header_text()


def _mix_input(n=_N):
    return np.random.default_rng(7).integers(-2**31, 2**31, (n, 4),
                                             np.int64).astype(np.int32)


@functools.cache
def _jax_mix(family):
    """_mix_probe_kernel(census, 128) interpreted on _mix_input()."""
    t = _load_tool("profile_sections")
    import jax.numpy as jnp
    call = t._mix_probe_kernel(dict(PS.CENSUS[family]), _TILE)
    return np.asarray(call(jnp.asarray(_mix_input().T.copy()))).reshape(_N)


@pytest.fixture(scope="module")
def mix_host(tmp_path_factory):
    """mix_probe.cuh's chain, built with g++ for every family."""
    fn = _host_lib(tmp_path_factory, "mix_probe_host", "-O1") \
        .dtx_mix_probe_host
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(xh, family):
        out = np.zeros(len(xh), np.int32)
        assert fn(xh.ctypes.data, len(xh), PS.FAMILIES.index(family),
                  out.ctypes.data) == 0
        return out

    return run


@pytest.mark.parametrize("family", ["EAC_R11", "ETC1"])
def test_mix_probe_plain_vs_jax_interpret(jt, family):
    got = PS.mix_probe(torch.from_numpy(_mix_input()), family).numpy()
    np.testing.assert_array_equal(got, _jax_mix(family))


@pytest.mark.parametrize("family", ["EAC_R11", "ETC1"])
def test_mix_probe_host_kernel_vs_jax_interpret(jt, mix_host, family):
    np.testing.assert_array_equal(mix_host(_mix_input(), family),
                                  _jax_mix(family))


@pytest.mark.parametrize("family", PS.FAMILIES)
def test_mix_probe_host_kernel_vs_plain(mix_host, family):
    xh = _mix_input(256)
    np.testing.assert_array_equal(
        mix_host(xh, family),
        PS.mix_probe(torch.from_numpy(xh), family).numpy())


# --- wrappers and the tools' paths on the CPU ---------------------------------


def test_wrappers_reject_unknown_device():
    meta = functools.partial(torch.zeros, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        MP.decode_bc7_pre(meta((4, 4)), meta((4, 2)))
    with pytest.raises(ValueError):
        IP.planar_add1(meta((16, 8, 4)))
    with pytest.raises(ValueError):
        IP.rows_interleave(meta((16, 8, 4)))
    with pytest.raises(ValueError):
        PS.mix_probe(meta((4, 4)), "BC7")


def test_tools_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (MP.main, IP.main, PS.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


@pytest.mark.parametrize("tool,argv", [
    (MP, ["--device", "cpu", "--n", "512", "--rounds", "1"]),
    (IP, ["--device", "cpu", "--sizes", "256"]),
    (PS, ["--device", "cpu", "--sizes", "64", "EAC_R11", "ETC1"]),
    (PS, ["--no-measure"] + list(PS.FAMILIES)),
])
def test_tool_main_on_cpu(capsys, tool, argv):
    rows = tool.main(argv)
    printed = [json.loads(line) for line in capsys.readouterr().out
               .splitlines() if line.startswith("{")]
    assert rows and printed == rows
    assert all(r.get("device", "cpu") == "cpu" for r in rows)


# --- the CUDA kernels (on a card only) ----------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode_mask,flags", _SETTINGS)
def test_cuda_bc7_pre_vs_plain(cuda, mode_mask, flags):
    words = torch.from_numpy(_words(_bc7_blocks())).to(cuda)
    pre = MP.pregather(words)
    before = MP.KERNEL_LAUNCHES["bc7_pre_decode"]
    p0, v0 = MP.decode_bc7_pre_plain(words, pre, mode_mask, flags)
    p1, v1 = MP.decode_bc7_pre(words, pre, mode_mask, flags)
    p2, v2 = bptc.decode_bptc(words, mode_mask, flags)
    torch.cuda.synchronize()
    assert torch.equal(v0, v1) and torch.equal(p0, p1)
    assert torch.equal(v2, v1) and torch.equal(p2, p1)
    assert MP.KERNEL_LAUNCHES["bc7_pre_decode"] == before + 1
    np.testing.assert_array_equal(
        pre.cpu().numpy(), MP.pregather(words.cpu()).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("anchors", ["random", "degenerate"])
def test_cuda_bc7_pre_any_words_vs_plain(cuda, anchors):
    blocks = _bc7_blocks()
    words = torch.from_numpy(_words(blocks)).to(cuda)
    pre = torch.from_numpy(_any_pre(blocks, anchors)).to(cuda)
    for mode_mask, flags in _SETTINGS:
        p0, v0 = MP.decode_bc7_pre_plain(words, pre, mode_mask, flags)
        p1, v1 = MP.decode_bc7_pre(words, pre, mode_mask, flags)
        torch.cuda.synchronize()
        assert torch.equal(v0, v1) and torch.equal(p0, p1)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [7, _LANES, 8192])
def test_cuda_interleave_vs_plain(cuda, lanes):
    xh = np.random.default_rng(lanes).integers(
        -2**31, 2**31, (16, 8, lanes), np.int64).astype(np.int32)
    x = torch.from_numpy(xh).to(cuda)
    for fn, plain in ((IP.planar_add1, IP.planar_add1_plain),
                      (IP.rows_interleave, IP.rows_interleave_plain)):
        assert torch.equal(fn(x), plain(x))
    assert torch.equal(IP.rows_interleave(x), IP.library_rows(x))


@pytest.mark.cuda
@pytest.mark.parametrize("family", PS.FAMILIES)
def test_cuda_mix_probe_vs_plain(cuda, family):
    x = torch.from_numpy(_mix_input(4099)).to(cuda)
    before = PS.KERNEL_LAUNCHES["mix_probe"]
    got = PS.mix_probe(x, family)
    assert torch.equal(got, PS.mix_probe_plain(x, family))
    assert PS.KERNEL_LAUNCHES["mix_probe"] == before + 1


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_input(cuda):
    z = functools.partial(torch.zeros, device=cuda)
    with pytest.raises(ValueError):
        MP.decode_bc7_pre(z((8, 4), dtype=torch.int32),
                          z((8, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        MP.decode_bc7_pre(z((8, 4), dtype=torch.int32),
                          z((7, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        IP.rows_interleave(z((16, 4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        PS.mix_probe(z((8, 4), dtype=torch.int64), "BC7")
