"""detex_tpu_torch/tools/bench_decode.py, the port's counterpart of the root
bench.py, on the CPU: its inputs byte-equal to bench.py's, its family table
bench.py's, each family's decode (the plain version) bit-equal to the JAX
decoder bench.py times (its Pallas kernel in interpret mode, as
tests/test_pallas.py runs it) and to the native runtime, main's lines with
bench.py's keys, the witness biting, the card as the default.

bench.py is read, not imported: its top level puts tools/ on sys.path and
sets a JAX cache directory.  Its functions are compiled from its source.

The test marked `cuda` runs the graph path on a card and skips here.
"""

import ast
import dataclasses
import json
import math
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from detex_tpu_torch import native
from detex_tpu_torch.ops import bc, bptc, eac, etc
from detex_tpu_torch.tools import bench_decode as BD

_REPO = Path(__file__).resolve().parent.parent
_BENCH = _REPO / "bench.py"
_CSRC = _REPO / "detex_tpu_torch" / "csrc"
_NAMES = list(BD.FAMILIES)
_N_JAX = 1024       # blocks each family's decode is held to JAX on


def _bench_tree():
    return ast.parse(_BENCH.read_text(), str(_BENCH))


def _bench_functions(*names) -> dict:
    """bench.py's top-level functions `names`, compiled from its source
    into a namespace that holds numpy and bench.py's N_BLOCKS."""
    nodes = [n for n in _bench_tree().body
             if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in nodes} == set(names)
    ns = {"np": np, "N_BLOCKS": BD.N_BLOCKS}
    exec(compile(ast.Module(nodes, []), str(_BENCH), "exec"), ns)
    return ns


def _headline_keys() -> set:
    """The keys of the dict bench.py prints as its headline line."""
    for node in ast.walk(_bench_tree()):
        if isinstance(node, ast.Dict):
            names = [k.value for k in node.keys
                     if isinstance(k, ast.Constant)]
            if "metric" in names:
                return set(names)
    raise AssertionError("bench.py prints no dict with a metric")


@pytest.fixture(scope="module")
def jax_table():
    """bench.py's _family_table(): name -> (planar JAX decoder, block
    bytes, v5e tile, fixup)."""
    return _bench_functions("_family_table")["_family_table"]()


def _drawn(name: str, draw) -> np.ndarray:
    """The blocks of family `name` from one seed-7 generator drawn across
    the families in table order up to it, by draw(rng, family)."""
    rng = np.random.default_rng(7)
    for fam in BD.FAMILIES.values():
        blocks = draw(rng, fam)
        if fam.name == name:
            return blocks
    raise KeyError(name)


def _port_blocks(name: str) -> np.ndarray:
    return _drawn(name, lambda rng, f: BD.family_blocks(
        rng, BD.N_BLOCKS, f.block_bytes, f.fixup))


# --- inputs ---------------------------------------------------------------


def test_headline_blocks_are_bench_py_recipe():
    """bench.py main's statements up to its blocks' mode prefix, run as
    written, give headline_blocks(65536) byte for byte."""
    main = next(n for n in _bench_tree().body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = []
    for stmt in main.body:
        body.append(stmt)
        if isinstance(stmt, ast.Assign) and \
                isinstance(stmt.targets[0], ast.Subscript):
            break
    ns = {"np": np, "N_BLOCKS": BD.N_BLOCKS}
    exec(compile(ast.Module(body, []), str(_BENCH), "exec"), ns)
    want = BD.headline_blocks(BD.N_BLOCKS)
    assert want.shape == (65536, 16) and want.dtype == np.uint8
    np.testing.assert_array_equal(ns["blocks"], want)


def test_families_are_bench_py_table(jax_table):
    assert _NAMES == list(jax_table)
    for name, (_, bb, _, fixup) in jax_table.items():
        fam = BD.FAMILIES[name]
        assert (fam.name, fam.block_bytes, fam.fixup) == (name, bb, fixup)
        assert native.family_info(name)[0] == bb


@pytest.mark.parametrize("name", _NAMES)
def test_family_blocks_byte_equal_to_bench_py(name):
    bench = _bench_functions("_family_blocks")["_family_blocks"]
    want = _drawn(name, lambda rng, f: bench(rng, f.block_bytes, f.fixup))
    got = _port_blocks(name)
    assert got.shape == (BD.N_BLOCKS, BD.FAMILIES[name].block_bytes)
    np.testing.assert_array_equal(got, want)


def test_tiles_match_sources():
    """Each family's tile is its kernel's: kThreads * kRounds of its source
    where the kernel decodes a tile (decode_tile, bc7_tile), None where
    each thread stores its own block."""
    threads = int(re.search(r"constexpr int kThreads = (\d+);",
                            (_CSRC / "dtx_hd.cuh").read_text()).group(1))
    for fam in BD.FAMILIES.values():
        src = (_REPO / fam.source).read_text()
        rounds = int(re.search(r"constexpr int kRounds = (\d+);",
                               src).group(1))
        m = re.search(rf"__global__[^{{]*?\b{fam.kernel}\(.*?\n}}\n", src,
                      re.S)
        assert m, fam.kernel
        tiled = "decode_tile" in m.group(0) or "bc7_tile" in m.group(0)
        assert fam.tile == (threads * rounds if tiled else None), fam.name


# --- each family's decode against JAX and native ---------------------------


@pytest.mark.parametrize("name", _NAMES)
def test_family_decode_vs_jax_and_native(jax_table, name):
    """On the first 1,024 of bench.py's blocks of the family: the port's
    wrapper on the CPU (the plain version) bit-equal to bench.py's JAX
    decoder (Pallas interpret mode), pixels and valid flags everywhere, and
    to native (valid flags everywhere, pixels on valid blocks)."""
    fam = BD.FAMILIES[name]
    blocks = _port_blocks(name)[:_N_JAX]
    pix, valid = fam.decode()(torch.from_numpy(
        np.ascontiguousarray(blocks).view(np.int32).copy()))
    pix, valid = pix.numpy(), valid.numpy()
    fn = jax_table[name][0]
    planar = np.ascontiguousarray(np.ascontiguousarray(blocks).view(np.uint32)
                                  .astype(np.int64).astype(np.int32).T)
    p_jax, v_jax = fn(planar, tile=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(v_jax), valid)
    np.testing.assert_array_equal(np.ascontiguousarray(np.asarray(p_jax).T),
                                  pix)
    want, want_valid = native.decode(name, blocks)
    ours = np.ascontiguousarray(pix).view(np.uint8).reshape(_N_JAX, -1)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(ours[want_valid], want[want_valid])
    assert valid.any()


# --- the timing path's pieces ----------------------------------------------


def test_copies_spread_and_l2_span(monkeypatch):
    words = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    copies = BD.perturbed(words, 3)
    for i, c in enumerate(copies):
        assert c.is_contiguous() and torch.equal(c, words ^ i)
    assert BD.spread_pct([90.0, 100.0, 95.0]) == 10.0
    cpu = torch.device("cpu")
    assert BD.l2_bytes(cpu) is None
    assert BD.copies_needed(65536, 16, cpu) == BD.CPU_COPIES
    monkeypatch.setattr(BD, "l2_bytes", lambda device: 50 << 20)
    # 1 MiB of BC7 words a copy, 16 MiB at 1,048,576: 100 and 7 copies.
    assert BD.copies_needed(65536, 16, cpu) == 100
    assert BD.copies_needed(1 << 20, 16, cpu) == 7
    assert BD.copies_needed(1, 8, cpu) == BD.MAX_COPIES


def test_measure_launches_in_copy_order(monkeypatch):
    """Launch i reads copy i mod R, and the witness reads launch 0's output,
    the unperturbed blocks' decode."""
    seen = []
    base = BD.FAMILIES["BC1"]

    def decode(words, mode_mask=BD._FULL, flags=0):
        seen.append(int(words[0, 0] ^ base_word))
        return bc.decode_bc1(words, mode_mask, flags)

    fam = dataclasses.replace(base, module=SimpleNamespace(
        decode_bc1=decode, decode_bc1_plain=bc.decode_bc1_plain))
    blocks = _port_blocks("BC1")[:256]
    base_word = int(blocks[:1].view(np.int32)[0, 0])
    row = BD.measure(fam, blocks, torch.device("cpu"), k=3)
    assert seen == [0, 1, 0] * (1 + BD.REPLAYS)
    assert row["correctness"] == "ok" and row["launches_per_replay"] == 3
    assert row["copies"] == 2 and row["n_blocks"] == 256
    assert row["tile"] == 128 and row["device_us"] is None
    assert row["blocks_per_s"] > 0 and row["l2_resident"] is None


# --- main -------------------------------------------------------------------


def _lines(capsys) -> list:
    return [json.loads(x) for x in capsys.readouterr().out.splitlines()]


def test_main_cpu(capsys, tmp_path):
    """The headline line holds every key of bench.py's but the TPU clock
    canary; the families line follows with all 19; --families-out gets the
    same object and BENCH_FAMILIES.json is left as it is."""
    jax_file = _REPO / "BENCH_FAMILIES.json"
    before = jax_file.read_bytes()
    out = tmp_path / "families.json"
    rows = BD.main(["--device", "cpu", "--n-blocks", "1024",
                    "--families-out", str(out)])
    lines = _lines(capsys)
    assert lines == json.loads(json.dumps(rows)) and len(lines) == 2
    head = lines[0]
    assert _headline_keys() - {"canary_gops"} <= set(head)
    assert "canary_gops" in _headline_keys()
    assert head["metric"] == "bc7_decode_blocks_per_s"
    assert head["correctness"] == "ok" and head["unit"] == "blocks/s"
    assert head["n_blocks"] == 1024 and head["tile"] == 256
    assert head["platform"] == "cpu" and head["card"] == "cpu"
    assert head["baseline"] == BD.BASELINE and head["value"] > 0
    assert head["vs_baseline"] == round(
        head["value"] / head["baseline_blocks_per_s"], 3)
    fam = lines[1]
    assert list(fam["families"]) == _NAMES
    for name, by_n in fam["families"].items():
        row = by_n["1024"]
        assert row["correctness"] == "ok" and row["blocks_per_s"] > 0
        assert row["tile"] == BD.FAMILIES[name].tile
        assert {"spread_pct", "device_us"} <= set(row)
    assert json.loads(out.read_text()) == fam
    assert jax_file.read_bytes() == before


def test_main_a_line_per_n(capsys):
    rows = BD.main(["--device", "cpu", "--n-blocks", "256,512",
                    "--no-families"])
    lines = _lines(capsys)
    assert lines == json.loads(json.dumps(rows))
    assert [r["n_blocks"] for r in lines] == [256, 512]
    assert all(r["correctness"] == "ok" for r in lines)


def _flipped(fn, what: str):
    """fn with one output changed: "pixel" a pixel word of block 0,
    "valid" block 0's flag, "invalid" a pixel word of the first block the
    decode calls invalid (which native does not compare)."""
    def wrapper(words, mode_mask=BD._FULL, flags=0):
        pix, valid = fn(words, mode_mask, flags)
        pix, valid = pix.clone(), valid.clone()
        if what == "valid":
            valid[0] = ~valid[0]
        else:
            i = int(torch.nonzero(~valid)[0, 0]) if what == "invalid" else 0
            pix[i, 0] ^= 1
        return pix, valid
    return wrapper


@pytest.mark.parametrize("module,wrapper,what,match", [
    (bptc, "decode_bptc", "pixel", "BPTC pixel miscompare against native"),
    (bptc, "decode_bptc", "valid", "BPTC valid-mask"),
    (eac, "decode_eac_signed_rg11", "pixel", "EAC_SIGNED_RG11 pixel"),
    (etc, "decode_etc1", "invalid",
     "ETC1 miscompare against its plain version")])
def test_witness_bites(monkeypatch, module, wrapper, what, match):
    monkeypatch.setattr(module, wrapper,
                        _flipped(getattr(module, wrapper), what))
    with pytest.raises(AssertionError, match=match):
        BD.main(["--device", "cpu", "--n-blocks", "512"])


@pytest.mark.parametrize("n_blocks", ["0", "1024,0"])
def test_n_blocks_must_be_positive(n_blocks):
    with pytest.raises(SystemExit):
        BD.main(["--device", "cpu", "--n-blocks", n_blocks])


def test_default_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BD.main([])


# --- on a card only ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["BPTC", "BPTC_FLOAT", "EAC_R11"])
def test_cuda_measure_graph(cuda, name):
    """The graph path at a small K: 8 launches a replay, witnessed against
    native and the plain version on the card; the replays' launches
    counted (2 warm-ups, 1 warm replay, the timed ones)."""
    fam = BD.FAMILIES[name]
    blocks = _port_blocks(name)[:4096]
    before = dict(BD.graphs.launch_counts())
    row = BD.measure(fam, blocks, cuda, k=8)
    after = BD.graphs.launch_counts()
    assert row["correctness"] == "ok" and row["launches_per_replay"] == 8
    assert row["blocks_per_s"] > 0 and row["device_us"] > 0
    assert row["l2_resident"] is True
    assert row["copies"] == min(BD.MAX_COPIES, math.ceil(
        2 * BD.l2_bytes(cuda) / (4096 * fam.block_bytes)))
    name_count = {"BPTC": "bptc", "BPTC_FLOAT": "bptc_float",
                  "EAC_R11": "eac_r11"}[name]
    # device_ms: 5 windows of 1 + 20 calls; the graph: 8 x (2 + 1 + 5).
    assert after[name_count] - before[name_count] == 5 * 21 + 8 * 8
