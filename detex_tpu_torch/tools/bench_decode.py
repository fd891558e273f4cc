"""Decode throughput of BC7 and of every decode family on the card: the
counterpart of the root bench.py.

    python -m detex_tpu_torch.tools.bench_decode [--n-blocks 65536,1048576]
        [--families-out PATH] [--no-families] [--device cpu]

Prints, as bench.py does, the headline line first: BC7's
bc7_decode_blocks_per_s at the first N (bench.py's 65,536 blocks, a 1024^2
texture) with bench.py's keys, then one such line for each further N (by
default 1,048,576, a 4K mip), then one line {"families": {...}} with the
rate of each of the 19 decode variants of bench.py's _family_table at each
N.  --families-out also writes that line's object to a file; nothing is
written otherwise (bench.py's BENCH_FAMILIES.json belongs to the JAX
package).  --no-families skips the sweep (bench.py's
DETEX_BENCH_FAMILIES=0).

The inputs are bench.py's, byte for byte: the headline's blocks from seed
42 with a valid BC7 mode prefix (headline_blocks), each family's from one
seed-7 generator drawn across the families in table order
(family_blocks).

Rate on the card (the counterpart of bench.py's fori_loop body, which
decodes `wp ^ i` at step i): R copies `words ^ r`, r = 0 .. R - 1, are made
before timing, enough that they span twice the card's L2 cache, so no
launch reads a source a recent launch left there.  One captured CUDA graph
(graphs.Graph) holds K back-to-back launches of the family's wrapper,
launch i on copy i mod R, each output freed inside the capture; K is chosen
so that a replay holds about 2 ms of device time.  A launch cannot be
elided, so bench.py's `acc ^ pix[0]` fold is not needed.  The rate is N * K
over the median of REPLAYS replays after one warm replay, each timed by
CUDA events; spread_pct is bench.py's (highest rate - lowest) / highest.
device_us beside it is the device time per launch by tools.device_ms
(launches queued on a stream behind a spin kernel, on the same copies in
the same order).  The two part by the gap between one kernel and the next:
a graph's kernel nodes follow each other closer than launches queued on a
stream, by 1-2 us a launch on an H100 (PERF.md section 6).

Witness (bench.py's witness_correctness): the output of the graph's launch
on copy 0, the unperturbed blocks, is held bit-equal to the native C++
runtime (detex_tpu_torch.native: valid flags everywhere, pixels where the
block is valid) and to the family's plain version on the same device
(pixels and valid flags everywhere).  Any difference raises; there is no
"skipped".

Baseline (bench.py's bench_reference): native.decode("BPTC") on one thread
over the headline's 65,536 blocks, one warm pass then one timed pass, host
clock; vs_baseline is ours / that.  bench.py divides by the C reference,
which needs a build of the reference sources the port does not carry.

--device defaults to the card and raises without one.  --device cpu runs
the plain versions (the wrappers on CPU tensors), two copies and two calls
a timed run on the host clock, with the same witness: for tests at a small
--n-blocks, never a fallback.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import math
import statistics
import time
from pathlib import Path

import numpy as np
import torch

from detex_tpu_torch import graphs, native, tools
from detex_tpu_torch.ops import bc, bptc, bptc_float, eac, etc, rgtc

N_BLOCKS = 1 << 16          # bench.py's N: a 1024x1024 texture
DEFAULT_N = (N_BLOCKS, 1 << 20)
REPLAYS = 5                 # timed replays after one warm one
REPLAY_MS = 2.0             # device time a replay holds, at least
MAX_COPIES = 4096
MAX_LAUNCHES = 8192
CPU_COPIES = 2
BASELINE = "native dtxnative.cpp, 1 thread"
_FULL = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Family:
    """One decode variant of bench.py's _family_table: its name (also the
    native runtime's), the port's module and wrapper, its block bytes and
    bench.py's block fixup, the CUDA kernel the wrapper launches, the
    source that defines it, and the tile of blocks one CUDA block of that
    kernel decodes (None where each thread stores its own block)."""

    name: str
    module: object
    wrapper: str
    block_bytes: int
    fixup: str | None
    kernel: str
    source: str
    tile: int | None

    def decode(self):
        """The wrapper, looked up at call time."""
        return getattr(self.module, self.wrapper)

    def plain(self):
        return getattr(self.module, self.wrapper + "_plain")


def _family(name, module, wrapper, bb, kernel, source, tile, fixup=None):
    return name, Family(name, module, wrapper, bb, fixup, kernel,
                        "detex_tpu_torch/csrc/" + source, tile)


# bench.py's _family_table (bench.py:241-278), in its order.
FAMILIES = dict((
    _family("BC1", bc, "decode_bc1", 8, "bc1_kernel", "bc.cu", 128),
    _family("BC1A", bc, "decode_bc1a", 8, "bc1_kernel", "bc.cu", 128),
    _family("BC2", bc, "decode_bc2", 16, "bc23_kernel", "bc.cu", 128),
    _family("BC3", bc, "decode_bc3", 16, "bc23_kernel", "bc.cu", 128),
    _family("RGTC1", rgtc, "decode_rgtc1", 8, "rgtc1_kernel", "bc.cu", None),
    _family("SIGNED_RGTC1", rgtc, "decode_signed_rgtc1", 8, "rgtc1_kernel",
            "bc.cu", None),
    _family("RGTC2", rgtc, "decode_rgtc2", 16, "rgtc2_kernel", "bc.cu", None),
    _family("SIGNED_RGTC2", rgtc, "decode_signed_rgtc2", 16, "rgtc2_kernel",
            "bc.cu", None),
    _family("BPTC", bptc, "decode_bptc", 16, "bc7_kernel", "bc7.cu", 256,
            "bc7_mode"),
    _family("BPTC_FLOAT", bptc_float, "decode_bptc_float", 16, "bc6h_kernel",
            "bc6h.cu", 128, "bc6h_mode"),
    _family("BPTC_SIGNED_FLOAT", bptc_float, "decode_bptc_signed_float", 16,
            "bc6h_kernel", "bc6h.cu", 128, "bc6h_mode"),
    _family("ETC1", etc, "decode_etc1", 8, "etc_kernel", "etc_eac.cu", 128),
    _family("ETC2", etc, "decode_etc2", 8, "etc_kernel", "etc_eac.cu", 128),
    _family("ETC2_PUNCHTHROUGH", etc, "decode_etc2_punchthrough", 8,
            "etc_kernel", "etc_eac.cu", 128),
    _family("ETC2_EAC", etc, "decode_etc2_eac", 16, "etc2_eac_kernel",
            "etc_eac.cu", 128),
    _family("EAC_R11", eac, "decode_eac_r11", 8, "eac_r11_kernel",
            "etc_eac.cu", None),
    _family("EAC_SIGNED_R11", eac, "decode_eac_signed_r11", 8,
            "eac_r11_kernel", "etc_eac.cu", None),
    _family("EAC_RG11", eac, "decode_eac_rg11", 16, "eac_rg11_kernel",
            "etc_eac.cu", 128),
    _family("EAC_SIGNED_RG11", eac, "decode_eac_signed_rg11", 16,
            "eac_rg11_kernel", "etc_eac.cu", 128),
))


def headline_blocks(n: int) -> np.ndarray:
    """bench.py main's blocks (bench.py:352-359) at n: random bytes from
    seed 42 with a valid, uniformly random BC7 mode prefix."""
    rng = np.random.default_rng(42)
    blocks = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    modes = rng.integers(0, 8, size=n)
    blocks[:, 0] = ((1 << modes)
                    | (blocks[:, 0] & (0xFF << (modes + 1)))).astype(np.uint8)
    return blocks


def family_blocks(rng, n: int, bb: int, fixup) -> np.ndarray:
    """bench.py's _family_blocks (bench.py:281-292) at n: random bytes, a
    valid BC7 mode prefix for "bc7_mode", BC6H mode 0 or 1 for
    "bc6h_mode" (a reserved code fails the block)."""
    blocks = rng.integers(0, 256, (n, bb), np.uint8)
    if fixup == "bc7_mode":
        modes = rng.integers(0, 8, n)
        blocks[:, 0] = ((1 << modes)
                        | (blocks[:, 0] & (0xFF << (modes + 1)))
                        ).astype(np.uint8)
    elif fixup == "bc6h_mode":
        blocks[:, 0] = ((blocks[:, 0] & 0xFC)
                        | rng.integers(0, 2, n)).astype(np.uint8)
    return blocks


def _words(blocks: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(blocks).view(np.int32)
                            .copy()).to(device)


def l2_bytes(device: torch.device):
    """The card's L2 cache in bytes, or None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).L2_cache_size


def copies_needed(n: int, bb: int, device: torch.device) -> int:
    """R: enough copies of n blocks of bb bytes to span twice the card's L2
    (at most MAX_COPIES); CPU_COPIES on the CPU."""
    l2 = l2_bytes(device)
    if l2 is None:
        return CPU_COPIES
    return max(1, min(MAX_COPIES, math.ceil(2 * l2 / (n * bb))))


def perturbed(words: torch.Tensor, r: int) -> list:
    """Copies words ^ i, i = 0 .. r - 1 (bench.py's `wp ^ i`, every word,
    mode bits included), each contiguous and aligned as its rows need."""
    shifts = torch.arange(r, dtype=torch.int32, device=words.device)
    return list((words.unsqueeze(0) ^ shifts.view(r, 1, 1)).unbind(0))


def spread_pct(rates) -> float:
    """bench.py's spread: (highest rate - lowest) / highest, in percent."""
    rates = sorted(rates)
    return round(100 * (rates[-1] - rates[0]) / rates[-1], 2)


def _launches(decode, copies: list, k: int):
    """K launches of decode, launch i on copy i mod R; returns launch 0's
    output (copy 0 is the unperturbed words) and drops the others."""
    first = decode(copies[0])
    for i in range(1, k):
        decode(copies[i % len(copies)])
    return first


def _graph_rate(fam: Family, copies: list, k: int, device: torch.device):
    """(launch 0's (pixels, valid) as the graph's last replay wrote them,
    the replays' ms, the graph).  The caller keeps the graph while it reads
    its output, and the copies, which the graph reads, outlive it."""
    decode = fam.decode()
    graph = graphs.Graph(device)
    graph.capture(lambda: _launches(decode, copies, k))
    graph.replay()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPLAYS)]
    for start, end in events:
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize(device)
    return graph.out, [s.elapsed_time(e) for s, e in events], graph


def _host_rate(fam: Family, copies: list, k: int):
    """(launch 0's output, each timed run's ms by the host clock)."""
    decode = fam.decode()
    _launches(decode, copies, k)
    ms = []
    for _ in range(REPLAYS):
        t0 = time.perf_counter()
        out = _launches(decode, copies, k)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, ms


def witness(fam: Family, blocks: np.ndarray, words: torch.Tensor,
            pix: torch.Tensor, valid: torch.Tensor) -> str:
    """Hold (pix, valid), the decode of `blocks` (`words` on the device),
    to the native runtime (valid flags everywhere, pixels on its valid
    blocks, which it alone zero-fills) and to the plain version on the
    same device (everything).  Returns "ok"; raises on any difference."""
    n = len(blocks)
    ours = pix.cpu().numpy().view(np.uint8).reshape(n, -1)
    ours_valid = valid.cpu().numpy()
    want, want_valid = native.decode(fam.name, blocks)
    if not np.array_equal(ours_valid, want_valid):
        raise AssertionError(
            f"{fam.name} valid-mask miscompare against native: "
            f"{int(np.sum(ours_valid != want_valid))} blocks differ")
    bad = np.nonzero(np.any(ours[want_valid] != want[want_valid], axis=1))[0]
    if bad.size:
        raise AssertionError(
            f"{fam.name} pixel miscompare against native: {bad.size} of "
            f"{int(want_valid.sum())} valid blocks differ")
    p_plain, v_plain = fam.plain()(words, _FULL, 0)
    if not (torch.equal(p_plain, pix) and torch.equal(v_plain, valid)):
        diff = int(((p_plain != pix).any(1) | (v_plain != valid)).sum())
        raise AssertionError(f"{fam.name} miscompare against its plain "
                             f"version on {words.device}: {diff} blocks")
    return "ok"


def measure(fam: Family, blocks: np.ndarray, device: torch.device,
            k: int | None = None) -> dict:
    """fam's rate on `blocks` and its witness: {"blocks_per_s",
    "spread_pct", "device_us", "correctness", "n_blocks", "tile",
    "l2_resident", "launches_per_replay", "copies"}.  k fixes K (launches
    a replay); by default it is chosen from device_us."""
    n = len(blocks)
    words = _words(blocks, device)
    copies = perturbed(words, copies_needed(n, fam.block_bytes, device))
    r = len(copies)
    # `graph` is held until the witness has read the output in its pool.
    graph, device_us = None, None
    if device.type == "cuda":
        decode = fam.decode()
        order = itertools.count()
        device_us = 1e3 * statistics.median(
            tools.device_ms(lambda: decode(copies[next(order) % r]))
            for _ in range(5))
        if k is None:
            # Every copy read once a replay, so a copy is read again only
            # after R - 1 others have passed through L2.
            k = min(MAX_LAUNCHES,
                    max(r, math.ceil(REPLAY_MS * 1e3 / device_us)))
        (pix, valid), ms, graph = _graph_rate(fam, copies, k, device)
    else:
        k = k or r
        (pix, valid), ms = _host_rate(fam, copies, k)
    rates = [n * k / (t / 1e3) for t in ms]
    correctness = witness(fam, blocks, words, pix, valid)
    l2 = l2_bytes(device)
    nbytes = n * (fam.block_bytes + pix.shape[1] * 4 + 1)
    return {"n_blocks": n, "blocks_per_s": statistics.median(rates),
            "tile": fam.tile, "spread_pct": spread_pct(rates),
            "device_us": device_us, "correctness": correctness,
            "l2_resident": None if l2 is None else nbytes <= l2,
            "launches_per_replay": k, "copies": r}


def bench_reference(blocks: np.ndarray) -> float:
    """The native runtime's BC7 rate on one thread, blocks/s: one warm pass,
    then one timed pass, host clock."""
    native.decode("BPTC", blocks, n_threads=1)
    t0 = time.perf_counter()
    native.decode("BPTC", blocks, n_threads=1)
    return len(blocks) / (time.perf_counter() - t0)


def headline(n: int, baseline: float, device: torch.device,
             card: str) -> dict:
    """BC7's line at n blocks, with bench.py's keys."""
    m = measure(FAMILIES["BPTC"], headline_blocks(n), device)
    value = m.pop("blocks_per_s")
    return {"metric": "bc7_decode_blocks_per_s", "value": value,
            "unit": "blocks/s", "vs_baseline": round(value / baseline, 3),
            "baseline": BASELINE, "baseline_blocks_per_s": baseline,
            "card": card, "platform": device.type, **m}


def bench_families(ns, device: torch.device, card: str) -> dict:
    """Every family's rate and witness at each n, each n drawing its blocks
    from a fresh seed-7 generator in table order, as bench.py's sweep."""
    out = {"n_blocks": list(ns), "unit": "blocks/s",
           "method": (f"N * K blocks over a captured graph of K launches "
                      f"on copies words ^ r spanning twice L2, median of "
                      f"{REPLAYS} replays by CUDA events"
                      if device.type == "cuda" else
                      f"N * K blocks over K calls of the plain version, "
                      f"median of {REPLAYS} runs by the host clock"),
           "card": card, "platform": device.type, "families": {}}
    for n in ns:
        rng = np.random.default_rng(7)
        for name, fam in FAMILIES.items():
            blocks = family_blocks(rng, n, fam.block_bytes, fam.fixup)
            row = measure(fam, blocks, device)
            out["families"].setdefault(name, {})[str(n)] = row
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-blocks", default=",".join(map(str, DEFAULT_N)),
                    help="comma-separated block counts; the first is the "
                         "headline's")
    ap.add_argument("--families-out", type=Path, default=None,
                    help="also write the families' JSON here")
    ap.add_argument("--no-families", action="store_true",
                    help="skip the all-family sweep")
    tools.device_arg(ap)
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)
    ns = [int(x) for x in args.n_blocks.split(",")]
    if min(ns) < 1:
        ap.error(f"--n-blocks {args.n_blocks}: each count must be >= 1")
    card = tools.card(device)

    baseline = bench_reference(headline_blocks(N_BLOCKS))
    rows = []
    for n in ns:
        rows.append(headline(n, baseline, device, card))
        print(json.dumps(rows[-1]), flush=True)
    if not args.no_families:
        fam = bench_families(ns, device, card)
        if args.families_out is not None:
            args.families_out.write_text(json.dumps(fam, indent=1) + "\n")
        rows.append(fam)
        print(json.dumps(fam), flush=True)
    return rows


if __name__ == "__main__":
    main()
