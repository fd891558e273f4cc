"""Every pixel conversion the host converter allows, run through
convert_device on the card (or the CPU) and held bit-equal to the host
converter (the port's copy of convert.convert_pixels, convert.c:1082-1166).

    python -m detex_tpu_torch.tools.convert_sweep [--device cpu]
        [SOURCE_FORMAT ...]

A pair is any two formats of convert.TABLE with a path between them
(match_conversion: the 73 direct edges and every path of two, three and
four steps; 449 pairs over 34 formats).  Each source format gets one
buffer, seeded by (SEED, format): rows of special values first, then
N_RANDOM random pixels.  The special rows set every lane of a pixel to one
value, then rotate the values across the lanes: for half and float lanes
+-0, the least and largest denormals, the least normal, +-1, +-the largest
finite, +-inf and quiet, signalling and negative NaNs; for integer lanes 0,
the largest value and the signed limits (0x7F.., 0x80..).  Every pair runs
under the default HDR parameters (1, 0, 1) and under (2.2, 0, 4), which
the HDR edges read (the gamma != 1 half table among them).

On a card each pair is its key's first call of convert_pixels_torch, which
runs eagerly (a graph of the same ops replays from the second call).
Prints one JSON line: pairs checked, pairs differing (each with its HDR
parameters and differing bytes); exits 1 if any pair differs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from detex_tpu_torch import convert, tools
from detex_tpu_torch import convert_device as CD
from detex_tpu_torch import formats as F
from detex_tpu_torch import hdr

HDR_SETTINGS = ((1.0, 0.0, 1.0), (2.2, 0.0, 4.0))
N_RANDOM, SEED = 257, 0
SPECIAL_F16 = np.array(
    [0x0000, 0x8000, 0x0001, 0x8001, 0x03FF, 0x83FF, 0x0400, 0x3C00,
     0xBC00, 0x7BFF, 0xFBFF, 0x7C00, 0xFC00, 0x7E00, 0x7C01, 0xFE00,
     0xFFFF], np.uint16)
SPECIAL_F32 = np.array(
    [0x00000000, 0x80000000, 0x00000001, 0x80000001, 0x007FFFFF,
     0x807FFFFF, 0x00800000, 0x3F800000, 0xBF800000, 0x7F7FFFFF,
     0xFF7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
     0xFFC00000, 0xFFFFFFFF], np.uint32)
SPECIAL_U8 = np.array([0x00, 0xFF, 0x7F, 0x80], np.uint8)
SPECIAL_U16 = np.array([0x0000, 0xFFFF, 0x7FFF, 0x8000], np.uint16)


def formats() -> list:
    """Every format of the conversion table, in numeric order."""
    return sorted({s for s, _, _ in convert.TABLE}
                  | {d for _, d, _ in convert.TABLE})


def pairs(sources=None) -> list:
    """(src, dst) for every pair of distinct formats with a conversion
    path, sources in `sources` (all by default)."""
    every = formats()
    return [(s, d) for s in (every if sources is None else sources)
            for d in every
            if s != d and convert.match_conversion(s, d) is not None]


def _specials(fmt: int) -> np.ndarray:
    size = F.component_size(fmt)
    if F.is_float(fmt):
        return SPECIAL_F16 if size == 2 else SPECIAL_F32
    return SPECIAL_U8 if size == 1 else SPECIAL_U16


def sweep_buffer(fmt: int, n_random: int = N_RANDOM) -> tuple:
    """(flat uint8 buffer, pixel count) for `fmt`: the special rows (each
    value in every lane; then each row's values rotated one lane per lane)
    and n_random pixels of random bytes from default_rng((SEED, fmt))."""
    sp = _specials(fmt)
    lanes = F.pixel_size(fmt) // F.component_size(fmt)
    step = np.arange(lanes)
    rows = np.stack([sp[(v + j * step) % sp.size]
                     for j in (0, 1) for v in range(sp.size)])
    rng = np.random.default_rng((SEED, fmt))
    rand = rng.integers(0, 256, n_random * F.pixel_size(fmt), np.uint8)
    buf = np.concatenate([rows.view(np.uint8).ravel(), rand])
    return buf, rows.shape[0] + n_random


def sweep(device, sources=None, oracle=convert.convert_pixels,
          set_hdr=hdr.set_hdr_parameters) -> dict:
    """Every pair from `sources` (all formats by default) under each of
    HDR_SETTINGS: convert_device.convert_pixels_torch on `device` against
    oracle(buf, n, src, dst), byte for byte.  set_hdr(gamma, min, max) sets
    the HDR parameters both sides read; the port's parameters found on
    entry are set again on exit.  Returns {"pairs": pairs checked,
    "runs": conversions run, "differing": [[src name, dst name, HDR
    parameters, differing bytes], ...]}."""
    found = hdr.get_hdr_parameters()
    todo = pairs(sources)
    differing = []
    try:
        for params in HDR_SETTINGS:
            set_hdr(*params)
            bufs = {}
            for src, dst in todo:
                if src not in bufs:
                    bufs[src] = sweep_buffer(src)
                buf, n = bufs[src]
                got = CD.convert_pixels_torch(buf, n, src, dst, device)
                with np.errstate(all="ignore"):     # NaN and inf lanes
                    want = oracle(buf, n, src, dst)
                if got.shape != want.shape or not np.array_equal(got, want):
                    bad = (int((got != want).sum()) if got.shape == want.shape
                           else -1)
                    differing.append([F.format_name(src), F.format_name(dst),
                                      list(params), bad])
    finally:
        set_hdr(found.gamma, found.range_min, found.range_max)
    return {"pairs": len(todo), "runs": len(todo) * len(HDR_SETTINGS),
            "differing": differing}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="*",
                    help="source format names (all by default)")
    tools.device_arg(ap)
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)
    names = {F.format_name(f): f for f in formats()}
    unknown = set(args.sources) - set(names)
    if unknown:
        ap.error(f"unknown formats {sorted(unknown)}")
    t0 = time.perf_counter()
    out = sweep(device, [names[s] for s in args.sources] or None)
    row = dict(out, seconds=time.perf_counter() - t0,
               platform=device.type, device=tools.card(device))
    print(json.dumps(row), flush=True)
    if out["differing"]:
        sys.exit(1)
    return row


if __name__ == "__main__":
    main()
