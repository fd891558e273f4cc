"""Per-family op census and ALU mix probe on an NVIDIA card: the
counterpart of tools/profile_sections.py.

    python -m detex_tpu_torch.tools.profile_sections [FAMILY ...]
        [--device cpu] [--sizes 65536,1048576] [--no-measure]
    python -m detex_tpu_torch.tools.profile_sections --write-header

For each family it prints the census, the measured rate of the port's
decode kernel (through the port's wrapper, at each size), the rate of the
mix probe on the census, and their ratio.

The census is the TPU kernel's: the element ops per block, by class, that
tools/profile_sections.py:op_census counts in the Pallas kernel's jaxpr,
a select-tree count (every mode's and branch's work is done and selected).
The port cannot trace a jaxpr, so it keeps a copy as data, `CENSUS`, held
equal to op_census by tests/test_torch_tools.py, order included, since the
order sets the schedule.  The CUDA decoders branch and execute fewer
operations than the census, so the ratio says how the port's CUDA kernel
compares with this card running the TPU kernel's op mix; it is not a
roofline share of the CUDA kernel.

`mix_probe` launches mix_probe_kernel<Family> (csrc/mix_probe.cu), which
replaces tools/profile_sections.py:_mix_probe_kernel (L186): the schedule
as straight-line code, from the generated header csrc/mix_sched.h that
`--write-header` writes and a CPU test regenerates.
"""

from __future__ import annotations

import argparse
import functools
import json
from pathlib import Path

import numpy as np
import torch

from detex_tpu_torch import tools
from detex_tpu_torch.ops import _cuda, bptc, bptc_float, eac, etc
from detex_tpu_torch.ops.bitops import shr

N = 1 << 16
HEADER = Path(__file__).resolve().parents[1] / "csrc" / "mix_sched.h"

# Launches of mix_probe_kernel in this process (plain-version calls are not
# counted).
KERNEL_LAUNCHES = {"mix_probe": 0}

# Issue classes, in the header's numbering (csrc/mix_probe.cuh MixClass).
CLASSES = ("mul", "addsub", "shift", "logical", "cmpsel")

# op_census(family) of tools/profile_sections.py: per-block element ops by
# class, in the order the jaxpr walk meets them.
CENSUS = {
    "BC7": (("logical", 442.0009765625), ("cmpsel", 859.0009765625),
            ("shift", 596.0), ("addsub", 253.0), ("mul", 95.0)),
    "BC6H": (("logical", 464.0), ("shift", 500.0), ("cmpsel", 808.0),
             ("addsub", 141.0), ("mul", 113.0)),
    "ETC1": (("shift", 219.00390625), ("logical", 343.0), ("cmpsel", 120.0),
             ("addsub", 114.0), ("mul", 4.0)),
    "ETC2": (("shift", 374.0078125), ("logical", 498.0), ("cmpsel", 353.0),
             ("addsub", 263.0), ("mul", 4.0)),
    "ETC2_EAC": (("shift", 459.0), ("logical", 579.00048828125),
                 ("cmpsel", 421.00048828125), ("addsub", 279.0),
                 ("mul", 8.0)),
    "EAC_R11": (("shift", 85.0), ("logical", 101.0), ("cmpsel", 85.0),
                ("mul", 32.0), ("addsub", 64.0)),
    "EAC_RG11": (("shift", 170.0), ("logical", 202.0), ("cmpsel", 170.0),
                 ("mul", 64.0), ("addsub", 128.0)),
}
FAMILIES = tuple(CENSUS)

# family -> (the port's decode wrapper: module, name; block bytes)
DECODERS = {
    "BC7": (bptc, "decode_bptc", 16),
    "BC6H": (bptc_float, "decode_bptc_float", 16),
    "ETC1": (etc, "decode_etc1", 8),
    "ETC2": (etc, "decode_etc2", 8),
    "ETC2_EAC": (etc, "decode_etc2_eac", 16),
    "EAC_R11": (eac, "decode_eac_r11", 8),
    "EAC_RG11": (eac, "decode_eac_rg11", 16),
}


def schedule(census) -> list:
    """The probe's op order (tools/profile_sections.py:194-199): each
    class int(round(n)) times in census order, then shuffled by
    np.random.default_rng(0)."""
    sched = []
    for cls, n in census:
        sched += [cls] * int(round(n))
    rng = np.random.default_rng(0)
    rng.shuffle(sched)
    return sched


@functools.cache
def _schedule(family: str) -> tuple:
    return tuple(schedule(CENSUS[family]))


def header_text() -> str:
    """csrc/mix_sched.h: one struct per family with the class number of
    each step of its schedule, and DTX_MIX_SCHEDULES listing them."""
    lines = [
        "// Generated by `python -m detex_tpu_torch.tools.profile_sections "
        "--write-header`",
        "// from CENSUS in detex_tpu_torch/tools/profile_sections.py; do "
        "not edit.",
        "// One struct per census family: kLen steps, kSteps[k] the class "
        "of step k",
        "// (" + ", ".join(f"{i} {c}" for i, c in enumerate(CLASSES))
        + "), in the order of schedule().",
        "",
        "#pragma once",
        "",
        "namespace dtx {",
        ""]
    for family in FAMILIES:
        steps = [CLASSES.index(c) for c in _schedule(family)]
        lines += [f"struct MixSched{family} {{",
                  f"  static constexpr int kLen = {len(steps)};",
                  "  static constexpr int kSteps[kLen] = {"]
        for i in range(0, len(steps), 36):
            lines.append("      " + ", ".join(map(str, steps[i:i + 36]))
                         + ",")
        lines += ["  };", "};", ""]
    lines += ["}  // namespace dtx", "",
              "// X(index, struct) for every family, in FAMILIES order: the "
              "index is the",
              "// `family` argument of dtx_mix_probe.",
              "#define DTX_MIX_SCHEDULES(X) \\"]
    lines += [f"  X({i}, MixSched{f})" + (" \\" if i < len(FAMILIES) - 1
                                          else "")
              for i, f in enumerate(FAMILIES)]
    return "\n".join(lines) + "\n"


def mix_probe_plain(x: torch.Tensor, family: str) -> torch.Tensor:
    """Plain PyTorch version of mix_probe on any device, step by step."""
    acc = [x[:, i].clone() for i in range(4)]
    for k, cls in enumerate(_schedule(family)):
        i, j = k & 3, (k + 1) & 3
        c = (0x9E3779B1 * (k + 1)) & 0x7FFFFFFF
        alt = bool(k & 4)
        if cls == "mul":
            acc[i] = acc[i] * (c | 1)
        elif cls == "addsub":
            acc[i] = acc[i] + (acc[j] if alt else c)
        elif cls == "shift":
            acc[i] = acc[i] << (k % 31 + 1) if alt \
                else shr(acc[i], k % 31 + 1)
        elif cls == "logical":
            acc[i] = acc[i] ^ (acc[j] if alt else c)
        else:
            acc[i] = torch.maximum(acc[i], acc[j]) if alt \
                else torch.clamp(acc[i], min=c)
    return acc[0] ^ acc[1] ^ acc[2] ^ acc[3]


def mix_probe(x: torch.Tensor, family: str) -> torch.Tensor:
    """The mix probe of `family`'s census on each row of `x`: (N, 4) int32
    -> (N,) int32.  A CUDA tensor launches mix_probe_kernel, a CPU tensor
    runs mix_probe_plain."""
    index = FAMILIES.index(family)
    if x.device.type == "cpu":
        return mix_probe_plain(x, family)
    if x.device.type != "cuda":
        raise ValueError(f"no mix probe for device {x.device}")
    _cuda.check_rows("mix_probe", "x", x, 4)
    out = torch.empty((x.shape[0],), dtype=torch.int32, device=x.device)
    if x.shape[0]:
        _cuda.call("mix_probe", "dtx_mix_probe", x.device, x.data_ptr(),
                   x.shape[0], index, out.data_ptr())
        KERNEL_LAUNCHES["mix_probe"] += 1
    return out


def _decoder(family: str):
    module, name, _ = DECODERS[family]
    return getattr(module, name)


def sustained(family: str, n: int, device: torch.device) -> float:
    """Blocks/s of the port's decoder of `family` on n random blocks
    (seed 42, as the JAX tool)."""
    blocks = np.random.default_rng(42).integers(
        0, 256, (n, DECODERS[family][2]), np.uint8)
    words = torch.from_numpy(blocks.view(np.int32).copy()).to(device)
    fn = _decoder(family)
    return n / (tools.time_ms(lambda: fn(words), device) / 1e3)


def probe_rate(family: str, n: int, device: torch.device) -> float:
    """Blocks/s of the mix probe of `family`'s census on n random blocks
    (seed 7, as the JAX tool)."""
    x = torch.from_numpy(np.random.default_rng(7).integers(
        -2**31, 2**31, (n, 4), np.int64).astype(np.int32)).to(device)
    return n / (tools.time_ms(lambda: mix_probe(x, family), device) / 1e3)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*",
                    default=["ETC2", "ETC2_EAC", "BC6H", "EAC_RG11"])
    tools.device_arg(ap)
    ap.add_argument("--sizes", default=f"{N},{1 << 20}",
                    help="block counts to time at, comma-separated")
    ap.add_argument("--no-measure", action="store_true",
                    help="census only (no timing)")
    ap.add_argument("--write-header", action="store_true",
                    help=f"write {HEADER.name} from CENSUS and exit")
    args = ap.parse_args(argv)
    if args.write_header:
        HEADER.write_text(header_text())
        print(f"wrote {HEADER}")
        return []
    device = None if args.no_measure else tools.open_device(args.device)
    rows = []
    for family in args.families:
        census = dict(CENSUS[family])
        total = sum(census.values())
        row = {"family": family,
               "ops_per_block": {k: round(v, 1) for k, v in census.items()},
               "total_ops_per_block": round(total, 1)}
        if device is not None:
            row["device"] = tools.device_name(device)
            for n in map(int, args.sizes.split(",")):
                rate = sustained(family, n, device)
                peak = probe_rate(family, n, device)
                row[f"n{n}"] = {
                    "decode_blocks_per_s": rate,
                    "mix_probe_blocks_per_s": peak,
                    "mix_probe_ops_per_s": peak * total,
                    "decode_over_mix_probe": rate / peak}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
