"""In-kernel lane interleave on an NVIDIA card: the counterpart of
tools/interleave_probe.py.

    python -m detex_tpu_torch.tools.interleave_probe [--device cpu]
        [--sizes 65536,1048576]

The TPU tool asked whether a kernel could write image rows itself: read a
(16, 8, L) int32 array (16 pixels of 8 x L blocks), add 1, and write it
planar or as (4, 8, 4L) rows out[py, s, 4l + px] = x[4py + px, s, l] + 1.
On the TPU every way of writing the rows failed to lower or ran 64x slower
than planar.  Here `planar_add1` launches planar_add1_kernel and
`rows_interleave` launches rows_interleave_kernel (csrc/interleave.cu,
which replace tools/interleave_probe.py:_kernel_planar L58 and
_kernel_rows_strided L79 / _kernel_rows L86 with stack or repeat: one
CUDA kernel, since a thread's strided store needs no special form).

main() checks both kernels against numpy (as the tool does), then times
each at N = 65,536 blocks (L = 8,192) and 1,048,576, beside the PyTorch
call that computes the same function (`library`, the yardstick: x + 1,
and (x + 1).view(4, 4, 8, L).permute(0, 2, 3, 1).reshape(4, 8, 4L)),
one JSON line per kernel and size.  The port never calls the library
forms.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from detex_tpu_torch import tools
from detex_tpu_torch.ops import _cuda

N = 1 << 16

# Launches of the kernels in this process (plain-version calls are not
# counted).
KERNEL_LAUNCHES = {"interleave_planar": 0, "interleave_rows": 0}


def _check(name: str, x: torch.Tensor) -> int:
    """Raise unless x is a contiguous 16 B aligned (16, 8, L) int32
    tensor; return L."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[:2] != (16, 8):
        raise ValueError(f"{name} takes a (16, 8, L) int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} input must be contiguous and 16 B aligned")
    return x.shape[2]


def planar_add1_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of planar_add1 on any device."""
    return x + 1


def rows_interleave_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of rows_interleave on any device: the 16
    strided stores of tools/interleave_probe.py:_kernel_rows_strided."""
    out = torch.empty((4, 8, 4 * x.shape[2]), dtype=x.dtype, device=x.device)
    for py in range(4):
        for px in range(4):
            out[py, :, px::4] = x[4 * py + px] + 1
    return out


def _launch(name: str, entry: str, x: torch.Tensor,
            shape: tuple) -> torch.Tensor:
    lanes = _check(name, x)
    out = torch.empty(shape, dtype=torch.int32, device=x.device)
    if lanes:
        _cuda.call(name, entry, x.device, x.data_ptr(), lanes,
                   out.data_ptr())
        KERNEL_LAUNCHES[name] += 1
    return out


def planar_add1(x: torch.Tensor) -> torch.Tensor:
    """(16, 8, L) int32 -> x + 1 (int32 wrap-around), same layout.  A CUDA
    tensor launches planar_add1_kernel, a CPU tensor runs the plain
    version."""
    if x.device.type == "cpu":
        return planar_add1_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no planar_add1 for device {x.device}")
    return _launch("interleave_planar", "dtx_planar_add1", x, tuple(x.shape))


def rows_interleave(x: torch.Tensor) -> torch.Tensor:
    """(16, 8, L) int32 -> (4, 8, 4L) rows, out[py, s, 4l + px] =
    x[4py + px, s, l] + 1.  A CUDA tensor launches rows_interleave_kernel,
    a CPU tensor runs the plain version."""
    if x.device.type == "cpu":
        return rows_interleave_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no rows_interleave for device {x.device}")
    return _launch("interleave_rows", "dtx_rows_interleave", x,
                   (4, 8, 4 * x.shape[2]))


def library_planar(x: torch.Tensor) -> torch.Tensor:
    """The PyTorch call computing planar_add1 (the yardstick)."""
    return x + 1


def library_rows(x: torch.Tensor) -> torch.Tensor:
    """The PyTorch calls computing rows_interleave (the yardstick)."""
    lanes = x.shape[2]
    return (x + 1).view(4, 4, 8, lanes).permute(0, 2, 3, 1) \
        .reshape(4, 8, 4 * lanes)


def numpy_rows(xh: np.ndarray) -> np.ndarray:
    """The rows by numpy (tools/interleave_probe.py:129-132)."""
    want = np.empty((4, 8, 4 * xh.shape[2]), np.int32)
    for py in range(4):
        for px in range(4):
            want[py, :, px::4] = xh[4 * py + px] + 1
    return want


def tool_input(n: int = N, seed: int = 0) -> np.ndarray:
    """The tool's input (tools/interleave_probe.py:123-125) for n blocks."""
    return np.random.default_rng(seed).integers(
        0, 1 << 30, (16, 8, n // 8), np.int64).astype(np.int32)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    tools.device_arg(ap)
    ap.add_argument("--sizes", default=f"{N},{1 << 20}",
                    help="block counts, comma-separated (multiples of 8)")
    args = ap.parse_args(argv)
    device = tools.open_device(args.device)
    rows = []
    for n in map(int, args.sizes.split(",")):
        xh = tool_input(n)
        x = torch.from_numpy(xh).to(device)
        for mode, fn, lib, want in (
                ("planar", planar_add1, library_planar, xh + 1),
                ("rows", rows_interleave, library_rows, numpy_rows(xh))):
            if not np.array_equal(fn(x).cpu().numpy(), want):
                raise AssertionError(f"{mode} WRONG at N={n}")
            ms = tools.time_ms(lambda: fn(x), device)
            lib_ms = tools.time_ms(lambda: lib(x), device)
            row = {"mode": mode, "n": n, "lanes": n // 8,
                   "device": tools.device_name(device), "ms": ms,
                   "library_ms": lib_ms,
                   "blocks_per_s": n / (ms / 1e3),
                   "gb_per_s": 2 * x.numel() * 4 / (ms * 1e6)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


if __name__ == "__main__":
    main()
