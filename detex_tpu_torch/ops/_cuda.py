"""Launching the block-decode kernels of libdtx_cuda.so from PyTorch, and
the dispatch shared by the wrappers of ops/bc.py, ops/rgtc.py, ops/etc.py,
ops/eac.py and ops/bptc_float.py (and ops/bptc.py's launch): a CPU
tensor runs the plain PyTorch version, a CUDA tensor launches the
hand-written kernel or raises, any other device raises.  There is no
fallback between the two.

Every decode entry point of the library takes
    (const void* words, long long n, unsigned mode_mask, unsigned flags,
     [int variant,] void* pixels, void* valid, void* stream)
and returns cudaGetLastError() after launching on `stream`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from detex_tpu_torch import _build

_FULL = 0xFFFFFFFF


def launch(name: str, entry: str, words: torch.Tensor, words_in: int,
           words_out: int, mode_mask: int, flags: int, *extra: int):
    """Check `words` ((N, words_in) int32, contiguous, aligned for one
    vector load per block), allocate ((N, words_out) int32 pixels, (N,)
    bool valid) on its device and launch `entry` on the current stream
    (no launch for N = 0).  `extra` goes between flags and the outputs."""
    if words.dtype != torch.int32 or words.dim() != 2 \
            or words.shape[1] != words_in:
        raise ValueError(f"{name} words must be an (N, {words_in}) int32 "
                         f"tensor, got {tuple(words.shape)} {words.dtype}")
    if not words.is_contiguous():
        raise ValueError(f"{name} words must be contiguous")
    if words.data_ptr() % (4 * words_in):
        raise ValueError(f"{name} words must be {4 * words_in}-byte "
                         "aligned")
    n = words.shape[0]
    pix = torch.empty((n, words_out), dtype=torch.int32, device=words.device)
    valid = torch.empty((n,), dtype=torch.bool, device=words.device)
    if n == 0:
        return pix, valid
    fn = getattr(_build.load_library(), entry)
    with torch.cuda.device(words.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(words.data_ptr(), n, int(mode_mask) & _FULL,
                 int(flags) & _FULL, *extra, pix.data_ptr(),
                 valid.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return pix, valid


@dataclasses.dataclass(frozen=True)
class Variant:
    """One format variant of a kernel of bc.cu, etc_eac.cu or bc6h.cu: its
    entry point and the value that picks the kernel's instantiation, its
    word counts per block, and its plain version."""

    name: str
    entry: str
    variant: int
    words_in: int
    words_out: int
    plain: Callable


def decode(v: Variant, counts: dict, words: torch.Tensor, mode_mask: int,
           flags: int):
    """Run variant `v` on `words`; each kernel launch adds one to
    counts[v.name]."""
    if words.device.type == "cpu":
        return v.plain(words, mode_mask, flags)
    if words.device.type != "cuda":
        raise ValueError(f"no {v.name} decoder for device {words.device}")
    out = launch(v.name, v.entry, words, v.words_in, v.words_out, mode_mask,
                 flags, v.variant)
    if words.shape[0]:
        counts[v.name] += 1
    return out
