"""Launching the block-decode kernels of libdtx_cuda.so from PyTorch, and
the dispatch shared by the wrappers of ops/bc.py, ops/rgtc.py, ops/etc.py,
ops/eac.py and ops/bptc_float.py (and the launches of ops/bptc.py and
tools/): a CPU tensor runs the plain PyTorch version, a CUDA tensor
launches the hand-written kernel or raises, any other device raises.
There is no fallback between the two.

Every decode entry point of the library takes
    (const void* words, [const void* pre,] long long n, unsigned mode_mask,
     unsigned flags, [int variant,] void* pixels, void* valid, void* stream)
and returns cudaGetLastError() after launching on `stream`; the tools'
entry points take their own arguments, then the stream, and return the
same (`call`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from detex_tpu_torch import _build

_FULL = 0xFFFFFFFF


def check_rows(name: str, what: str, t: torch.Tensor, cols: int) -> None:
    """Raise unless `t` is an (N, cols) int32 tensor, contiguous and aligned
    for one vector load of its row."""
    if t.dtype != torch.int32 or t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} {what} must be an (N, {cols}) int32 "
                         f"tensor, got {tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} {what} must be contiguous")
    if t.data_ptr() % (4 * cols):
        raise ValueError(f"{name} {what} must be {4 * cols}-byte aligned")


def call(name: str, entry: str, device: torch.device, *args) -> None:
    """Call library entry point `entry` with `args` and the current stream
    of `device`; raise if it returns a CUDA error."""
    fn = getattr(_build.load_library(), entry)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def launch(name: str, entry: str, words: torch.Tensor, words_in: int,
           words_out: int, mode_mask: int, flags: int, *extra: int,
           pre: torch.Tensor | None = None):
    """Check `words` ((N, words_in) int32, contiguous, aligned for one
    vector load per block), allocate ((N, words_out) int32 pixels, (N,)
    bool valid) on its device and launch `entry` on the current stream
    (no launch for N = 0).  `extra` goes between flags and the outputs;
    `pre`, an (N, 2) int32 tensor of per-block words, right after `words`."""
    check_rows(name, "words", words, words_in)
    n = words.shape[0]
    pix = torch.empty((n, words_out), dtype=torch.int32, device=words.device)
    valid = torch.empty((n,), dtype=torch.bool, device=words.device)
    if n == 0:
        return pix, valid
    inputs = [words.data_ptr()]
    if pre is not None:
        inputs.append(pre.data_ptr())
    call(name, entry, words.device, *inputs, n, int(mode_mask) & _FULL,
         int(flags) & _FULL, *extra, pix.data_ptr(), valid.data_ptr())
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
