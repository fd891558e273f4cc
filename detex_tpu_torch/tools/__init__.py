"""The port's counterparts of the JAX package's probe tools (tools/), each
the path of its own command and each with its own hand-written kernels:

    python -m detex_tpu_torch.tools.mxu_probe          (csrc/bc7_pre.cu)
    python -m detex_tpu_torch.tools.interleave_probe   (csrc/interleave.cu)
    python -m detex_tpu_torch.tools.profile_sections   (csrc/mix_probe.cu)

They run on the card unless given `--device cpu`, which runs the kernels'
plain versions.  The TPU tools' timing workarounds (the two-point
fori_loop marginal method and its LO/HI trip counts) are left out: times
come from CUDA events (`time_ms`).
"""

from __future__ import annotations

import argparse
import statistics
import time

import torch

from detex_tpu_torch import resolve_device


def device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="cuda (the kernels; default) or cpu (their "
                             "plain versions)")


def device_name(device: torch.device) -> str:
    """The card's name, or "cpu": every printed time carries it."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def open_device(name: str) -> torch.device:
    """`name` as a device; a CUDA device with no card raises.  TF32 off, as
    in the tests."""
    device = resolve_device(name)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def time_ms(fn, device: torch.device, reps: int = 21, inner: int = 10
            ) -> float:
    """Median over `reps` of the mean time per call of `inner` back-to-back
    calls of fn(), after 3 warm-up calls: CUDA events on a card, the host
    clock on the CPU."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(times)
