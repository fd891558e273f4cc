"""The port's counterparts of the JAX package's probe tools (tools/), each
the path of its own command and each with its own hand-written kernels:

    python -m detex_tpu_torch.tools.mxu_probe          (csrc/bc7_pre.cu)
    python -m detex_tpu_torch.tools.interleave_probe   (csrc/interleave.cu)
    python -m detex_tpu_torch.tools.profile_sections   (csrc/mix_probe.cu)

and of its benches and checks, which run the package's own paths:

    python -m detex_tpu_torch.tools.bench_control_step
    python -m detex_tpu_torch.tools.bench_train_step
    python -m detex_tpu_torch.tools.bench_pipelines
    python -m detex_tpu_torch.tools.bench_scaling
    python -m detex_tpu_torch.tools.diag_mppi_gap
    python -m detex_tpu_torch.tools.mass_fuzz
    python -m detex_tpu_torch.tools.convert_sweep
    python -m detex_tpu_torch.tools.bench_decode     (the root bench.py)

They run on the card unless given `--device cpu`, which runs the kernels'
plain versions.  The TPU tools' timing workarounds (the two-point
fori_loop marginal method and its LO/HI trip counts) are left out: times
come from CUDA events (`time_ms` for one call repeated, `device_ms` for a
kernel's device time, `step_times` for a loop of steps).
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import numpy as np
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


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them (a card set
    below its maximum runs slower under load), or "cpu"."""
    if device.type != "cuda":
        return device.type
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()
    return lines[min(device.index or 0, len(lines) - 1)].strip()


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


def device_ms(fn, inner: int = 20) -> float:
    """Device time per call of fn(), by CUDA events around `inner`
    back-to-back calls enqueued behind a spin kernel: the launches queue up
    while it runs, so host enqueue time falls outside the events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(4_000_000)        # about 2 ms at 1.98 GHz
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def step_times(step, device: torch.device, warmup: int, steps: int):
    """Run step(i) for i = 0 .. warmup + steps - 1 back to back, with no
    wait for the card between steps, and return, for each of the last
    `steps`, (its ms on the card's timeline, the host's ms to enqueue it).

    On a card the first is the interval between CUDA events recorded
    before and after the step: in the steady state that is the step's
    period, set by the card or by the host's enqueue, whichever is slower.
    The card is waited for once after the warm-up and once at the end.  On
    the CPU both are the host clock."""
    cuda = device.type == "cuda"
    for i in range(warmup):
        step(i)
    if cuda:
        torch.cuda.synchronize(device)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(steps + 1)]
        events[0].record()
    host = []
    for k in range(steps):
        t0 = time.perf_counter()
        step(warmup + k)
        if cuda:
            events[k + 1].record()
        host.append((time.perf_counter() - t0) * 1e3)
    if not cuda:
        return host, host
    events[-1].synchronize()
    return [events[k].elapsed_time(events[k + 1]) for k in range(steps)], host


def spread(ms) -> dict:
    """Median, p10 and p90 of a list of times in ms."""
    p10, p50, p90 = np.percentile(np.asarray(ms, np.float64), (10, 50, 90))
    return {"median": float(p50), "p10": float(p10), "p90": float(p90)}
