"""The traced run: torch.profiler over part of the measured window, reduced
to what the per-layer readers (dtxbench/metrics/) take.

The profiler records the device's kernels, copies and sets (CUPTI) and
the host's operations and the benchmark's own spans.  The window is the
span "dtxbench.window"; everything is clipped to it.  The reduction gives:

  window_s        the window's length;
  busy_s          the time in which any operation ran on the device;
  kernel_busy_s   the time in which a kernel ran (copies left out);
  kernel_s        the kernels' summed durations;
  h2d_s, d2h_s    the copies' summed durations by direction;
  device_ops      the kernels (and copies) that took most time, by name;
  idle_gaps       the device's idle time, by what the host was doing at
                  each gap's middle (its innermost operation or span);
  n_device_ops    how many device records the window holds.

A driver adds `work`: what the program did in the window (steps, calls,
samples), counted by the benchmark or read from the program's counters.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Iterable, List, Optional, Tuple

import torch

WINDOW = "dtxbench.window"
TOP = 10
SHORT_GAP_NS = 10_000
SHORT_GAP = "(gaps under 10 us between device operations)"


class Tracer:
    """Start and stop torch.profiler around a part of the window; a no-op
    when tracing is off."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self._prof = self._span = self._done = None

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW)
        self._span.__enter__()
        self._t_start = time.perf_counter()

    @property
    def running(self) -> bool:
        return self._prof is not None

    def due(self, seconds: float) -> bool:
        """Whether the traced part has run `seconds` since the profiler
        started (its start, which can take a second, left out)."""
        return time.perf_counter() - self._t_start >= seconds

    def stop(self) -> None:
        """Close the traced part, waiting for the device first."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done, self._prof, self._span = self._prof, None, None

    def finish(self, work: Optional[dict]) -> Optional[dict]:
        """The traced part reduced (summarise), with `work` attached: what
        the program did in it.  Called once the window has closed."""
        if self._done is None:
            return None
        summary = summarise(_records(self._done))
        summary["work"] = dict(work or {})
        self._done = None
        return summary


def _records(prof) -> List[Tuple[str, bool, str, int, int]]:
    """(name, on the device, kind, start ns, end ns) of every record:
    kind is "kernel", "memcpy", "memset" or "cpu"."""
    out = []
    for e in prof.profiler.kineto_results.events():
        device = str(e.device_type()).upper().endswith("CUDA")
        name = e.name()
        kind = "cpu"
        act = str(e.activity_type()).lower() if hasattr(
            e, "activity_type") else ""
        if device and ("annotation" in act or name.startswith("dtxbench.")):
            continue            # a host span drawn on the device's timeline
        if device:
            low = name.lower()
            if "memcpy" in act or low.startswith("memcpy"):
                kind = "memcpy"
            elif "memset" in act or low.startswith("memset"):
                kind = "memset"
            else:
                kind = "kernel"
        start = int(e.start_ns())
        out.append((name, device, kind, start, start + int(e.duration_ns())))
    return out


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def summarise(records) -> dict:
    """Reduce (name, on device, kind, start ns, end ns) records to the
    window's numbers (module docstring).  A trace without the window span
    gives window_s None."""
    spans = [(a, b) for n, dev, _, a, b in records if n == WINDOW and not dev]
    if not spans:
        return {"window_s": None}
    w0, w1 = spans[0]

    def clip(a, b):
        return max(a, w0), min(b, w1)

    dev = [(n, k, *clip(a, b)) for n, d, k, a, b in records if d]
    dev = [(n, k, a, b) for n, k, a, b in dev if b > a]
    busy = _union((a, b) for _, _, a, b in dev)
    kernels = [(n, a, b) for n, k, a, b in dev if k == "kernel"]
    by_name = collections.Counter()
    for n, k, a, b in dev:
        by_name[n] += b - a
    h2d = sum(b - a for n, k, a, b in dev if k == "memcpy" and "htod" in
              n.lower())
    d2h = sum(b - a for n, k, a, b in dev if k == "memcpy" and "dtoh" in
              n.lower())

    # Idle gaps, each named by the innermost host record at its middle;
    # the short ones between device operations (a graph's nodes, a
    # stream's launches) together.
    host = sorted((a, b, n) for n, d, _, a, b in records
                  if not d and n != WINDOW and b > a)
    starts = [a for a, _, _ in host]
    gaps = collections.Counter()
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        if b - a < SHORT_GAP_NS:
            gaps[SHORT_GAP] += b - a
            continue
        mid = (a + b) // 2
        inner = None
        for ha, hb, hn in host[:bisect.bisect_right(starts, mid)]:
            if hb >= mid and (inner is None or hb - ha < inner[1] - inner[0]):
                inner = (ha, hb, hn)
        gaps[inner[2] if inner else "(no host record)"] += b - a

    ns = 1e-9
    return {
        "window_s": (w1 - w0) * ns,
        "busy_s": _length(busy) * ns,
        "kernel_busy_s": _length(_union((a, b) for _, a, b in kernels)) * ns,
        "kernel_s": sum(b - a for _, a, b in kernels) * ns,
        "h2d_s": h2d * ns,
        "d2h_s": d2h * ns,
        "n_device_ops": len(dev),
        "device_ops": [[n[:200], t * ns] for n, t in by_name.most_common(TOP)],
        "idle_gaps": [[n[:200], t * ns] for n, t in gaps.most_common(TOP)],
    }


def merge(summaries: List[dict]) -> dict:
    """One chip's summary per rank -> the run's: the device times averaged
    over the chips, the window, the breakdown and the work of the first;
    None where a rank's trace holds no window."""
    if any(not s or not s.get("window_s") for s in summaries):
        return None
    first = dict(summaries[0])
    for key in ("busy_s", "kernel_busy_s", "kernel_s", "h2d_s", "d2h_s"):
        first[key] = sum(s[key] for s in summaries) / len(summaries)
    first["chips"] = len(summaries)
    return first
