"""Spans and copy counters of the port: the host's time per stage and the
bytes it moves between host and card, recorded only when asked for.

Recording is on while torch.profiler runs, or after enable(True).  Off, a
span is one check of two flags and the shared no-op context: nothing is
allocated and nothing is called in torch.  On, a span opens a profiler
range under its name (on the profiler's clock, the one its kernel and
copy records use, so a trace names the host's stage at each of the
card's idle gaps) and adds its host-clock duration to the name's totals.
The range is a host operation's (torch's _RecordFunctionFast), not
record_function's user annotation, which the profiler also draws on the
card's timeline over the kernels it encloses, where a trace's reader
takes it for device work.  Whether a span records is decided when it is
entered: one entered while recording was off records nothing, one
entered while it was on is added to the totals when it is left, by an
exception too, even where the profiler stopped inside it.

The spans (names start with "dtx."; none sits inside a captured graph's
body, so a replay launches what it did without them):

  dtx.control.step      Controller.step and PipelinedController.step,
                        the whole call
  dtx.control.load      the observation's words to the card
  dtx.control.plan      the noise draw and the graph's replay (the eager
                        control_step on the CPU or a gloo mesh)
  dtx.control.wait      the action to the host: the host waits for the
                        card here
  dtx.tdmpc2.draw       TD-MPC2's draws of a step into the step's static
                        buffers (inside dtx.control.plan)
  dtx.texture.words     the texture's bytes copied into a host block as
                        words (convert_device.staged)
  dtx.texture.upload    the words (or convert_device.from_bytes' pixels)
                        to the card: from a pinned block the enqueue
                        alone, its copy then waited for in .copy_out
  dtx.texture.run       graphs.run: the key's program found, its input
                        copied, its eager first call or its replay launched
  dtx.texture.copy_out  convert_device.to_bytes: the copy into a host
                        block and the wait for it, and so for all the
                        card still had to do (the upload, the replay)
  dtx.train.step        one iteration of train()'s loop
  dtx.train.env         env.sample_batch
  dtx.train.stage       the batch into the pinned buffers and up (on the
                        CPU or a gloo mesh: to tensors on the device)
  dtx.train.wait        the host waits for the card: a pinned buffer's
                        upload two loads behind, the loss read at a log
  dtx.train.launch      the replay and the loss's copy (the eager step
                        on the CPU or a gloo mesh)
  dtx.train.checkpoint  a checkpoint's gathers and save
  dtx.graph.capture     graphs.Graph.capture, warm-ups included

The counters, by name:

  dtx.h2d_bytes, dtx.d2h_bytes  bytes copied from a host tensor to a CUDA
                                one and back, counted where the copy is
                                made (count_copy)
  dtx.pinned_copies,            copies staged in a pinned host block from
  dtx.pinned_bytes              torch's caching host allocator, and the
                                bytes asked for (count_pinned; the cache
                                pins each block's size rounded up to a
                                power of two)
  dtx.graph.captures            graphs.Graph captures
  dtx.tdmpc2.rows               rows through TD-MPC2's MLPs, added once a
                                step (tdmpc2.mlp_rows)

For an operator: snapshot() gives the spans' totals and the counters,
with the kernels' launch counts (graphs.launch_counts), the collectives'
bytes (parallel/mesh.COLLECTIVE_BYTES), read where they are kept, and,
in a process that has used a card, host_allocs: the caching host
allocator's count of fresh pinned allocations (cudaHostAlloc).  Over a
stretch of calls, 1 - (its change) / (dtx.pinned_copies' change) is the
share of staged copies the cache served; it reads 1.0 in a steady state
whose callers free what the engine returned.  Around a stretch of
serving, enable(True), reset() and snapshot() give the host time per
stage and the bytes each way a request, which size a deployment's PCIe
load; dtx.graph.captures should stay at zero in a steady state, and
rises where keys churn past graphs.PROGRAMS_KEPT.
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_ENABLED = False
# name -> [count, total s, max s]
_SPANS: dict = {}
_COUNTS: collections.Counter = collections.Counter()
_LOCK = threading.Lock()


def enable(flag: bool = True) -> None:
    """Record spans and counters whether or not a profiler runs."""
    global _ENABLED
    _ENABLED = bool(flag)


def reset() -> None:
    """Forget the spans' totals and the counters."""
    with _LOCK:
        _SPANS.clear()
        _COUNTS.clear()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._range = torch._C._profiler._RecordFunctionFast(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        seconds = (time.perf_counter_ns() - self._t0) * 1e-9
        with _LOCK:
            total = _SPANS.get(self.name)
            if total is None:
                _SPANS[self.name] = [1, seconds, seconds]
            else:
                total[0] += 1
                total[1] += seconds
                total[2] = max(total[2], seconds)
        self._range.__exit__(None, None, None)
        return False


def span(name: str):
    """A context manager that records `name` where recording is on when
    it is entered (module docstring), and does nothing otherwise."""
    if not (_ENABLED or _profiler._is_profiler_enabled):
        return _NO_SPAN
    return _Span(name)


def count(name: str, n: int) -> None:
    """Add n to the counter `name` where recording is on."""
    if _ENABLED or _profiler._is_profiler_enabled:
        with _LOCK:
            _COUNTS[name] += n


def count_copy(t: torch.Tensor, device) -> None:
    """Count t's bytes as dtx.h2d_bytes or dtx.d2h_bytes where copying it
    to `device` crosses between the host and a card, where recording is
    on."""
    if not (_ENABLED or _profiler._is_profiler_enabled):
        return
    to_card = torch.device(device).type == "cuda"
    if t.is_cuda != to_card:
        count("dtx.h2d_bytes" if to_card else "dtx.d2h_bytes", t.nbytes)


def count_pinned(block: torch.Tensor) -> None:
    """Count one copy staged in the pinned host block `block` as
    dtx.pinned_copies and its bytes as dtx.pinned_bytes, where recording
    is on."""
    count("dtx.pinned_copies", 1)
    count("dtx.pinned_bytes", block.nbytes)


def snapshot() -> dict:
    """{"spans": {name: {"count", "total_s", "max_s"}}, "counts": the
    counters, "launches": graphs.launch_counts(), "collective_bytes":
    parallel/mesh.COLLECTIVE_BYTES by (collective, axis)}, as they stand,
    and "host_allocs", the caching host allocator's fresh allocations,
    where this process has used a card (absent otherwise)."""
    from detex_tpu_torch import graphs
    from detex_tpu_torch.parallel import mesh
    with _LOCK:
        spans = {name: {"count": c, "total_s": s, "max_s": m}
                 for name, (c, s, m) in _SPANS.items()}
        counts = dict(_COUNTS)
    snap = {"spans": spans, "counts": counts,
            "launches": graphs.launch_counts(),
            "collective_bytes": dict(mesh.COLLECTIVE_BYTES)}
    stats = getattr(torch.cuda, "host_memory_stats", None)
    if stats is not None and torch.cuda.is_initialized():
        snap["host_allocs"] = stats()["num_host_alloc"]
    return snap
