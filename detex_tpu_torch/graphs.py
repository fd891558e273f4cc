"""Captured CUDA graphs: the port's one-program form of a step.

The JAX package serves each of its steps as one XLA program (jax.jit).
The port's counterpart on one card is a CUDA graph captured from the
eager body: one replay launches every kernel of the step with no Python
between them.  Three paths use it:

  * the control step, mpc/runtime._StepProgram (jax.jit at
    detex_tpu/mpc/runtime.py:158-160);
  * the train step, mpc/train_loop._TrainGraph (detex_tpu/mpc/
    train_loop.py:218-233);
  * the texture engine's decode -> convert -> assemble pipelines and the
    uncompressed conversion, engine._device_pipeline and
    convert_device.convert_pixels_torch (detex_tpu/engine.py:278-394,
    detex_tpu/convert_device.py:609-611), through `Program` and `run`.
    A texture key is captured at its second call, not its first: most
    texture callers (a converter walking a mip chain, a viewer) never
    repeat a key, and for them a capture would only add its warm-ups and
    keep a memory pool.

Every capture follows one recipe (Graph.capture): GRAPH_WARMUP eager runs
of the body on a side stream, which make what the body creates at its
first use (the kernels' library, cuBLAS/cuDNN handles and plans, lookup
tables, the allocator's blocks); an optional reset of what the warm-ups
changed; then, with Python's garbage collection held off, the capture on
that stream into the graph's own memory pool.  A failed capture or replay
raises: nothing falls back to the eager body.  The CPU has no graphs, so
there the callers run their bodies eagerly.

On a mesh whose groups are all NCCL (parallel/mesh.capturable), the
control and train steps are captured with their collectives, the
counterpart of jax.jit with a mesh: one replay runs the step's kernels and
its NCCL collectives.  The warm-ups make each group's communicator (NCCL
makes one at a group's first collective), so the capture never holds a
group's first collective.

Counts: each kernel wrapper adds one to its count where it launches its
kernel (ops/*.KERNEL_LAUNCHES), and each collective helper its bytes to
parallel/mesh.COLLECTIVE_BYTES where it is called.  At capture they count a
launch or a collective that was only recorded; Graph takes those counts
back (take_back) and adds them at every replay (add_back), when the work
runs.
"""

from __future__ import annotations

import collections
import gc
import threading
import time

import torch

from detex_tpu_torch.ops import bc, bptc, bptc_float, eac, etc, rgtc
from detex_tpu_torch.parallel import mesh as mesh_mod
from detex_tpu_torch.utils import trace

# Eager runs of the body before a capture.  The first makes what the body
# creates lazily; the second runs on what the first left, as every replay
# will.
GRAPH_WARMUP = 2

# The decode modules whose KERNEL_LAUNCHES is a dict by variant name; BC7's
# (ops/bptc.py) is one int, named "bptc" here.
_VARIANT_MODULES = (bc, rgtc, etc, eac, bptc_float)


def launch_counts() -> dict:
    """Every decode kernel's launch count by name: "bptc" for BC7, the
    variant names (bc1, ..., bptc_signed_float) for the others."""
    counts = {"bptc": bptc.KERNEL_LAUNCHES}
    for module in _VARIANT_MODULES:
        counts.update(module.KERNEL_LAUNCHES)
    return counts


def add_launches(delta: dict) -> None:
    """Add delta[name] to each named kernel's launch count."""
    for name, n in delta.items():
        if name == "bptc":
            bptc.KERNEL_LAUNCHES += n
            continue
        for module in _VARIANT_MODULES:
            if name in module.KERNEL_LAUNCHES:
                module.KERNEL_LAUNCHES[name] += n
                break
        else:
            raise KeyError(f"no launch count named {name!r}")


def snapshot() -> tuple:
    """The counters a capture moves to its replays: (launch_counts(), a copy
    of mesh.COLLECTIVE_BYTES)."""
    return launch_counts(), collections.Counter(mesh_mod.COLLECTIVE_BYTES)


def take_back(before: tuple) -> tuple:
    """Undo what the counters gained since `before` (a snapshot()), and
    return it: (kernel launches by name, collective bytes by (collective,
    axis)), the counts of one replay of what ran in between.  A key that
    was not in COLLECTIVE_BYTES before is removed again."""
    launches_before, bytes_before = before
    after = launch_counts()
    launches = {k: after[k] - launches_before[k] for k in after
                if after[k] != launches_before[k]}
    add_launches({k: -n for k, n in launches.items()})
    nbytes = {k: n - bytes_before[k]
              for k, n in mesh_mod.COLLECTIVE_BYTES.items()
              if n != bytes_before[k]}
    for k, n in nbytes.items():
        mesh_mod.COLLECTIVE_BYTES[k] -= n
        if k not in bytes_before:
            del mesh_mod.COLLECTIVE_BYTES[k]
    return launches, nbytes


def add_back(counts: tuple) -> None:
    """Add one replay's counts (take_back's result) to the counters."""
    launches, nbytes = counts
    add_launches(launches)
    mesh_mod.COLLECTIVE_BYTES.update(nbytes)


class Graph:
    """One CUDA graph on `device`: capture(body, reset) captures body() once;
    reset(), if given, runs on the capture's stream between the warm-ups
    and the capture (to undo what the warm-ups changed).  After the capture
    `out` is what the captured body returned: tensors in the graph's pool,
    which every replay overwrites.  `launches` holds the kernel launches of
    one replay by count name, `collective_bytes` its collectives' bytes by
    (collective, axis), and `capture_s` the capture's wall time, warm-ups
    included.  The graph keeps neither callable, so an owner that passes
    its own methods makes no reference cycle: a dropped owner frees its
    graph and pool at once, never in a garbage collection that could fall
    inside another capture.

    The capture runs in "thread_local" mode, which restricts only the
    capturing thread: in torch's default ("global") mode a potentially
    unsafe CUDA call from any other thread during a capture is refused and
    invalidates it, and ProcessGroupNCCL's watchdog thread queries the
    events of NCCL collectives (the warm-ups' among them) whenever it
    wakes, in every process that has an NCCL group."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a captured graph needs a CUDA device, not "
                             f"{self.device}")
        self.graph = None
        self.out = None
        self.launches = {}
        self.collective_bytes = {}
        self.capture_s = None

    def capture(self, body, reset=None) -> None:
        """Warm up and capture, once."""
        if self.graph is not None:
            return
        with trace.span("dtx.graph.capture"):
            self._capture(body, reset)
        trace.count("dtx.graph.captures", 1)

    def _capture(self, body, reset) -> None:
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(self.device)
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            for _ in range(GRAPH_WARMUP):
                body()
            if reset is not None:
                reset()
            # A collection inside the capture could free another graph
            # (cudaGraphExecDestroy), which invalidates the capture.  The
            # graphs here are freed with their owners, never in a
            # collection, so none is run before it: only held off during it.
            collecting = gc.isenabled()
            gc.disable()
            before = snapshot()
            try:
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    out = body()
            finally:
                if collecting:
                    gc.enable()
                # The wrappers counted work that was only recorded.
                launches, nbytes = take_back(before)
        current.wait_stream(stream)
        self.launches, self.collective_bytes = launches, nbytes
        self.graph, self.out = graph, out
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Replay on the current stream and return `out`."""
        if self.graph is None:
            raise RuntimeError("replay before capture")
        self.graph.replay()
        add_back((self.launches, self.collective_bytes))
        return self.out


class Program:
    """fn(x) for inputs of one shape and dtype on one card: the first call
    runs fn(x) eagerly and returns its fresh result; the second captures
    fn on a static input buffer (a Graph) and every call from there copies
    x into the buffer (on the current stream, so after the replay before
    it) and replays, returning the graph's output, which the next call
    overwrites.  `keep` holds tensors the captured kernels read but fn
    does not own (the HDR lookup table), so that they live as long as the
    graph.  Callers go through run(), which holds the lock that makes a
    call, and the read of its result, one step for every thread."""

    def __init__(self, fn, keep=()):
        self.fn, self.keep = fn, tuple(keep)
        self.calls = 0
        self.input = None
        self.graph = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        if self.calls == 1:
            return self.fn(x)
        if self.input is None:
            self.graph = Graph(x.device)
            self.input = torch.empty_like(x)
        elif tuple(x.shape) != tuple(self.input.shape) or \
                x.dtype != self.input.dtype:
            raise ValueError(f"input of shape {tuple(x.shape)} {x.dtype}, "
                             f"expected {tuple(self.input.shape)} "
                             f"{self.input.dtype}")
        self.input.copy_(x)
        self.graph.capture(lambda: self.fn(self.input))
        return self.graph.replay()


# Each captured program holds its own memory pool (a 4096^2 BC6H -> RGBA8
# pipeline's int64 intermediates are 512 MiB each; a program called once
# holds nothing), so only the programs of the last few keys stay, the
# oldest dropped first.
PROGRAMS_KEPT = 4
_PROGRAMS: "collections.OrderedDict[tuple, Program]" = \
    collections.OrderedDict()
# One texture call at a time: a program's buffer, graph and output are
# shared by every caller of its key, and a capture in one thread would
# fail on another thread's launches.
_LOCK = threading.RLock()


def program(key: tuple, make) -> Program:
    """The Program cached under `key`, made by make() where there is none;
    the least recently used beyond PROGRAMS_KEPT are dropped, and with them
    their graphs and pools."""
    with _LOCK:
        prog = _PROGRAMS.pop(key, None)
        if prog is None:
            prog = make()
        _PROGRAMS[key] = prog
        while len(_PROGRAMS) > PROGRAMS_KEPT:
            _PROGRAMS.popitem(last=False)
        return prog


def run(key: tuple, make, x: torch.Tensor, read=None):
    """program(key, make)(x), and read(result) where read is given, under
    the lock: a caller that copies the result out (to the host, or into a
    tensor of its own) gets its own call's result, whatever other threads
    call.  Without read the result is the program's, and the key's next
    call may overwrite it."""
    with _LOCK:
        with trace.span("dtx.texture.run"):
            out = program(key, make)(x)
        return out if read is None else read(out)
