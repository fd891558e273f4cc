"""What every driver shares: the run's context, the device, the window's
clock, the checks that decide `correct`, and the spans the benchmark
records around its calls into the program."""

from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# Seeds reach 2**31 and more; numpy and torch take any whole number from 0
# to 2**63 - 1.
SEED_MASK = (1 << 63) - 1


class StopWindow(Exception):
    """Raised inside the program's loop by the benchmark's own feed when
    the measured window has closed (the training cell's way out of
    train(), which has no time limit)."""


@dataclasses.dataclass
class Context:
    """One run: the cell's files, its seed and length, and where it runs.
    `variant` is "program" for the benchmark's runs and "control" where the
    reference one precision lower takes the program's place in what is
    judged.  `prepare` names a function ("module:function") called in
    every process that runs the program, before it starts: the tests'
    planted faults."""
    cell: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    wall0: float
    variant: str = "program"
    prepare: Optional[str] = None

    @property
    def traffic(self) -> dict:
        return self.cell["params"]

    def to_args(self) -> dict:
        """The context as plain values, for a spawned rank."""
        args = dataclasses.asdict(self)
        args["device"] = str(self.device)
        return args

    @classmethod
    def from_args(cls, args: dict) -> "Context":
        return cls(**dict(args, device=torch.device(args["device"])))

    def derived_seed(self, stream: int) -> int:
        """A 63-bit seed for the run's seed and a stream number."""
        state = np.random.SeedSequence(
            [self.seed & SEED_MASK, stream]).generate_state(2, np.uint64)
        return int(state[0]) & SEED_MASK

    def rng(self, stream: int) -> np.random.Generator:
        """A numpy generator for the run's seed and a stream number."""
        return np.random.default_rng(self.derived_seed(stream))


_PREPARED = set()


def call_prepare(path: Optional[str]) -> None:
    """Call the function named "module:function" (the tests' planted
    faults), in the process that runs the program, once: a process that
    runs several seeds plants its fault once."""
    if path and path not in _PREPARED:
        _PREPARED.add(path)
        module, name = path.split(":")
        getattr(importlib.import_module(module), name)()


# The JAX package and JAX itself: nothing a run loads may be one of them,
# compared by the whole top-level name (detex_tpu_torch is the port).
FORBIDDEN = ("jax", "jaxlib", "flax", "detex_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted(name for name in list(sys.modules)
                  if name.split(".")[0] in FORBIDDEN)


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    """Release what the program held, before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def peak_bytes(device: torch.device) -> int:
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def set_precision(device: torch.device) -> None:
    """The configurations' precision: float32 stays float32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def span(name: str):
    """A span of the benchmark's own in the profiler's trace (a no-op
    costing about a microsecond where no profiler runs)."""
    return torch.profiler.record_function(name)


@dataclasses.dataclass
class Check:
    """One number that decides `correct`, with its limit: the run is
    correct where every value is at most its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back to run.py."""
    attempted: int
    failed: int
    metrics: Dict[str, float]          # end-to-end values by name
    checks: List[Check]
    memory_peak_bytes: int
    chips: int
    trace: Optional[dict] = None       # trace.summarise's dict, per chip
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


def pick(rng: np.random.Generator, expected: int, count: int) -> set:
    """`count` distinct indices drawn from the first nine tenths of
    `expected`, the requests a window is expected to hold (from the warm-up
    rate), always with the first and the last of that range."""
    top = max(1, int(expected * 0.9))
    if top <= count:
        return set(range(top))
    chosen = set(rng.choice(top, size=count - 2, replace=False).tolist())
    return chosen | {0, top - 1}


class Marks:
    """Named moments of the set-up, in seconds since the process started
    (its wall clock, which spawned ranks share), printed to stderr: where
    setup_s goes."""

    def __init__(self, wall0: float):
        self.wall0 = wall0
        self.at = {}

    def __call__(self, name: str) -> None:
        self.at[name] = round(time.time() - self.wall0, 3)


class Window:
    """The measured window on the host's clock: opened once, closed
    once."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.t_open = self.t_close = None

    def open(self) -> None:
        self.t_open = time.perf_counter()

    def over(self) -> bool:
        return time.perf_counter() - self.t_open >= self.seconds

    def close(self) -> None:
        self.t_close = time.perf_counter()

    @property
    def length(self) -> float:
        return self.t_close - self.t_open

