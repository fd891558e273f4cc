"""Structured per-step metrics (SURVEY.md §5 observability: the
reference has none beyond printf; the rebuild emits JSON lines).

The port's own copy of detex_tpu/utils/metrics.py, so that the port
imports nothing of the JAX package; the two are held equal by
tests/test_torch_host_copies.py."""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, Optional, TextIO


class MetricsLogger:
    """Emit one JSON line per step: {"step": n, "t": epoch_s, ...}."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream or sys.stdout
        self._t0 = time.time()

    def log(self, step: int, **values: Any) -> None:
        rec: Dict[str, Any] = {"step": step,
                               "t": round(time.time() - self._t0, 6)}
        for k, v in values.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self.stream.write(json.dumps(rec) + "\n")
        self.stream.flush()


class Timer:
    """Wall-clock timing context for step-budget accounting (the 10 ms
    control-step budget in BASELINE.md)."""

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_s = time.perf_counter() - self.t0
        return False
