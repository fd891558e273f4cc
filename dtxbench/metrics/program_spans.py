"""What the readers of the program's own spans share: the totals that
detex_tpu_torch/utils/trace.py keeps in this process, recorded while the
traced part's profiler ran (the program records nothing otherwise).

A program without that module, or whose module lacks snapshot(), or
that recorded no such span, gives None, as does a summary without a
window: run.py then leaves the metric out of the line.  The readers run
in the process that ran the cell; a cell whose program runs in spawned
ranks has no totals here, and no such metric.  Each value is a mean over
the span's occurrences, so a process that runs several seeds still reads
one span's mean."""

import importlib


def totals(summary):
    """The program's span totals by name ({"count", "total_s", "max_s"}),
    or None where there is nothing to read."""
    if not summary or not summary.get("window_s"):
        return None
    try:
        module = importlib.import_module("detex_tpu_torch.utils.trace")
    except ImportError:
        return None
    snapshot = getattr(module, "snapshot", None)
    if snapshot is None:
        return None
    return snapshot().get("spans") or None


def mean_ms(summary, name):
    """The mean of span `name` in ms, or None where it never ran."""
    span = (totals(summary) or {}).get(name)
    if not span or not span.get("count"):
        return None
    return 1e3 * span["total_s"] / span["count"]
