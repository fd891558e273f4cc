"""One reader per per-layer quantity, found by the metric's name in
BENCHMARK.json up to its first dot (`mfu_pct.train` is read by
mfu_pct.py; a quantity whose cells move different end-to-end metrics is
split by such a suffix): `read(summary)` takes the traced part of the window as
dtxbench.trace reduced it (with the driver's `work` under "work") and
returns the metric's value, or None where the trace holds nothing to read
it from; run.py then leaves the metric out of the result."""


def device_time(summary, key):
    """summary[key] where the trace holds device records, else None."""
    if not summary or not summary.get("window_s") \
            or not summary.get("n_device_ops"):
        return None
    return summary[key]
