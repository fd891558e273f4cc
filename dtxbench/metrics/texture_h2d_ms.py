"""Host -> device copy time a texture call, ms: the copies' durations in
the device trace over the calls of the traced window."""

from dtxbench.metrics import device_time


def read(summary):
    h2d = device_time(summary, "h2d_s")
    calls = (summary or {}).get("work", {}).get("calls")
    if not h2d or not calls:
        return None
    return 1e3 * h2d / calls
