"""Device -> host copy time a texture call, ms: the copies' durations in
the device trace over the calls of the traced window."""

from dtxbench.metrics import device_time


def read(summary):
    d2h = device_time(summary, "d2h_s")
    calls = (summary or {}).get("work", {}).get("calls")
    if not d2h or not calls:
        return None
    return 1e3 * d2h / calls
