"""The 95th percentile of every control step of the window, host clock
around Controller.step (words on the host to the action on the host)."""


def read(summary):
    return ((summary or {}).get("work") or {}).get("step_p95_ms")
