"""Device operations a step: the records of kernels, copies and sets that
the traced part of the window holds (dtxbench.trace's n_device_ops), over
the steps it traced.  A captured step's replay is counted by its nodes:
the number shows how much glue surrounds the GEMMs."""

from dtxbench.metrics import device_time


def read(summary):
    n = device_time(summary, "n_device_ops")
    steps = ((summary or {}).get("work") or {}).get("steps")
    if not n or not steps:
        return None
    return n / steps
