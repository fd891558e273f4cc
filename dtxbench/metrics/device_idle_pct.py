"""The share of the traced window in which no kernel runs on the card
(copies are left out), averaged over the cards of the cell.  One reader
for every `device_idle_pct.<cell kind>` metric."""

from dtxbench.metrics import device_time


def read(summary):
    busy = device_time(summary, "kernel_busy_s")
    if busy is None:
        return None
    return 100.0 * (1.0 - busy / summary["window_s"])
