"""The work's share of the bfloat16 peak of the cards it uses: the model's
FLOPs a unit of work (a control step, or a transition trained; counted
from the shapes by dtxbench.flops) times the units done, over the time
they took, against 989e12 FLOP/s a card.  The time is the host clock's
over the window's work after the traced part (the profiler slows the
traced part), or over the traced part where the window ends inside it.
One reader for every `mfu_pct.<cell kind>` metric."""

from dtxbench import flops


def read(summary):
    work = (summary or {}).get("work", {})
    if work.get("untraced_units"):
        units, seconds = work["untraced_units"], work["untraced_s"]
    elif work.get("units") and summary.get("window_s"):
        units, seconds = work["units"], summary["window_s"]
    else:
        return None
    rate = work["flops_per_unit"] * units / seconds
    return 100.0 * rate / (flops.BF16_FLOPS * summary["chips"])
