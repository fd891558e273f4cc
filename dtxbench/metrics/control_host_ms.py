"""The host's own time in a control step, ms: the program's span
dtx.control.step (Controller.step, the whole call) less dtx.control.wait
(the action's copy to the host, where the host waits for the card), over
the steps: the words' upload, the noise draw and the replay's launch."""

from dtxbench.metrics import program_spans


def read(summary):
    spans = program_spans.totals(summary) or {}
    step, wait = spans.get("dtx.control.step"), spans.get("dtx.control.wait")
    if not step or not wait or not step.get("count"):
        return None
    return 1e3 * (step["total_s"] - wait["total_s"]) / step["count"]
