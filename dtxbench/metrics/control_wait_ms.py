"""The host's wait on the card in a control step, ms: the mean of the
program's span dtx.control.wait (the action's copy to the host)."""

from dtxbench.metrics import program_spans


def read(summary):
    return program_spans.mean_ms(summary, "dtx.control.wait")
