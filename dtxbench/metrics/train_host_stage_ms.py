"""The host's staging of a training batch, ms: the mean of the program's
span dtx.train.stage (the batch copied into the pinned buffers and sent
up)."""

from dtxbench.metrics import program_spans


def read(summary):
    return program_spans.mean_ms(summary, "dtx.train.stage")
