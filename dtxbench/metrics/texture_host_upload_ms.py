"""The host's side of a texture call's upload, ms: the mean of the
program's span dtx.texture.upload (the words' copy to the card)."""

from dtxbench.metrics import program_spans


def read(summary):
    return program_spans.mean_ms(summary, "dtx.texture.upload")
