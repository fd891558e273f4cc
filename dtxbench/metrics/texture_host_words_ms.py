"""The host's word conversion of a texture call, ms: the mean of the
program's span dtx.texture.words (engine._words: words_from_bytes)."""

from dtxbench.metrics import program_spans


def read(summary):
    return program_spans.mean_ms(summary, "dtx.texture.words")
