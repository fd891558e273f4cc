"""The host's side of a texture call's copy out, ms: the mean of the
program's span dtx.texture.copy_out (convert_device.to_bytes: the wait
for the replay, the copy into host memory, the numpy view)."""

from dtxbench.metrics import program_spans


def read(summary):
    return program_spans.mean_ms(summary, "dtx.texture.copy_out")
