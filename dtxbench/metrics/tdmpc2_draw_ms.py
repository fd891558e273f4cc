"""The host's draw of a TD-MPC2 step, ms: the mean of the program's span
dtx.tdmpc2.draw (the step's normal, uniform and exponential draws into
the step's static buffers, before the replay)."""

from dtxbench.metrics import program_spans


def read(summary):
    return program_spans.mean_ms(summary, "dtx.tdmpc2.draw")
