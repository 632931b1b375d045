"""sched.step_ms (model step; program span): the median length of the
window's ``sched.step`` spans (one batched decode step, issued and its
tokens read back), in ms."""

from bench import spans


def read(rec):
    return spans.median_length(rec, "sched.step", 1e3)
