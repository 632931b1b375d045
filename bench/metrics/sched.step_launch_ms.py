"""sched.step_launch_ms (model step; program span): the median length of the
window's ``sched.step.launch`` spans (the host issuing a decode step's
launches, before it waits for the tokens), in ms."""

from bench import spans


def read(rec):
    return spans.median_length(rec, "sched.step.launch", 1e3)
