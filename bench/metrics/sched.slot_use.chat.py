"""sched.slot_use.chat (scheduler; program span): the mean, over the window's
``sched.step`` spans, of active slots over slots: the rows a decode step
computes for a request, over every row it computes, in %."""

from bench import spans


def read(rec):
    return spans.slot_use(rec)
