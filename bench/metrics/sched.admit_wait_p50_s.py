"""sched.admit_wait_p50_s (scheduler; program span): the median length of
the window's ``serve.queued`` spans, from a request's acceptance to the
start of its admission: the wait behind other prefills."""

from bench import spans


def read(rec):
    return spans.median_length(rec, "serve.queued")
