"""sched.accept_wait_p50_s (scheduler; program span): the median, over the
requests admitted in the window, of the time from when each was due to when
the serving loop accepted it (the start of its ``serve.queued`` span): the
wait for the loop to poll between steps."""

from bench import readings, spans


def read(rec):
    return readings.p50(spans.accept_waits(rec))
