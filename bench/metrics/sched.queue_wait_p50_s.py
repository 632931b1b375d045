"""sched.queue_wait_p50_s (scheduler): the median, over the window's
admissions, of the time from when the request was due to the start of its
admission (its B=1 prefill)."""

from bench import readings


def read(rec):
    return readings.p50(readings.queue_waits(rec))
