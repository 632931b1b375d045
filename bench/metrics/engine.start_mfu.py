"""engine.start_mfu (engine): each start's bound (its arena's bytes written
once, then its prefill's roofline bound) summed over the starts' times, in %."""

from bench import readings


def read(rec):
    return readings.start_share(rec)
