"""sched.loop_gap_ms (scheduler; program span): the median, over pairs of
consecutive ``sched.step`` spans in the window with no ``sched.admit``
between them, of the next step's start minus the previous step's end: the
serving loop's own host work between steps, with nothing queued on the
card, in ms."""

from bench import readings, spans


def read(rec):
    v = readings.p50(spans.loop_gaps(rec))
    return None if v is None else 1e3 * v
