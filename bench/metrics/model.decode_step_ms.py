"""model.decode_step_ms (model step): the median time between two decode
steps' tokens with no admission between them, in ms."""

from bench import readings


def read(rec):
    v = readings.p50([s["t_end"] - s["t_start"] for s in readings.steps(rec, clean=True)])
    return None if v is None else 1e3 * v
