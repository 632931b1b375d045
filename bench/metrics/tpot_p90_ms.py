"""tpot_p90_ms: the 90th percentile, over requests with two tokens or more in
the window, of (last token - first token) / (tokens - 1) there, in ms."""

from bench import readings


def read(rec):
    v = readings.p90(readings.tpot(rec))
    return None if v is None else 1e3 * v
