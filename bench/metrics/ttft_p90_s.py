"""ttft_p90_s: the 90th percentile, over every request due in the window, of
the time from when it was due to its first streamed token; a request with
none by the close counts its wait so far."""

from bench import readings


def read(rec):
    return readings.p90(readings.ttft(rec))
