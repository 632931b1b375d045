"""device.idle_share.start (device): the traced stretch's share of time with
no kernel running on the card, in %."""

from bench import readings


def read(rec):
    return readings.idle_share(rec)
