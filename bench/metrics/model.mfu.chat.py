"""model.mfu.chat (model step): the window's prefills and decode steps, their
roofline bounds (bench/roofline.py) summed over their measured times, in %."""

from bench import readings


def read(rec):
    return readings.step_share(rec)
