"""engine.prefill_launch_s (engine; program span): the mean length of the
window's ``engine.prefill.launch`` spans: the host issuing a start's first
prefill, before it waits for the card."""

from bench import spans


def read(rec):
    return spans.mean_length(rec, "engine.prefill.launch")
