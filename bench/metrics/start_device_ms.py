"""start_device_ms (device): the milliseconds a replica start holds the
card (its weights' upload, the page copy that builds its arena, the first
prefill and its argmax), as the union of the device's kernels and copies
over the traced stretch, per start in it: the card time a start takes from
the replicas that serve beside it."""

from bench import readings


def read(rec):
    return readings.device_ms_per_start(rec)
