"""engine.start_s (engine): the window's seconds over the replicas that
reached their first token in it (each: drop the last, load from the epoch,
lift, serve one request to its first token). A start is paced by the host
(the payloads' read, the prefill's issue), so this moves with the host's
speed from run to run; the cell's end-to-end metric is the card's part,
``start_device_ms``."""

from bench import readings


def read(rec):
    done = readings.starts(rec)
    return rec.seconds / len(done) if done else None
