"""replica_start_s: the window's seconds over the replicas that reached their
first token in it (each: drop the last, load from the epoch, lift, serve
one request to its first token)."""

from bench import readings


def read(rec):
    done = readings.starts(rec)
    return rec.seconds / len(done) if done else None
