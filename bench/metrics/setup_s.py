"""setup_s: seconds from the process's start to the window's (or its ramp's) opening:
imports, weights, the engine or the publish, and the warm-up (with the
kernels' build in a checkout's first run)."""


def read(rec):
    return rec.setup_s
