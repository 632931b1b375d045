"""link.load_s (stable linker, device arena): mean LoadStats.startup_s of the
window's starts."""

import numpy as np

from bench import readings


def read(rec):
    done = readings.starts(rec)
    return float(np.mean([s["load_s"] for s in done])) if done else None
