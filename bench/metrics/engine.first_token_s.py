"""engine.first_token_s (engine): mean time from a start's load to its first
token: lifting the parameters, then the prefill."""

import numpy as np

from bench import readings


def read(rec):
    done = readings.starts(rec)
    return float(np.mean([s["first_ts"] - s["t0"] - s["load_s"] for s in done])) if done else None
