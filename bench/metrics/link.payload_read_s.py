"""link.payload_read_s (stable linker, device arena; program span): the mean,
over the window's ``link.load`` spans, of the seconds of their
``link.payload_read`` spans: the host copying the payloads out of their
mappings into the pinned staging buffers."""

import numpy as np

from bench import spans


def read(rec):
    per = spans.payload_read_per_load(rec)
    return float(np.mean(per)) if per else None
