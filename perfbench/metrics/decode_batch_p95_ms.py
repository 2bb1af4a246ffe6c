"""The 95th percentile over every batch of the window of the time from
the batch's turn in the loop (its request) to its captions on the host,
linear between order statistics."""

import numpy as np


def read(w):
    if not w.latencies_s:
        return None
    return float(np.percentile(np.asarray(w.latencies_s, np.float64), 95)) * 1e3
