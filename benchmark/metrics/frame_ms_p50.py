"""The median of the completed frames' ``process_frame`` times (host
clock)."""

import numpy as np


def read(run):
    if not run.frames:
        return None
    return float(np.median([1e3 * (t1 - t0) for _, t0, t1, _, _ in run.frames]))
