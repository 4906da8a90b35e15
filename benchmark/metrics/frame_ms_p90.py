"""The 90th percentile (linear interpolation) of every completed frame's
``process_frame`` time on the host clock."""

import numpy as np


def read(run):
    if not run.frames:
        return None
    return float(np.percentile([1e3 * (t1 - t0)
                                for _, t0, t1, _, _ in run.frames], 90))
