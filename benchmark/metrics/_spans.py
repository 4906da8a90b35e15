"""The median of one span's durations inside the window, in ms."""

import numpy as np


def median_ms(run, name):
    go, end = run.window
    d = [1e3 * (t1 - t0) for n, _, t0, t1 in run.spans or []
         if n == name and go <= t0 and t1 <= end]
    return float(np.median(d)) if d else None
