"""Device operations (kernels, copies, fills) per frame: those that start
inside the program's ``pipeline.frame`` span of a frame completed in the
window, over those frames.  Work queued after a frame's last host read
starts inside the next frame's span."""

import numpy as np

from benchmark.metrics._program import frames


def read(run):
    per = frames(run)
    if not per or run.trace is None:
        return None
    iv = sorted((f[4], f[5]) for f, _ in per.values())
    starts = np.array([a for a, _ in iv])
    ends = np.array([b for _, b in iv])
    s = np.array([op[1] for op in run.trace.ops])
    i = np.searchsorted(starts, s, side="right") - 1
    inside = (i >= 0) & (s < ends[np.clip(i, 0, None)])
    return float(np.sum(inside)) / len(iv)
