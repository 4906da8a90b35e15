"""The median over the frames completed in the window of the program's
``pipeline.frame`` wall time less the frontend thread's CPU time inside it:
how long the thread was off the CPU (waiting for the interpreter lock or
the OS).  A CUDA synchronisation spins, so it counts as CPU time."""

import numpy as np

from benchmark.metrics._program import frames


def read(run):
    per = frames(run)
    if not per:
        return None
    return float(np.median([1e3 * (f[5] - f[4] - f[6])
                            for f, _ in per.values()]))
