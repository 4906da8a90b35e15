"""The median over the tracked frames completed in the window of each
frame's summed time in the program's ``frame.fuse`` spans: the pointmap
fusions (``update_pointmap``, twice a tracked frame; host clock)."""

from benchmark.metrics._program import tracked_median_ms


def read(run):
    return tracked_median_ms(run, lambda name: name == "frame.fuse")
