"""The median over the tracked frames completed in the window of each
frame's time in the program's ``vggt.aggregate`` span: VGGT's aggregator
over the pair, 24 frame and 24 global blocks (host clock).  A network
without that span gives None."""

from benchmark.metrics._program import tracked_median_ms


def read(run):
    return tracked_median_ms(run, lambda name: name == "vggt.aggregate")
