"""The median over the tracked frames completed in the window of each
frame's time in the program's ``vggt.point_head`` and ``vggt.track_head``
spans together: VGGT's two DPT heads on both views (host clock).  A
network without those spans gives None."""

from benchmark.metrics._program import tracked_median_ms

HEADS = ("vggt.point_head", "vggt.track_head")


def read(run):
    return tracked_median_ms(run, lambda name: name in HEADS)
