"""The median over the tracked frames completed in the window of each
frame's time in the program's ``tracker.gn`` span: the GN solve (its point
data, ``gn_solve``'s launch and its result; host clock)."""

from benchmark.metrics._program import tracked_median_ms


def read(run):
    return tracked_median_ms(run, lambda name: name == "tracker.gn")
