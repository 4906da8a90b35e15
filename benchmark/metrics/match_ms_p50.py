"""The median over the tracked frames completed in the window of each
frame's time in the program's ``matching.match`` span: the q8
quantisation and the matcher (kernel C, ``iter_proj``, the refinement;
host clock)."""

from benchmark.metrics._program import tracked_median_ms


def read(run):
    return tracked_median_ms(run, lambda name: name == "matching.match")
