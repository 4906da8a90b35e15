"""The median over the tracked frames completed in the window of each
frame's summed time in the program's ``sync.*`` spans, its host reads of
the card: how long the host waited for the card (host clock)."""

from benchmark.metrics._program import tracked_median_ms


def read(run):
    return tracked_median_ms(run, lambda name: name.startswith("sync."))
