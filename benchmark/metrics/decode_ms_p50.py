"""The median over the tracked frames completed in the window of each
frame's time in the program's ``inference.decode`` span:
``InferenceEngine.decode_pair``, both decoder branches and both heads
(host clock)."""

from benchmark.metrics._program import tracked_median_ms


def read(run):
    return tracked_median_ms(run, lambda name: name == "inference.decode")
