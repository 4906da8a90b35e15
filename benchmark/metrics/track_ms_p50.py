"""The median of the benchmark's ``tracker.track`` spans inside the
window (host clock)."""

from benchmark.metrics._spans import median_ms


def read(run):
    return median_ms(run, "tracker.track")
