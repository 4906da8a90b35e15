"""The median of the benchmark's ``engine.encode`` spans inside the
window (host clock)."""

from benchmark.metrics._spans import median_ms


def read(run):
    return median_ms(run, "engine.encode")
