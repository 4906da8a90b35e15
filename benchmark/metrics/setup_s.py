"""Seconds from the start of the process until the window opens: the
kernels' build (cached after a checkout's first run), the weights, the
engine, the clip, the warm-up and the measured system."""


def read(run):
    return run.setup_s
