"""Frames completed in the window over the window's seconds (host
clock)."""


def read(run):
    return len(run.frames) / run.seconds
