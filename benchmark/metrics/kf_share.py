"""Keyframes among the completed frames, in percent: the share the
traffic's schedule fixes, read from what ``process_frame`` reported."""


def read(run):
    if not run.frames:
        return None
    return 100.0 * sum(1 for r in run.frames if r[4]) / len(run.frames)
