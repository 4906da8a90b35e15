"""The whole step's share of the card's peak: the network operations of
the frames completed in the window (encode, two-branch decode and both
heads per frame, from shapes; int8 products at the int8 peak, the rest at
the bf16 peak) over the window's seconds."""

from benchmark import flops


def read(run):
    if not run.frames:
        return None
    at_peak = flops.step_seconds_at_peak(run.step_flops) * len(run.frames)
    return 100.0 * at_peak / run.seconds
