"""Kernel A's share of its roofline: the operations of its launches inside
the traced window (from their shapes) over the bf16 peak times its traced
time.  At these shapes (Dh 64, 768 keys) the operations bound it."""

from benchmark import flops


def read(run):
    tr = run.trace
    if tr is None or not run.attn:
        return None
    t = tr.kernel_time("attn_fwd")
    if t <= 0:
        return None
    ops = sum(flops.attention(*shape) for t0, shape in run.attn
              if tr.t0 <= t0 < tr.t1)
    return 100.0 * ops / (flops.PEAK["bf16"] * t)
