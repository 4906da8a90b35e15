"""The program's own spans of a traced run, frame by frame.

The port records its frame path in one process-wide tracer
(``mast3r_slam_torch.utils.profiler.TRACER``): records ``(name, key,
thread, parent, start, end, cpu_s, note)`` on the host clock, the frame's
``pipeline.frame`` keyed by its index and noted with its mode, each span
beneath it keyed alike.  The tracer records while a ``torch.profiler``
session does, so a traced run (``--trace 1``) holds the window's spans and
a run with ``--trace 0`` none.  A program without that tracer gives
nothing, and the readers return None.
"""

import sys

import numpy as np

TRACER_MODULE = "mast3r_slam_torch.utils.profiler"


def records(run):
    """The run's span records: ``run.program_spans`` where the run carries
    them, else, in a traced run, the process-wide tracer's; None without
    any."""
    rec = getattr(run, "program_spans", None)
    if rec is None and run.trace is not None:
        tracer = getattr(sys.modules.get(TRACER_MODULE), "TRACER", None)
        rec = tracer.records() if tracer is not None else None
    return rec or None


def frames(run):
    """{frame index: (its ``pipeline.frame`` record, [the records beneath
    it])} for the frames completed in the window on the frontend thread;
    None without spans."""
    rec = records(run)
    if rec is None:
        return None
    go, end = run.window
    done = {r[0] for r in run.frames}
    root = []
    out = {}
    for i, r in enumerate(rec):
        # a parent is entered, so recorded, before its children
        root.append(i if r[3] is None else root[r[3]])
        top = rec[root[i]]
        if top[0] != "pipeline.frame" or top[2] != run.thread or \
                top[1] not in done or not (go <= top[4] and top[5] <= end):
            continue
        if root[i] == i:
            out.setdefault(r[1], [None, []])[0] = r
        else:
            out.setdefault(top[1], [None, []])[1].append(r)
    return {k: (f, kids) for k, (f, kids) in out.items() if f is not None}


def tracked_median_ms(run, match):
    """The median over the tracked frames (mode ``TRACKING...``) of each
    frame's summed time in the spans ``match(name)`` accepts, over the
    frames that hold one; None when none does."""
    per = frames(run)
    if per is None:
        return None
    sums = []
    for f, kids in per.values():
        d = [r[5] - r[4] for r in kids if match(r[0])]
        if d and (f[7] or "").startswith("TRACKING"):
            sums.append(1e3 * sum(d))
    return float(np.median(sums)) if sums else None
