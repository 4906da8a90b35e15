"""A traced run of one cell, read through the program's own spans.

    python3 -m benchmark.tools.program_trace --workload <cell> --seed <n> \
        --seconds <s> [--device-trace 0] [--out FILE]

On the card, from the root of a checkout.  The run is the harness's
``--trace 1`` run, with two additions that the result line of
``run.py`` does not have yet:

* the idle gaps of the device trace are labelled by the innermost span
  over both the benchmark's wrappers (``frame``, ``tracker.track``,
  ``engine.encode``, ``backend.round``) and the program's spans
  (``mast3r_slam_torch.utils.profiler.TRACER``), a program span counting
  as deeper than every wrapper around it and than its parent, so that the
  gaps name ``inference.decode``, ``matching.match``, ``sync.kf_decision``
  and so on (``breakdown.idle_gaps``; the wrappers' own labels stay under
  ``breakdown.idle_gaps_wrappers``);
* a second marker kernel at the end of the trace: the difference between
  the two markers' host-to-device offsets is the error of every gap label
  (``markers``; also on standard error).

It prints one JSON line: the run's result object with those, and
``spans``, each program span's median per tracked frame, the share of
``tracker.step`` its children cover and the idle time left to a wrapper.

With ``--device-trace 0`` the run is the harness's untraced run (the
end-to-end metrics) with the program's tracer on over the window and no
profiler: the spans' own cost and the frame's off-CPU time without the
device trace's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from benchmark.metrics import _program  # noqa: E402
from benchmark.trace import MARKER, DeviceTrace  # noqa: E402

# the benchmark's wrappers sit at depths 0 to 2 (harness.spans_by_thread)
PROGRAM_DEPTH = 3
WRAPPERS = ("frame", "tracker.track", "engine.encode", "backend.round")
STEP_CHILDREN = ("inference.decode", "matching.match", "tracker.gn",
                 "frame.fuse", "sync.kf_decision")


def thread_spans(run, wrappers: dict) -> dict:
    """``wrappers`` (thread -> [(name, start, end, depth)], the harness's
    spans) with the program's spans added at ``PROGRAM_DEPTH`` plus their
    nesting depth."""
    out = {th: list(v) for th, v in wrappers.items()}
    depth = []
    for name, _, th, parent, t0, t1, _, _ in _program.records(run) or []:
        depth.append(0 if parent is None else depth[parent] + 1)
        out.setdefault(th, []).append((name, t0, t1,
                                       PROGRAM_DEPTH + depth[-1]))
    return out


def idle_gaps(trace, spans_of_thread: dict, n: int = 10):
    """``DeviceTrace.idle_gaps`` with each span's own depth, so that one
    name may sit at several depths and its spans may nest: each gap is
    labelled by the deepest span each thread was in at its midpoint."""
    s, e = trace.intervals()
    gs = np.concatenate([[trace.t0], e])
    ge = np.concatenate([s, [trace.t1]])
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mids = 0.5 * (gs + ge)
    labels = [collections.Counter() for _ in mids]
    for spans in spans_of_thread.values():
        best = np.full(len(mids), -1)
        name_of = np.empty(len(mids), dtype=object)
        for name, st, en, depth in sorted(spans, key=lambda x: x[3]):
            lo, hi = np.searchsorted(mids, [st, en], side="left")
            deeper = depth > best[lo:hi]
            best[lo:hi][deeper] = depth
            name_of[lo:hi][deeper] = name
        for k in np.nonzero(best >= 0)[0]:
            labels[k][name_of[k]] += 1
    tot = collections.Counter()
    for lab, g in zip(labels, ge - gs):
        key = "+".join(f"{k}x{c}" if c > 1 else k
                       for k, c in sorted(lab.items())) or "none"
        tot[key] += float(g)
    return [[k, v] for k, v in tot.most_common(n)]


def wrapper_share(gaps) -> float | None:
    """The share of the idle time whose label names a benchmark wrapper."""
    total = sum(v for _, v in gaps)
    if not total:
        return None
    return sum(v for k, v in gaps
               if {re.sub(r"x\d+$", "", p) for p in k.split("+")}
               & set(WRAPPERS)) / total


class MarkedTrace(DeviceTrace):
    """The device trace with two more marker kernels, each on a stream of
    its own after a synchronise: one just after the harness's first (the
    same launch path once the profiler runs) and one before the profiler
    stops.  ``offsets_s`` are the three host-to-device offsets in launch
    order; the operations are mapped with the first, as the harness maps
    them."""

    offsets_s = None

    def _marker(self):
        import torch

        torch.cuda.synchronize()
        with torch.cuda.stream(torch.cuda.Stream()):
            h = time.perf_counter()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return h

    def start(self):
        super().start()
        self._hosts = [self._h0, self._marker()]

    def stop(self, window):
        import torch

        self.t0, self.t1 = window
        self._hosts.append(self._marker())
        self.prof.__exit__(None, None, None)
        events, marks = [], []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            (marks if MARKER in ev.name() else events).append(
                (ev.name(), s, e))
        if len(marks) != len(self._hosts):
            raise RuntimeError(f"the device trace holds {len(marks)} marker "
                               f"kernels, not {len(self._hosts)}")
        marks.sort(key=lambda m: m[1])
        self.offsets_s = [m[1] - h for m, h in zip(marks, self._hosts)]
        self.ops = [(n, s - self.offsets_s[0], e - self.offsets_s[0])
                    for n, s, e in events]
        self.prof = None

    def markers(self) -> dict:
        """The harness's mapping error at the end of the trace (the last
        marker's offset less the first's), the first launch's extra
        latency (the first's less the second's) and the clocks' drift (the
        last's less the second's), in us, and the trace's host length."""
        a, b, c = self.offsets_s
        return {"drift_us": 1e6 * (c - a), "first_launch_us": 1e6 * (a - b),
                "clock_drift_us": 1e6 * (c - b),
                "apart_s": self._hosts[2] - self._hosts[0]}

    def idle_gaps(self, thread_spans: dict, n: int = 10):
        return idle_gaps(self, thread_spans, n)


def span_table(run) -> dict:
    """Each program span's median over the tracked frames of its summed ms
    a frame; ``tracker.step``'s self time (less its children) and the
    share of its median its children's median covers."""
    per = _program.frames(run) or {}
    sums = collections.defaultdict(list)
    self_ms, kids_ms = [], []
    for f, kids in per.values():
        if not (f[7] or "").startswith("TRACKING"):
            continue
        by = collections.defaultdict(float)
        for r in kids:
            by[r[0]] += 1e3 * (r[5] - r[4])
        for name, v in by.items():
            sums[name].append(v)
        sums["pipeline.frame"].append(1e3 * (f[5] - f[4]))
        child = sum(by[k] for k in STEP_CHILDREN)
        kids_ms.append(child)
        self_ms.append(by["tracker.step"] - child)
    out = {k: float(np.median(v)) for k, v in sorted(sums.items())}
    if kids_ms:
        out["tracker.step.self"] = float(np.median(self_ms))
        out["tracker.step.covered"] = float(
            np.median(kids_ms) / out["tracker.step"])
        out["tracked_frames"] = len(kids_ms)
    return out


def run_cell(cell, seed: int, seconds: float, device_trace: bool, device,
             t_start: float, log=print) -> dict:
    """``harness.run_cell`` with the program's spans read as the module's
    docstring says; returns the result object with ``spans`` (and with
    the device trace ``markers`` and ``breakdown.idle_gaps_wrappers``)."""
    from benchmark import drive, harness
    from benchmark import trace as trace_mod

    seen = {}
    patched = [(harness, "spans_by_thread"), (trace_mod, "DeviceTrace"),
               (harness, "RunData"), (drive.Camera, "run")]
    saved = [getattr(o, k) for o, k in patched]
    wrappers, run_data, camera_run = saved[0], saved[2], saved[3]

    class Trace(MarkedTrace):
        def __init__(self):
            super().__init__()
            seen["trace"] = self

    def spans(run):
        w = wrappers(run)
        seen["wrapper_gaps"] = DeviceTrace.idle_gaps(seen["trace"], w, 10)
        merged = thread_spans(run, w)
        seen["all_gaps"] = idle_gaps(seen["trace"], merged, 10 ** 9)
        return merged

    def captured(*a, **kw):
        seen["run"] = run = run_data(*a, **kw)
        if not device_trace:
            # the tracer ran by itself over the window (below)
            run.program_spans = tracer.records()
        return run

    def window_traced(camera, end):
        tracer.reset()
        tracer.enable()
        try:
            return camera_run(camera, end)
        finally:
            tracer.disable()

    tracer = None
    if not device_trace:
        from mast3r_slam_torch.utils.profiler import TRACER as tracer
    for (o, k), v in zip(patched, (
            spans, Trace, captured,
            camera_run if device_trace else window_traced)):
        setattr(o, k, v)
    try:
        out = harness.run_cell(cell, seed, seconds, device_trace, device,
                               t_start, log=log)
    finally:
        for (o, k), v in zip(patched, saved):
            setattr(o, k, v)
    run = seen["run"]
    if "trace" in seen:
        out["markers"] = m = seen["trace"].markers()
        log(f"markers: the last marker's offset differs from the first's by "
            f"{m['drift_us']:.1f} us over {m['apart_s']:.1f} s (the first "
            f"launch {m['first_launch_us']:.1f} us, the clocks "
            f"{m['clock_drift_us']:.1f} us)")
        out["breakdown"]["idle_gaps_wrappers"] = seen["wrapper_gaps"]
    if not device_trace:
        out["metrics"].update({
            k: {"value": harness.read_metric(k, run)} for k in
            ("frame_ms_p50", "frame_offcpu_ms_p50", "host_sync_ms_p50")})
    out["spans"] = span_table(run)
    if "all_gaps" in seen:
        out["spans"]["wrapper_idle_share"] = wrapper_share(seen["all_gaps"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device-trace", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import harness

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    harness.cache_dirs()
    cell = harness.load_cell(args.workload)
    import torch

    info = harness.device_info(torch, int(cell.workload["chips"]))
    log(f"{info['kind']}, power limit {info['power_limit_w']} W; workload "
        f"{args.workload}, seed {args.seed}, {args.seconds} s, program "
        f"spans, device trace {args.device_trace}")
    out = run_cell(cell, args.seed, args.seconds, bool(args.device_trace),
                   "cuda", T_START, log)
    out["device"].update(info)
    line = json.dumps(dict(workload=args.workload, seed=args.seed, **out))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
