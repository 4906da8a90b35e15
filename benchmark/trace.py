"""The device trace of a traced run, on the host's clock.

``torch.profiler`` records the card's activity (kernels, copies, fills)
over the window; a marker kernel launched on a stream of its
own when the trace starts ties the trace's clock to ``time.perf_counter``.
The reduction gives the busy time (the union of every operation's
interval), the operations that took most time, and the idle gaps labelled
by what the host threads were inside of at the time.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

MARKER = "spin_kernel"          # torch.cuda._sleep's kernel


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None
        self.ops: list = []     # (name, start_s, end_s), host clock

    def start(self):
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        marker_stream = torch.cuda.Stream()
        with torch.cuda.stream(marker_stream):
            self._h0 = time.perf_counter()
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self, window):
        """Stop recording; the window [t0, t1] is the measured one."""
        self.t0, self.t1 = window
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        events = []
        offset = None
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            name = ev.name()
            if offset is None and MARKER in name:
                offset = s - self._h0
                continue
            events.append((name, s, e))
        if offset is None:
            raise RuntimeError("the device trace holds no marker kernel")
        self.ops = [(n, s - offset, e - offset) for n, s, e in events]
        self.prof = None

    # -- reductions -------------------------------------------------------

    def window_s(self) -> float:
        return self.t1 - self.t0

    def intervals(self):
        """The merged busy intervals inside [t0, t1], as (starts, ends)."""
        iv = sorted((max(s, self.t0), min(e, self.t1))
                    for _, s, e in self.ops if e > self.t0 and s < self.t1)
        starts, ends = [], []
        for s, e in iv:
            if starts and s <= ends[-1]:
                ends[-1] = max(ends[-1], e)
            else:
                starts.append(s)
                ends.append(e)
        return np.array(starts), np.array(ends)

    def busy_s(self) -> float:
        s, e = self.intervals()
        return float(np.sum(e - s))

    def top_ops(self, n: int = 10):
        tot = collections.Counter()
        for name, s, e in self.ops:
            if e > self.t0 and s < self.t1:
                tot[name[:64]] += min(e, self.t1) - max(s, self.t0)
        return [[k, v] for k, v in tot.most_common(n)]

    def kernel_time(self, pattern: str) -> float:
        """Seconds of the operations whose name holds ``pattern`` and that
        start inside the window."""
        return sum(e - s for name, s, e in self.ops
                   if pattern in name and self.t0 <= s < self.t1)

    def idle_gaps(self, thread_spans: dict, n: int = 10):
        """The idle time inside the window by what the host threads were
        doing: each gap is labelled by the innermost span each thread was
        in at its midpoint (``thread_spans``: thread -> list of (name,
        start, end, depth)); the seconds of each label, the largest
        ``n``."""
        s, e = self.intervals()
        gs = np.concatenate([[self.t0], e])
        ge = np.concatenate([s, [self.t1]])
        keep = ge > gs
        gs, ge = gs[keep], ge[keep]
        mids = 0.5 * (gs + ge)
        labels = [collections.Counter() for _ in mids]
        for spans in thread_spans.values():
            best = np.full(len(mids), -1)
            name_of = np.empty(len(mids), dtype=object)
            for name, depth, st, en in _by_name(spans):
                i = np.searchsorted(st, mids, side="right") - 1
                ok = (i >= 0) & (mids < en[np.clip(i, 0, None)]) & \
                    (depth > best)
                best[ok] = depth
                name_of[ok] = name
            for k in np.nonzero(best >= 0)[0]:
                labels[k][name_of[k]] += 1
        tot = collections.Counter()
        for lab, g in zip(labels, ge - gs):
            key = "+".join(f"{k}x{c}" if c > 1 else k
                           for k, c in sorted(lab.items())) or "none"
            tot[key] += float(g)
        return [[k, v] for k, v in tot.most_common(n)]


def _by_name(spans):
    """Per span name (each name's spans of one thread do not overlap): its
    depth and its sorted starts and ends."""
    groups = collections.defaultdict(list)
    depth = {}
    for name, st, en, d in spans:
        groups[name].append((st, en))
        depth[name] = d
    for name, iv in groups.items():
        iv.sort()
        yield (name, depth[name], np.array([a for a, _ in iv]),
               np.array([b for _, b in iv]))
