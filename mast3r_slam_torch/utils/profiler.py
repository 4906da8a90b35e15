"""The port's tracer: host-clock spans on the frame path, one per process.

The JAX package keeps one process-wide ``TimeProfiler``
(``mast3r_slam_tpu/utils/profiler.py``); here ``TRACER`` is the one
instance, so the pipeline, the tracker, the engine and the ops beneath them
reach it without an argument::

    with TRACER.span("tracker.gn"):
        ...

A span records ``(name, key, thread id, parent index, start, end, cpu_s,
note)``: ``start`` and ``end`` from ``time.perf_counter()`` (the clock a
device trace is mapped onto), ``parent`` the index of the enclosing span of
the same thread, ``key`` the frame index on the frontend and the keyframe
index in a backend round (a span without a key takes its parent's, so all
spans of one frame share one), ``cpu_s`` the thread's own CPU time inside
the span (``time.thread_time``), ``note`` a short string (the frame's
mode).

Nothing here synchronises the card.  A span's time is the host's: the
time to issue its work, plus any wait in a host read of the card inside
it.  A frame's total is whole, since a frame ends on a host read of the
card; a section's share of it is where the host spent its time, not where
the card did.

The tracer records while it is enabled (``enable``; ``main_torch.py
--profile``) or while a ``torch.profiler`` session records, so that a
device trace always has the host's spans beside it on the same clock.
Otherwise a span is one shared object that does nothing: no clock read and
no allocation.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

from torch.autograd import profiler as _torch_profiler


class _Off:
    """The span of a tracer that is not recording: one shared instance."""

    __slots__ = ("note",)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()


class _Span:
    """A recorded span; it stays in the tracer's list once entered and is
    read out as a tuple by ``Tracer.records``."""

    __slots__ = ("tracer", "name", "key", "thread", "parent", "start",
                 "end", "cpu0", "cpu_s", "note")

    def __init__(self, tracer, name, key, note):
        self.tracer = tracer
        self.name = name
        self.key = key
        self.note = note
        self.end = None

    def __enter__(self):
        stack = self.tracer._stack()
        self.parent = stack[-1] if stack else None
        if self.key is None and self.parent is not None:
            self.key = self.parent.key
        self.thread = threading.get_ident()
        stack.append(self)
        self.tracer._spans.append(self)     # atomic: no lock between threads
        self.cpu0 = time.thread_time()
        self.start = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = time.perf_counter()
        self.cpu_s = time.thread_time() - self.cpu0
        self.tracer._stack().pop()
        return False


class Tracer:
    """Spans kept in memory, in the order they were entered."""

    def __init__(self):
        self.enabled = False
        self._spans: list = []
        self._local = threading.local()

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        self._spans = []

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, key=None, note: str | None = None):
        """A context manager around one section; ``key`` defaults to the
        enclosing span's.  Assign ``.note`` on what it returns to label the
        span once its outcome is known."""
        if not (self.enabled or _torch_profiler._is_profiler_enabled):
            return _OFF
        return _Span(self, name, key, note)

    def records(self) -> list:
        """The finished spans as (name, key, thread id, parent index, start,
        end, cpu_s, note), in the order they were entered; ``parent`` is the
        index of the enclosing span in this list, or None."""
        spans = [s for s in self._spans if s.end is not None]
        index = {id(s): i for i, s in enumerate(spans)}
        return [(s.name, s.key, s.thread,
                 None if s.parent is None else index.get(id(s.parent)),
                 s.start, s.end, s.cpu_s, s.note) for s in spans]

    def summary(self) -> dict:
        """name -> {count, total_s, mean_ms}, from the records."""
        tot, cnt = defaultdict(float), defaultdict(int)
        for name, _, _, _, t0, t1, _, _ in self.records():
            tot[name] += t1 - t0
            cnt[name] += 1
        return {k: {"count": cnt[k], "total_s": tot[k],
                    "mean_ms": 1e3 * tot[k] / cnt[k]} for k in tot}

    def print_summary(self):
        """Spans by total host-clock time (a parent's total holds its
        children's), then the network's encode + decode against the
        frames' total."""
        stats = self.summary()
        if not stats:
            print("[tracer] no spans recorded (tracer disabled?)")
            return
        print("=" * 64)
        print(f"{'span (host clock)':<28}{'count':>8}{'mean ms':>14}"
              f"{'total s':>14}")
        print("-" * 64)
        for k in sorted(stats, key=lambda k: -stats[k]["total_s"]):
            v = stats[k]
            print(f"{k:<28}{v['count']:>8}{v['mean_ms']:>14.3f}"
                  f"{v['total_s']:>14.3f}")
        net = sum(stats[k]["total_s"] for k in
                  ("inference.encode", "inference.decode") if k in stats)
        frames = stats.get("pipeline.frame", {"total_s": 0.0})["total_s"]
        print("-" * 64)
        print(f"network (inference.encode + inference.decode): {net:.3f}s | "
              f"frames (pipeline.frame): {frames:.3f}s")
        print("=" * 64)


TRACER = Tracer()
