"""Section-timing profiler.

Mirrors ``mast3r_slam_tpu/utils/profiler.py``: context timers that
synchronise the device around a section, and a summary that splits network
time from the rest, under the same section names (``create_frame``,
``vit_encode``, ``decoder``, ``track``).  Disabled by default: a synchronise
per section ends PyTorch's asynchronous enqueueing.  The JAX package keeps
one process-global instance; here the caller creates a ``TimeProfiler`` and
hands it to ``SLAMSystem``.

A profiled run is a diagnosis mode.  The backend thread times its sections
too: the sums are taken under a lock, and its ``torch.cuda.synchronize()``
waits for all of the card's queued work, the frontend's included, so a
section's time then holds whatever the other thread queued meanwhile.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch


class TimeProfiler:
    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.times = defaultdict(float)
        self.counts = defaultdict(int)
        self._lock = threading.Lock()

    def enable(self):
        self.enabled = True

    def disable(self):
        self.enabled = False

    def reset(self):
        with self._lock:
            self.times.clear()
            self.counts.clear()

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def timer(self, name: str):
        """Add the section's time to ``name``, the card synchronised before
        and after it.  From the backend thread the synchronise also waits
        for the frontend's queued work (and the frontend's for the
        backend's): a profiled run diagnoses, it is not timed as a run."""
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()   # the section owns its device time
            dt = time.perf_counter() - t0
            with self._lock:
                self.times[name] += dt
                self.counts[name] += 1

    def get_stats(self):
        with self._lock:
            return {
                k: {"total_s": self.times[k], "count": self.counts[k],
                    "mean_ms": 1e3 * self.times[k] / max(self.counts[k], 1)}
                for k in self.times
            }

    def print_summary(self):
        """Sections by total time, then network (encode + decode) against
        the total (profiler.py:76)."""
        if not self.times:
            print("[profiler] no sections recorded (profiler disabled?)")
            return
        stats = self.get_stats()
        total = sum(v["total_s"] for v in stats.values())
        print("=" * 64)
        print(f"{'section':<24}{'count':>8}{'mean ms':>12}{'total s':>10}"
              f"{'share':>8}")
        print("-" * 64)
        for k in sorted(stats, key=lambda k: -stats[k]["total_s"]):
            v = stats[k]
            print(f"{k:<24}{v['count']:>8}{v['mean_ms']:>12.2f}"
                  f"{v['total_s']:>10.3f}{v['total_s'] / total:>8.1%}")
        net = sum(stats.get(k, {"total_s": 0})["total_s"]
                  for k in ("vit_encode", "decoder"))
        print("-" * 64)
        print(f"network (encode+decode): {net:.3f}s | total: {total:.3f}s")
        print("=" * 64)
