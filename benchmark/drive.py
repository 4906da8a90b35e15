"""One camera served by the port: the system under test, driven as the live
loop drives it.

One ``pipeline.SLAMSystem`` (``config/base.yaml``'s values: threaded
backend, no retrieval, no viewer) is fed ``process_frame`` in a closed loop
on the caller's thread and current CUDA stream: the next frame as soon as
the last returns, as a live loop takes the newest camera frame.

The benchmark's own wrappers sit on bound methods of the program's
objects, set at run time (the package is never edited):

* always, the capture for the correctness check: on the sampled frames the
  tracker step's inputs (the keyframe and the frame's starting pose, the
  warm start) and outputs (the network's two views, the pose, the
  keyframe decision), and one backend round's inputs and outputs;
* with ``trace``, host-clock spans around ``tracker.track``,
  ``engine.encode`` and ``SLAMSystem._process_task``, and a count of kernel
  A's launches with their shapes.
"""

from __future__ import annotations

import copy
import threading
import time

from .clips import Clip


class Spans:
    """Host-clock spans (name, thread id, start, end) and kernel A's
    launches (start, (B, H, Nq, Nk, Dh)), kept in memory.  ``list.append``
    is atomic, so the backend thread shares the lists without a lock."""

    def __init__(self):
        self.items: list = []
        self.attn: list = []

    def wrap(self, name: str, fn):
        items = self.items

        def spanned(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                items.append((name, threading.get_ident(), t0,
                              time.perf_counter()))
        return spanned

    def count_attention(self, fn):
        attn = self.attn

        def counted(q, k, v):
            attn.append((time.perf_counter(), (q.shape[0], q.shape[1],
                                               q.shape[2], k.shape[2],
                                               q.shape[3])))
            return fn(q, k, v)
        return counted


class Capture:
    """What the camera hands the correctness check.  ``thread`` is the
    frontend's thread while a sampled step runs (the backend thread decodes
    on the same engine meanwhile), and ``views`` that step's decode."""

    def __init__(self, frames, ba_round):
        self.frames = set(frames)
        self.ba_round = ba_round
        self.tracked: dict = {}
        self.ba = None
        self.rounds = 0
        self.thread = None
        self.views = None

    def wrap_decode(self, decode):
        def captured_decode(*a):
            out = decode(*a)
            if self.thread == threading.get_ident():
                self.views = out
            return out
        return captured_decode


class Camera:
    """The camera: its clip, its system and its frame records (t, start,
    end, mode, new_kf, keyframe metric, match share, GN iterations)."""

    def __init__(self, clip: Clip, capture: Capture, make_system,
                 spans: Spans | None):
        """Set-up: a throw-away system driven over the warm frames, so that
        every shape the cell uses is built and cached, then the measured
        system with its wrappers."""
        self.clip = clip
        self.capture = capture
        self.records: list = []
        self.t = -1
        self.thread = threading.get_ident()
        warm = make_system()
        for t in warm_frames(clip):
            warm.process_frame(t, clip.frame(t))
        warm.terminate()
        del warm
        self.system = make_system()
        self.install(self.system, spans)

    def install(self, system, spans: Spans | None):
        """The capture wrappers, and with ``spans`` the span wrappers, on
        ``system`` (instance attributes shadow the bound methods)."""
        cap, tracker = self.capture, system.tracker
        track = tracker.track

        def captured_track(frame, keyframe):
            if self.t not in cap.frames:
                return track(frame, keyframe)
            pre = dict(kf=(keyframe.X_canon, keyframe.C, keyframe.N,
                           keyframe.T_WC), kf_id=keyframe.frame_id,
                       T0=frame.T_WC, idx=tracker.idx_f2k)
            cap.thread, cap.views = threading.get_ident(), None
            try:
                out = track(frame, keyframe)
            finally:
                cap.thread = None
            new_kf, fr, _, lost, _ = out
            cap.tracked[self.t] = dict(
                pre, views=cap.views, T=fr.T_WC, new_kf=bool(new_kf),
                lost=bool(lost),
                metric=float(tracker.last_diag["new_kf_metric"]))
            return out

        graph = system.graph
        solve = graph.solve_poses

        def captured_solve(arena, residual_type):
            with_edges = graph.n_edges > 0
            res = solve(arena, residual_type)
            if with_edges:
                cap.rounds += 1
                if cap.rounds == cap.ba_round and res is not None:
                    n, ne = arena.n_size, graph.n_edges
                    cap.ba = dict(
                        X=arena.X[:n].clone(), C=arena.C[:n].clone(),
                        N=arena.N[:n].clone(),
                        T_WC=arena.T_WC[:n].clone(), ii=graph.ii[:ne].copy(),
                        jj=graph.jj[:ne].copy(),
                        stores=[s[:ne].clone() for s in graph._stores()],
                        upd=res[0], T_new=res[1])
            return res

        tracker.track = captured_track
        graph.solve_poses = captured_solve
        if spans is not None:
            tracker.track = spans.wrap("tracker.track", tracker.track)
            system._process_task = spans.wrap("backend.round",
                                              system._process_task)

    def run(self, end: float):
        """The closed loop until the host clock passes ``end``; the frame
        under way then finishes."""
        system, clip, rec = self.system, self.clip, self.records
        t = 0
        while time.perf_counter() < end:
            img = clip.frame(t)
            self.t = t
            t0 = time.perf_counter()
            info = system.process_frame(t, img)
            rec.append((t, t0, time.perf_counter(), info["mode"],
                        bool(info["new_kf"]), info.get("new_kf_metric"),
                        info.get("match_frac"), info.get("gn_iters")))
            t += 1


def warm_frames(clip: Clip) -> list[int]:
    """The frames a warm-up drives: the first, a tracked one and, where the
    traffic jumps, up to and past the first jump (a keyframe and a backend
    round with an edge)."""
    return list(range(clip.K + 2)) if clip.K else [0, 1, 2]


def make_system_factory(slam_cfg: dict, engine, img_hw):
    from mast3r_slam_torch.pipeline import SLAMSystem

    def make():
        return SLAMSystem(copy.deepcopy(slam_cfg), engine, tuple(img_hw),
                          device=engine.device)
    return make
