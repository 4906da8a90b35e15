"""The SLAM system: frontend tracking, the backend and relocalization.

Mirrors ``mast3r_slam_tpu/pipeline.py``: the mode machine {INIT,
TRACKING, RELOC, TERMINATED}, keyframe decisions in the uncalibrated and
the calibrated mode, the backend round of every new keyframe (a
consecutive factor-graph edge, the retrieval's edges and the pointmap BA,
``_process_task``) and relocalization through the retrieval object
(``NullRetrieval`` or an ASMK ``RetrievalDatabase``).

The backend runs inline: after each keyframe, ``process_frame`` runs its
round before it returns, which is the JAX package's deterministic
``single_thread: True`` path.  JAX runs the same rounds on a thread when
``single_thread`` is False, and its results then depend on timing; the
threaded backend (with its task queue), state files and the backend on a
second card are later slices of the port.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .frame import (
    FilteringMode,
    Frame,
    KeyframeArena,
    Mode,
    arena_append,
    arena_get,
    arena_grow,
    arena_pop_last,
    arena_set,
    arena_update_poses,
    make_arena,
    update_pointmap,
)
from .global_opt import FactorGraph
from .inference import IMGNORM_MEAN, IMGNORM_STD, resize_img
from .ops import lie_sim3 as sim3
from .tracker import FrameTracker, TrackerConfig
from .utils.profiler import TimeProfiler


class NullRetrieval:
    """No loop-closure or relocalization proposals (pipeline.py:51); the
    ASMK ``retrieval.database.RetrievalDatabase`` has the same interface."""

    def update(self, frame, arena, add_after_query, k, min_thresh):
        return []


class SLAMSystem:
    """The SLAM engine around one inference engine and one keyframe arena
    (pipeline.py:59)."""

    def __init__(self, cfg: dict, engine, img_hw, K=None, retrieval=None,
                 buffer: int | None = None, device="cuda",
                 profiler: TimeProfiler | None = None):
        """``engine`` is an ``InferenceEngine`` or any object with its
        interface (the oracle harness of ``testing``).  ``K`` (3, 3) selects
        the calibrated mode, as in JAX; ``cfg["use_calib"]`` must agree.
        ``retrieval`` proposes loop-closure and relocalization candidates
        (``NullRetrieval`` when None).  ``profiler`` times the sections
        when it is enabled."""
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine runs on {engine.device}, the system "
                             f"on {self.device}")
        self.cfg = cfg
        self.img_hw = tuple(img_hw)
        h, w = self.img_hw
        self.img_size = int(cfg["dataset"].get("img_size", 512))
        self.engine = engine
        self.use_calib = K is not None
        if self.use_calib != bool(cfg.get("use_calib", False)):
            raise ValueError(
                f"use_calib={cfg.get('use_calib', False)} in the config but "
                f"K is {'given' if self.use_calib else 'missing'}")
        self.K = None if K is None else torch.as_tensor(
            np.asarray(K), dtype=torch.float32).to(self.device)
        self.tracker = FrameTracker(engine, TrackerConfig.from_config(cfg),
                                    self.K)
        self.profiler = profiler or TimeProfiler()
        self.diag = False   # per-frame pose in the info dict
        buffer = buffer or int(cfg.get("map", {}).get("buffer", 512))
        self.arena: KeyframeArena = make_arena(
            buffer, h, w, engine.n_patches, engine.feat_dim, self.device)
        # edge_query_subsample 2 matches edges on the (::2, ::2) grid only,
        # which BA reads exactly at points_subsample 4; at any other stride
        # BA would read never-matched pixels, so reset it (pipeline.py:107)
        eqs = int(cfg.get("matching", {}).get("edge_query_subsample", 1))
        if eqs > 1 and int(cfg["local_opt"].get("points_subsample", 1)) != 4:
            print("[warn] matching.edge_query_subsample=%d requires "
                  "local_opt.points_subsample=4 — resetting "
                  "edge_query_subsample to 1 (full-grid edge matches)" % eqs)
            cfg.setdefault("matching", {})["edge_query_subsample"] = 1
            if getattr(engine, "match_cfg", None) is not None and \
                    engine.match_cfg.edge_query_subsample != 1:
                engine.match_cfg = engine.match_cfg._replace(
                    edge_query_subsample=1)
        if cfg["local_opt"].get("sharded_ba"):
            raise NotImplementedError(
                "local_opt.sharded_ba (BA sharded over cards): multi-GPU "
                "slice")
        self.graph = FactorGraph(engine, h * w, cfg, K=self.K,
                                 store_device=self.device)
        self.retrieval = retrieval or NullRetrieval()
        self.mode = Mode.INIT
        # the tracker's frame -> keyframe match as one direction of the
        # consecutive factor-graph edge
        self._reuse_matches = bool(
            cfg["local_opt"].get("reuse_track_matches", True))
        self._edge_reuse = None
        self.filtering_mode = FilteringMode.from_str(
            cfg["tracking"]["filtering_mode"])
        self._median_score = \
            cfg["tracking"].get("filtering_score", "median") == "median"
        self.last_T_WC = sim3.identity(device=self.device)
        self.reloc_attempts = 0
        self.ba_iters_total = 0
        self.ba_ok_total = 0
        self.stats = {"tracked": 0, "skipped": 0, "keyframes": 0,
                      "reloc": 0, "ba_rounds": 0, "retrieval_edges": 0,
                      "retrieval_proposals": 0}

    def _arena_append(self, frame: Frame):
        """Append a keyframe, first growing the arena by a power of two when
        it is full (pipeline.py:245)."""
        if self.arena.n_size >= self.arena.buffer:
            self.arena = arena_grow(self.arena, 2 * self.arena.buffer)
        arena_append(self.arena, frame)

    def prepare_image(self, img: np.ndarray):
        """Resize + ImgNorm on the host (pipeline.py:303).  Returns
        (normalised (h, w, 3) f32, (h, w, 3) uint8)."""
        if img.shape[:2] == self.img_hw:
            if img.dtype == np.uint8:
                return img.astype(np.float32) * (1.0 / 127.5) - 1.0, img
            uimg = np.clip(img, 0.0, 1.0).astype(np.float32)
            return (uimg - IMGNORM_MEAN) / IMGNORM_STD, \
                np.uint8(np.round(uimg * 255.0))
        out = resize_img(img, self.img_size)
        return np.asarray(out["img"][0], np.float32), \
            np.asarray(out["unnormalized_img_u8"], np.uint8)

    def create_frame(self, i: int, img) -> Frame:
        """Image -> frame on the device with its encoder features
        (pipeline.py:325).  ``img`` is a raw image or a prepared
        (normed, uimg) pair."""
        dev = self.device
        with self.profiler.timer("create_frame"):
            normed, uimg = img if isinstance(img, tuple) else \
                self.prepare_image(img)
            device_img = torch.from_numpy(normed)[None].to(dev)
        with self.profiler.timer("vit_encode"):
            feat, pos = self.engine.encode(device_img)
        hw = self.img_hw[0] * self.img_hw[1]
        return Frame(
            frame_id=torch.tensor(i, dtype=torch.int32, device=dev),
            uimg=torch.from_numpy(np.ascontiguousarray(uimg)).to(dev),
            T_WC=self.last_T_WC,
            X_canon=torch.zeros((hw, 3), device=dev),
            C=torch.zeros((hw, 1), device=dev),
            feat=feat[0],
            pos=pos[0],
            N=torch.zeros((), dtype=torch.int32, device=dev),
            N_updates=torch.zeros((), dtype=torch.int32, device=dev),
            score=torch.zeros((), device=dev),
        )

    def _mono_frame(self, frame: Frame) -> Frame:
        with self.profiler.timer("decoder"):
            X, C = self.engine.inference_mono(frame.feat[None],
                                              frame.pos[None])
        return update_pointmap(frame, X[0], C[0], self.filtering_mode,
                               self._median_score)

    def process_frame(self, i: int, img: np.ndarray) -> dict:
        """One iteration of the mode machine (pipeline.py:355), with the
        backend rounds it queues.  Returns step info."""
        frame = self.create_frame(i, img)
        info = {"mode": self.mode.name, "new_kf": False}

        if self.mode == Mode.INIT:
            frame = self._mono_frame(frame)
            self._arena_append(frame)
            self.stats["keyframes"] += 1
            self._process_task(self.arena.n_size - 1)
            self.mode = Mode.TRACKING
            self.last_T_WC = frame.T_WC
            return info

        if self.mode == Mode.TRACKING:
            last = self.arena.n_size - 1
            kf = arena_get(self.arena, last)
            with self.profiler.timer("track"):
                new_kf, frame, kf, try_reloc, reuse = \
                    self.tracker.track(frame, kf)
            info.update(self.tracker.last_diag)
            if try_reloc:
                self.mode = Mode.RELOC
                self.stats["skipped"] += 1
                info["mode"] = "TRACKING->RELOC"
                return info
            arena_set(self.arena, last, kf)
            self.stats["tracked"] += 1
            self.last_T_WC = frame.T_WC
            if self.diag:
                info["T_WC"] = [round(float(x), 6)
                                for x in frame.T_WC.cpu().ravel()]
            h, w = self.img_hw
            if self.graph.retrieval_edge_mode == "desc_global" and \
                    reuse[5] is not None:
                # the last keyframe's q8 table, from the tracker's decode
                # of (frame, keyframe): covers the INIT keyframe, whose mono
                # decode exports none (pipeline.py:392)
                self.graph.store_desc(last, reuse[5], reuse[3], h, w)
            if new_kf:
                self._arena_append(frame)
                self.stats["keyframes"] += 1
                info["new_kf"] = True
                n = self.arena.n_size
                if self.graph.retrieval_edge_mode == "desc_global" and \
                        reuse[4] is not None:
                    self.graph.store_desc(n - 1, reuse[4], reuse[2], h, w)
                if self._reuse_matches and n >= 2:
                    idx_f2k, vm, Qff, Qkf, d8f, d8k = reuse
                    # the tracker's direction is the j -> i direction of
                    # the edge (i = n-2, j = n-1): Qff is the new
                    # keyframe's own confidence (Qjj), Qkf the old
                    # keyframe's cross confidence (Qij) (pipeline.py:413)
                    self._edge_reuse = {
                        "pair": (n - 2, n - 1),
                        "idx_j2i": idx_f2k, "valid_i": vm,
                        "Qjj": Qff, "Qij": Qkf,
                        "desc8_frame": d8f, "desc8_kf": d8k,
                    }
                self._process_task(n - 1)
            return info

        if self.mode == Mode.RELOC:
            frame = self._mono_frame(frame)
            self.stats["reloc"] += 1
            if self._relocalization(frame):
                self.mode = Mode.TRACKING
            return info

        raise RuntimeError(f"invalid mode {self.mode}")

    # ------------------------------------------------------------------
    # Backend (pipeline.py:459-603), run inline
    # ------------------------------------------------------------------

    def _process_task(self, idx: int):
        """One backend round for keyframe ``idx`` (pipeline.py:498): the
        consecutive edge (idx-1, idx) and the retrieval's edges, then the
        BA solve."""
        kf_idx = [idx - 1] if idx >= 1 else []
        frame = arena_get(self.arena, idx)
        kf_idx += self.retrieval.update(
            frame, self.arena, add_after_query=True,
            k=self.cfg["retrieval"]["k"],
            min_thresh=self.cfg["retrieval"]["min_thresh"])
        kf_idx = list(set(kf_idx) - {idx})
        # proposals before add_factors' min_match_frac gate
        self.stats["retrieval_proposals"] += len(set(kf_idx) - {idx - 1})
        ne0 = self.graph.n_edges
        if kf_idx:
            reuse = self._edge_reuse
            if reuse is not None and reuse["pair"] == (idx - 1, idx):
                self._edge_reuse = None
            else:
                reuse = None     # a stale bundle of another pair
            with self.profiler.timer("add_factors"):
                self.graph.add_factors(
                    self.arena, kf_idx, [idx] * len(kf_idx),
                    float(self.cfg["local_opt"]["min_match_frac"]),
                    reuse=reuse)
            g = self.graph
            # accepted non-consecutive edges
            self.stats["retrieval_edges"] += int(np.sum(
                g.ii[ne0:g.n_edges] != g.jj[ne0:g.n_edges] - 1))
        self._solve_graph()

    def _solve_graph(self):
        """Solve, then write only the optimised non-pinned keyframes' poses
        (pipeline.py:573)."""
        with self.profiler.timer("ba_calib" if self.use_calib else
                                 "ba_rays"):
            res = self.graph.solve_poses(
                self.arena, "calib" if self.use_calib else "ray")
            if res is None:
                return
            upd, Twc_new, stats = res
            arena_update_poses(self.arena, Twc_new, upd)
        self.stats["ba_rounds"] += 1
        self.ba_iters_total += int(stats[0])
        self.ba_ok_total += int(bool(stats[2]))

    def _relocalization(self, frame: Frame) -> bool:
        """(pipeline.py:612)  The retrieval's candidates, the frame appended
        as a keyframe and matched against them under the relocalization
        gate; on success the frame takes the first candidate's pose and the
        graph is solved, otherwise the keyframe is popped again."""
        self.reloc_attempts += 1
        retr = self.cfg["retrieval"]
        kf_idx = list(self.retrieval.update(
            frame, self.arena, add_after_query=False, k=retr["k"],
            min_thresh=retr["min_thresh"]))
        if not kf_idx:
            return False
        self._arena_append(frame)
        n_kf = self.arena.n_size
        success = self.graph.add_factors(
            self.arena, [n_kf - 1] * len(kf_idx), kf_idx,
            float(self.cfg["reloc"]["min_match_frac"]),
            is_reloc=bool(self.cfg["reloc"]["strict"]))
        if success:
            self.retrieval.update(frame, self.arena, add_after_query=True,
                                  k=retr["k"], min_thresh=retr["min_thresh"])
            self.arena.T_WC[n_kf - 1] = self.arena.T_WC[kf_idx[0]]
            self.last_T_WC = self.arena.T_WC[n_kf - 1].clone()
            self.stats["keyframes"] += 1
            self.tracker.reset_idx_f2k()
            self._solve_graph()
            return True
        arena_pop_last(self.arena)
        # the next keyframe reuses this slot: a stored table would be stale
        self.graph.desc_store.pop(self.arena.n_size, None)
        return False

    def drain(self):
        """(pipeline.py:815)  Nothing to wait for: every round ran inline
        in the ``process_frame`` that queued it."""

    def terminate(self):
        """End of the run (pipeline.py:830)."""
        self.drain()
        self.mode = Mode.TERMINATED
