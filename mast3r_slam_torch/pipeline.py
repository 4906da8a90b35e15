"""The SLAM system: frontend tracking, the backend and relocalization.

Mirrors ``mast3r_slam_tpu/pipeline.py``: the mode machine {INIT,
TRACKING, RELOC, TERMINATED}, keyframe decisions in the uncalibrated and
the calibrated mode, the backend round of every new keyframe (a
consecutive factor-graph edge, the retrieval's edges and the pointmap BA,
``_process_task``), relocalization through the retrieval object
(``NullRetrieval`` or an ASMK ``RetrievalDatabase``) and SLAM-state save /
load (``save_state`` / ``load_state``, JAX's file format).

``single_thread: True`` runs each round inline in the ``process_frame``
that queued it, the deterministic path of the eval configs.  With
``single_thread: False`` (``config/base.yaml``) a backend thread takes
keyframe indices from a queue, as in JAX; a lost frame posts a reloc
sentinel that the thread coalesces, and ``drain`` / ``terminate`` wait for
the queue and re-raise the thread's first error.  The two threads share
the arena under ``_lock``: the frontend writes it in place, and a round
reads an ``arena_snapshot`` taken under the lock.  Both threads launch on
the stream that was current when the system was built, so the card runs
their work in the order it was queued.

Multi-device (pipeline.py:65-170): ``backend_device`` puts the backend's
device work (the edge store, its decodes and matches, the BA) on a device
of its own, with a mirror of the arena there that takes, each round, only
the rows written since the last one; only the optimised poses come back.
``local_opt.sharded_ba`` ("edge" or "map") shards the BA over every
device instead.  Devices are counted by ``device.local_devices``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import types

import numpy as np
import torch

from . import device as _device
from .device import resolve_device
from .frame import (
    FilteringMode,
    Frame,
    KeyframeArena,
    Mode,
    arena_append,
    arena_copy,
    arena_copy_rows,
    arena_get,
    arena_grow,
    arena_pop_last,
    arena_set,
    arena_snapshot,
    arena_update_poses,
    make_arena,
    update_pointmap,
)
from .global_opt import FactorGraph
from .parallel.mesh import make_mesh
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
                 profiler: TimeProfiler | None = None,
                 backend_device: int | None = None):
        """``engine`` is an ``InferenceEngine`` or any object with its
        interface (the oracle harness of ``testing``).  ``K`` (3, 3) selects
        the calibrated mode, as in JAX; ``cfg["use_calib"]`` must agree.
        ``retrieval`` proposes loop-closure and relocalization candidates
        (``NullRetrieval`` when None).  ``profiler`` times the sections
        when it is enabled.

        ``backend_device`` (or the cfg key ``backend_device``): the index,
        among ``local_devices`` of this system's device kind, of the device
        that runs the backend (pipeline.py:65-78): the edge store, the
        decodes of ``add_factors`` (through the engine's ``replica`` there)
        and the BA, on a mirror of the arena kept there row by row.  0 (the
        frontend's device) is valid and builds the mirror beside the live
        arena; an index past the devices prints one line and runs on one
        device.  It takes precedence over ``local_opt.sharded_ba``."""
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine runs on {engine.device}, the system "
                             f"on {self.device}")
        ds = getattr(engine, "downsample", 1)
        if ds != 1:
            # JAX's pipeline.py:81-82 sizes the arena from img_hw as well
            # and fails at the first frame's fusion (ROADMAP.md C)
            raise ValueError(
                f"dataset.img_downsample={ds}: the engine's pointmaps are "
                f"{engine.out_hw}, but the system's frames and keyframe "
                f"arena are {tuple(img_hw)}; the SLAM system runs only "
                f"img_downsample 1, as the reference pipeline does")
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
            buffer, h, w, engine.n_patches, engine.feat_dim, self.device,
            K=self.K)
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
        if backend_device is None:
            backend_device = cfg.get("backend_device", None)
        # local_opt.sharded_ba: null | edge | map, the BA sharded over every
        # device (pipeline.py:121-168)
        shard_mode = cfg["local_opt"].get("sharded_ba") or None
        devs = _device.local_devices(self.device.type)
        self._bdev = None
        if backend_device is not None:
            if int(backend_device) < len(devs):
                self._bdev = devs[int(backend_device)]
            else:
                print(f"backend_device={backend_device} unavailable "
                      f"({len(devs)} devices); running single-device")
        if self._bdev is not None:
            if shard_mode:
                print("backend_device takes precedence over "
                      "local_opt.sharded_ba (mutually exclusive)")
            replica = getattr(engine, "replica", None)
            self._bengine = replica(self._bdev) if replica else engine
            self.graph = FactorGraph(engine, h * w, cfg, K=self.K,
                                     device=self._bdev,
                                     params=self._bengine)
            # the backend's mirror of the arena and the rows written since
            # the last round (appended, fused into, or popped)
            self._marena = arena_copy(self.arena, self._bdev)
            self._dirty: set = set()
            self.mirror_rows_copied = 0
        else:
            mesh = None
            if shard_mode:
                n_edge = 1 << (len(devs).bit_length() - 1)  # pow2 <= n
                if n_edge > 1:
                    mesh = make_mesh(n_edge=n_edge, devices=devs)
                else:
                    print("local_opt.sharded_ba requested but only one "
                          "device is available; running single-device")
            self.graph = FactorGraph(engine, h * w, cfg, K=self.K, mesh=mesh,
                                     shard_mode=shard_mode or "edge",
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

        # backend plumbing (pipeline.py:210): keyframe indices, -1 for a
        # relocalization request; _lock guards the arena, _edge_reuse and
        # _reloc_frame, which both threads touch
        self.single_thread = bool(cfg.get("single_thread", False))
        self.tasks: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._terminate = False
        self._backend_error: Exception | None = None
        self._reloc_frame: Frame | None = None
        self._backend_thread: threading.Thread | None = None
        if not self.single_thread:
            # the thread launches on this thread's current stream, so the
            # card runs both threads' work in the order it was queued, and
            # the caching allocator cannot hand a block one thread freed to
            # the other while queued kernels still read it; it runs
            # PyTorch's CPU ops on as many threads as this one.  A backend
            # on another card launches there on this thread's current
            # stream of that card, which also orders the copies this thread
            # makes to it (the reused match, the desc tables)
            cuda = self.device.type == "cuda"
            self._stream = torch.cuda.current_stream(self.device) \
                if cuda else None
            self._bstream = torch.cuda.current_stream(self._bdev) \
                if cuda and self._bdev is not None else self._stream
            self._num_threads = torch.get_num_threads()
            self._backend_thread = threading.Thread(
                target=self._backend_loop, name="slam-backend", daemon=True)
            self._backend_thread.start()

    # ------------------------------------------------------------------
    # Arena access (pipeline.py:236-268): the frontend writes under _lock,
    # a backend round reads a snapshot taken under it
    # ------------------------------------------------------------------

    def _snapshot(self) -> KeyframeArena:
        """The arena as a backend round reads it (pipeline.py:605): the
        backend device's mirror, synced, when there is one; else the live
        arena when rounds run inline, or an ``arena_snapshot`` taken under
        the lock, one consistent state of the frontend's writes."""
        if self._bdev is not None:
            return self._sync_mirror()
        if self.single_thread:
            return self.arena
        with self._lock:
            return arena_snapshot(self.arena)

    def _arena_append(self, frame: Frame):
        """Append a keyframe, first growing the arena by a power of two when
        it is full (pipeline.py:245)."""
        with self._lock:
            if self.arena.n_size >= self.arena.buffer:
                self.arena = arena_grow(self.arena, 2 * self.arena.buffer)
            arena_append(self.arena, frame)
            if self._bdev is not None:
                self._dirty.add(self.arena.n_size - 1)

    def _arena_set_last(self, kf: Frame):
        """Write the fused last keyframe back (pipeline.py:262)."""
        with self._lock:
            arena_set(self.arena, self.arena.n_size - 1, kf)
            if self._bdev is not None:
                self._dirty.add(self.arena.n_size - 1)

    def _sync_mirror(self) -> KeyframeArena:
        """Bring the backend device's mirror up to the live arena
        (pipeline.py:270-297): the rows written since the last sync, the
        pose table and the keyframe count; the whole arena again after an
        ``arena_grow``.  The copies are made under ``_lock``, so that no
        frontend write lands between them, and, on the backend thread, on
        the frontend's stream of its card (the thread's current stream
        there), so that a row is read after the frontend's queued writes to
        it.  Rows below the last change only in their pose once a newer
        keyframe exists, so a steady round copies one or two rows."""
        with self._lock:
            arena = self.arena
            if self._marena.buffer != arena.buffer:
                self._marena = arena_copy(arena, self._bdev)
                self.mirror_rows_copied += arena.n_size
            else:
                self.mirror_rows_copied += arena_copy_rows(
                    self._marena, arena, self._dirty)
            self._dirty.clear()
            self._marena.T_WC.copy_(arena.T_WC)
            self._marena.n_size = arena.n_size
        return self._marena

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
            self._queue_backend(self.arena.n_size - 1)
            self.mode = Mode.TRACKING
            self.last_T_WC = frame.T_WC
            return info

        if self.mode == Mode.TRACKING:
            with self._lock:
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
            self._arena_set_last(kf)
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
                    if self._bdev is not None:
                        # the match crosses to the backend device
                        # (pipeline.py:413-417)
                        reuse = tuple(None if t is None else
                                      t.to(self._bdev) for t in reuse)
                    idx_f2k, vm, Qff, Qkf, d8f, d8k = reuse
                    # the tracker's direction is the j -> i direction of
                    # the edge (i = n-2, j = n-1): Qff is the new
                    # keyframe's own confidence (Qjj), Qkf the old
                    # keyframe's cross confidence (Qij) (pipeline.py:413)
                    with self._lock:
                        self._edge_reuse = {
                            "pair": (n - 2, n - 1),
                            "idx_j2i": idx_f2k, "valid_i": vm,
                            "Qjj": Qff, "Qij": Qkf,
                            "desc8_frame": d8f, "desc8_kf": d8k,
                        }
                self._queue_backend(n - 1)
            return info

        if self.mode == Mode.RELOC:
            frame = self._mono_frame(frame)
            self.stats["reloc"] += 1
            if self.single_thread:
                if self._relocalization(frame):
                    self.mode = Mode.TRACKING
            else:
                # the newest lost frame and a sentinel; the backend flips
                # the mode back when one relocalizes (pipeline.py:447)
                with self._lock:
                    self._reloc_frame = frame
                self.tasks.put(-1)
            return info

        raise RuntimeError(f"invalid mode {self.mode}")

    # ------------------------------------------------------------------
    # Backend (pipeline.py:459-685)
    # ------------------------------------------------------------------

    def _queue_backend(self, idx: int):
        """(pipeline.py:459)  Inline, the round runs before this returns."""
        self.tasks.put(idx)
        if self.single_thread:
            while not self.tasks.empty():
                self._backend_once()

    def _backend_loop(self):
        """The backend thread (pipeline.py:465): rounds until
        ``terminate``.  After an exception it takes no more rounds, since
        the graph may be half written, but marks each queued task done so
        that ``drain`` returns and re-raises the error."""
        torch.set_num_threads(self._num_threads)
        with contextlib.ExitStack() as ctx:
            if self._stream is not None:
                # the frontend's stream current on its card, the backend's
                # on the backend card (the same one on one card), the
                # backend card current
                ctx.enter_context(torch.cuda.stream(self._stream))
                ctx.enter_context(torch.cuda.stream(self._bstream))
                ctx.enter_context(torch.cuda.device(
                    self.device if self._bdev is None else self._bdev))
            while not self._terminate:
                try:
                    idx = self.tasks.get(timeout=0.01)
                except queue.Empty:
                    continue
                if self._backend_error is not None:
                    self.tasks.task_done()
                    continue
                try:
                    self._process_task(idx)
                except Exception as e:  # re-raised by drain / terminate
                    self._backend_error = e
                finally:
                    self.tasks.task_done()

    def _backend_once(self):
        """Run one queued task inline, if there is one (pipeline.py:485)."""
        try:
            idx = self.tasks.get_nowait()
        except queue.Empty:
            return
        try:
            self._process_task(idx)
        finally:
            self.tasks.task_done()

    def _process_task(self, idx: int):
        """One backend round for keyframe ``idx`` (pipeline.py:498): the
        consecutive edge (idx-1, idx) and the retrieval's edges, then the
        BA solve, all on one snapshot of the arena.  ``idx`` -1 is a
        relocalization request: the frontend posts one per lost frame, so
        once one has relocalized the rest are dropped."""
        if idx == -1:
            if self.mode != Mode.RELOC:
                return
            with self._lock:
                frame = self._reloc_frame
            if self._relocalization(frame):
                self.mode = Mode.TRACKING
            return
        kf_idx = [idx - 1] if idx >= 1 else []
        snap = self._snapshot()
        frame = arena_get(snap, idx)
        kf_idx += self.retrieval.update(
            frame, snap, add_after_query=True,
            k=self.cfg["retrieval"]["k"],
            min_thresh=self.cfg["retrieval"]["min_thresh"])
        kf_idx = list(set(kf_idx) - {idx})
        # proposals before add_factors' min_match_frac gate
        self.stats["retrieval_proposals"] += len(set(kf_idx) - {idx - 1})
        ne0 = self.graph.n_edges
        if kf_idx:
            with self._lock:
                reuse = self._edge_reuse
                if reuse is not None and reuse["pair"] == (idx - 1, idx):
                    self._edge_reuse = None
                else:
                    reuse = None     # a stale bundle of another pair
            with self.profiler.timer("add_factors"):
                self.graph.add_factors(
                    snap, kf_idx, [idx] * len(kf_idx),
                    float(self.cfg["local_opt"]["min_match_frac"]),
                    reuse=reuse)
            g = self.graph
            # accepted non-consecutive edges
            self.stats["retrieval_edges"] += int(np.sum(
                g.ii[ne0:g.n_edges] != g.jj[ne0:g.n_edges] - 1))
        self._solve_graph(snap)

    def _solve_graph(self, snap: KeyframeArena):
        """Solve on the snapshot, then write only the optimised non-pinned
        keyframes' poses into the live arena (pipeline.py:573): a keyframe
        the frontend appended meanwhile keeps its pose."""
        with self.profiler.timer("ba_calib" if self.use_calib else
                                 "ba_rays"):
            res = self.graph.solve_poses(
                snap, "calib" if self.use_calib else "ray")
            if res is None:
                return
            upd, Twc_new, stats = res
            # only the optimised poses cross devices (8 floats a keyframe)
            Twc_new = Twc_new.to(self.device)
            with self._lock:
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
            frame, self._snapshot(), add_after_query=False, k=retr["k"],
            min_thresh=retr["min_thresh"]))
        if not kf_idx:
            return False
        self._arena_append(frame)
        snap = self._snapshot()
        n_kf = snap.n_size
        success = self.graph.add_factors(
            snap, [n_kf - 1] * len(kf_idx), kf_idx,
            float(self.cfg["reloc"]["min_match_frac"]),
            is_reloc=bool(self.cfg["reloc"]["strict"]))
        if success:
            self.retrieval.update(frame, snap, add_after_query=True,
                                  k=retr["k"], min_thresh=retr["min_thresh"])
            with self._lock:
                self.arena.T_WC[n_kf - 1] = self.arena.T_WC[kf_idx[0]]
                self.last_T_WC = self.arena.T_WC[n_kf - 1].clone()
            self.stats["keyframes"] += 1
            self.tracker.reset_idx_f2k()
            self._solve_graph(self._snapshot())
            return True
        with self._lock:
            arena_pop_last(self.arena)
            # the next keyframe reuses this slot: a stored table would be
            # stale, and so would the mirror's row
            self.graph.desc_store.pop(self.arena.n_size, None)
            if self._bdev is not None:
                self._dirty.discard(self.arena.n_size)
        return False

    # ------------------------------------------------------------------
    # SLAM-state checkpoint / resume (pipeline.py:687-813)
    # ------------------------------------------------------------------

    def save_state(self, path):
        """Write the SLAM state to an ``.npz`` in JAX's format
        (pipeline.py:687), after the queued rounds: every arena field as
        ``arena_<field>`` (``pos`` int32, ``n_size`` an int32 scalar), the
        mode and last pose, the edge store at its full ``max_edges`` rows,
        the stats by name and the GN / BA cadence counters.  The
        ``desc_global`` tables are not saved, as in JAX."""
        self.drain()
        g = self.graph
        with self._lock:
            arena = self.arena
            arrays = {}
            for f in dataclasses.fields(arena):
                v = getattr(arena, f.name)
                if f.name == "n_size":
                    arrays["arena_n_size"] = np.asarray(v, np.int32)
                elif f.name == "pos":
                    arrays["arena_pos"] = v.cpu().numpy().astype(np.int32)
                else:
                    arrays[f"arena_{f.name}"] = v.cpu().numpy()

        def host(t):
            return t.cpu().numpy()

        np.savez_compressed(
            path,
            mode=self.mode.value,
            last_T_WC=host(self.last_T_WC),
            graph_ii=g.ii, graph_jj=g.jj, graph_n_edges=g.n_edges,
            graph_idx_ii2jj=host(g.idx_ii2jj),
            graph_idx_jj2ii=host(g.idx_jj2ii),
            graph_vmj=host(g.valid_match_j),
            graph_vmi=host(g.valid_match_i),
            graph_Qj=host(g.Q_ii2jj),
            graph_Qi=host(g.Q_jj2ii),
            stats=np.asarray([self.stats[k] for k in sorted(self.stats)],
                             np.int64),
            stats_keys=np.asarray(sorted(self.stats)),
            cadence=np.asarray([self.ba_iters_total, self.ba_ok_total,
                                self.tracker.gn_iters_total,
                                self.tracker.gn_frames], np.int64),
            **arrays,
        )

    def load_state(self, path):
        """Restore a ``save_state`` file, the port's or JAX's
        (pipeline.py:726): a float ``uimg`` of older files is requantised,
        every pose re-normalised, TERMINATED resumes as TRACKING, the edge
        store takes the file's ``max_edges`` (the pregather cache is
        reallocated and dropped), stats missing ``stats_keys`` are read in
        the five-key legacy order, and an empty retrieval database is
        replayed from the restored keyframes' features."""
        d = np.load(path)
        dev = self.device
        kw = {}
        for f in dataclasses.fields(self.arena):
            key = f"arena_{f.name}"
            if key not in d:
                continue
            v = d[key]
            if f.name == "n_size":
                kw["n_size"] = int(v)
                continue
            if f.name == "uimg" and np.issubdtype(v.dtype, np.floating):
                v = np.uint8(np.round(np.clip(v, 0.0, 1.0) * 255.0))
            kw[f.name] = torch.from_numpy(np.ascontiguousarray(v)).to(
                dev, getattr(self.arena, f.name).dtype)
        arena = dataclasses.replace(self.arena, **kw)
        arena.T_WC = sim3.normalize(arena.T_WC)
        with self._lock:
            self.arena = arena
        if "cadence" in d:
            cad = d["cadence"]
            self.ba_iters_total = int(cad[0])
            self.ba_ok_total = int(cad[1])
            self.tracker.gn_iters_total = int(cad[2])
            self.tracker.gn_frames = int(cad[3])
        self.mode = Mode(int(d["mode"]))
        if self.mode == Mode.TERMINATED:
            self.mode = Mode.TRACKING
        self.last_T_WC = sim3.normalize(
            torch.from_numpy(d["last_T_WC"]).to(dev, torch.float32))
        g = self.graph
        g.ii = d["graph_ii"].astype(np.int32)
        g.jj = d["graph_jj"].astype(np.int32)
        g.n_edges = int(d["graph_n_edges"])
        g.max_edges = int(g.ii.shape[0])
        # the database is not in the file: replay the restored keyframes'
        # features into an empty one, so that proposals against them keep
        # firing (pipeline.py:772)
        if getattr(self.retrieval, "kf_counter", None) == 0:
            for r in range(arena.n_size):
                self.retrieval.update(types.SimpleNamespace(
                    feat=arena.feat[r]), add_after_query=True, k=0)
        (g.idx_ii2jj, g.idx_jj2ii, g.valid_match_j, g.valid_match_i,
         g.Q_ii2jj, g.Q_jj2ii) = (
            torch.from_numpy(d[k]).to(g.dev, old.dtype)
            for k, old in zip(("graph_idx_ii2jj", "graph_idx_jj2ii",
                               "graph_vmj", "graph_vmi", "graph_Qj",
                               "graph_Qi"), g._stores()))
        if g.cache_pre:
            if g._pre_fresh.shape[0] != g.max_edges:
                g._pre_fresh = np.zeros((g.max_edges,), bool)
            g.invalidate_cache()
        if self._bdev is not None:
            # the mirror is stale: every row again at the next round
            with self._lock:
                self._dirty = set(range(arena.n_size))
        keys = ([str(k) for k in d["stats_keys"]] if "stats_keys" in d
                else ["ba_rounds", "keyframes", "reloc", "skipped",
                      "tracked"])
        for k, v in zip(keys, d["stats"]):
            if k in self.stats:
                self.stats[k] = int(v)
        self.tracker.reset_idx_f2k()

    def drain(self):
        """Wait until every queued round is done, the one the backend
        thread has taken included (pipeline.py:815), then re-raise the
        thread's error, if it had one.  Raises if the thread has ended
        with tasks still queued, which would otherwise never be done."""
        if self.single_thread:
            while not self.tasks.empty():
                self._backend_once()
        else:
            done = self.tasks.all_tasks_done
            with done:
                while self.tasks.unfinished_tasks:
                    if not self._backend_thread.is_alive():
                        raise RuntimeError(
                            "the backend thread ended with "
                            f"{self.tasks.unfinished_tasks} tasks queued")
                    done.wait(0.5)
        err = self._backend_error
        if err is not None:
            self._backend_error = None
            raise err

    def terminate(self):
        """End of the run (pipeline.py:830): drain, then stop the backend
        thread, also when the drain raises."""
        try:
            self.drain()
        finally:
            self._terminate = True
            if self._backend_thread is not None:
                self._backend_thread.join(timeout=5)
        self.mode = Mode.TERMINATED
