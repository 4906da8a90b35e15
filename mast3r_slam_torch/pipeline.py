"""The SLAM frontend: INIT and TRACKING.

Mirrors the frontend of ``mast3r_slam_tpu/pipeline.py`` (prepare_image,
create_frame and process_frame, pipeline.py:303-433) with the same
keyframe decisions.  The backend (factor graph, BA, retrieval) and
relocalization come in later slices: nothing is queued for a backend, and
``process_frame`` in RELOC raises.
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
    arena_set,
    make_arena,
    update_pointmap,
)
from .inference import IMGNORM_MEAN, IMGNORM_STD, resize_img
from .ops import lie_sim3 as sim3
from .tracker import FrameTracker, TrackerConfig


class SLAMSystem:
    """Frontend around one inference engine and one keyframe arena
    (pipeline.py:59)."""

    def __init__(self, cfg: dict, engine, img_hw, buffer: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if engine.device != self.device:
            raise ValueError(f"engine runs on {engine.device}, the system "
                             f"on {self.device}")
        self.cfg = cfg
        self.img_hw = tuple(img_hw)
        h, w = self.img_hw
        self.img_size = int(cfg["dataset"].get("img_size", 512))
        self.engine = engine
        self.tracker = FrameTracker(engine, TrackerConfig.from_config(cfg))
        buffer = buffer or int(cfg.get("map", {}).get("buffer", 512))
        self.arena: KeyframeArena = make_arena(
            buffer, h, w, engine.n_patches, engine.feat_dim, self.device)
        self.mode = Mode.INIT
        self.filtering_mode = FilteringMode.from_str(
            cfg["tracking"]["filtering_mode"])
        self._median_score = \
            cfg["tracking"].get("filtering_score", "median") == "median"
        self.last_T_WC = sim3.identity(device=self.device)
        self.stats = {"tracked": 0, "skipped": 0, "keyframes": 0}

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
        normed, uimg = img if isinstance(img, tuple) else \
            self.prepare_image(img)
        dev = self.device
        feat, pos = self.engine.encode(torch.from_numpy(normed)[None].to(dev))
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

    def process_frame(self, i: int, img: np.ndarray) -> dict:
        """One frontend iteration (pipeline.py:355).  Returns step info."""
        if self.mode == Mode.RELOC:
            raise NotImplementedError("relocalization: later slice")
        frame = self.create_frame(i, img)
        info = {"mode": self.mode.name, "new_kf": False}

        if self.mode == Mode.INIT:
            X, C = self.engine.inference_mono(frame.feat[None],
                                              frame.pos[None])
            frame = update_pointmap(frame, X[0], C[0], self.filtering_mode,
                                    self._median_score)
            arena_append(self.arena, frame)
            self.stats["keyframes"] += 1
            self.mode = Mode.TRACKING
            self.last_T_WC = frame.T_WC
            return info

        if self.mode == Mode.TRACKING:
            last = self.arena.n_size - 1
            kf = arena_get(self.arena, last)
            new_kf, frame, kf, try_reloc = self.tracker.track(frame, kf)
            info.update(self.tracker.last_diag)
            if try_reloc:
                self.mode = Mode.RELOC
                self.stats["skipped"] += 1
                info["mode"] = "TRACKING->RELOC"
                return info
            arena_set(self.arena, last, kf)
            self.stats["tracked"] += 1
            self.last_T_WC = frame.T_WC
            if new_kf:
                arena_append(self.arena, frame)
                self.stats["keyframes"] += 1
                info["new_kf"] = True
            return info

        raise RuntimeError(f"invalid mode {self.mode}")
