"""The one traffic generator: a camera cut from a seeded texture strip, with
the keyframe schedule fixed by construction.

A traffic mix is a JSON file under ``traffic/`` with these keys:

* ``keyframe_every``: K; the camera holds one position for K frames, the
  first of them a keyframe, then jumps ``jump_px`` pixels along the strip,
  and the jump frame must become a keyframe.  0 holds for ever (no
  keyframe after the first frame).  A held view is repeated exactly: the
  network reads a shift of even one pixel as a new view, and sensor noise
  decays the matcher's warm start into keyframes at a cadence that moves
  with the seed (``tools/probe_keyframes.py``);
* ``jump_px``: the jump;
* ``texture``: the share of fine noise in the image (the rest is a
  coarse, smooth colour field) and the fine noise's grain in pixels;
* ``max_rate_fps``: the frame rate the strip is sized for; a camera that
  outruns it ends the run with an error;
* ``check``: what the correctness check samples (``frames``: the range of
  frame indices, ``tracked``: tracked frames, ``first``: frame 1 always
  among them, ``jumps``: jump frames among them, ``ba_rounds``: the range of backend rounds, 1-based, of which
  one is held to the reference);
* ``assumed``: where the mix departs from what a camera sends, in words.

Everything the camera shows is drawn from ``--seed``: the strip's texture.
The schedule, and so the work per frame, does not depend on it.
"""

from __future__ import annotations

import math

import numpy as np


def stream_rng(seed: int, *keys: int) -> np.random.Generator:
    """The generator of one purpose of a run's seed."""
    return np.random.default_rng([int(seed) % (1 << 64), *keys])


def _smooth_noise(rng, H: int, W: int, cell: int) -> np.ndarray:
    """(H, W, 3) uint8 noise drawn on a grid of ``cell`` pixels and
    interpolated bicubically between its points."""
    from PIL import Image

    h, w = H // cell + 2, W // cell + 2
    grid = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return np.asarray(Image.fromarray(grid).resize((w * cell, h * cell),
                                                   Image.BICUBIC))[:H, :W]


def texture(rng: np.random.Generator, H: int, W: int, share: float,
            grain_px: int) -> np.ndarray:
    """(H, W, 3) uint8: ``share`` of fine noise (grain ``grain_px``) on a
    coarse colour field (grain 48 pixels), both from ``rng``."""
    fine = _smooth_noise(rng, H, W, grain_px).astype(np.uint16)
    coarse = _smooth_noise(rng, H, W, 48).astype(np.uint16)
    a = int(round(256 * share))
    return ((fine * a + coarse * (256 - a)) >> 8).astype(np.uint8)


class Clip:
    """The camera's frames: frame ``t`` is the (h, w, 3) uint8 window of the
    strip at the position of its hold."""

    def __init__(self, traffic: dict, seed: int, img_hw, seconds: float):
        self.h, self.w = img_hw
        self.K = int(traffic["keyframe_every"])
        self.J = int(traffic.get("jump_px", 0))
        self.capacity = int(math.ceil(float(traffic["max_rate_fps"])
                                      * seconds)) + 64
        jumps = self.capacity // self.K + 1 if self.K else 0
        tex = traffic["texture"]
        self.strip = texture(stream_rng(seed, 0), self.h,
                             self.w + self.J * jumps, float(tex["share"]),
                             int(tex["grain_px"]))

    def is_keyframe(self, t: int) -> bool:
        """The schedule: the first frame, then every jump."""
        return t == 0 or (self.K > 0 and t % self.K == 0)

    def frame(self, t: int) -> np.ndarray:
        if t >= self.capacity:
            raise RuntimeError(
                f"the camera reached frame {t}, the end of its strip: the "
                f"traffic's max_rate_fps is too low for this program")
        x0 = (t // self.K) * self.J if self.K else 0
        return np.ascontiguousarray(self.strip[:, x0:x0 + self.w])
