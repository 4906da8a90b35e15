"""Inference adapters around the MASt3R network.

Mirrors ``mast3r_slam_tpu/inference.py``: encode, the asymmetric two-view
decode with both heads, the mono (self-pair) decode, the asymmetric
decode + dense match of the tracker, and the host-side image resize.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .device import resolve_device
from .models.mast3r import MASt3R, cast_trunk_params_bf16
from .ops import matching


class InferenceEngine:
    """Holds the model on ``device`` and exposes the inference entry points
    (inference.py:30).  ``img_hw`` is fixed per run."""

    def __init__(self, model: MASt3R, img_hw: Tuple[int, int],
                 match_cfg: matching.MatchingConfig | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # The heads compute in f32 (the reference's autocast policy);
            # PyTorch would run their cuDNN convolutions in TF32 by default,
            # which keeps ~3 decimal digits.  Keep both matmul and conv f32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if model.cfg.dtype == torch.bfloat16:
            cast_trunk_params_bf16(model)
        self.model = model.to(self.device).eval()
        self.img_hw = tuple(img_hw)
        self.match_cfg = match_cfg or matching.MatchingConfig()
        p = model.cfg.patch_size
        self.n_patches = (img_hw[0] // p) * (img_hw[1] // p)
        self.feat_dim = model.cfg.enc_embed_dim

    @torch.no_grad()
    def encode(self, img):
        """img (B, h, w, 3) -> (feat (B, N, C) f32, pos (B, N, 2))
        (inference.py:161)."""
        return self.model.encode(img.to(self.device))

    @torch.no_grad()
    def decode_pair(self, feat1, pos1, feat2, pos2):
        """One asymmetric two-view decode (inference.py:165).  Returns
        ((X, C, D, Q) for view 1, for view 2), each (B, h, w, ...)."""
        res = self.model.decode_and_head(feat1, pos1, feat2, pos2,
                                         self.img_hw)
        return tuple((r["pts3d"], r["conf"], r["desc"], r["desc_conf"])
                     for r in res)

    def inference_mono(self, feat, pos):
        """Self-pair decode (inference.py:170).  Returns Xii (1, hw, 3),
        Cii (1, hw, 1)."""
        (X, C, _, _), _ = self.decode_pair(feat, pos, feat, pos)
        b = X.shape[0]
        return X.reshape(b, -1, 3), C.reshape(b, -1, 1)

    @torch.no_grad()
    def match_asymmetric(self, frame_feat, frame_pos, kf_feat, kf_pos,
                         idx_i2j_init=None):
        """Asymmetric decode + dense match (inference.py:177-215).  Returns
        (idx_f2k (1, hw), valid_match (1, hw, 1), Xff, Cff, Qff, Xkf, Ckf,
        Qkf) with pointmaps flattened to (1, hw, ...)."""
        (Xii, Cii, Dii, Qii), (Xji, Cji, Dji, Qji) = self.decode_pair(
            frame_feat, frame_pos, kf_feat, kf_pos)
        idx_i2j, valid_match_j = matching.match(
            Xii, Xji, Dii, Dji, idx_1_to_2_init=idx_i2j_init,
            cfg=self.match_cfg)
        b = Xii.shape[0]

        def flat(A):
            return A.reshape(b, -1, A.shape[-1] if A.dim() == 4 else 1)

        return (idx_i2j, valid_match_j, flat(Xii), flat(Cii), flat(Qii),
                flat(Xji), flat(Cji), flat(Qji))


# ---------------------------------------------------------------------------
# Image resize to network input shape (host side, numpy)
# ---------------------------------------------------------------------------

IMGNORM_MEAN = np.array([0.5, 0.5, 0.5], dtype=np.float32)
IMGNORM_STD = np.array([0.5, 0.5, 0.5], dtype=np.float32)


def resize_img(img: np.ndarray, size: int = 512):
    """Resize the long side to ``size`` and centre-crop H, W to multiples of
    16 (inference.py:392; 224 square mode included).  img: (H, W, 3) uint8
    or float in [0, 1].  Returns dict(img (1, h, w, 3) normalised,
    true_shape (1, 2), unnormalized_img, unnormalized_img_u8)."""
    from PIL import Image

    if size not in (224, 512):
        raise ValueError(f"resize_img: size must be 224 or 512, got {size}")
    if img.dtype == np.uint8:
        pil = Image.fromarray(img)
    else:
        pil = Image.fromarray(np.uint8(np.clip(img, 0, 1) * 255))
    W1, H1 = pil.size

    def _resize_long(p, long_edge):
        S = max(p.size)
        interp = Image.LANCZOS if S > long_edge else Image.BICUBIC
        new_size = tuple(int(round(x * long_edge / S)) for x in p.size)
        return p.resize(new_size, interp)

    if size == 224:
        pil = _resize_long(pil, round(size * max(W1 / H1, H1 / W1)))
        W, H = pil.size
        cx, cy = W // 2, H // 2
        half = min(cx, cy)
        pil = pil.crop((cx - half, cy - half, cx + half, cy + half))
    else:
        pil = _resize_long(pil, size)
        W, H = pil.size
        cx, cy = W // 2, H // 2
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if W == H:
            halfh = int(3 * halfw / 4)
        pil = pil.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))

    arr8 = np.asarray(pil)
    return {
        "img": (arr8.astype(np.float32) * (1.0 / 127.5) - 1.0)[None],
        "true_shape": np.int32([pil.size[::-1]]),
        "unnormalized_img": arr8.astype(np.float32) * (1.0 / 255.0),
        "unnormalized_img_u8": arr8,
    }
