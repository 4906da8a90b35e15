"""Scharr-like image gradients (mirrors ``mast3r_slam_tpu/ops/image.py``)."""

from __future__ import annotations

import torch.nn.functional as F


def img_gradient(img):
    """img (b, h, w, c) -> (gx, gy), each (b, h, w, c), with reflect padding
    (image.py:26): kernels [-3 0 3; -10 0 10; -3 0 3] / 32, the edge pixel
    not repeated."""
    h, w = img.shape[-3], img.shape[-2]
    p = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    p = p.permute(0, 2, 3, 1)

    def sh(dy, dx):
        return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :]

    gx = (1.0 / 32.0) * (
        3.0 * (sh(-1, 1) - sh(-1, -1))
        + 10.0 * (sh(0, 1) - sh(0, -1))
        + 3.0 * (sh(1, 1) - sh(1, -1))
    )
    gy = (1.0 / 32.0) * (
        3.0 * (sh(1, -1) - sh(-1, -1))
        + 10.0 * (sh(1, 0) - sh(-1, 0))
        + 3.0 * (sh(1, 1) - sh(-1, 1))
    )
    return gx, gy
