"""Ray+distance geometry.

Mirrors the part of ``mast3r_slam_tpu/ops/geometry.py`` that the
uncalibrated path uses; the calibrated projection comes with the calibrated
solve in a later slice.
"""

from __future__ import annotations

import torch


def point_to_dist(X):
    """(geometry.py:26)"""
    return torch.linalg.norm(X, dim=-1, keepdim=True)


def point_to_ray_dist(X):
    """Points (..., 3) -> [unit ray (3), distance (1)] (geometry.py:30)."""
    d = point_to_dist(X)
    r = (1.0 / torch.clamp(d, min=1e-12)) * X
    return torch.cat([r, d], dim=-1)
