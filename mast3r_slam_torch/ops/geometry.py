"""Projective geometry with analytic Jacobians.

Mirrors ``mast3r_slam_tpu/ops/geometry.py``: the ray+distance map, the
calibrated pinhole projection with log-depth, backprojection, ray-constrained
pointmaps and pixel grids.
"""

from __future__ import annotations

import torch


def skew_sym(x):
    """(..., 3) -> (..., 3, 3) (geometry.py:14)."""
    xx, yy, zz = x.unbind(-1)
    o = torch.zeros_like(xx)
    return torch.stack([o, -zz, yy, zz, o, -xx, -yy, xx, o], dim=-1).reshape(
        x.shape[:-1] + (3, 3))


def point_to_dist(X):
    """(geometry.py:23)"""
    return torch.linalg.norm(X, dim=-1, keepdim=True)


def point_to_ray_dist(X, jacobian: bool = False):
    """Points (..., 3) -> [unit ray (3), distance (1)], with
    ``jacobian`` also d(ray, dist)/dX (..., 4, 3) (geometry.py:27)."""
    d = point_to_dist(X)
    d_inv = 1.0 / torch.clamp(d, min=1e-12)
    r = d_inv * X
    rd = torch.cat([r, d], dim=-1)
    if not jacobian:
        return rd
    eye = torch.eye(3, dtype=X.dtype, device=X.device).expand(
        X.shape[:-1] + (3, 3))
    outer = X[..., :, None] * X[..., None, :]
    dr_dX = d_inv[..., None] * (eye - (d_inv * d_inv)[..., None] * outer)
    return rd, torch.cat([dr_dX, r[..., None, :]], dim=-2)


def decompose_K(K):
    """(fx, fy, cx, cy) (geometry.py:46)."""
    return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]


def project_calib(P, K, img_size, jacobian: bool = False, border: int = 0,
                  z_eps: float = 0.0):
    """Pinhole projection to (u, v, log z) with its validity mask and,
    with ``jacobian``, d(u, v, log z)/dP (..., 3, 3) (geometry.py:50).  A
    negative ``border`` admits pixels outside the image."""
    h, w = img_size
    fx, fy, cx, cy = decompose_K(K)
    x, y, z = P.unbind(-1)

    valid_z = z > z_eps
    z_safe = torch.where(valid_z, z, torch.ones_like(z))
    z_inv = 1.0 / z_safe

    u = fx * x * z_inv + cx
    v = fy * y * z_inv + cy

    valid_u = (u > border) & (u < w - 1 - border)
    valid_v = (v > border) & (v < h - 1 - border)
    valid = (valid_u & valid_v & valid_z)[..., None]

    logz = torch.where(valid_z, torch.log(z_safe), torch.zeros_like(z))
    pz = torch.stack([u, v, logz], dim=-1)
    if not jacobian:
        return pz, valid

    zero = torch.zeros_like(z_inv)
    J = torch.stack([
        torch.stack([fx * z_inv, zero, -fx * x * z_inv * z_inv], dim=-1),
        torch.stack([zero, fy * z_inv, -fy * y * z_inv * z_inv], dim=-1),
        torch.stack([zero, zero, z_inv], dim=-1),
    ], dim=-2)
    return pz, J, valid


def backproject(p, z, K):
    """Pixels (..., 2) + depth (..., 1) -> points (..., 3)
    (geometry.py:89)."""
    fx, fy, cx, cy = decompose_K(K)
    x = (p[..., 0] - cx) / fx
    y = (p[..., 1] - cy) / fy
    return z * torch.stack([x, y, torch.ones_like(x)], dim=-1)


def get_pixel_coords(batch, img_size, dtype=torch.float32, device=None):
    """(b, h, w, 2) pixel grid in (u, v) order (geometry.py:99)."""
    h, w = img_size
    u = torch.arange(w, dtype=dtype, device=device)
    v = torch.arange(h, dtype=dtype, device=device)
    uu, vv = torch.meshgrid(u, v, indexing="xy")
    return torch.stack([uu, vv], dim=-1)[None].expand(batch, h, w, 2)


def constrain_points_to_ray(img_size, Xs, K):
    """Reproject pointmaps (b, h*w, 3) onto their pixel rays, keeping z
    (geometry.py:109)."""
    b = Xs.shape[0]
    uv = get_pixel_coords(b, img_size, dtype=Xs.dtype, device=Xs.device) \
        .reshape(b, -1, 2)
    return backproject(uv, Xs[..., 2:3], K)
