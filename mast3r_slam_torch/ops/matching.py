"""Dense iterative projective matching, reference-exact path.

Mirrors the ``coarse_subsample = 1`` branch of
``mast3r_slam_tpu/ops/matching.py::match`` (matching.py:601-800):

* ``iter_proj``: per-pixel Levenberg-Marquardt on a bilinearly sampled
  unit-ray field with the f16 ray table and the evaluate/propose/accept
  schedule;
* the 3D-distance occlusion gate at the LM positions;
* ``refine_matches``: dilated window argmax of int8 descriptor dot products
  at dilations ``dilation_max``..1, u-major probe order, first maximum wins.

The JAX version packs probe tables with rolls because TPU gathers are
row-count bound; here each probe is a plain gather, which reads the same
values for every probe inside the image.  The production approximations
(half-res coarse stages, thinned ladders, ...) come in a later slice:
``MatchingConfig.from_dict`` refuses them by name.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .image import img_gradient

# Knobs of the JAX MatchingConfig that the port runs only at these values.
_PORTED_ONLY = {
    "coarse_subsample": 1,
    "lm_subsample": 0,
    "lm_table_subsample": 1,
    "final_radius": 0,
    "coarse_radius": 0,
    "dilation_schedule": (),
    "coarse_bits": 8,
    "occlusion_subsample": 1,
    "edge_query_subsample": 1,
    "desc_bits": 8,
}


class MatchingConfig(NamedTuple):
    """The reference-exact matcher's parameters (matching.py:33).  The
    descriptor tables are always int8 (``desc_bits`` 8)."""
    max_iter: int = 10
    lambda_init: float = 1e-8
    convergence_thresh: float = 1e-6
    dist_thresh: float = 1e-1
    radius: int = 3
    dilation_max: int = 5
    desc_prenorm: bool = True

    @classmethod
    def from_dict(cls, d: dict) -> "MatchingConfig":
        """From a config's ``matching`` block (matching.py:141).  Raises
        ``NotImplementedError`` naming any knob set to a value this slice
        does not run."""
        for knob, ported in _PORTED_ONLY.items():
            val = d.get(knob, ported)
            if isinstance(ported, tuple):
                val = tuple(val)
            if val != ported:
                raise NotImplementedError(
                    f"matching.{knob}={val!r} is not ported yet (the port "
                    f"runs {ported!r})")
        return cls(
            max_iter=int(d["max_iter"]),
            lambda_init=float(d["lambda_init"]),
            convergence_thresh=float(d["convergence_thresh"]),
            dist_thresh=float(d["dist_thresh"]),
            radius=int(d["radius"]),
            dilation_max=int(d["dilation_max"]),
            desc_prenorm=bool(d.get("desc_prenorm", True)),
        )


def pixel_to_lin(p, w):
    """(..., 2) int pixels -> linear index u + w*v (matching.py:169)."""
    return p[..., 0] + w * p[..., 1]


def lin_to_pixel(idx, w):
    """Linear index -> (..., 2) (u, v) (matching.py:174)."""
    return torch.stack([idx % w, idx // w], dim=-1)


def _normalize(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def prep_for_iter_proj(X11, X21, idx_1_to_2_init):
    """The 9-channel ray+gradient image, normalised target points and the
    initial pixel guesses (matching.py:186).  X11, X21: (b, h, w, 3);
    idx init (b, h*w) or None (identity)."""
    b, h, w, _ = X11.shape
    rays = _normalize(X11)
    gx, gy = img_gradient(rays)
    rays_with_grad = torch.cat([rays, gx, gy], dim=-1)
    pts3d_norm = _normalize(X21.reshape(b, h * w, 3))
    if idx_1_to_2_init is None:
        idx_1_to_2_init = torch.arange(h * w, device=X11.device)[None] \
            .expand(b, h * w)
    p_init = lin_to_pixel(idx_1_to_2_init, w).to(X11.dtype)
    return rays_with_grad, pts3d_norm, p_init


def _bilinear(table, w, u, v):
    """Bilinear sample of table (b, hw, c) at float (u, v) (b, n), in f32
    (matching.py:229).  The caller keeps u in [1, w-2] and v in [1, h-2],
    so all four corners are inside the image."""
    b = u.shape[0]
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    base = (v0 * w + u0).to(torch.int64)
    bi = torch.arange(b, device=u.device)[:, None]
    g00 = table[bi, base].float()
    g01 = table[bi, base + 1].float()
    g10 = table[bi, base + w].float()
    g11 = table[bi, base + w + 1].float()
    w22 = (1 - du) * (1 - dv)
    w21 = du * (1 - dv)
    w12 = (1 - du) * dv
    w11 = du * dv
    return w22 * g00 + w21 * g01 + w12 * g10 + w11 * g11


def _ray_cost(table, w, u, v, pts3d_norm):
    """Sample and normalise the ray at (u, v): (cost (b, n), err, gx, gy
    (b, n, 3)) (matching.py:259)."""
    s = _bilinear(table, w, u, v)
    ray = s[..., 0:3]
    norm = torch.sqrt(torch.clamp(_sum3(ray * ray), min=1e-24))[..., None]
    err = ray / norm - pts3d_norm
    return _sum3(err * err), err, s[..., 3:6], s[..., 6:9]


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter=10,
              lambda_init=1e-8, cost_thresh=1e-6, table_f16=True):
    """Per-pixel LM projection solve (matching.py:272).

    rays_with_grad_img (b, h, w, 9); pts3d_norm (b, n, 3); p_init (b, n, 2)
    float.  Returns (p (b, n, 2) float, converged (b, n) bool).  The ray
    table is stored as f16 (``table_f16``); all arithmetic is f32.  The
    sampled state at the current iterate is carried, so each iteration
    samples only the trial point, with the reference's iterate sequence.
    """
    b, h, w, _ = rays_with_grad_img.shape
    table = rays_with_grad_img.reshape(b, h * w, 9)
    if table_f16:
        table = table.to(torch.float16)
    u = torch.clamp(p_init[..., 0], 1.0, w - 2.0)
    v = torch.clamp(p_init[..., 1], 1.0, h - 2.0)
    lam = torch.full_like(u, lambda_init)
    cost, err, gx, gy = _ray_cost(table, w, u, v, pts3d_norm)
    for _ in range(max_iter):
        A00 = _sum3(gx * gx) + lam
        A01 = _sum3(gx * gy)
        A11 = _sum3(gy * gy) + lam
        b0 = -_sum3(err * gx)
        b1 = -_sum3(err * gy)
        det = A00 * A11 - A01 * A01
        det_inv = 1.0 / torch.where(torch.abs(det) < 1e-24,
                                    torch.full_like(det, 1e-24), det)
        du_ = det_inv * (A11 * b0 - A01 * b1)
        dv_ = det_inv * (-A01 * b0 + A00 * b1)
        u_new = torch.clamp(u + du_, 1.0, w - 2.0)
        v_new = torch.clamp(v + dv_, 1.0, h - 2.0)
        new_cost, new_err, new_gx, new_gy = _ray_cost(
            table, w, u_new, v_new, pts3d_norm)
        accept = new_cost < cost
        acc_c = accept[..., None]
        u = torch.where(accept, u_new, u)
        v = torch.where(accept, v_new, v)
        cost = torch.where(accept, new_cost, cost)
        err = torch.where(acc_c, new_err, err)
        gx = torch.where(acc_c, new_gx, gx)
        gy = torch.where(acc_c, new_gy, gy)
        lam = torch.where(accept, lam * 0.1, lam * 10.0)
    return torch.stack([u, v], dim=-1), cost < cost_thresh


def refine_matches(D11, D21, p1, radius=3, dilation_max=5):
    """Coarse-to-fine dilated window argmax of descriptor dot products
    (matching.py:350), as a plain gather-and-score.

    D11 (b, h, w, f) descriptor image (int8 or float); D21 (b, n, f) query
    descriptors; p1 (b, n, 2) int pixel guesses.  Probe k = i*(2r+1) + j
    sits at offset (u, v) = (-rd + i*d, -rd + j*d) (u-major); probes
    outside the image never win; the first maximum wins; a query whose best
    score is <= 0 keeps its position.  Returns (b, n, 2) int64.
    """
    b, h, w, f = D11.shape
    n = p1.shape[1]
    flat = D11.reshape(b, h * w, f)
    integer = not D11.dtype.is_floating_point
    acc_t = torch.int32 if integer else torch.float32
    neg_inf = -(2 ** 30) if integer else float("-inf")
    q = D21.to(acc_t)[:, :, None, :]
    k_side = 2 * radius + 1
    K = k_side * k_side
    dev = D11.device
    bi = torch.arange(b, device=dev)[:, None, None]
    ko = torch.arange(K, device=dev)
    uv = p1.to(torch.int64)
    for d in range(dilation_max, 0, -1):
        rd = radius * d
        u0, v0 = uv[..., 0], uv[..., 1]
        uu = u0[..., None] + ((ko // k_side) * d - rd)     # (b, n, K)
        vv = v0[..., None] + ((ko % k_side) * d - rd)
        inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        lin = vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)
        score = torch.empty((b, n, K), dtype=acc_t, device=dev)
        for i in range(k_side):  # one probe column at a time bounds memory
            cols = slice(i * k_side, (i + 1) * k_side)
            cand = flat[bi, lin[..., cols]].to(acc_t)       # (b, n, k, f)
            score[..., cols] = (cand * q).sum(dim=-1)
        score = torch.where(inside, score, torch.full_like(score, neg_inf))
        sbest = score.max(dim=-1).values
        kbest = torch.where(score == sbest[..., None], ko, K).min(dim=-1).values
        keep = sbest <= 0
        ub = torch.where(keep, u0, u0 + (kbest // k_side) * d - rd)
        vb = torch.where(keep, v0, v0 + (kbest % k_side) * d - rd)
        uv = torch.stack([ub, vb], dim=-1)
    return uv


def _q8_pair(D11, D21_flat, prenorm=True):
    """Symmetric int8 descriptor tables (matching.py:580).  With per-pixel
    L2-normalised descriptors the fixed scale 127 is exact; the window
    argmax is invariant to the scale, so nothing is dequantised."""

    def q8(D):
        s = 127.0 if prenorm else \
            127.0 / torch.clamp(torch.max(torch.abs(D)), min=1e-12)
        return torch.clamp(torch.round(D * s), -127, 127).to(torch.int8)

    return q8(D11), q8(D21_flat)


def match(X11, X21, D11, D21, idx_1_to_2_init=None,
          cfg: MatchingConfig = MatchingConfig()):
    """Dense matching, reference-exact (matching.py:601, the
    ``coarse_subsample == 1`` branch).  X11, X21 (b, h, w, 3); D11, D21
    (b, h, w, f) float or pre-quantised int8.  Returns (idx_1_to_2
    (b, h*w) int64, valid (b, h*w, 1) bool)."""
    b, h, w = X21.shape[:3]
    rays_img, pts3d_norm, p_init = prep_for_iter_proj(X11, X21,
                                                      idx_1_to_2_init)
    p1, valid_proj2 = iter_proj(
        rays_img, pts3d_norm, p_init, max_iter=cfg.max_iter,
        lambda_init=cfg.lambda_init, cost_thresh=cfg.convergence_thresh)
    p1 = p1.to(torch.int64)  # truncation; LM positions are >= 1

    # occlusion gate on 3D distance (matching.py:777-784)
    lim = torch.tensor([w - 1, h - 1], device=p1.device)
    idx = pixel_to_lin(torch.minimum(torch.clamp(p1, min=0), lim), w)
    X11_flat = X11.reshape(b, h * w, 3)
    X11_at = torch.gather(X11_flat, 1, idx[..., None].expand(b, h * w, 3))
    dists2 = torch.linalg.norm(X11_at - X21.reshape(b, h * w, 3), dim=-1)
    valid = valid_proj2 & (dists2 < cfg.dist_thresh)

    if cfg.radius > 0:
        D21_flat = D21.reshape(b, h * w, -1)
        if D11.dtype.is_floating_point:
            D11, D21_flat = _q8_pair(D11, D21_flat, cfg.desc_prenorm)
        p1 = refine_matches(D11, D21_flat, p1, radius=cfg.radius,
                            dilation_max=cfg.dilation_max)
    return pixel_to_lin(p1, w), valid[..., None]
