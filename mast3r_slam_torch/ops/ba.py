"""Pointmap bundle adjustment: Gauss-Newton over the Sim(3) keyframe poses.

Mirrors ``mast3r_slam_tpu/ops/ba.py``: three residual kinds over the
factor-graph edges (point alignment, ray + distance, calibrated pixel +
log-depth), each accumulated into per-edge 14x14 systems with Huber and
confidence weights, a dense (7F x 7F) pose system, a Jacobi-scaled damped
f32 Cholesky solve and a Sim(3) retraction, with the first ``pin`` poses
held fixed.

The JAX package has no Pallas kernel here (its accumulation is XLA, its
solve ``jnp.linalg.cholesky``), so the port is plain PyTorch.  What it
does differently, and why:

* ``_accumulate_pre`` builds each pass's per-point Jacobian rows
  (E, R, 7, n) once from the same SoA row forms and forms H and g with
  one batched product over (edge, point chunk) pairs.  The JAX version writes the 28 unique H entries as
  separate sums, which eager PyTorch would run as thousands of small
  launches per iteration; here a GN iteration costs a fixed number of
  launches while the rows fit ``_PASS_ELEMENTS`` (one pass over all points
  at the production sizes).
* ``_assemble_dense`` assembles H and g with products against a 0/1
  incidence matrix, in a fixed order, where JAX scatter-adds: a scatter-add
  on the card uses float atomics, whose order is not fixed, and the system
  feeds a Cholesky.
* ``torch.linalg.cholesky_ex`` reports a non-positive-definite system in
  ``info`` where ``jnp.linalg.cholesky`` returns NaN; ``_solve_scaled``
  reads both, so ``ok`` is False and dx is 0 in the same cases.
* The GN loop's early exit reads one flag pair per iteration on the host
  (the JAX ``while_loop`` tests it on the device); the iteration count is
  the same.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import lie_sim3 as sim3
from .robust import huber

# elements of one pass's Jacobian rows (E x R x 7 x points): 128 MB of f32;
# larger edge sets take the points in several passes
_PASS_ELEMENTS = 1 << 25


class BAConfig(NamedTuple):
    """(ba.py:49)"""
    pin: int = 1
    C_conf: float = 0.0
    Q_conf: float = 1.5
    max_iters: int = 10
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    sigma_point: float = 0.05
    delta_norm: float = 1e-8
    pixel_border: int = -10
    depth_eps: float = 1e-6
    chunk_points: int = 8192
    damping: float = 1e-6     # relative damping of the f32 solve
    huber_k: float = 1.345
    points_subsample: int = 1  # stride-s subset of each edge's pixels

    @classmethod
    def from_config(cls, cfg: dict) -> "BAConfig":
        lo = cfg["local_opt"]
        return cls(
            pin=int(lo["pin"]),
            C_conf=float(lo["C_conf"]),
            Q_conf=float(lo["Q_conf"]),
            max_iters=int(lo["max_iters"]),
            sigma_ray=float(lo["sigma_ray"]),
            sigma_dist=float(lo["sigma_dist"]),
            sigma_pixel=float(lo["sigma_pixel"]),
            sigma_depth=float(lo["sigma_depth"]),
            sigma_point=float(lo["sigma_point"]),
            delta_norm=float(lo["delta_norm"]),
            pixel_border=int(lo["pixel_border"]),
            depth_eps=float(lo["depth_eps"]),
            chunk_points=int(lo.get("chunk_points", 8192)),
            points_subsample=int(lo.get("points_subsample", 1)),
        )


def sqrt_rn(x):
    """f32 square root rounded to nearest, as XLA and CUDA's ``sqrtf``
    round it.  PyTorch's vectorised CPU ``sqrt`` is one ulp off in ~0.6% of
    f32 inputs; the f64 root rounded once to f32 is exact."""
    return torch.sqrt(x.double()).to(x.dtype)


def _skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).reshape(
        v.shape[:-1] + (3, 3))


# ---------------------------------------------------------------------------
# Residuals, (E, C, ...) layout.  Each returns (err (E, C, R), J_local
# (E, C, R, 7), valid (E, C), sig (R,)); J_local is taken with respect to a
# left perturbation in camera i's frame at Xj_Ci (ba.py:96-201).
# ---------------------------------------------------------------------------

def _residual_point(Tij, Xi, Xj, ind_Xi, K, img_wh, cfg: BAConfig):
    """Point alignment (ba.py:102)."""
    Xj_Ci = sim3.act(Tij[:, None, :], Xj)
    err = Xj_Ci - Xi
    E, C = err.shape[:2]
    eye = torch.eye(3, dtype=err.dtype, device=err.device).expand(E, C, 3, 3)
    J = torch.cat([eye, -_skew(Xj_Ci), Xj_Ci[..., :, None]], dim=-1)
    valid = torch.ones((E, C), dtype=torch.bool, device=err.device)
    sig = torch.full((3,), 1.0 / cfg.sigma_point, device=err.device)
    return err, J, valid, sig


def _residual_ray(Tij, Xi, Xj, ind_Xi, K, img_wh, cfg: BAConfig):
    """Ray + distance (ba.py:116)."""
    Xj_Ci = sim3.act(Tij[:, None, :], Xj)
    norm_i = torch.clamp(torch.linalg.norm(Xi, dim=-1, keepdim=True),
                         min=1e-12)
    norm_j = torch.clamp(torch.linalg.norm(Xj_Ci, dim=-1, keepdim=True),
                         min=1e-12)
    ri = Xi / norm_i
    rj = Xj_Ci / norm_j
    err = torch.cat([rj - ri, norm_j - norm_i], dim=-1)
    E, C = err.shape[:2]
    eye = torch.eye(3, dtype=err.dtype, device=err.device)
    dr_dP = (eye - rj[..., :, None] * rj[..., None, :]) / norm_j[..., None]
    zeros1 = torch.zeros((E, C, 3, 1), dtype=err.dtype, device=err.device)
    J_ray = torch.cat([dr_dP, -_skew(rj), zeros1], dim=-1)
    J_dist = torch.cat([rj, torch.zeros_like(rj), norm_j], dim=-1)[..., None, :]
    J = torch.cat([J_ray, J_dist], dim=-2)
    valid = torch.ones((E, C), dtype=torch.bool, device=err.device)
    sig = torch.tensor([1.0 / cfg.sigma_ray] * 3 + [1.0 / cfg.sigma_dist],
                       device=err.device)
    return err, J, valid, sig


def _residual_calib(Tij, Xi, Xj, ind_Xi, K, img_wh, cfg: BAConfig):
    """Calibrated pixel + log-depth (ba.py:145)."""
    width, height = img_wh
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Xj_Ci = sim3.act(Tij[:, None, :], Xj)
    zi = Xi[..., 2]
    zj = Xj_Ci[..., 2]
    valid_z = (zj > cfg.depth_eps) & (zi > cfg.depth_eps)
    one = torch.ones_like(zj)
    zj_safe = torch.where(valid_z, zj, one)
    zi_safe = torch.where(valid_z, zi, one)
    zj_inv = 1.0 / zj_safe
    x_div_z = Xj_Ci[..., 0] * zj_inv
    y_div_z = Xj_Ci[..., 1] * zj_inv
    u = fx * x_div_z + cx
    v = fy * y_div_z + cy
    u_t = (ind_Xi % width).to(u.dtype)
    v_t = (ind_Xi // width).to(u.dtype)
    valid_u = (u > cfg.pixel_border) & (u < width - 1 - cfg.pixel_border)
    valid_v = (v > cfg.pixel_border) & (v < height - 1 - cfg.pixel_border)
    valid = valid_z & valid_u & valid_v
    err = torch.stack([u - u_t, v - v_t,
                       torch.log(zj_safe) - torch.log(zi_safe)], dim=-1)
    o = torch.zeros_like(zj_inv)
    Ju = torch.stack([fx * zj_inv, o, -fx * x_div_z * zj_inv,
                      -fx * x_div_z * y_div_z, fx * (1 + x_div_z * x_div_z),
                      -fx * y_div_z, o], dim=-1)
    Jv = torch.stack([o, fy * zj_inv, -fy * y_div_z * zj_inv,
                      -fy * (1 + y_div_z * y_div_z), fy * x_div_z * y_div_z,
                      fy * x_div_z, o], dim=-1)
    Jz = torch.stack([o, o, zj_inv, y_div_z, -x_div_z, o, one], dim=-1)
    J = torch.stack([Ju, Jv, Jz], dim=-2)
    sig = torch.tensor([1.0 / cfg.sigma_pixel] * 2 + [1.0 / cfg.sigma_depth],
                       device=err.device)
    return err, J, valid, sig


_RESIDUALS = {
    "point": (_residual_point, 3),
    "ray": (_residual_ray, 4),
    "calib": (_residual_calib, 3),
}


# ---------------------------------------------------------------------------
# SoA residual rows, points on the last axis (ba.py:204-311).  Each builder
# returns a list of rows (sig, r (E, C), J [7 entries: (E, C) tensor |
# float | None], valid (E, C) or None), None marking a structural zero.
# ---------------------------------------------------------------------------

def _act_soa(Tij, Xj):
    """Sim(3) action on SoA points Xj (E, 3, C) -> (px, py, pz)."""
    R = tuple(tuple(e[:, None] for e in row)
              for row in sim3.quat_rot_entries(Tij[:, 3:7]))
    s = Tij[:, 7:8]
    xj, yj, zj = Xj[:, 0], Xj[:, 1], Xj[:, 2]
    px = s * (R[0][0] * xj + R[0][1] * yj + R[0][2] * zj) + Tij[:, 0:1]
    py = s * (R[1][0] * xj + R[1][1] * yj + R[1][2] * zj) + Tij[:, 1:2]
    pz = s * (R[2][0] * xj + R[2][1] * yj + R[2][2] * zj) + Tij[:, 2:3]
    return px, py, pz


def _soa_point(Tij, Xi, Xj, ind, K, img_wh, cfg: BAConfig):
    """Point-alignment rows, J = [I | -skew(p) | p] (ba.py:231)."""
    px, py, pz = _act_soa(Tij, Xj)
    sp = 1.0 / cfg.sigma_point
    return [
        (sp, px - Xi[:, 0], [1.0, None, None, None, pz, -py, px], None),
        (sp, py - Xi[:, 1], [None, 1.0, None, -pz, None, px, py], None),
        (sp, pz - Xi[:, 2], [None, None, 1.0, py, -px, None, pz], None),
    ]


def _soa_ray(Tij, Xi, Xj, ind, K, img_wh, cfg: BAConfig):
    """Ray + distance rows (ba.py:242)."""
    px, py, pz = _act_soa(Tij, Xj)
    d = torch.clamp(torch.sqrt(px * px + py * py + pz * pz), min=1e-12)
    dinv = 1.0 / d
    rx, ry, rz = px * dinv, py * dinv, pz * dinv
    xi, yi, zi = Xi[:, 0], Xi[:, 1], Xi[:, 2]
    di = torch.clamp(torch.sqrt(xi * xi + yi * yi + zi * zi), min=1e-12)
    di_inv = 1.0 / di
    rix, riy, riz = xi * di_inv, yi * di_inv, zi * di_inv
    d3 = dinv * dinv * dinv
    axx = dinv - px * px * d3
    ayy = dinv - py * py * d3
    azz = dinv - pz * pz * d3
    axy = -px * py * d3
    axz = -px * pz * d3
    ayz = -py * pz * d3
    sr, sd = 1.0 / cfg.sigma_ray, 1.0 / cfg.sigma_dist
    return [
        (sr, rx - rix, [axx, axy, axz, None, rz, -ry, None], None),
        (sr, ry - riy, [axy, ayy, ayz, -rz, None, rx, None], None),
        (sr, rz - riz, [axz, ayz, azz, ry, -rx, None, None], None),
        (sd, d - di, [rx, ry, rz, None, None, None, d], None),
    ]


def _soa_calib(Tij, Xi, Xj, ind, K, img_wh, cfg: BAConfig):
    """Calibrated pixel + log-depth rows (ba.py:272)."""
    width, height = img_wh
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    px, py, pz = _act_soa(Tij, Xj)
    zi = Xi[:, 2]
    valid_z = (pz > cfg.depth_eps) & (zi > cfg.depth_eps)
    one = torch.ones_like(pz)
    pz_safe = torch.where(valid_z, pz, one)
    zi_safe = torch.where(valid_z, zi, one)
    zj_inv = 1.0 / pz_safe
    xz = px * zj_inv
    yz = py * zj_inv
    u = fx * xz + cx
    v = fy * yz + cy
    u_t = (ind % width).to(u.dtype)
    v_t = (ind // width).to(u.dtype)
    valid = (
        valid_z
        & (u > cfg.pixel_border) & (u < width - 1 - cfg.pixel_border)
        & (v > cfg.pixel_border) & (v < height - 1 - cfg.pixel_border)
    )
    sp, sz = 1.0 / cfg.sigma_pixel, 1.0 / cfg.sigma_depth
    return [
        (sp, u - u_t,
         [fx * zj_inv, None, -fx * xz * zj_inv,
          -fx * xz * yz, fx * (1 + xz * xz), -fx * yz, None], valid),
        (sp, v - v_t,
         [None, fy * zj_inv, -fy * yz * zj_inv,
          -fy * (1 + yz * yz), fy * xz * yz, fy * xz, None], valid),
        (sz, torch.log(pz_safe) - torch.log(zi_safe),
         [None, None, zj_inv, yz, -xz, None, 1.0], valid),
    ]


_SOA_RESIDUALS = {
    "point": _soa_point,
    "ray": _soa_ray,
    "calib": _soa_calib,
}


def soa_rows_dense(rows, like):
    """The SoA rows as dense tensors: (sig (R,), r (E, R, C), J
    (E, R, 7, C), valid (E, R, C) bool or None), structural zeros and
    scalar entries expanded to the shape of ``like`` (E, C)."""
    zero = torch.zeros((), dtype=like.dtype, device=like.device)

    def entry(e):
        if e is None:
            return zero.expand_as(like)
        if isinstance(e, float):
            return torch.full((), e, dtype=like.dtype,
                              device=like.device).expand_as(like)
        return e

    sig = torch.tensor([row[0] for row in rows], dtype=like.dtype,
                       device=like.device)
    r = torch.stack([row[1] for row in rows], dim=1)
    J = torch.stack([torch.stack([entry(e) for e in row[2]], dim=1)
                     for row in rows], dim=1)
    valid = None
    if rows[0][3] is not None:
        valid = torch.stack([row[3] for row in rows], dim=1)
    return sig, r, J, valid


def _normal_equations(rows, sqw, huber_k, chunk):
    """H (E, 7, 7) and g (E, 7) of one pass of SoA rows with weights sqw
    (E, n), in f32 (ba.py:314, ``_soa_accumulate``): per row
    w = huber(sig * sqw * r) * (sig * sqw)^2, H = sum w J J^T,
    g = sum w r J.  Both come from one batched product of [J | r] with
    w [J | r] over (edge, chunk of ``chunk`` points) pairs, summed over the
    chunks: batched per edge alone, the product's long reduction leaves
    the card's library a few blocks to run it on."""
    sig, r, J, valid = soa_rows_dense(rows, sqw)
    sw = sig[None, :, None] * sqw[:, None, :]                # (E, R, n)
    if valid is not None:
        sw = torch.where(valid, sw, torch.zeros_like(sw))
    w = huber(sw * r, k=huber_k) * (sw * sw)
    Jr = torch.cat([J, r[:, :, None]], dim=2)                # (E, R, 8, n)
    E, R, _, n = Jr.shape
    S = n // chunk

    def per_chunk(A):      # (E, R, 8, n) -> (E * S, 8, R * chunk)
        return A.reshape(E, R, 8, S, chunk).permute(0, 3, 2, 1, 4).reshape(
            E * S, 8, R * chunk)

    Jc = per_chunk(Jr)
    H8 = torch.bmm(per_chunk(w[:, :, None] * Jr), Jc.transpose(1, 2))
    H8 = H8.reshape(E, S, 8, 8).sum(dim=1)
    return H8[:, :7, :7], H8[:, :7, 7]


# ---------------------------------------------------------------------------
# Accumulation, assembly and solve
# ---------------------------------------------------------------------------

class EdgeData(NamedTuple):
    """Per-edge point data that does not depend on the poses, gathered once
    per solve (ba.py:353).  SoA, padded along the points to a multiple of
    the chunk size with zero weight."""
    Xi: torch.Tensor    # (E, 3, Np) gathered i-side points (matched order)
    Xj: torch.Tensor    # (E, 3, Np) j-side points (raster order)
    sqw: torch.Tensor   # (E, Np) sqrt(Q) with every static gate folded in
    ind: torch.Tensor   # (E, Np) matched linear indices (calib targets)


_flat_fallback_warned: set = set()


def _warn_flat_fallback(why: str):
    """One warning per cause when ``subsample_points`` falls back to the
    flat stride (ba.py:373): that stride sees only every s-th image column,
    which costs the BA accuracy on depth-discontinuity scenes."""
    if why not in _flat_fallback_warned:
        _flat_fallback_warned.add(why)
        warnings.warn(
            f"subsample_points: falling back to the flat [:, ::s] stride "
            f"({why}) — column-biased BA residual coverage; pick a "
            f"resolution divisible by the stride factors", stacklevel=3)


def subsample_points(a, s: int, img_wh):
    """Spatially balanced stride-``s`` subset along the flat raster axis 1
    (ba.py:389): s is factored into near-square strides (sv, su) and the
    (::sv, ::su) grid is taken; the flat ``[:, ::s]`` stride, with a
    warning, when the factors do not divide (h, w) or ``img_wh`` is
    None."""
    if s <= 1:
        return a
    if img_wh is None:
        _warn_flat_fallback("img_wh=None")
        return a[:, ::s]
    w, h = img_wh
    sv = int(s ** 0.5)
    while s % sv:
        sv -= 1
    su = s // sv
    if a.shape[1] != h * w or h % sv or w % su:
        _warn_flat_fallback(
            f"shape[1]={a.shape[1]} vs h*w={h * w}, "
            f"(h, w)=({h}, {w}) not divisible by (sv, su)=({sv}, {su})")
        return a[:, ::s]
    E = a.shape[0]
    rest = tuple(a.shape[2:])
    return a.reshape((E, h, w) + rest)[:, ::sv, ::su].reshape(
        (E, (h // sv) * (w // su)) + rest)


def _pregather_edges(Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                     edge_valid, cfg: BAConfig, C: int,
                     img_wh=None) -> EdgeData:
    """(ba.py:422)  Xs (P, N, 3), Cs (P, N); ii, jj (E,); idx_ii2jj,
    valid_match, Q (E, N); edge_valid (E,)."""
    s = max(int(cfg.points_subsample), 1)
    if s > 1:
        idx_ii2jj = subsample_points(idx_ii2jj, s, img_wh)
        valid_match = subsample_points(valid_match, s, img_wh)
        Q = subsample_points(Q, s, img_wh)
    E, N = idx_ii2jj.shape
    P, Nx = Xs.shape[0], Xs.shape[1]
    ind = torch.where(valid_match, idx_ii2jj, torch.zeros_like(idx_ii2jj))
    # one gather of the packed (x, y, z, c) rows for the i side
    src_i = torch.cat([Xs.reshape(P * Nx, 3), Cs.reshape(P * Nx, 1)], dim=-1)
    gi = src_i[ii.long()[:, None] * Nx + ind.long()]      # (E, N, 4)
    Xi, ci = gi[..., :3].transpose(1, 2), gi[..., 3]
    Xj = subsample_points(Xs[jj.long()], s, img_wh).transpose(1, 2)
    cj = subsample_points(Cs[jj.long()], s, img_wh)
    static_valid = (
        valid_match & (Q > cfg.Q_conf) & (ci > cfg.C_conf)
        & (cj > cfg.C_conf) & edge_valid[:, None]
    )
    sqw = torch.where(static_valid, sqrt_rn(torch.clamp(Q, min=0.0)),
                      torch.zeros_like(Q))
    pad = (-N) % C
    Xi, Xj, sqw, ind = (F.pad(A, (0, pad)) if pad else A
                        for A in (Xi, Xj, sqw, ind))
    return EdgeData(Xi.contiguous(), Xj.contiguous(), sqw.contiguous(),
                    ind.contiguous())


def _accumulate_pre(residual_type: str, Twc, ii, jj, pre: EdgeData, K,
                    img_wh, cfg: BAConfig):
    """Hs (E, 14, 14) and gs (E, 14) from pregathered edge data
    (ba.py:462).  Accumulates in camera i's frame, where Ji = -Jj, then
    takes the 7x7 block to the world frame once per edge (A^T H A)."""
    soa = _SOA_RESIDUALS[residual_type]
    R = _RESIDUALS[residual_type][1]
    E, Np = pre.sqw.shape
    C = min(cfg.chunk_points, Np)
    step = C * max(1, _PASS_ELEMENTS // max(E * R * 7 * C, 1))
    Ti = Twc[ii.long()]
    Tij = sim3.rel(Ti, Twc[jj.long()])
    H_loc = g_loc = 0.0
    for c0 in range(0, Np, step):
        sl = slice(c0, c0 + step)
        rows = soa(Tij, pre.Xi[..., sl], pre.Xj[..., sl], pre.ind[:, sl], K,
                   img_wh, cfg)
        H7, g7 = _normal_equations(rows, pre.sqw[:, sl], cfg.huber_k, C)
        H_loc, g_loc = H_loc + H7, g_loc + g7
    eye = torch.eye(7, dtype=H_loc.dtype, device=H_loc.device)
    A = sim3.apply_adj_inv(Ti[:, None, :], eye.expand(E, 7, 7))
    At = A.transpose(1, 2)
    H7 = At @ H_loc @ A
    g7 = (At @ g_loc[..., None])[..., 0]
    Hs = torch.cat([torch.cat([H7, -H7], dim=-1),
                    torch.cat([-H7, H7], dim=-1)], dim=-2)
    gs = torch.cat([-g7, g7], dim=-1)
    return Hs, gs


def _incidence(ii, jj, P: int, pin: int, dtype=torch.float32):
    """(E*14, 7F) 0/1 matrix S with S[(e, a, k), (f, l)] = 1 where side a
    (i or j) of edge e is free pose f and k == l; F = P - pin.  A pinned
    endpoint's rows stay 0, which drops its blocks as the dump row of
    ba.py:528 does."""
    Fr = P - pin
    ends = torch.stack([ii, jj], dim=1).long() - pin                # (E, 2)
    slot = torch.where(ends >= 0, ends, torch.full_like(ends, Fr))
    onehot = F.one_hot(slot, Fr + 1)[..., :Fr].to(dtype)            # (E,2,F)
    eye = torch.eye(7, dtype=dtype, device=onehot.device)
    S = onehot[:, :, None, :, None] * eye[None, None, :, None, :]
    return S.reshape(ii.shape[0] * 14, 7 * Fr)


def _assemble_with(S, Hs, gs):
    """H = sum_e S_e^T Hs_e S_e, g = sum_e S_e^T gs_e, as two products in a
    fixed order."""
    E = Hs.shape[0]
    HS = torch.bmm(Hs, S.reshape(E, 14, -1)).reshape(E * 14, -1)
    return S.T @ HS, S.T @ gs.reshape(E * 14)


def _assemble_dense(Hs, gs, ii, jj, P: int, pin: int):
    """Per-edge 14x14 blocks into the dense free-pose system
    (ba.py:528): H (7F, 7F), g (7F,), F = P - pin."""
    return _assemble_with(_incidence(ii, jj, P, pin, Hs.dtype), Hs, gs)


def _solve_scaled(H, g, damping):
    """Jacobi-preconditioned damped Cholesky solve of H dx = g in f32
    (ba.py:563).  Empty rows (padded poses) get a unit diagonal; dx is 0
    and ok False when the factorization fails or dx is not finite."""
    d = torch.diagonal(H)
    empty = d <= 0.0
    s = torch.where(empty, torch.ones_like(d),
                    1.0 / torch.sqrt(torch.clamp(d, min=1e-20)))
    Hs = H * s[:, None] * s[None, :]
    Hs = Hs + torch.diag(empty.to(H.dtype) + damping)
    L, info = torch.linalg.cholesky_ex(Hs)
    y = torch.cholesky_solve((s * g)[:, None], L)
    dx = s * y[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    return torch.where(ok, dx, torch.zeros_like(dx)), ok


def gauss_newton(Twc, Xs, Cs, ii, jj, idx_ii2jj, valid_match, Q,
                 edge_valid, K, residual_type: str, img_wh,
                 cfg: BAConfig):
    """The whole GN pose-graph solve (ba.py:583).  Twc (P, 8); Xs (P, N, 3);
    Cs (P, N, 1) or (P, N); ii, jj (E,) two-way edge endpoints; idx_ii2jj
    (E, N); valid_match (E, N) or (E, N, 1); Q (E, N) or (E, N, 1);
    edge_valid (E,).  Returns (Twc', iterations, |dx|, ok)."""
    def two(A):
        return A[..., 0] if A.dim() == 3 else A

    C = min(cfg.chunk_points, idx_ii2jj.shape[1])
    pre = _pregather_edges(Xs, two(Cs), ii, jj, idx_ii2jj, two(valid_match),
                           two(Q), edge_valid, cfg, C, img_wh)
    return gauss_newton_from_pre(Twc, pre, ii, jj, K, residual_type, img_wh,
                                 cfg)


def gauss_newton_from_pre(Twc, pre: EdgeData, ii, jj, K,
                          residual_type: str, img_wh, cfg: BAConfig):
    """The GN loop on prebuilt ``EdgeData`` (ba.py:608): at most
    ``max_iters`` iterations, leaving after the one whose |dx| is under
    ``delta_norm`` or whose solve failed (a failed solve keeps the poses).
    One host read of two flags per iteration.  Returns (Twc', iterations
    (int), |dx| of the last iteration (0-d tensor), ok (bool))."""
    P = Twc.shape[0]
    S = _incidence(ii, jj, P, cfg.pin, Twc.dtype)
    zeros_pin = torch.zeros((cfg.pin, 7), dtype=Twc.dtype, device=Twc.device)
    delta = torch.full((), float("inf"), device=Twc.device)
    it, ok = 0, True
    while it < cfg.max_iters:
        Hs, gs = _accumulate_pre(residual_type, Twc, ii, jj, pre, K, img_wh,
                                 cfg)
        H, g = _assemble_with(S, Hs, gs)
        dx, solve_ok = _solve_scaled(H, g, cfg.damping)
        dx = -dx
        Twc_new = sim3.retr(Twc, torch.cat([zeros_pin,
                                            dx.reshape(P - cfg.pin, 7)]))
        delta = torch.linalg.norm(dx)
        Twc = torch.where(solve_ok, Twc_new, Twc)
        it += 1
        converged, solve_ok = torch.stack(
            [delta < cfg.delta_norm, solve_ok]).tolist()
        ok = ok and solve_ok
        if converged or not solve_ok:
            break
    return Twc, it, delta, ok
