"""One tracking step in plain PyTorch: the benchmark's reference for the
port's ``tracker.py::track_step`` under ``config/base.yaml`` (uncalibrated,
joint ray Huber, weighted-pointmap fusion, every pixel in the solve).

A frozen copy of the port's plain math: the asymmetric match through
``reference.matching``, the closed-form ray + distance Gauss-Newton solve
(27 sums per iteration, the 7x7 LDL^T solve and the convergence test on the
host in float32, the left Sim(3) retraction) and the keyframe metric.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import lie_sim3 as sim3
from .matching import MatchCfg, match, q8
from .network import round_tf32
from .robust import check_convergence, solve_spd_small


class TrackCfg(NamedTuple):
    min_match_frac: float
    max_iters: int
    C_conf: float
    Q_conf: float
    rel_error: float
    delta_norm: float
    huber_k: float
    match_frac_thresh: float
    sigma_ray: float
    sigma_dist: float

    @classmethod
    def from_dict(cls, cfg: dict) -> "TrackCfg":
        t = cfg["tracking"]
        if cfg.get("use_calib") or not t.get("joint_ray_huber", True) or \
                int(t.get("point_subsample", 1)) != 1 or \
                t["filtering_mode"] != "weighted_pointmap":
            raise ValueError("the reference tracker takes the uncalibrated "
                             "joint-ray-Huber solve over every pixel and "
                             "weighted-pointmap fusion")
        return cls(float(t["min_match_frac"]), int(t["max_iters"]),
                   float(t["C_conf"]), float(t["Q_conf"]),
                   float(t["rel_error"]), float(t["delta_norm"]),
                   float(t["huber"]), float(t["match_frac_thresh"]),
                   float(t["sigma_ray"]), float(t["sigma_dist"]))


def gn_terms(pts, scal, huber_k):
    """The 27 per-point terms whose sums are the normal equations of the
    joint-ray-Huber ray + distance residuals at the pose ``scal``
    ([R00..R22, tx, ty, tz, s])."""
    R00, R01, R02, R10, R11, R12, R20, R21, R22, tx, ty, tz, sc = \
        scal.unbind(0)
    xf, yf, zf, rkx, rky, rkz, rkd, w_ray, w_dist = pts.unbind(0)
    px = sc * (R00 * xf + R01 * yf + R02 * zf) + tx
    py = sc * (R10 * xf + R11 * yf + R12 * zf) + ty
    pz = sc * (R20 * xf + R21 * yf + R22 * zf) + tz
    d2 = px * px + py * py + pz * pz
    d = torch.sqrt(torch.clamp(d2, min=1e-24))
    dinv = 1.0 / d
    rx, ry, rz = px * dinv, py * dinv, pz * dinv
    ex, ey, ez, ed = rkx - rx, rky - ry, rkz - rz, rkd - d
    e2 = ex * ex + ey * ey + ez * ez

    def huber(r):
        ra = torch.abs(r)
        return torch.where(ra < huber_k, torch.ones_like(ra),
                           huber_k / torch.clamp(ra, min=1e-12))

    w_r = huber(w_ray * torch.sqrt(e2)) * w_ray * w_ray
    w_d = huber(w_dist * ed) * w_dist * w_dist
    qxx, qyy, qzz = rx * rx, ry * ry, rz * rz
    qxy, qxz, qyz = rx * ry, rx * rz, ry * rz
    wrd2 = w_r * (dinv * dinv)
    wrd = w_r * dinv
    rTe = rx * ex + ry * ey + rz * ez
    return torch.stack([
        wrd2 * (1 - qxx) + w_d * qxx, (w_d - wrd2) * qxy,
        (w_d - wrd2) * qxz, wrd2 * (1 - qyy) + w_d * qyy,
        (w_d - wrd2) * qyz, wrd2 * (1 - qzz) + w_d * qzz,
        wrd * rx, wrd * ry, wrd * rz,
        w_r * (1 - qxx), -w_r * qxy, -w_r * qxz, w_r * (1 - qyy),
        -w_r * qyz, w_r * (1 - qzz),
        w_d * px, w_d * py, w_d * pz, w_d * d2,
        w_r * (ex - rx * rTe) * dinv + w_d * ed * rx,
        w_r * (ey - ry * rTe) * dinv + w_d * ed * ry,
        w_r * (ez - rz * rTe) * dinv + w_d * ed * rz,
        w_r * (ry * ez - rz * ey), w_r * (rz * ex - rx * ez),
        w_r * (rx * ey - ry * ex), w_d * ed * d, w_r * e2 + w_d * ed * ed])


# H (7x7) as entries of the 27 sums (27 is a zero), with signs
_H_IDX = torch.tensor((
    (0, 1, 2, 27, 8, 7, 15), (1, 3, 4, 8, 27, 6, 16),
    (2, 4, 5, 7, 6, 27, 17), (27, 8, 7, 9, 10, 11, 27),
    (8, 27, 6, 10, 12, 13, 27), (7, 6, 27, 11, 13, 14, 27),
    (15, 16, 17, 27, 27, 27, 18)))
_H_SIGN = torch.tensor((
    (1, 1, 1, 1, 1, -1, 1), (1, 1, 1, -1, 1, 1, 1), (1, 1, 1, 1, -1, 1, 1),
    (1, -1, 1, 1, 1, 1, 1), (1, 1, -1, 1, 1, 1, 1), (-1, 1, 1, 1, 1, 1, 1),
    (1, 1, 1, 1, 1, 1, 1)), dtype=torch.float32)


def _scalars(T):
    Re = sim3.quat_rot_entries(T[3:7])
    return torch.stack([e for row in Re for e in row] +
                       [T[0], T[1], T[2], T[7]])


def gn_solve(pts, T_init, cfg: TrackCfg):
    """Gauss-Newton from ``T_init`` (8,): the sums where the points are,
    the solve and the test on the host.  Returns (T (8,) on the host, ok,
    iterations)."""
    T = T_init.detach().to("cpu", torch.float32)
    old_cost, ok, it = math.inf, True, 0
    while it < cfg.max_iters:
        a = gn_terms(pts, _scalars(T).to(pts.device),
                     cfg.huber_k).sum(dim=1).cpu()
        H = torch.cat([a, a.new_zeros(1)])[_H_IDX] * _H_SIGN
        g, cost = a[19:26], 0.5 * a[26]
        tau, spd_ok = solve_spd_small(H, g)
        solve_ok = bool(spd_ok) and bool(torch.isfinite(tau).all())
        if not solve_ok:
            tau = torch.zeros_like(tau)
        conv = bool(check_convergence(cfg.rel_error, cfg.delta_norm,
                                      old_cost, cost, tau))
        if solve_ok:
            T = sim3.retr(T, tau)
        old_cost = cost
        ok = ok and solve_ok
        it += 1
        if conv or not solve_ok:
            break
    return T, ok, it


class TrackOut(NamedTuple):
    T_WC: torch.Tensor          # (8,) the frame's pose
    new_kf_metric: float
    match_frac: float
    new_kf: bool
    lost: bool


def track(views, kf, T_WC_frame, idx_init, mcfg: MatchCfg, tcfg: TrackCfg,
          tf32: bool = False) -> TrackOut:
    """One step against the keyframe.  ``views`` are the network's
    ((X, C, D, Q) of the frame, (X, C, D, Q) of the keyframe in the frame's
    pair), each (1, h, w, ...); ``kf`` the keyframe as the step found it,
    (X_canon (hw, 3), C (hw, 1), N (), T_WC (8,)); ``T_WC_frame`` the
    frame's starting pose; ``idx_init`` (1, hw) the warm start or None.
    ``tf32`` rounds the solve's inputs to TF32 (the control)."""
    (Xii, Cii, Dii, Qii), (Xji, Cji, Dji, Qji) = views
    h, w = Xii.shape[1:3]
    hw = h * w
    idx, vm = match(Xii, Xji, q8(Dii), q8(Dji), idx_init, mcfg)
    idx, vm = idx[0], vm[0]
    Xf, Cf, Qff = Xii.reshape(hw, 3), Cii.reshape(hw, 1), Qii.reshape(hw, 1)
    Qkf = Qji.reshape(hw, 1)
    kX, kC, kN, kT = kf
    Ck = kC / torch.clamp(kN, min=1).to(kC.dtype)
    g = torch.cat([Xf, Cf, Qff], dim=-1)[idx]
    Xf_m, Cf_m = g[:, 0:3], g[:, 3:4]
    Qk = torch.sqrt(g[:, 4:5] * Qkf)
    valid_Q = Qk > tcfg.Q_conf
    valid_opt = vm & (Cf_m > tcfg.C_conf) & (Ck > tcfg.C_conf) & valid_Q
    valid_kf = vm & valid_Q
    match_frac = float(torch.mean(valid_opt.float()))
    vq = (valid_opt.float() * torch.sqrt(Qk))[:, 0]
    dk = torch.sqrt(torch.clamp(torch.sum(kX * kX, dim=-1), min=1e-24))
    pts = torch.stack([Xf_m[:, 0], Xf_m[:, 1], Xf_m[:, 2],
                       kX[:, 0] / dk, kX[:, 1] / dk, kX[:, 2] / dk, dk,
                       (1.0 / tcfg.sigma_ray) * vq,
                       (1.0 / tcfg.sigma_dist) * vq]).float()
    if tf32:
        pts = round_tf32(pts)
    T_init = sim3.rel(kT, T_WC_frame)
    T_CkCf, ok, _ = gn_solve(pts, T_init, tcfg)
    T_CkCf = T_CkCf.to(kT.device)
    T_WC = sim3.normalize(sim3.mul(kT, T_CkCf))
    seen = torch.zeros((hw + 1,), dtype=torch.int32, device=idx.device)
    seen[torch.where(vm[:, 0], idx, torch.full_like(idx, hw))] = 1
    metric = min(float(torch.mean(valid_kf.float())),
                 float(seen[:hw].sum()) / hw)
    lost = match_frac < tcfg.min_match_frac or not ok
    return TrackOut(T_WC, metric, match_frac,
                    (not lost) and metric < tcfg.match_frac_thresh, lost)
