"""The backend's pointmap bundle adjustment in plain PyTorch: the
benchmark's reference for ``global_opt.FactorGraph.solve_poses`` with ray
+ distance residuals under ``config/base.yaml``.

A frozen copy of the port's plain math, without the pregather cache: the
keyframes the edges touch, the two-way edge set padded to a power of two,
the balanced stride-4 subset of each edge's pixels, the per-edge 14x14
systems with Huber and confidence weights, their dense assembly, the
Jacobi-scaled damped Cholesky solve and the left Sim(3) retraction, the
first ``pin`` poses held.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import lie_sim3 as sim3
from .network import round_tf32
from .robust import huber


class BACfg(NamedTuple):
    pin: int
    C_conf: float
    Q_conf: float
    max_iters: int
    sigma_ray: float
    sigma_dist: float
    delta_norm: float
    chunk_points: int
    points_subsample: int
    damping: float = 1e-6
    huber_k: float = 1.345

    @classmethod
    def from_dict(cls, cfg: dict) -> "BACfg":
        lo = cfg["local_opt"]
        if lo.get("sharded_ba"):
            raise ValueError("the reference BA is the single-device solve")
        return cls(int(lo["pin"]), float(lo["C_conf"]), float(lo["Q_conf"]),
                   int(lo["max_iters"]), float(lo["sigma_ray"]),
                   float(lo["sigma_dist"]), float(lo["delta_norm"]),
                   int(lo.get("chunk_points", 8192)),
                   int(lo.get("points_subsample", 1)))


def sqrt_rn(x):
    """float32 square root rounded to nearest (through float64)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _next_bucket(n: int, minimum: int = 1) -> int:
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def subsample_points(a, s, img_wh):
    """The (::sv, ::su) grid of each row's raster, s = sv * su near
    square."""
    if s <= 1:
        return a
    w, h = img_wh
    sv = int(s ** 0.5)
    while s % sv:
        sv -= 1
    su = s // sv
    E = a.shape[0]
    rest = tuple(a.shape[2:])
    return a.reshape((E, h, w) + rest)[:, ::sv, ::su].reshape(
        (E, (h // sv) * (w // su)) + rest)


def _pregather(Xs, Cs, ii, jj, idx, vm, Q, ev, cfg: BACfg, img_wh):
    s = max(cfg.points_subsample, 1)
    idx, vm, Q = (subsample_points(a, s, img_wh) for a in (idx, vm, Q))
    E, N = idx.shape
    P, Nx = Xs.shape[0], Xs.shape[1]
    ind = torch.where(vm, idx, torch.zeros_like(idx))
    src = torch.cat([Xs.reshape(P * Nx, 3), Cs.reshape(P * Nx, 1)], dim=-1)
    gi = src[ii.long()[:, None] * Nx + ind.long()]
    Xi, ci = gi[..., :3].transpose(1, 2), gi[..., 3]
    Xj = subsample_points(Xs[jj.long()], s, img_wh).transpose(1, 2)
    cj = subsample_points(Cs[jj.long()], s, img_wh)
    ok = vm & (Q > cfg.Q_conf) & (ci > cfg.C_conf) & (cj > cfg.C_conf) \
        & ev[:, None]
    sqw = torch.where(ok, sqrt_rn(torch.clamp(Q, min=0.0)),
                      torch.zeros_like(Q))
    C = min(cfg.chunk_points, N)
    pad = (-N) % C
    if pad:
        Xi, Xj, sqw = (F.pad(A, (0, pad)) for A in (Xi, Xj, sqw))
    return Xi.contiguous(), Xj.contiguous(), sqw.contiguous()


def _ray_rows(Tij, Xi, Xj, cfg: BACfg):
    """Ray + distance residual rows of points Xj (E, 3, n) in camera i
    against Xi: (sig, r (E, n), J [7 entries or None])."""
    R = tuple(tuple(e[:, None] for e in row)
              for row in sim3.quat_rot_entries(Tij[:, 3:7]))
    s = Tij[:, 7:8]
    xj, yj, zj = Xj[:, 0], Xj[:, 1], Xj[:, 2]
    px = s * (R[0][0] * xj + R[0][1] * yj + R[0][2] * zj) + Tij[:, 0:1]
    py = s * (R[1][0] * xj + R[1][1] * yj + R[1][2] * zj) + Tij[:, 1:2]
    pz = s * (R[2][0] * xj + R[2][1] * yj + R[2][2] * zj) + Tij[:, 2:3]
    d = torch.clamp(torch.sqrt(px * px + py * py + pz * pz), min=1e-12)
    dinv = 1.0 / d
    rx, ry, rz = px * dinv, py * dinv, pz * dinv
    xi, yi, zi = Xi[:, 0], Xi[:, 1], Xi[:, 2]
    di = torch.clamp(torch.sqrt(xi * xi + yi * yi + zi * zi), min=1e-12)
    di_inv = 1.0 / di
    d3 = dinv * dinv * dinv
    axx, ayy, azz = dinv - px * px * d3, dinv - py * py * d3, \
        dinv - pz * pz * d3
    axy, axz, ayz = -px * py * d3, -px * pz * d3, -py * pz * d3
    sr, sd = 1.0 / cfg.sigma_ray, 1.0 / cfg.sigma_dist
    return [
        (sr, rx - xi * di_inv, [axx, axy, axz, None, rz, -ry, None]),
        (sr, ry - yi * di_inv, [axy, ayy, ayz, -rz, None, rx, None]),
        (sr, rz - zi * di_inv, [axz, ayz, azz, ry, -rx, None, None]),
        (sd, d - di, [rx, ry, rz, None, None, None, d]),
    ]


def _normal_equations(rows, sqw, cfg: BACfg, tf32: bool):
    """H (E, 7, 7), g (E, 7) of the rows with weights sqw (E, n):
    w = huber(sig sqw r) (sig sqw)^2, H = sum w J J^T, g = sum w r J, as
    one batched product over (edge, point chunk) pairs."""
    zero = torch.zeros((), dtype=sqw.dtype, device=sqw.device)
    sig = torch.tensor([r[0] for r in rows], dtype=sqw.dtype,
                       device=sqw.device)
    r = torch.stack([row[1] for row in rows], dim=1)
    J = torch.stack([torch.stack([zero.expand_as(sqw) if e is None else e
                                  for e in row[2]], dim=1)
                     for row in rows], dim=1)                # (E, R, 7, n)
    sw = sig[None, :, None] * sqw[:, None, :]
    w = huber(sw * r, k=cfg.huber_k) * (sw * sw)
    Jr = torch.cat([J, r[:, :, None]], dim=2)                # (E, R, 8, n)
    E, R, _, n = Jr.shape
    chunk = min(cfg.chunk_points, n)
    S = n // chunk

    def per_chunk(A):
        return A.reshape(E, R, 8, S, chunk).permute(0, 3, 2, 1, 4).reshape(
            E * S, 8, R * chunk)

    A, B = per_chunk(w[:, :, None] * Jr), per_chunk(Jr)
    if tf32:
        A, B = round_tf32(A), round_tf32(B)
    H8 = torch.bmm(A, B.transpose(1, 2)).reshape(E, S, 8, 8).sum(dim=1)
    return H8[:, :7, :7], H8[:, :7, 7]


def _accumulate(Twc, ii, jj, pre, cfg: BACfg, tf32: bool):
    Xi, Xj, sqw = pre
    Ti = Twc[ii.long()]
    Tij = sim3.rel(Ti, Twc[jj.long()])
    H_loc, g_loc = _normal_equations(_ray_rows(Tij, Xi, Xj, cfg), sqw, cfg,
                                     tf32)
    E = H_loc.shape[0]
    eye = torch.eye(7, dtype=H_loc.dtype, device=H_loc.device)
    A = sim3.apply_adj_inv(Ti[:, None, :], eye.expand(E, 7, 7))
    At = A.transpose(1, 2)
    H7 = At @ H_loc @ A
    g7 = (At @ g_loc[..., None])[..., 0]
    Hs = torch.cat([torch.cat([H7, -H7], dim=-1),
                    torch.cat([-H7, H7], dim=-1)], dim=-2)
    return Hs, torch.cat([-g7, g7], dim=-1)


def _incidence(ii, jj, P, pin, dtype):
    Fr = P - pin
    ends = torch.stack([ii, jj], dim=1).long() - pin
    slot = torch.where(ends >= 0, ends, torch.full_like(ends, Fr))
    onehot = F.one_hot(slot, Fr + 1)[..., :Fr].to(dtype)
    eye = torch.eye(7, dtype=dtype, device=onehot.device)
    S = onehot[:, :, None, :, None] * eye[None, None, :, None, :]
    return S.reshape(ii.shape[0] * 14, 7 * Fr)


def _solve_scaled(H, g, damping):
    d = torch.diagonal(H)
    empty = d <= 0.0
    s = torch.where(empty, torch.ones_like(d),
                    1.0 / torch.sqrt(torch.clamp(d, min=1e-20)))
    Hs = H * s[:, None] * s[None, :] + torch.diag(empty.to(H.dtype) + damping)
    L, info = torch.linalg.cholesky_ex(Hs)
    dx = s * torch.cholesky_solve((s * g)[:, None], L)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    return torch.where(ok, dx, torch.zeros_like(dx)), ok


def gauss_newton(Twc, pre, ii, jj, cfg: BACfg, tf32: bool):
    P = Twc.shape[0]
    S = _incidence(ii, jj, P, cfg.pin, Twc.dtype)
    zeros_pin = torch.zeros((cfg.pin, 7), dtype=Twc.dtype, device=Twc.device)
    for _ in range(cfg.max_iters):
        Hs, gs = _accumulate(Twc, ii, jj, pre, cfg, tf32)
        E = Hs.shape[0]
        HS = torch.bmm(Hs, S.reshape(E, 14, -1)).reshape(E * 14, -1)
        dx, ok = _solve_scaled(S.T @ HS, S.T @ gs.reshape(E * 14),
                               cfg.damping)
        dx = -dx
        Twc_new = sim3.retr(Twc, torch.cat([zeros_pin,
                                            dx.reshape(P - cfg.pin, 7)]))
        Twc = torch.where(ok, Twc_new, Twc)
        if bool(torch.linalg.norm(dx) < cfg.delta_norm) or not bool(ok):
            break
    return Twc


def solve_poses(X, C, N, T_WC, ii, jj, idx_ii2jj, idx_jj2ii, vmj, vmi, Qj, Qi,
                img_hw, cfg: BACfg, tf32: bool = False):
    """The poses of every keyframe after one BA round.  X (n, hw, 3), C
    (n, hw, 1), N (n,), T_WC (n, 8): the keyframes as the round read them;
    ii, jj (E,) host ints; the edge arrays (E, hw).  Returns (n, 8): the
    optimised poses, the others as they were."""
    h, w = img_hw
    n_e = len(ii)
    unique = np.unique(np.concatenate([ii, jj]))
    P = len(unique)
    if n_e == 0 or P <= cfg.pin:
        return T_WC.clone()
    E_b = _next_bucket(n_e, 4)
    P_pad = _next_bucket(P, 2)
    remap = {int(k): c for c, k in enumerate(unique)}
    ii_c = np.array([remap[int(k)] for k in ii], np.int64)
    jj_c = np.array([remap[int(k)] for k in jj], np.int64)
    ii2 = np.zeros((2 * E_b,), np.int64)
    jj2 = np.zeros((2 * E_b,), np.int64)
    ev = np.zeros((2 * E_b,), bool)
    ii2[:n_e], jj2[:n_e], ev[:n_e] = ii_c, jj_c, True
    ii2[E_b:E_b + n_e], jj2[E_b:E_b + n_e] = jj_c, ii_c
    ev[E_b:E_b + n_e] = True
    u_pad = np.zeros((P_pad,), np.int64)
    u_pad[:P] = unique
    dev = X.device

    def put(a):
        return torch.from_numpy(a).to(dev)

    def two(a, b):
        z = torch.zeros((E_b - n_e,) + tuple(a.shape[1:]), dtype=a.dtype,
                        device=dev)
        return torch.cat([a, z, b, z])

    u = put(u_pad)
    Xs = X[u]
    Cs = C[u, :, 0] / torch.clamp(N[u], min=1)[:, None].to(C.dtype)
    pre = _pregather(Xs, Cs, put(ii2), put(jj2),
                     two(idx_ii2jj, idx_jj2ii).long(), two(vmj, vmi),
                     two(Qj, Qi), put(ev), cfg, (w, h))
    Twc = gauss_newton(T_WC[u], pre, put(ii2), put(jj2), cfg, tf32)
    out = T_WC.clone()
    out[put(unique[cfg.pin:])] = Twc[cfg.pin:P]
    return out
