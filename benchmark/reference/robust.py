"""Huber weight, GN convergence test and the small SPD solve: a frozen copy
of the port's plain math (``mast3r_slam_torch/ops/robust.py``)."""

from __future__ import annotations

import torch


def huber(r, k: float = 1.345):
    """IRLS Huber weight: 1 inside |r| < k, k/|r| outside (robust.py:15)."""
    r_abs = torch.abs(r)
    return torch.where(r_abs < k, torch.ones_like(r_abs),
                       k / torch.clamp(r_abs, min=1e-12))


def check_convergence(rel_error_threshold, delta_norm_threshold, old_cost,
                      new_cost, delta):
    """Relative cost decrease or update norm below threshold
    (robust.py:30)."""
    old_cost = torch.as_tensor(old_cost, dtype=new_cost.dtype,
                               device=new_cost.device)
    finite = torch.isfinite(old_cost)
    old_safe = torch.where(finite & (old_cost != 0.0), old_cost,
                           torch.ones_like(old_cost))
    rel_dec = torch.abs((old_cost - new_cost) / old_safe)
    rel_ok = finite & (rel_dec < rel_error_threshold)
    return rel_ok | (torch.linalg.norm(delta) < delta_norm_threshold)


def solve_spd_small(H, g):
    """Unrolled LDL^T solve of a small SPD system H x = g with Jacobi
    prescaling (robust.py:39).  Returns (x, ok); ok is False when a pivot is
    non-positive or non-finite.

    The prescale by D^{-1/2} brings every pivot of the Sim(3) normal
    equations to ~1; without it fp32 loses the pivots to cancellation on
    scenes with large depth and the tracker drops to relocalization.
    """
    n = H.shape[0]
    dscale = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
    g = g * dscale
    H = H * dscale[:, None] * dscale[None, :]
    L = [[None] * n for _ in range(n)]
    d = [None] * n
    dinv = [None] * n
    ok = torch.ones((), dtype=torch.bool, device=H.device)
    for j in range(n):
        dj = H[j, j]
        for k in range(j):
            dj = dj - L[j][k] * L[j][k] * d[k]
        ok = ok & (dj > 0) & torch.isfinite(dj)
        d[j] = dj
        dinv[j] = 1.0 / torch.where(dj > 0, dj, torch.ones_like(dj))
        for i in range(j + 1, n):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * d[k]
            L[i][j] = s * dinv[j]
    z = [None] * n
    for i in range(n):
        s = g[i]
        for k in range(i):
            s = s - L[i][k] * z[k]
        z[i] = s
    x = [None] * n
    for i in reversed(range(n)):
        xi = z[i] * dinv[i]
        for k in range(i + 1, n):
            xi = xi - L[k][i] * x[k]
        x[i] = xi
    return torch.stack(x) * dscale, ok
