"""Sim(3) Lie group on the 8-float embedding, in PyTorch.

Mirrors ``mast3r_slam_tpu/ops/lie_sim3.py``:

    T = [t(3), q(4, xyzw), s(1)]        acting as   X -> s * R(q) @ X + t

Tangent vectors are ``[tau(3), omega(3), sigma(1)]`` and retraction is on the
left, ``retr(T, xi) = exp(xi) * T``.  Every function batches over leading
dims and keeps the JAX version's order of operations.
"""

from __future__ import annotations

import torch

_EPS = 1e-6  # small-angle switch (lie_sim3.py:22)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(qi, qj):
    """Hamilton product qi * qj, xyzw (lie_sim3.py:29)."""
    xi, yi, zi, wi = qi.unbind(-1)
    xj, yj, zj, wj = qj.unbind(-1)
    return torch.stack(
        [
            wi * xj + xi * wj + yi * zj - zi * yj,
            wi * yj - xi * zj + yi * wj + zi * xj,
            wi * zj + xi * yj - yi * xj + zi * wj,
            wi * wj - xi * xj - yi * yj - zi * zj,
        ],
        dim=-1,
    )


def quat_inv(q):
    """Conjugate of a unit quaternion (lie_sim3.py:44)."""
    return q * q.new_tensor([-1.0, -1.0, -1.0, 1.0])


def quat_act(q, X):
    """Rotate X (..., 3) by unit quaternions q (..., 4) (lie_sim3.py:49)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    qv, X = torch.broadcast_tensors(qv, X)
    uv = 2.0 * _cross(qv, X)
    return X + qw * uv + _cross(qv, uv)


def identity(batch_shape=(), dtype=torch.float32, device=None):
    """Identity pose (lie_sim3.py:65)."""
    T = torch.zeros(tuple(batch_shape) + (8,), dtype=dtype, device=device)
    T[..., 6] = 1.0
    T[..., 7] = 1.0
    return T


def t_of(T):
    return T[..., 0:3]


def q_of(T):
    return T[..., 3:7]


def s_of(T):
    return T[..., 7:8]


def act(T, X):
    """s * R X + t (lie_sim3.py:89)."""
    return s_of(T) * quat_act(q_of(T), X) + t_of(T)


def mul(Ta, Tb):
    """Compose Ta * Tb (lie_sim3.py:94)."""
    t = s_of(Ta) * quat_act(q_of(Ta), t_of(Tb)) + t_of(Ta)
    q = quat_mul(q_of(Ta), q_of(Tb))
    s = s_of(Ta) * s_of(Tb)
    return torch.cat([t, q, s], dim=-1)


def inv(T):
    """Inverse (lie_sim3.py:102)."""
    s_inv = 1.0 / s_of(T)
    qi = quat_inv(q_of(T))
    t = -s_inv * quat_act(qi, t_of(T))
    return torch.cat([t, qi, s_inv], dim=-1)


def rel(Ti, Tj):
    """inv(Ti) * Tj (lie_sim3.py:110)."""
    si_inv = 1.0 / s_of(Ti)
    qi_inv = quat_inv(q_of(Ti))
    q = quat_mul(qi_inv, q_of(Tj))
    t = si_inv * quat_act(qi_inv, t_of(Tj) - t_of(Ti))
    s = si_inv * s_of(Tj)
    return torch.cat([t, q, s], dim=-1)


def _safe_sqrt(x):
    return torch.sqrt(torch.clamp(x, min=1e-24))


def exp_so3_quat(phi):
    """SO(3) exp to a quaternion with a Taylor branch near zero
    (lie_sim3.py:129)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = _safe_sqrt(theta_sq)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < _EPS
    imag = torch.where(
        small,
        0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4,
        torch.sin(0.5 * theta) / theta,
    )
    real = torch.where(
        small,
        1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4,
        torch.cos(0.5 * theta),
    )
    return torch.cat([imag * phi, real], dim=-1)


def _sim3_W_coeffs(theta_sq, sigma, scale):
    """(A, B, C) of W = C I + A Phi + B Phi^2 (lie_sim3.py:149)."""
    one = torch.ones_like(theta_sq)
    theta = _safe_sqrt(theta_sq)
    small_theta = theta_sq < _EPS * _EPS
    small_sigma = torch.abs(sigma) < _EPS

    th2_safe = torch.where(small_theta, one, theta_sq)
    th_safe = torch.where(small_theta, one, theta)
    sig_safe = torch.where(small_sigma, one, sigma)
    sig2_safe = sig_safe * sig_safe

    C1 = torch.ones_like(sigma)
    A1 = torch.where(small_theta, 0.5 * one, (1.0 - torch.cos(theta)) / th2_safe)
    B1 = torch.where(small_theta, one / 6.0,
                     (theta - torch.sin(theta)) / (th2_safe * th_safe))

    C2 = (scale - 1.0) / sig_safe
    A2a = ((sig_safe - 1.0) * scale + 1.0) / sig2_safe
    B2a = (scale * 0.5 * sig2_safe + scale - 1.0 - sig_safe * scale) / (
        sig2_safe * sig_safe)
    a = scale * torch.sin(theta)
    b = scale * torch.cos(theta)
    c = theta_sq + sigma * sigma
    c_safe = torch.where(c == 0.0, one, c)
    A2b = (a * sig_safe + (1.0 - b) * th_safe) / (th_safe * c_safe)
    B2b = (C2 - ((b - 1.0) * sig_safe + a * th_safe) / c_safe) / th2_safe

    A2 = torch.where(small_theta, A2a, A2b)
    B2 = torch.where(small_theta, B2a, B2b)
    A = torch.where(small_sigma, A1, A2)
    B = torch.where(small_sigma, B1, B2)
    C = torch.where(small_sigma, C1, C2)
    return A, B, C


def exp(xi):
    """Sim(3) exponential: (..., 7) -> (..., 8) (lie_sim3.py:194)."""
    tau = xi[..., 0:3]
    phi = xi[..., 3:6]
    sigma = xi[..., 6:7]
    scale = torch.exp(sigma)
    q = exp_so3_quat(phi)
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    A, B, C = _sim3_W_coeffs(theta_sq, sigma, scale)
    phi_x_tau = _cross(phi, tau)
    phi_x_phi_x_tau = _cross(phi, phi_x_tau)
    t = C * tau + A * phi_x_tau + B * phi_x_phi_x_tau
    return torch.cat([t, q, scale], dim=-1)


def normalize(T):
    """Re-impose ||q|| = 1 (lie_sim3.py:212).  Without it the pose recursion
    amplifies fp32 rounding in ||q|| geometrically and poses go NaN over
    long drives."""
    q = q_of(T)
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    qn = q / torch.clamp(n, min=1e-12)
    return torch.cat([t_of(T), qn, s_of(T)], dim=-1)


def retr(T, xi):
    """Left retraction exp(xi) * T, quaternion re-normalised
    (lie_sim3.py:234)."""
    return normalize(mul(exp(xi), T))


def apply_adj_inv(T, v):
    """Row-vector application of the inverse adjoint: turns a local
    (camera-i frame) Jacobian row into a world-frame one
    (lie_sim3.py:242).  v (..., 7) ordered [a(3), b(3), c(1)]; T is the
    world pose T_WCi."""
    t, q, s = t_of(T), q_of(T), s_of(T)
    s_inv = 1.0 / s
    a, b, c = v[..., 0:3], v[..., 3:6], v[..., 6:7]
    Ra = quat_act(q, a)
    y0 = s_inv * Ra
    y1 = quat_act(q, b) + s_inv * _cross(t.expand_as(Ra), Ra)
    y2 = c + s_inv * torch.sum(t * Ra, dim=-1, keepdim=True)
    return torch.cat([y0, y1, y2], dim=-1)


def quat_rot_entries(q):
    """The 9 rotation-matrix entries of unit quaternions q (..., 4) as a 3x3
    nested tuple (lie_sim3.py:268)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )
