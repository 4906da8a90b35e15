"""Dense iterative projective matching in plain PyTorch: the benchmark's
reference for the port's ``ops/matching.py::match``.

A frozen copy of the port's plain math with every table read as a plain
gather (no packed table, no kernel): the LM projection on the float16 ray
field, the 3D occlusion gate and the coarse-to-fine window argmax of int8
descriptor products, one probe at a time, with the production schedule
(LM on the quarter grid, coarse walk on the half grid, a per-pixel final
pass).  Integer sums are exact, so on the same inputs it gives the
program's matches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class MatchCfg(NamedTuple):
    max_iter: int
    lambda_init: float
    convergence_thresh: float
    dist_thresh: float
    radius: int
    dilation_max: int
    coarse_subsample: int
    final_radius: int
    coarse_radius: int
    dilation_schedule: tuple
    lm_subsample: int
    occlusion_subsample: int

    @classmethod
    def from_dict(cls, d: dict) -> "MatchCfg":
        if int(d.get("desc_bits", 8)) != 8 or \
                int(d.get("coarse_bits", 8)) != 8 or \
                int(d.get("lm_table_subsample", 1)) != 1 or \
                not d.get("desc_prenorm", True):
            raise ValueError("the reference matcher takes int8 tables, 8-bit "
                             "coarse tables and a full-resolution ray field")
        return cls(int(d["max_iter"]), float(d["lambda_init"]),
                   float(d["convergence_thresh"]), float(d["dist_thresh"]),
                   int(d["radius"]), int(d["dilation_max"]),
                   int(d.get("coarse_subsample", 1)),
                   int(d.get("final_radius", 0)),
                   int(d.get("coarse_radius", 0)),
                   tuple(int(x) for x in d.get("dilation_schedule", ())),
                   int(d.get("lm_subsample", 0)),
                   int(d.get("occlusion_subsample", 1)))


def pixel_to_lin(p, w):
    return p[..., 0] + w * p[..., 1]


def lin_to_pixel(idx, w):
    return torch.stack([idx % w, idx // w], dim=-1)


def _normalize(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


def _sum3(a):
    return a[..., 0] + a[..., 1] + a[..., 2]


def img_gradient(img):
    """Scharr-like gradients of (b, h, w, c) with reflect padding."""
    h, w = img.shape[-3], img.shape[-2]
    p = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    p = p.permute(0, 2, 3, 1)

    def sh(dy, dx):
        return p[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w, :]

    gx = (1.0 / 32.0) * (3.0 * (sh(-1, 1) - sh(-1, -1))
                         + 10.0 * (sh(0, 1) - sh(0, -1))
                         + 3.0 * (sh(1, 1) - sh(1, -1)))
    gy = (1.0 / 32.0) * (3.0 * (sh(1, -1) - sh(-1, -1))
                         + 10.0 * (sh(1, 0) - sh(-1, 0))
                         + 3.0 * (sh(1, 1) - sh(-1, 1)))
    return gx, gy


def _bilinear(table, w, u, v):
    """Bilinear sample of the (b, hw, c) table at float (u, v) (b, n), the
    four corners read one by one, arithmetic in float32."""
    b, n = u.shape
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = (u - u0)[..., None], (v - v0)[..., None]
    base = (v0 * w + u0).to(torch.int64)
    bi = torch.arange(b, device=u.device)[:, None]

    def at(off):
        return table[bi, base + off].float()

    return (1 - du) * (1 - dv) * at(0) + du * (1 - dv) * at(1) \
        + (1 - du) * dv * at(w) + du * dv * at(w + 1)


def _ray_cost(table, w, u, v, pts3d_norm):
    s = _bilinear(table, w, u, v)
    ray = s[..., 0:3]
    norm = torch.sqrt(torch.clamp(_sum3(ray * ray), min=1e-24))[..., None]
    err = ray / norm - pts3d_norm
    return _sum3(err * err), err, s[..., 3:6], s[..., 6:9]


def iter_proj(rays_with_grad, pts3d_norm, p_init, cfg: MatchCfg):
    """Per-pixel Levenberg-Marquardt on the float16 ray field."""
    b, h, w, _ = rays_with_grad.shape
    table = rays_with_grad.reshape(b, h * w, 9).to(torch.float16)
    u = torch.clamp(p_init[..., 0], 1.0, w - 2.0)
    v = torch.clamp(p_init[..., 1], 1.0, h - 2.0)
    lam = torch.full_like(u, cfg.lambda_init)
    cost, err, gx, gy = _ray_cost(table, w, u, v, pts3d_norm)
    for _ in range(cfg.max_iter):
        A00 = _sum3(gx * gx) + lam
        A01 = _sum3(gx * gy)
        A11 = _sum3(gy * gy) + lam
        b0 = -_sum3(err * gx)
        b1 = -_sum3(err * gy)
        det = A00 * A11 - A01 * A01
        det_inv = 1.0 / torch.where(torch.abs(det) < 1e-24,
                                    torch.full_like(det, 1e-24), det)
        u_new = torch.clamp(u + det_inv * (A11 * b0 - A01 * b1), 1.0, w - 2.0)
        v_new = torch.clamp(v + det_inv * (-A01 * b0 + A00 * b1), 1.0,
                            h - 2.0)
        new_cost, new_err, new_gx, new_gy = _ray_cost(table, w, u_new, v_new,
                                                      pts3d_norm)
        acc = new_cost < cost
        acc3 = acc[..., None]
        u, v = torch.where(acc, u_new, u), torch.where(acc, v_new, v)
        cost = torch.where(acc, new_cost, cost)
        err = torch.where(acc3, new_err, err)
        gx = torch.where(acc3, new_gx, gx)
        gy = torch.where(acc3, new_gy, gy)
        lam = torch.where(acc, lam * 0.1, lam * 10.0)
    return torch.stack([u, v], dim=-1), cost < cfg.convergence_thresh


def refine(D11, D21, p1, radius, dilation_max, dilation_min=1):
    """Coarse-to-fine dilated window argmax of int8 descriptor products:
    probe k = i (2r + 1) + j at (u, v) offset (-rd + i d, -rd + j d);
    probes outside the image never win, the first maximum wins, and a
    query whose best score is <= 0 keeps its position."""
    b, h, w, f = D11.shape
    n = p1.shape[1]
    flat = D11.reshape(b, h * w, f)
    q = D21.to(torch.int32)[:, :, None, :]
    k_side = 2 * radius + 1
    K = k_side * k_side
    dev = D11.device
    bi = torch.arange(b, device=dev)[:, None, None]
    ko = torch.arange(K, device=dev)
    neg_inf = -(2 ** 30)
    uv = p1.to(torch.int64)
    for d in range(dilation_max, dilation_min - 1, -1):
        rd = radius * d
        u0, v0 = uv[..., 0], uv[..., 1]
        uu = u0[..., None] + ((ko // k_side) * d - rd)
        vv = v0[..., None] + ((ko % k_side) * d - rd)
        lin = vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)
        score = torch.empty((b, n, K), dtype=torch.int32, device=dev)
        for i in range(k_side):
            cols = slice(i * k_side, (i + 1) * k_side)
            cand = flat[bi, lin[..., cols]].to(torch.int32)
            score[..., cols] = (cand * q).sum(dim=-1, dtype=torch.int32)
        inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
        score = torch.where(inside, score, torch.full_like(score, neg_inf))
        sbest = score.max(dim=-1).values
        kbest = torch.where(score == sbest[..., None], ko, K).min(dim=-1).values
        keep = sbest <= 0
        uv = torch.stack(
            [torch.where(keep, u0, u0 + (kbest // k_side) * d - rd),
             torch.where(keep, v0, v0 + (kbest % k_side) * d - rd)], dim=-1)
    return uv


def _upsample2x_field(fh):
    def up_axis(a, axis):
        n = a.shape[axis]
        nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                        dim=axis)
        st = torch.stack([a, 0.5 * (a + nxt)], dim=axis + 1)
        shape = list(a.shape)
        shape[axis] = 2 * n
        return st.reshape(shape)

    return up_axis(up_axis(fh, 1), 2)


def q8(D):
    """Unit descriptors as int8 codes (scale 127)."""
    return torch.clamp(torch.round(D * 127.0), -127, 127).to(torch.int8)


def _grid(A, b, h, w, s):
    return A.reshape(b, h, w, -1)[:, ::s, ::s].reshape(
        b, (h // s) * (w // s), -1)


def _repeat2x2(A, b, h2, w2):
    return A.reshape(b, h2, w2).repeat_interleave(2, dim=1) \
        .repeat_interleave(2, dim=2).reshape(b, 4 * h2 * w2)


def _clip_pixels(p, h, w):
    return torch.stack([p[..., 0].clamp(0, w - 1), p[..., 1].clamp(0, h - 1)],
                       dim=-1)


def _occlusion_gate(X11, X21_q, p1_int, valid_proj2, h, w, dist_thresh):
    b = X11.shape[0]
    idx = pixel_to_lin(_clip_pixels(p1_int, h, w), w)
    X11_at = torch.gather(X11.reshape(b, h * w, 3), 1,
                          idx[..., None].expand(-1, -1, 3))
    return valid_proj2 & (torch.linalg.norm(X11_at - X21_q, dim=-1)
                          < dist_thresh)


def match(X11, X21, D11, D21, idx_init, cfg: MatchCfg):
    """X11, X21 (b, h, w, 3); D11, D21 (b, h, w, f) int8; idx_init (b, hw)
    or None.  Returns (idx (b, hw) int64, valid (b, hw, 1) bool)."""
    b, h, w = X21.shape[:3]
    hw = h * w
    even = h % 2 == 0 and w % 2 == 0
    half = cfg.coarse_subsample == 2 and even
    lm4 = half and cfg.lm_subsample == 4 and h % 4 == 0 and w % 4 == 0
    rays = _normalize(X11)
    gx, gy = img_gradient(rays)
    X21_flat = X21.reshape(b, hw, 3)
    pts = _normalize(X21_flat)
    if idx_init is None:
        idx_init = torch.arange(hw, device=X11.device)[None].expand(b, hw)
    p_init = lin_to_pixel(idx_init, w).to(X11.dtype)
    if half:
        s_lm = 4 if lm4 else 2
        pts, p_init = _grid(pts, b, h, w, s_lm), _grid(p_init, b, h, w, s_lm)
    p1, valid_proj2 = iter_proj(torch.cat([rays, gx, gy], dim=-1), pts,
                                p_init, cfg)
    h2, w2 = h // 2, w // 2
    if lm4:
        h4, w4 = h // 4, w // 4
        p1 = _upsample2x_field(p1.reshape(b, h4, w4, 2)).reshape(b, h2 * w2, 2)
        valid_proj2 = _repeat2x2(valid_proj2, b, h4, w4)
    D21_r = D21.reshape(b, hw, -1)
    if half:
        p1c = p1.to(torch.int64)
        D21_h = _grid(D21_r, b, h, w, 2)
        if cfg.dilation_max > 1:
            sched = cfg.dilation_schedule or \
                tuple(range(cfg.dilation_max, 1, -1))
            p1c = refine(D11, D21_h, p1c, cfg.radius, sched[0], sched[0])
            r_coarse = cfg.coarse_radius or cfg.radius
            for dd in sched[1:]:
                p1c = refine(D11, D21_h, p1c, r_coarse, dd, dd)
        occl_half = cfg.occlusion_subsample == 2
        if occl_half:
            valid = _repeat2x2(_occlusion_gate(
                X11, _grid(X21_flat, b, h, w, 2), p1.to(torch.int64),
                valid_proj2, h, w, cfg.dist_thresh), b, h2, w2)

        def up(P):
            return _upsample2x_field(
                P.to(torch.float32).reshape(b, h2, w2, 2)).reshape(b, hw, 2)

        p1 = up(p1)
        p1_start = _clip_pixels(torch.round(up(p1c)).to(torch.int64), h, w)
        valid_proj2 = _repeat2x2(valid_proj2, b, h2, w2)
    else:
        occl_half = False
        p1_start = p1.to(torch.int64)
    if not occl_half:
        valid = _occlusion_gate(X11, X21_flat, p1.to(torch.int64),
                                valid_proj2, h, w, cfg.dist_thresh)
    if half and cfg.final_radius < 0:
        p1_out = p1_start
    else:
        r_final = cfg.final_radius if (half and cfg.final_radius > 0) \
            else cfg.radius
        p1_out = refine(D11, D21_r, p1_start, r_final,
                        1 if half else cfg.dilation_max)
    return pixel_to_lin(p1_out, w), valid[..., None]
