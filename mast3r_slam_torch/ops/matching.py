"""Dense iterative projective matching.

Mirrors ``mast3r_slam_tpu/ops/matching.py`` (config :33-166, ``iter_proj``
:211-342, ``refine_matches`` :345-557, ``match`` :601-800):

* ``iter_proj``: per-pixel Levenberg-Marquardt on a bilinearly sampled
  unit-ray field with the f16 ray table and the evaluate/propose/accept
  schedule;
* the 3D-distance occlusion gate at the LM positions;
* ``refine_matches``: dilated window argmax of descriptor dot products,
  u-major probe order, first maximum wins;
* ``match``: the pipeline with every knob of the JAX ``MatchingConfig``: the
  reference-exact walk (``coarse_subsample 1``) and the production one (LM
  on the quarter grid, coarse walk on the half grid with a thinned dilation
  schedule, per-pixel final pass at a small radius).

As in the JAX package every stage fetches from a pre-packed table built once
per stage by ``ops.pack.pack_rows`` (``csrc/pack.cu`` on the card): the four
bilinear corners of the ray table are one gathered row, and each dilation of
the refine gathers ``ceil(k_side / u_pack)`` rows per query that hold whole
probe columns.  ``refine_matches_probes`` states the same window argmax one
probe at a time; the tests hold the packed path against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .image import img_gradient
from .pack import _offsets, pack_rows


class MatchingConfig(NamedTuple):
    """The matcher's parameters, field for field the JAX ``MatchingConfig``
    (matching.py:33), whose comments say what each knob trades.  The
    ``desc_global_*`` gates and ``edge_query_subsample`` are stored for the
    retrieval and backend paths and read by nothing in the frontend."""
    max_iter: int = 10
    lambda_init: float = 1e-8
    convergence_thresh: float = 1e-6
    dist_thresh: float = 1e-1
    radius: int = 3
    dilation_max: int = 5
    desc_bits: int = 8            # refine tables: 8 (int8) | 16 (bf16)
    desc_prenorm: bool = True     # descriptors are unit vectors: scale 127
    coarse_subsample: int = 1     # 2: LM + coarse walk on the half grid
    coarse_bits: int = 8          # 4: nibble tables for dilations > 1
    final_radius: int = 0         # final d=1 pass (0 = radius, -1 = skip)
    coarse_radius: int = 0        # inner coarse dilations (0 = radius)
    dilation_schedule: tuple = ()  # coarse dilations (() = dilation_max..2)
    lm_table_subsample: int = 1   # 2: LM ray table from the half-res pointmap
    lm_subsample: int = 0         # 4: LM queries on the quarter grid
    occlusion_subsample: int = 1  # 2: occlusion gate on the half grid
    edge_query_subsample: int = 1
    desc_global_mutual_px: int = 2
    desc_global_min_cos: float = 0.85
    desc_global_min_margin: float = 0.1
    desc_global_max_mult: int = 8

    @classmethod
    def from_dict(cls, d: dict) -> "MatchingConfig":
        """From a config's ``matching`` block (matching.py:141)."""
        return cls(
            max_iter=int(d["max_iter"]),
            lambda_init=float(d["lambda_init"]),
            convergence_thresh=float(d["convergence_thresh"]),
            dist_thresh=float(d["dist_thresh"]),
            radius=int(d["radius"]),
            dilation_max=int(d["dilation_max"]),
            desc_bits=int(d.get("desc_bits", 8)),
            desc_prenorm=bool(d.get("desc_prenorm", True)),
            coarse_bits=int(d.get("coarse_bits", 8)),
            coarse_subsample=int(d.get("coarse_subsample", 1)),
            final_radius=int(d.get("final_radius", 0)),
            coarse_radius=int(d.get("coarse_radius", 0)),
            dilation_schedule=tuple(
                int(x) for x in d.get("dilation_schedule", ())),
            lm_table_subsample=int(d.get("lm_table_subsample", 1)),
            lm_subsample=int(d.get("lm_subsample", 0)),
            occlusion_subsample=int(d.get("occlusion_subsample", 1)),
            edge_query_subsample=int(d.get("edge_query_subsample", 1)),
            desc_global_mutual_px=int(d.get("desc_global_mutual_px", 2)),
            desc_global_min_cos=float(d.get("desc_global_min_cos", 0.85)),
            desc_global_min_margin=float(
                d.get("desc_global_min_margin", 0.1)),
            desc_global_max_mult=int(d.get("desc_global_max_mult", 8)),
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


def prep_for_iter_proj(X11, X21, idx_1_to_2_init, table_subsample: int = 1):
    """The 9-channel ray+gradient image, normalised target points and the
    initial pixel guesses (matching.py:186).  X11, X21: (b, h, w, 3);
    idx init (b, h*w) or None (identity).  ``table_subsample`` > 1 builds
    the ray field from the subsampled pointmap; ``p_init`` is then in table
    coordinates (full-res position / s)."""
    b, h, w, _ = X11.shape
    s = max(int(table_subsample), 1)
    rays = _normalize(X11[:, ::s, ::s] if s > 1 else X11)
    gx, gy = img_gradient(rays)
    rays_with_grad = torch.cat([rays, gx, gy], dim=-1)
    pts3d_norm = _normalize(X21.reshape(b, h * w, 3))
    if idx_1_to_2_init is None:
        idx_1_to_2_init = torch.arange(h * w, device=X11.device)[None] \
            .expand(b, h * w)
    p_init = lin_to_pixel(idx_1_to_2_init, w).to(X11.dtype)
    if s > 1:
        p_init = p_init / float(s)
    return rays_with_grad, pts3d_norm, p_init


def _pack_corners(table, w):
    """Corner-packed table: row m = [t[m], t[m+1], t[m+w], t[m+w+1]]
    (matching.py:211), so the four bilinear corners are one gathered row."""
    return pack_rows(table, (0, 1, w, w + 1))


def _bilinear_packed(packed, w, u, v):
    """Bilinear sample from a corner-packed table at float (u, v) (b, n),
    in f32: (b, n, c) (matching.py:229).  The caller keeps u in [1, w-2]
    and v in [1, h-2], so all four corners are inside the image."""
    b, n = u.shape
    c = packed.shape[-1] // 4
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    du = (u - u0)[..., None]
    dv = (v - v0)[..., None]
    base = (v0 * w + u0).to(torch.int64)
    bi = torch.arange(b, device=u.device)[:, None]
    g = packed[bi, base].reshape(b, n, 4, c).float()
    # packed order: (v0,u0), (v0,u0+1), (v0+1,u0), (v0+1,u0+1)
    w22 = (1 - du) * (1 - dv)
    w21 = du * (1 - dv)
    w12 = (1 - du) * dv
    w11 = du * dv
    return w22 * g[:, :, 0] + w21 * g[:, :, 1] + w12 * g[:, :, 2] \
        + w11 * g[:, :, 3]


def _ray_cost(packed, w, u, v, pts3d_norm):
    """Sample and normalise the ray at (u, v): (cost (b, n), err, gx, gy
    (b, n, 3)) (matching.py:259)."""
    s = _bilinear_packed(packed, w, u, v)
    ray = s[..., 0:3]
    norm = torch.sqrt(torch.clamp(_sum3(ray * ray), min=1e-24))[..., None]
    err = ray / norm - pts3d_norm
    return _sum3(err * err), err, s[..., 3:6], s[..., 6:9]


def iter_proj(rays_with_grad_img, pts3d_norm, p_init, max_iter=10,
              lambda_init=1e-8, cost_thresh=1e-6, table_f16=True):
    """Per-pixel LM projection solve (matching.py:272).

    rays_with_grad_img (b, h, w, 9); pts3d_norm (b, n, 3); p_init (b, n, 2)
    float.  Returns (p (b, n, 2) float, converged (b, n) bool).  The ray
    table is stored as f16 (``table_f16``) and corner-packed once per call;
    all arithmetic is f32.  The sampled state at the current iterate is
    carried, so each iteration gathers only at the trial point, with the
    reference's iterate sequence.
    """
    b, h, w, _ = rays_with_grad_img.shape
    table = rays_with_grad_img.reshape(b, h * w, 9)
    if table_f16:
        table = table.to(torch.float16)
    packed = _pack_corners(table.contiguous(), w)
    u = torch.clamp(p_init[..., 0], 1.0, w - 2.0)
    v = torch.clamp(p_init[..., 1], 1.0, h - 2.0)
    lam = torch.full_like(u, lambda_init)
    cost, err, gx, gy = _ray_cost(packed, w, u, v, pts3d_norm)
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
            packed, w, u_new, v_new, pts3d_norm)
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


def _window_best(score, uv, k_side, d, rd, h, w, neg_inf):
    """The window argmax of one dilation: mask the probes outside the
    image, take the first maximum in u-major probe order, and keep the
    centre when no score is positive (matching.py:485-504).  score
    (b, n, K); uv (b, n, 2) int64.  Returns (uv', best score)."""
    K = k_side * k_side
    ko = torch.arange(K, device=score.device)
    u0, v0 = uv[..., 0], uv[..., 1]
    uu = u0[..., None] + ((ko // k_side) * d - rd)     # (b, n, K)
    vv = v0[..., None] + ((ko % k_side) * d - rd)
    inside = (uu >= 0) & (uu < w) & (vv >= 0) & (vv < h)
    score = torch.where(inside, score, torch.full_like(score, neg_inf))
    sbest = score.max(dim=-1).values
    # argmax does not promise the first index on the card: take it by hand
    kbest = torch.where(score == sbest[..., None], ko, K).min(dim=-1).values
    keep = sbest <= 0
    ub = torch.where(keep, u0, u0 + (kbest // k_side) * d - rd)
    vb = torch.where(keep, v0, v0 + (kbest % k_side) * d - rd)
    return torch.stack([ub, vb], dim=-1), sbest


def refine_matches(D11, D21, p1, radius=3, dilation_max=5, u_pack=2,
                   coarse_bits=8, dilation_min=1, return_score=False):
    """Coarse-to-fine dilated window argmax of descriptor dot products
    (matching.py:350), fetched from packed tables.

    D11 (b, h, w, f) descriptor image (int8, bf16, f16 or f32); D21
    (b, n, f) query descriptors; p1 (b, n, 2) int pixel guesses inside the
    image.  Probe k = i*(2r+1) + j sits at offset (u, v) = (-rd + i*d,
    -rd + j*d) (u-major); probes outside the image never win; the first
    maximum wins; a query whose best score is <= 0 keeps its position.
    Returns (b, n, 2) int64, with ``return_score`` also the last dilation's
    best score (b, n).

    Per dilation the table is packed once (``pack_rows``): row m holds
    ``u_pack`` probe columns of ``k_side`` descriptors each, and every query
    gathers ``ceil(k_side / u_pack)`` rows.  The table covers rows
    ``[-rd, hw + rd)``, zero outside the image, and row ``base + du`` is
    gathered with no modular wrap: a probe inside the image then reads its
    own descriptor for every query, and every other probe is masked, which
    is what the JAX version's roll-and-wrap tables give.  ``coarse_bits 4``
    nibble-packs the table for dilations > 1 (queries stay int8).  The JAX
    ``qmajor=False`` variant is a TPU layout of the same function and is
    not ported.
    """
    b, h, w, f = D11.shape
    n = p1.shape[1]
    hw = h * w
    flat = D11.reshape(b, hw, f).contiguous()
    integer = not D11.dtype.is_floating_point
    acc_t = torch.int32 if integer else torch.float32
    neg_inf = -(2 ** 30) if integer else float("-inf")
    q = D21.to(D11.dtype).to(acc_t)                        # (b, n, f)
    k_side = 2 * radius + 1
    dev = D11.device
    bi = torch.arange(b, device=dev)[:, None]

    use_int4 = coarse_bits == 4 and integer and dilation_max > 1
    if use_int4:
        # two 4-bit table values per byte, odd feature in the high nibble
        # (matching.py:388-398); |q4| <= 7, so the byte fits int8 unwrapped
        fe = f + (f % 2)
        q4 = torch.round(F.pad(flat, (0, fe - f)).float() * (7.0 / 127.0)) \
            .to(torch.int32)
        flat4 = ((q4[..., 1::2] << 4) | (q4[..., 0::2] & 15)) \
            .to(torch.int8).contiguous()
        q_pad = F.pad(q, (0, fe - f))
        q_even = q_pad[..., 0::2][:, :, None, :]
        q_odd = q_pad[..., 1::2][:, :, None, :]

    uv = p1.to(torch.int64)
    sbest = None
    P = max(1, min(u_pack, k_side))
    for d in range(dilation_max, dilation_min - 1, -1):
        int4 = use_int4 and d > 1
        tbl = flat4 if int4 else flat
        fb = tbl.shape[-1]
        rd = radius * d
        packed = pack_rows(tbl, _offsets(k_side, d, rd, w, P), row0=-rd,
                           n_rows=hw + 2 * rd)   # (b, hw + 2rd, P*k_side*fb)
        base = uv[..., 1] * w + uv[..., 0]
        blocks = []
        for i0 in range(0, k_side, P):
            # packed row base + du holds probe columns i0 .. i0 + P - 1
            cand = packed[bi, base + (i0 * d - rd) + rd] \
                .reshape(b, n, P * k_side, fb)
            if int4:
                c32 = cand.to(torch.int32)
                lo = ((c32 & 15) ^ 8) - 8
                hi = c32 >> 4
                blk = (lo * q_even + hi * q_odd).sum(-1, dtype=acc_t)
            else:
                blk = (cand.to(acc_t) * q[:, :, None, :]).sum(-1, dtype=acc_t)
            # the last group may carry columns beyond k_side
            blocks.append(blk[..., :min(P, k_side - i0) * k_side])
        score = torch.cat(blocks, dim=-1)                  # (b, n, K)
        uv, sbest = _window_best(score, uv, k_side, d, rd, h, w, neg_inf)
    if return_score:
        return uv, sbest
    return uv


def refine_matches_probes(D11, D21, p1, radius=3, dilation_max=5,
                          dilation_min=1):
    """The window argmax of ``refine_matches`` stated one probe at a time,
    with plain gathers and no packed table: an independent statement of the
    same function for the tests, used by nothing on the main path."""
    b, h, w, f = D11.shape
    n = p1.shape[1]
    flat = D11.reshape(b, h * w, f)
    integer = not D11.dtype.is_floating_point
    acc_t = torch.int32 if integer else torch.float32
    neg_inf = -(2 ** 30) if integer else float("-inf")
    q = D21.to(D11.dtype).to(acc_t)[:, :, None, :]
    k_side = 2 * radius + 1
    K = k_side * k_side
    dev = D11.device
    bi = torch.arange(b, device=dev)[:, None, None]
    ko = torch.arange(K, device=dev)
    uv = p1.to(torch.int64)
    for d in range(dilation_max, dilation_min - 1, -1):
        rd = radius * d
        uu = uv[..., 0, None] + ((ko // k_side) * d - rd)  # (b, n, K)
        vv = uv[..., 1, None] + ((ko % k_side) * d - rd)
        lin = vv.clamp(0, h - 1) * w + uu.clamp(0, w - 1)
        score = torch.empty((b, n, K), dtype=acc_t, device=dev)
        for i in range(k_side):  # one probe column at a time bounds memory
            cols = slice(i * k_side, (i + 1) * k_side)
            cand = flat[bi, lin[..., cols]].to(acc_t)       # (b, n, k, f)
            score[..., cols] = (cand * q).sum(dim=-1, dtype=acc_t)
        uv, _ = _window_best(score, uv, k_side, d, rd, h, w, neg_inf)
    return uv


def _upsample2x_field(fh):
    """2x linear upsampling of a field sampled on the even-pixel grid:
    out[2i] = in[i], out[2i+1] = (in[i] + in[i+1]) / 2, edge-clamped
    (matching.py:560).  fh (b, h2, w2, c) float -> (b, 2*h2, 2*w2, c)."""

    def up_axis(a, axis):
        n = a.shape[axis]
        nxt = torch.cat([a.narrow(axis, 1, n - 1), a.narrow(axis, n - 1, 1)],
                        dim=axis)
        st = torch.stack([a, 0.5 * (a + nxt)], dim=axis + 1)
        shape = list(a.shape)
        shape[axis] = 2 * n
        return st.reshape(shape)

    return up_axis(up_axis(fh, 1), 2)


def _q8_pair(D11, D21_flat, prenorm=True):
    """Symmetric int8 descriptor tables (matching.py:580).  With per-pixel
    L2-normalised descriptors the fixed scale 127 is exact; the window
    argmax is invariant to the scale, so nothing is dequantised."""

    def q8(D):
        s = 127.0 if prenorm else \
            127.0 / torch.clamp(torch.max(torch.abs(D)), min=1e-12)
        return torch.clamp(torch.round(D * s), -127, 127).to(torch.int8)

    return q8(D11), q8(D21_flat)


def _grid(A, b, h, w, s):
    """(b, h*w, c) -> its (::s, ::s) query subgrid (b, (h/s)*(w/s), c)."""
    return A.reshape(b, h, w, -1)[:, ::s, ::s].reshape(
        b, (h // s) * (w // s), -1)


def _repeat2x2(A, b, h2, w2):
    """(b, h2*w2) -> (b, 2*h2 * 2*w2), each value replicated 2x2."""
    return A.reshape(b, h2, w2).repeat_interleave(2, dim=1) \
        .repeat_interleave(2, dim=2).reshape(b, 4 * h2 * w2)


def _clip_pixels(p, h, w):
    """(..., 2) pixels clipped into the image (no host-to-device copy)."""
    return torch.stack([p[..., 0].clamp(0, w - 1), p[..., 1].clamp(0, h - 1)],
                       dim=-1)


def _occlusion_gate(X11, X21_q, p1_int, valid_proj2, h, w, dist_thresh):
    """3D distance between each query point and the table point at its LM
    position, under ``dist_thresh`` (matching.py:777-784)."""
    b = X11.shape[0]
    idx = pixel_to_lin(_clip_pixels(p1_int, h, w), w)
    X11_at = torch.gather(X11.reshape(b, h * w, 3), 1,
                          idx[..., None].expand(-1, -1, 3))
    dists = torch.linalg.norm(X11_at - X21_q, dim=-1)
    return valid_proj2 & (dists < dist_thresh)


def _grids(cfg: MatchingConfig, h, w):
    """(half, lm4, lmt): which of the subsampled stages run at this size
    (matching.py:623-629)."""
    even = h % 2 == 0 and w % 2 == 0
    half = cfg.coarse_subsample == 2 and even
    lm4 = half and cfg.lm_subsample == 4 and h % 4 == 0 and w % 4 == 0
    lmt = cfg.lm_table_subsample == 2 and even
    return half, lm4, lmt


def match_lm(X11, X21, idx_1_to_2_init=None,
             cfg: MatchingConfig = MatchingConfig()):
    """The LM stage of ``match`` (matching.py:620-644): prepares the ray
    table and runs ``iter_proj`` on the full, half or quarter query grid.
    Returns ``iter_proj``'s (p (b, nq, 2) float in table coordinates,
    converged (b, nq))."""
    b, h, w = X21.shape[:3]
    half, lm4, lmt = _grids(cfg, h, w)
    rays_img, pts3d_norm, p_init = prep_for_iter_proj(
        X11, X21, idx_1_to_2_init, table_subsample=2 if lmt else 1)
    if half:
        s_lm = 4 if lm4 else 2
        pts3d_norm = _grid(pts3d_norm, b, h, w, s_lm)
        p_init = _grid(p_init, b, h, w, s_lm)
    return iter_proj(
        rays_img, pts3d_norm, p_init, max_iter=cfg.max_iter,
        lambda_init=cfg.lambda_init, cost_thresh=cfg.convergence_thresh)


def match_after_lm(X11, X21, D11, D21, p1, valid_proj2,
                   cfg: MatchingConfig = MatchingConfig(),
                   query_subsample: int = 1):
    """Everything of ``match`` after the LM stage (matching.py:645-800),
    from ``iter_proj``'s positions and convergence flags: all of it is
    integer or exactly rounded arithmetic, so on the same LM output it
    gives the JAX result bit for bit."""
    b, h, w = X21.shape[:3]
    hw = h * w
    half, lm4, lmt = _grids(cfg, h, w)
    qsub = query_subsample == 2 and half and cfg.radius > 0
    h2, w2 = h // 2, w // 2
    X21_flat = X21.reshape(b, hw, 3)
    if lmt:
        p1 = p1 * 2.0  # table coordinates -> full-res pixels
    if lm4:
        # LM ran on the quarter grid: interpolate its position field up to
        # the half grid for the refine walk
        h4, w4 = h // 4, w // 4
        p1 = _upsample2x_field(p1.reshape(b, h4, w4, 2)) \
            .reshape(b, h2 * w2, 2)
        valid_proj2 = _repeat2x2(valid_proj2, b, h4, w4)

    if cfg.radius > 0:
        D21_flat = D21.reshape(b, hw, -1)
        if not D11.dtype.is_floating_point:
            D11_r, D21_r = D11, D21_flat     # pre-quantised int8 tables
        elif cfg.desc_bits == 8:
            D11_r, D21_r = _q8_pair(D11, D21_flat, cfg.desc_prenorm)
        else:
            D11_r = D11.to(torch.bfloat16)
            D21_r = D21_flat.to(torch.bfloat16)

    def final_u_pack(r):
        return (2 * r + 1) if r <= 2 else 2

    if half:
        # coarse refine walk on the half grid (queries are the even-pixel
        # descriptors; the table stays full-resolution)
        p1c = p1.to(torch.int64)
        if cfg.radius > 0:
            D21_h = _grid(D21_r, b, h, w, 2)
        if cfg.radius > 0 and cfg.dilation_max > 1:
            # coarsest dilation at the full radius, inner dilations at
            # coarse_radius
            sched = cfg.dilation_schedule or \
                tuple(range(cfg.dilation_max, 1, -1))
            p1c = refine_matches(
                D11_r, D21_h, p1c, radius=cfg.radius, dilation_max=sched[0],
                coarse_bits=cfg.coarse_bits, dilation_min=sched[0])
            if len(sched) > 1:
                r_coarse = cfg.coarse_radius if cfg.coarse_radius > 0 \
                    else cfg.radius
                up = final_u_pack(r_coarse)
                contiguous = sched[1:] == tuple(
                    range(sched[1], sched[-1] - 1, -1))
                runs = [(sched[1], sched[-1])] if contiguous else \
                    [(dd, dd) for dd in sched[1:]]
                for d_hi, d_lo in runs:
                    p1c = refine_matches(
                        D11_r, D21_h, p1c, radius=r_coarse,
                        dilation_max=d_hi, coarse_bits=cfg.coarse_bits,
                        dilation_min=d_lo, u_pack=up)
        if qsub or cfg.occlusion_subsample == 2:
            # occlusion gate where the LM positions live (half grid)
            valid_h = _occlusion_gate(
                X11, _grid(X21_flat, b, h, w, 2), p1.to(torch.int64),
                valid_proj2, h, w, cfg.dist_thresh)
        if qsub:
            # subgrid output: the final refine runs on the half-grid
            # queries and the outputs stay on the (::2, ::2) grid
            if cfg.final_radius < 0:
                p1f = p1c
            else:
                r_final = cfg.final_radius if cfg.final_radius > 0 \
                    else cfg.radius
                p1f = refine_matches(
                    D11_r, D21_h, p1c, radius=r_final, dilation_max=1,
                    coarse_bits=cfg.coarse_bits,
                    u_pack=final_u_pack(r_final))
            return pixel_to_lin(p1f, w), valid_h[..., None]

        occl_half = cfg.occlusion_subsample == 2
        if occl_half:
            valid = _repeat2x2(valid_h, b, h2, w2)

        def up(P):   # interpolate a half-grid position field to full res
            return _upsample2x_field(
                P.to(torch.float32).reshape(b, h2, w2, 2)).reshape(b, hw, 2)

        p1 = up(p1)                      # pre-refine (occlusion check)
        p1_start = _clip_pixels(torch.round(up(p1c)).to(torch.int64), h, w)
        valid_proj2 = _repeat2x2(valid_proj2, b, h2, w2)
    else:
        occl_half = False
        p1_start = p1.to(torch.int64)   # truncation; LM positions are >= 1

    if not occl_half:
        valid = _occlusion_gate(X11, X21_flat, p1.to(torch.int64),
                                valid_proj2, h, w, cfg.dist_thresh)

    if cfg.radius > 0 and not (half and cfg.final_radius < 0):
        r_final = cfg.final_radius if (half and cfg.final_radius > 0) \
            else cfg.radius
        p1_out = refine_matches(
            D11_r, D21_r, p1_start, radius=r_final,
            dilation_max=1 if half else cfg.dilation_max,
            coarse_bits=cfg.coarse_bits,
            u_pack=final_u_pack(r_final) if half else 2)
    else:
        p1_out = p1_start
    return pixel_to_lin(p1_out, w), valid[..., None]


def match(X11, X21, D11, D21, idx_1_to_2_init=None,
          cfg: MatchingConfig = MatchingConfig(), query_subsample: int = 1):
    """Dense matching (matching.py:601).  X11, X21 (b, h, w, 3); D11, D21
    (b, h, w, f) float or pre-quantised int8.  Returns (idx_1_to_2
    (b, h*w) int64, valid (b, h*w, 1) bool).

    With ``coarse_subsample 2`` the LM projection and the dilation > 1
    refine run on the half-resolution query grid (the LM on the quarter
    grid under ``lm_subsample 4``) and only the final d=1 refine is per
    pixel.  ``query_subsample 2`` (factor-graph edges; needs
    ``coarse_subsample 2``) keeps the final refine and the gate on the
    (::2, ::2) grid too and returns subgrid-sized outputs.
    """
    p1, valid_proj2 = match_lm(X11, X21, idx_1_to_2_init, cfg)
    return match_after_lm(X11, X21, D11, D21, p1, valid_proj2, cfg,
                          query_subsample)


# ---------------------------------------------------------------------------
# Pose-free global descriptor matching (retrieval / loop-closure edges)
# ---------------------------------------------------------------------------

def _coarse_global_argmax(D_tab8, D_q8, h, w, s_key: int,
                          chunk: int = 2048, excl_cells: int = 3):
    """For each query descriptor, the best-scoring position on the
    ``s_key``-strided key grid of the table, and the best score outside an
    ``excl_cells``-radius box of key cells around the winner
    (matching.py:807): the second peak of a ratio test, away from the
    winner's legitimately high neighbours.  Queries go in chunks of
    ``chunk`` so the (chunk, n_keys) score block stays small.

    The int8 products are taken in f32: each is at most 127^2 and a
    24-feature sum at most 387,096 < 2^24, so every partial sum is an exact
    integer in any order and the scores equal JAX's int32 ones.  The first
    maximum wins (``torch.argmax``, as ``jnp.argmax``).

    D_tab8 (b, h, w, f) int8; D_q8 (b, nq, f) int8.  Returns (pos (b, nq, 2)
    int64 full-res pixels, score (b, nq) int32, second (b, nq) int32)."""
    b, f = D_tab8.shape[0], D_tab8.shape[-1]
    hk, wk = h // s_key, w // s_key
    keys = D_tab8[:, ::s_key, ::s_key].reshape(b, hk * wk, f) \
        .to(torch.float32).transpose(1, 2)                  # (b, f, nk)
    ku = torch.arange(wk, device=D_tab8.device)
    kv = torch.arange(hk, device=D_tab8.device)
    best, score, second = [], [], []
    for c0 in range(0, D_q8.shape[1], chunk):
        q = D_q8[:, c0:c0 + chunk].to(torch.float32)
        s = torch.bmm(q, keys)                               # (b, c, nk)
        bi = torch.argmax(s, dim=-1)
        smax = s.gather(-1, bi[..., None])[..., 0]
        # the exclusion box as (rows near) x (columns near)
        near_u = (ku - (bi % wk)[..., None]).abs() <= excl_cells
        near_v = (kv - (bi // wk)[..., None]).abs() <= excl_cells
        near = (near_v[..., :, None] & near_u[..., None, :]).flatten(-2)
        s2 = s.masked_fill_(near, -(2 ** 30)).amax(dim=-1)
        best.append(bi)
        score.append(smax.to(torch.int32))
        second.append(s2.to(torch.int32))
    best = torch.cat(best, dim=1)
    pos = torch.stack([(best % wk) * s_key, (best // wk) * s_key], dim=-1)
    return pos, torch.cat(score, dim=1), torch.cat(second, dim=1)


def match_desc_global(D8_i, D8_j, dconf_i, dconf_j, h, w,
                      cfg: MatchingConfig = MatchingConfig()):
    """Pose-free symmetric matching of two keyframes from their stored q8
    descriptor tables, the decode-free retrieval-edge path
    (matching.py:858).

    Per direction: the coarse global argmax of the quarter-grid queries on
    the stride-4 key grid, each half-grid query inheriting its parent
    quarter cell's position, then the refine walk at full table resolution
    (radius 2, dilation 2, then dilation 1 returning the winning score),
    both through packed tables (kernel C on the card).  Four gates replace
    the decode's occlusion gate: the reverse field at the match must come
    back to the query (mutual), the refined score must beat the second peak
    by ``desc_global_min_margin`` cosine, no target half cell may be
    claimed by more than ``desc_global_max_mult`` queries, and the cosine
    must reach ``desc_global_min_cos``.

    D8_i / D8_j (b, h, w, f) int8; dconf_i / dconf_j (b, h*w, 1).  Returns
    ``add_factors``' subgrid layout (edge_query_subsample 2): (idx_i2j
    (b, hw/4), idx_j2i, vm_j (b, hw/4, 1), vm_i, Qii, Qjj, Qji, Qij), where
    idx_i2j[q] is the pixel of view i matched by half-grid query q of view
    j and the Q blocks are the full-res descriptor confidences."""
    b = D8_i.shape[0]
    h2, w2 = h // 2, w // 2
    h4, w4 = h // 4, w // 4

    def half_queries(D8):
        return D8[:, ::2, ::2].reshape(b, h2 * w2, -1)

    def quarter_queries(D8):
        return D8[:, ::4, ::4].reshape(b, h4 * w4, -1)

    def expand2x(A):
        """(b, h4*w4, ...) quarter-grid field -> (b, h2*w2, ...): each
        half-grid query takes its parent quarter cell's value."""
        A4 = A.reshape((b, h4, w4) + tuple(A.shape[2:]))
        A4 = A4.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return A4.reshape((b, h2 * w2) + tuple(A.shape[2:]))

    def one_direction(D_tab, D_q4, D_qh):
        pos4, _, second4 = _coarse_global_argmax(D_tab, D_q4, h, w, s_key=4)
        pos = refine_matches(D_tab, D_qh, expand2x(pos4), radius=2,
                             dilation_max=2, coarse_bits=cfg.coarse_bits,
                             dilation_min=2, u_pack=5)
        pos, rs = refine_matches(D_tab, D_qh, pos, radius=2, dilation_max=1,
                                 coarse_bits=cfg.coarse_bits, u_pack=5,
                                 return_score=True)
        return _clip_pixels(pos, h, w), rs, expand2x(second4)

    p_ij, s_ij, s2_ij = one_direction(       # (b, h2*w2, 2) in i's pixels
        D8_i, quarter_queries(D8_j), half_queries(D8_j))
    p_ji, s_ji, s2_ji = one_direction(       # in j's pixels
        D8_j, quarter_queries(D8_i), half_queries(D8_i))

    f_norm = 127.0 * 127.0   # q8 scale of unit descriptors, squared
    qi = torch.arange(h2 * w2, device=D8_i.device)
    q_pos = torch.stack([(qi % w2) * 2, (qi // w2) * 2], dim=-1)[None]

    def gates(p_fwd, p_rev_field, s_fwd, s2_fwd):
        cell = (p_fwd[..., 1] // 2) * w2 + (p_fwd[..., 0] // 2)
        back = torch.gather(p_rev_field, 1, cell[..., None].expand(-1, -1, 2))
        ok = (back - q_pos).abs().amax(dim=-1) <= cfg.desc_global_mutual_px
        cos = s_fwd.to(torch.float32) / f_norm
        cos2 = s2_fwd.to(torch.float32) / f_norm
        ok &= (cos - cos2) >= cfg.desc_global_min_margin
        ok &= cos >= cfg.desc_global_min_cos
        # claims per target half cell: an integer count, deterministic
        mult = torch.zeros((b, h2 * w2), dtype=torch.int32,
                           device=cell.device)
        mult.scatter_add_(1, cell, torch.ones_like(mult))
        ok &= torch.gather(mult, 1, cell) <= cfg.desc_global_max_mult
        return ok

    vm_j = gates(p_ij, p_ji, s_ij, s2_ij)              # per query of j
    vm_i = gates(p_ji, p_ij, s_ji, s2_ji)              # per query of i
    return (pixel_to_lin(p_ij, w), pixel_to_lin(p_ji, w), vm_j[..., None],
            vm_i[..., None], dconf_i, dconf_j, dconf_j, dconf_i)
