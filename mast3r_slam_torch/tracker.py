"""Frame tracker: two-view registration against the last keyframe.

Mirrors ``mast3r_slam_tpu/tracker.py``: the uncalibrated ray+distance solve
(under the production joint ray Huber weight, or the reference-exact
per-component weights) and the calibrated pixel + log-depth solve.  The JAX
version runs the GN loop as a device ``while_loop``.  Under
``joint_ray_huber`` the port does the same on the card: ``ops.gn.gn_solve``
runs every iteration (the sums, the 7x7 solve, the retraction and the
convergence test) in one kernel launch with one copy back per solve; on the
CPU it is the host loop over the plain closed form.  The other two bodies
(per-component weights, calibrated) have no TPU kernel and keep the host
loop ``ops.gn.gn_loop``, one sync per iteration: they expand the whitened
Jacobian rows on the points' device and reduce them with one matrix
product, as in JAX, and the 7x7 solve, retraction and convergence test run
on the host in f32 on the sums the sync has brought over.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .frame import FilteringMode, Frame, update_pointmap
from .ops import gn
from .ops import lie_sim3 as sim3
from .ops.geometry import (
    constrain_points_to_ray,
    get_pixel_coords,
    point_to_ray_dist,
    project_calib,
)
from .ops.robust import huber


class TrackerConfig(NamedTuple):
    """Tracking parameters, field for field the JAX ``TrackerConfig``
    (tracker.py:35)."""
    min_match_frac: float = 0.05
    max_iters: int = 50
    C_conf: float = 0.0
    Q_conf: float = 1.5
    rel_error: float = 1e-3
    delta_norm: float = 1e-3
    huber_k: float = 1.345
    match_frac_thresh: float = 0.333
    sigma_ray: float = 0.003
    sigma_dist: float = 10.0
    sigma_pixel: float = 1.0
    sigma_depth: float = 10.0
    pixel_border: int = -10
    depth_eps: float = 1e-6
    filtering_mode: int = int(FilteringMode.WEIGHTED_POINTMAP)
    use_median_score: bool = True
    use_calib: bool = False
    # one Huber weight per point from the whitened ray-error norm (the
    # closed form of ops.gn); False = per-component weights
    joint_ray_huber: bool = True
    # grid stride of the points fed to the GN solve (1 = all pixels)
    point_subsample: int = 1

    @classmethod
    def from_config(cls, cfg: dict) -> "TrackerConfig":
        """From a whole config dict (tracker.py:70)."""
        t = cfg["tracking"]
        return cls(
            min_match_frac=float(t["min_match_frac"]),
            max_iters=int(t["max_iters"]),
            C_conf=float(t["C_conf"]),
            Q_conf=float(t["Q_conf"]),
            rel_error=float(t["rel_error"]),
            delta_norm=float(t["delta_norm"]),
            huber_k=float(t["huber"]),
            match_frac_thresh=float(t["match_frac_thresh"]),
            sigma_ray=float(t["sigma_ray"]),
            sigma_dist=float(t["sigma_dist"]),
            sigma_pixel=float(t["sigma_pixel"]),
            sigma_depth=float(t["sigma_depth"]),
            pixel_border=int(t["pixel_border"]),
            depth_eps=float(t["depth_eps"]),
            filtering_mode=int(FilteringMode.from_str(t["filtering_mode"])),
            use_median_score=t.get("filtering_score", "median") == "median",
            use_calib=bool(cfg.get("use_calib", False)),
            joint_ray_huber=bool(t.get("joint_ray_huber", True)),
            point_subsample=int(t.get("point_subsample", 1)),
        )


def _fuse_pose_jacobian(J_res, pW):
    """J = -(J_res @ [I | -skew(pW) | pW]) with elementwise and cross
    products (tracker.py:101).  J_res (n, R, 3) residual Jacobian wrt the
    transformed point; pW (n, 3).  Returns (n, R, 7)."""
    p = pW[:, None, :].expand_as(J_res)
    rot = torch.linalg.cross(J_res, p, dim=-1)
    scl = torch.sum(J_res * p, dim=-1, keepdim=True)
    return torch.cat([-J_res, rot, -scl], dim=-1)


def _normal_equations_7x7(sqrt_info, r, J, huber_k):
    """Whiten, robustify and assemble the 7x7 normal equations
    (tracker.py:114, the part before the solve).  sqrt_info, r (n, R);
    J (n, R, 7).  Returns (H (7, 7), g (7,), cost ()) on the host."""
    robust = sqrt_info * torch.sqrt(huber(sqrt_info * r, k=huber_k))
    A = (robust[..., None] * J).reshape(-1, 7)
    b = (robust * r).reshape(-1, 1)
    H = A.T @ A
    g = -(A.T @ b)[:, 0]
    cost = 0.5 * torch.sum(b * b)
    return H.cpu(), g.cpu(), cost.cpu()


def _ray_dist_weights(Xk, Qk, valid, cfg: TrackerConfig):
    """(w_ray (n,), w_dist (n,), dk (n,)): the whitening weights of the ray
    and distance residuals and the keyframe points' distances
    (tracker.py:146-151)."""
    vq = (valid * torch.sqrt(Qk))[:, 0]
    dk = torch.sqrt(torch.clamp(torch.sum(Xk * Xk, dim=-1), min=1e-24))
    return (1.0 / cfg.sigma_ray) * vq, (1.0 / cfg.sigma_dist) * vq, dk


def ray_dist_point_data(Xf, Xk, Qk, valid, cfg: TrackerConfig):
    """The per-point inputs of the joint-ray-Huber solve, built once per
    solve (tracker.py:367)."""
    w_ray, w_dist, dk = _ray_dist_weights(Xk, Qk, valid, cfg)
    rd_k_t = torch.cat([Xk.T / dk[None, :], dk[None, :]])
    return gn.GNPointData(Xf, rd_k_t, w_ray, w_dist)


def opt_pose_ray_dist_sim3(Xf, Xk, T_init, Qk, valid, cfg: TrackerConfig):
    """Uncalibrated GN with ray + distance residuals (tracker.py:133).
    Xf, Xk (n, 3); Qk, valid (n, 1).  Returns (T_CkCf on T_init's device,
    ok, iterations run).  T stays on the host.  Under ``joint_ray_huber``
    (one weight per point for the three ray components, the closed form of
    tracker.py:203-298) each iteration sends its 13 pose scalars to the
    card without a sync and copies the 27 sums back; otherwise (per
    component weights, tracker.py:300-341) the four residual rows and their
    fused pose Jacobians are expanded on the points' device and reduced to
    H and g there."""
    if cfg.joint_ray_huber:
        return gn.gn_solve(ray_dist_point_data(Xf, Xk, Qk, valid, cfg),
                           T_init, cfg)

    w_ray, w_dist, dk = _ray_dist_weights(Xk, Qk, valid, cfg)
    rd_k = torch.cat([Xk / dk[:, None], dk[:, None]], dim=-1)      # (n, 4)
    sqrt_info = torch.stack([w_ray, w_ray, w_ray, w_dist], dim=-1)

    def per_component(T):
        p = sim3.act(T.to(Xf.device), Xf)
        rd, J_rd = point_to_ray_dist(p, jacobian=True)
        return _normal_equations_7x7(
            sqrt_info, rd_k - rd, _fuse_pose_jacobian(J_rd, p), cfg.huber_k)

    return gn.gn_loop(per_component, T_init, cfg)


def opt_pose_calib_sim3(Xf, Xk, T_init, Qk, valid, meas_k, valid_meas_k, K,
                        img_size, cfg: TrackerConfig):
    """Calibrated GN with pixel + log-depth residuals (tracker.py:377).
    meas_k (n, 3) the keyframe's (u, v, log z); valid_meas_k (n, 1); K
    (3, 3).  ``Xk`` is unused, as in JAX: the keyframe enters through
    ``meas_k``."""
    vq = valid * torch.sqrt(Qk)
    sqrt_info = torch.cat([
        ((1.0 / cfg.sigma_pixel) * vq).expand(-1, 2),
        (1.0 / cfg.sigma_depth) * vq], dim=1)

    def pixel_logdepth(T):
        Xf_Ck = sim3.act(T.to(Xf.device), Xf)
        pz, J_pz, valid_proj = project_calib(
            Xf_Ck, K, img_size, jacobian=True, border=cfg.pixel_border,
            z_eps=cfg.depth_eps)
        si = (valid_proj & valid_meas_k) * sqrt_info
        return _normal_equations_7x7(
            si, meas_k - pz, _fuse_pose_jacobian(J_pz, Xf_Ck), cfg.huber_k)

    return gn.gn_loop(pixel_logdepth, T_init, cfg)


class TrackResult(NamedTuple):
    """(tracker.py:419).  ``valid_match``, ``Qff``, ``Qkf`` and the q8
    descriptor tables are what the backend reuses for the consecutive
    factor-graph edge when the frame becomes a keyframe."""
    frame: Frame
    keyframe: Frame
    idx_f2k: torch.Tensor        # (1, hw)
    match_frac: torch.Tensor     # ()
    new_kf_metric: torch.Tensor  # () min(match_frac_k, unique_frac_f)
    ok: bool                     # solver healthy
    gn_iters: int
    valid_match: torch.Tensor    # (1, hw, 1) bool
    Qff: torch.Tensor            # (1, hw, 1) frame self desc-conf
    Qkf: torch.Tensor            # (1, hw, 1) keyframe cross desc-conf
    desc8_frame: object          # (1, hw, f) int8 q8 descriptors or None
    desc8_kf: object             # (1, hw, f) int8 q8 descriptors or None


def track_step(engine, frame: Frame, keyframe: Frame, idx_init,
               cfg: TrackerConfig, K=None) -> TrackResult:
    """One tracking step (tracker.py:445): asymmetric decode + match
    against the keyframe, fusion, the Sim(3) solve, the keyframe's fusion
    and the keyframe-selection metrics.  ``K`` (3, 3) is read under
    ``cfg.use_calib`` only."""
    h, w = frame.uimg.shape[0], frame.uimg.shape[1]
    hw = h * w
    outs = engine.match_asymmetric(frame.feat[None], frame.pos[None],
                                   keyframe.feat[None], keyframe.pos[None],
                                   idx_init)
    desc8_f = desc8_k = None
    if len(outs) == 10:   # engine that exports its q8 descriptor tables
        desc8_f, desc8_k = outs[8:]
    idx_f2k_b, valid_match_k_b, Xff, Cff, Qff, Xkf, Ckf, Qkf = outs[:8]
    idx_f2k = idx_f2k_b[0]
    valid_match_k = valid_match_k_b[0]
    Xff, Cff, Qff = Xff[0], Cff[0], Qff[0]
    Xkf, Ckf, Qkf = Xkf[0], Ckf[0], Qkf[0]
    mode = FilteringMode(cfg.filtering_mode)

    frame = update_pointmap(frame, Xff, Cff, mode, cfg.use_median_score)
    Xf = frame.X_canon
    Xk = keyframe.X_canon
    Cf = frame.get_average_conf()
    Ck = keyframe.get_average_conf()

    meas_k = valid_meas_k = None
    if cfg.use_calib:
        Xf = constrain_points_to_ray((h, w), Xf[None], K)[0]
        Xk = constrain_points_to_ray((h, w), Xk[None], K)[0]
        uv_k = get_pixel_coords(1, (h, w), device=Xk.device).reshape(-1, 2)
        valid_meas_k = Xk[..., 2:3] > cfg.depth_eps
        z_safe = torch.where(valid_meas_k, Xk[..., 2:3],
                             torch.ones_like(Xk[..., 2:3]))
        meas_k = torch.cat([uv_k, torch.log(z_safe)], dim=-1)
        meas_k = torch.where(valid_meas_k, meas_k, torch.zeros_like(meas_k))

    # GN point set: the full raster or an s x s subgrid (point_subsample);
    # the gathered tables stay full-res
    s = cfg.point_subsample
    if s > 1 and h % s == 0 and w % s == 0:
        def sub(A):
            return A.reshape(h, w, -1)[::s, ::s].reshape(
                (h // s) * (w // s), -1)

        idx_gn = idx_f2k.reshape(h, w)[::s, ::s].reshape(-1)
        vm_gn = sub(valid_match_k)
        Qkf_gn, Xk_gn, Ck_gn = sub(Qkf), sub(Xk), sub(Ck)
        if cfg.use_calib:
            meas_k, valid_meas_k = sub(meas_k), sub(valid_meas_k)
    else:
        idx_gn, vm_gn = idx_f2k, valid_match_k
        Qkf_gn, Xk_gn, Ck_gn = Qkf, Xk, Ck

    # one gather for Xf, Cf, Qff, which share idx_f2k (tracker.py:527)
    g = torch.cat([Xf, Cf, Qff], dim=-1)[idx_gn]
    Xf_m = g[:, 0:3]
    Cf_m = g[:, 3:4]
    Qk = torch.sqrt(g[:, 4:5] * Qkf_gn)

    valid_Q = Qk > cfg.Q_conf
    valid_opt = vm_gn & (Cf_m > cfg.C_conf) & (Ck_gn > cfg.C_conf) & valid_Q
    valid_kf = vm_gn & valid_Q
    match_frac = torch.mean(valid_opt.float())

    T_WCf, T_WCk = frame.T_WC, keyframe.T_WC
    T_init = sim3.rel(T_WCk, T_WCf)
    if cfg.use_calib:
        T_CkCf, ok, gn_iters = opt_pose_calib_sim3(
            Xf_m, Xk_gn, T_init, Qk, valid_opt.to(Xf_m.dtype), meas_k,
            valid_meas_k, K, (h, w), cfg)
    else:
        T_CkCf, ok, gn_iters = opt_pose_ray_dist_sim3(
            Xf_m, Xk_gn, T_init, Qk, valid_opt.to(Xf_m.dtype), cfg)
    # normalize: this product is the per-frame pose recursion (tracker.py:557)
    frame = frame.replace(T_WC=sim3.normalize(sim3.mul(T_WCk, T_CkCf)))

    keyframe = update_pointmap(keyframe, sim3.act(T_CkCf, Xkf), Ckf, mode,
                               cfg.use_median_score)

    match_frac_k = torch.mean(valid_kf.float())
    seen = torch.zeros((hw + 1,), dtype=torch.int32, device=idx_f2k.device)
    seen[torch.where(valid_match_k[:, 0], idx_f2k,
                     torch.full_like(idx_f2k, hw))] = 1
    unique_frac_f = seen[:hw].sum().float() / hw
    return TrackResult(
        frame=frame, keyframe=keyframe, idx_f2k=idx_f2k_b,
        match_frac=match_frac,
        new_kf_metric=torch.minimum(match_frac_k, unique_frac_f),
        ok=ok, gn_iters=gn_iters, valid_match=valid_match_k_b,
        Qff=Qff[None], Qkf=Qkf[None], desc8_frame=desc8_f, desc8_kf=desc8_k)


class FrameTracker:
    """The tracker on the host (tracker.py:590): owns the match-index warm
    start and makes the skip / new-keyframe decisions."""

    def __init__(self, engine, cfg: TrackerConfig, K=None):
        self.engine = engine
        self.cfg = cfg
        self.K = K
        self.idx_f2k = None
        self.last_diag = {}
        # measured GN cadence: max_iters is only the cap
        self.gn_iters_total = 0
        self.gn_frames = 0

    def reset_idx_f2k(self):
        self.idx_f2k = None

    def track(self, frame: Frame, keyframe: Frame):
        """Returns (new_kf, frame, keyframe, try_reloc, reuse)
        (tracker.py:638).  ``reuse`` = (idx_f2k, valid_match, Qff, Qkf,
        desc8_frame, desc8_kf), the frame -> keyframe direction that the
        backend reuses for the consecutive edge when the frame becomes a
        keyframe; None when tracking is lost."""
        idx_init = self.idx_f2k
        if idx_init is None:
            idx_init = torch.arange(frame.hw,
                                    device=frame.X_canon.device)[None]
        res = track_step(self.engine, frame, keyframe, idx_init, self.cfg,
                         self.K)
        match_frac = float(res.match_frac)
        self.gn_iters_total += res.gn_iters
        self.gn_frames += 1
        self.last_diag = {
            "match_frac": match_frac,
            "gn_iters": res.gn_iters,
            "ok": res.ok,
            "new_kf_metric": float(res.new_kf_metric),
        }
        self.idx_f2k = res.idx_f2k
        if match_frac < self.cfg.min_match_frac or not res.ok:
            return False, frame, keyframe, True, None
        new_kf = self.last_diag["new_kf_metric"] < self.cfg.match_frac_thresh
        if new_kf:
            self.reset_idx_f2k()
        reuse = (res.idx_f2k, res.valid_match, res.Qff, res.Qkf,
                 res.desc8_frame, res.desc8_kf)
        return new_kf, res.frame, res.keyframe, False, reuse
