"""Frame tracker: two-view registration against the last keyframe.

Mirrors ``mast3r_slam_tpu/tracker.py`` for the uncalibrated ray+distance
solve under the production joint ray Huber weight.  The JAX version runs
the GN loop as a device ``while_loop``; here it is a Python loop with one
host sync per iteration for the convergence test, the reference's own
``.item()`` cadence.  Each iteration's normal equations come from
``ops.gn.gn_accumulate`` (the CUDA kernel on the card, its plain closed
form on the CPU); the 7x7 solve, retraction and convergence test then run
on the host in f32, on the sums the sync has already brought over.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .frame import FilteringMode, Frame, update_pointmap
from .ops import gn
from .ops import lie_sim3 as sim3
from .ops.robust import check_convergence, solve_spd_small

# Knobs of the JAX TrackerConfig that the port runs only at these values.
_PORTED_ONLY = {
    ("tracking", "joint_ray_huber"): True,
    ("tracking", "point_subsample"): 1,
    (None, "use_calib"): False,
}


class TrackerConfig(NamedTuple):
    """Tracking parameters of the ray+distance solve (tracker.py:35)."""
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
    filtering_mode: int = int(FilteringMode.WEIGHTED_POINTMAP)
    use_median_score: bool = True

    @classmethod
    def from_config(cls, cfg: dict) -> "TrackerConfig":
        """From a whole config dict (tracker.py:70).  Raises
        ``NotImplementedError`` naming any knob set to a value this slice
        does not run."""
        t = cfg["tracking"]
        for (block, knob), ported in _PORTED_ONLY.items():
            src = t if block else cfg
            val = src.get(knob, ported)
            if val != ported:
                name = f"{block}.{knob}" if block else knob
                raise NotImplementedError(
                    f"{name}={val!r} is not ported yet (the port runs "
                    f"{ported!r})")
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
            filtering_mode=int(FilteringMode.from_str(t["filtering_mode"])),
            use_median_score=t.get("filtering_score", "median") == "median",
        )


def opt_pose_ray_dist_sim3(Xf, Xk, T_init, Qk, valid, cfg: TrackerConfig):
    """Uncalibrated GN with ray + distance residuals and one Huber weight
    per point for the three ray components (tracker.py:133, the closed form
    of tracker.py:203-298).  Xf, Xk (n, 3); Qk, valid (n, 1).  Returns
    (T_CkCf on T_init's device, ok, iterations run).  T stays on the
    host; each iteration sends its 13 pose scalars to the card without a
    sync and copies the 27 sums back."""
    vq = (valid * torch.sqrt(Qk))[:, 0]
    w_ray = (1.0 / cfg.sigma_ray) * vq
    w_dist = (1.0 / cfg.sigma_dist) * vq
    dk = torch.sqrt(torch.clamp(torch.sum(Xk * Xk, dim=-1), min=1e-24))
    rd_k_t = torch.cat([Xk.T / dk[None, :], dk[None, :]])
    pre = gn.GNPointData(Xf, rd_k_t, w_ray, w_dist)

    T = T_init.detach().to("cpu", torch.float32)
    old_cost = math.inf
    ok = True
    it = 0
    while it < cfg.max_iters:
        H, g, cost = gn.gn_accumulate(pre, T, cfg.huber_k)  # host: the sync
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
    return T.to(T_init.device), ok, it


class TrackResult(NamedTuple):
    """(tracker.py:419) without the backend's reuse fields."""
    frame: Frame
    keyframe: Frame
    idx_f2k: torch.Tensor        # (1, hw)
    match_frac: torch.Tensor     # ()
    new_kf_metric: torch.Tensor  # () min(match_frac_k, unique_frac_f)
    ok: bool                     # solver healthy
    gn_iters: int


def track_step(engine, frame: Frame, keyframe: Frame, idx_init,
               cfg: TrackerConfig) -> TrackResult:
    """One tracking step (tracker.py:445): asymmetric decode + match
    against the keyframe, fusion, the Sim(3) solve, the keyframe's fusion
    and the keyframe-selection metrics."""
    hw = frame.hw
    (idx_f2k_b, valid_match_k_b, Xff, Cff, Qff, Xkf, Ckf, Qkf) = \
        engine.match_asymmetric(frame.feat[None], frame.pos[None],
                                keyframe.feat[None], keyframe.pos[None],
                                idx_init)
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

    # one gather for Xf, Cf, Qff, which share idx_f2k (tracker.py:527)
    g = torch.cat([Xf, Cf, Qff], dim=-1)[idx_f2k]
    Xf_m = g[:, 0:3]
    Cf_m = g[:, 3:4]
    Qk = torch.sqrt(g[:, 4:5] * Qkf)

    valid_Q = Qk > cfg.Q_conf
    valid_opt = valid_match_k & (Cf_m > cfg.C_conf) & (Ck > cfg.C_conf) \
        & valid_Q
    valid_kf = valid_match_k & valid_Q
    match_frac = torch.mean(valid_opt.float())

    T_WCf, T_WCk = frame.T_WC, keyframe.T_WC
    T_CkCf, ok, gn_iters = opt_pose_ray_dist_sim3(
        Xf_m, Xk, sim3.rel(T_WCk, T_WCf), Qk, valid_opt.to(Xf_m.dtype), cfg)
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
        ok=ok, gn_iters=gn_iters)


class FrameTracker:
    """The tracker on the host (tracker.py:590): owns the match-index warm
    start and makes the skip / new-keyframe decisions."""

    def __init__(self, engine, cfg: TrackerConfig):
        self.engine = engine
        self.cfg = cfg
        self.idx_f2k = None
        self.last_diag = {}

    def reset_idx_f2k(self):
        self.idx_f2k = None

    def track(self, frame: Frame, keyframe: Frame):
        """Returns (new_kf, frame, keyframe, try_reloc) (tracker.py:638)."""
        idx_init = self.idx_f2k
        if idx_init is None:
            idx_init = torch.arange(frame.hw,
                                    device=frame.X_canon.device)[None]
        res = track_step(self.engine, frame, keyframe, idx_init, self.cfg)
        match_frac = float(res.match_frac)
        self.last_diag = {
            "match_frac": match_frac,
            "gn_iters": res.gn_iters,
            "ok": res.ok,
            "new_kf_metric": float(res.new_kf_metric),
        }
        self.idx_f2k = res.idx_f2k
        if match_frac < self.cfg.min_match_frac or not res.ok:
            return False, frame, keyframe, True
        new_kf = self.last_diag["new_kf_metric"] < self.cfg.match_frac_thresh
        if new_kf:
            self.reset_idx_f2k()
        return new_kf, res.frame, res.keyframe, False
