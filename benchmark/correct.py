"""How ``correct`` is decided: the timed path's outputs against the plain
reference in ``reference/``, once the window has closed and the program's
state is freed.

The run sampled from its seed, before it began, tracked frames (held and
jump frames) and one backend round; the program's outputs there were kept
by ``drive.Camera.install``.  The reference computes, from the same
weights and frames:

* ``net_gap``: the network's outputs (each view's pointmap, confidence,
  descriptors and descriptor confidence): the largest relative RMS gap;
* ``pose_gap``: the tracker's pose, the reference's step from the state the
  program's step started from (its keyframe, the frame's starting pose
  and the matcher's warm start, all the program's own, since the step
  cannot be followed otherwise): how far the two poses put the frame's
  points apart, relative to their distance from the camera; and
  ``pose_move``, the same between the starting pose and the reference's:
  what a step that returned its pose unchanged would read.  On a held
  view the reference barely moves the pose (both stop at the solve's
  floor, a step under ``delta_norm``), so a pose left unchanged is there
  the right answer; on a jump frame it has to move;
* ``start_pose_miss``: on the first tracked frame, where the step starts
  from the identity and runs to convergence, ``pose_gap`` over
  ``pose_move``, the share of the reference's move that the step missed:
  a pose left unchanged reads 1; ``jump_pose_miss`` (traffic with jumps),
  the same on jump frames;
* ``kf_metric_gap`` and ``kf_decisions``: the keyframe metric's largest
  absolute gap, and the frames whose keyframe (or lost) decision differs;
* ``ba_gap`` (traffic with jumps): the backend round's poses, the
  reference solve on the inputs the round read: the largest relative
  displacement of a keyframe's points.

What the reference takes from the program's state, as inputs only, since
it could be made again only by following every frame and round before the
sampled one: for a tracking step, the keyframe's fused pointmap,
confidence, count and pose, the frame's starting pose and the matcher's
warm start; for the backend round, the keyframes' fused pointmaps,
confidences, counts and poses, the edges and each edge's match store.  So
the matches the backend's edges hold and the keyframes' fusion are not
judged by themselves; the network's views, the matcher and the solves on
those inputs are, and the tracker's own fusion of the frame is inside its
step.

The control is the reference itself one precision step down, in the
program's place (``Precision`` of the configuration's ``control``).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import ba as ref_ba
from .reference import lie_sim3 as sim3
from .reference import network, tracker
from .reference.matching import MatchCfg


def rel_rms(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.sqrt(torch.mean((a - b) ** 2))
                 / torch.clamp(torch.sqrt(torch.mean(b * b)), min=1e-30))


def point_gap(T_a, T_b, X) -> float:
    """RMS distance between the points X (n, 3) placed by the poses T_a and
    T_b, over their RMS distance from the camera under T_b."""
    Pa, Pb = sim3.act(T_a.float(), X), sim3.act(T_b.float(), X)
    d = torch.sqrt(torch.mean(torch.sum((Pa - Pb) ** 2, dim=-1)))
    r = torch.sqrt(torch.mean(torch.sum((Pb - T_b[:3]) ** 2, dim=-1)))
    return float(d / torch.clamp(r, min=1e-30))


class Reference:
    """The reference (or the control) of one configuration: its
    architecture's network (``net``, from ``arch.reference``, in ``prec``)
    and the solver settings."""

    def __init__(self, net, prec: network.Precision, slam_cfg: dict, img_hw):
        self.net = net
        self.prec = prec
        self.mcfg = MatchCfg.from_dict(slam_cfg["matching"])
        self.tcfg = tracker.TrackCfg.from_dict(slam_cfg)
        self.bcfg = ref_ba.BACfg.from_dict(slam_cfg)
        self.img_hw = tuple(img_hw)

    def views(self, img_frame, img_kf):
        """The 8 outputs (``OUTPUTS`` of each view) for two uint8 frames."""
        return self.net.views(img_frame, img_kf)

    def track(self, views, rec):
        return tracker.track(views, rec["kf"], rec["T0"], rec["idx"],
                             self.mcfg, self.tcfg,
                             tf32=self.prec.solves == "tf32")

    def ba(self, b):
        return ref_ba.solve_poses(
            b["X"], b["C"], b["N"], b["T_WC"], b["ii"], b["jj"],
            *b["stores"], self.img_hw, self.bcfg,
            tf32=self.prec.solves == "tf32")


OUTPUTS = ("pts", "conf", "desc", "dconf")


def _frame_numbers(views_p, out_p, views_r, out_r, X, T0, jump, start):
    per = {f"net_{n}": max(rel_rms(vp[i], vr[i])
                           for vp, vr in zip(views_p, views_r))
           for i, n in enumerate(OUTPUTS)}
    gap = point_gap(out_p["T"], out_r.T_WC, X)
    move = point_gap(T0, out_r.T_WC, X)
    d = dict(net_gap=max(per.values()), **per, pose_gap=gap, pose_move=move,
             kf_metric_gap=abs(out_p["metric"] - out_r.new_kf_metric),
             kf_decisions=int(out_p["new_kf"] != out_r.new_kf
                              or out_p["lost"] != out_r.lost))
    miss = gap / max(move, 1e-30)
    if jump:
        d["jump_pose_miss"] = miss
    if start:
        d["start_pose_miss"] = miss
    return d


def _ba_numbers(b, T_ref):
    pin = int(b["pin"])
    upd = np.asarray(b["upd"])
    gaps = []
    for c, row in enumerate(upd):
        if c < pin or row >= len(b["T_WC"]):
            continue
        X = b["X"][int(row)]
        gaps.append(point_gap(b["T_new"][c], T_ref[int(row)], X))
    return dict(ba_gap=max(gaps) if gaps else float("inf"))


# the keys of a sample that say which frame it is, not how far it is off
WHICH = ("t", "jump")


def numbers(ref: Reference, capture, clip, control: Reference | None = None):
    """The compared numbers of the program against ``ref`` (and, with
    ``control``, of the control against ``ref``): dicts of the largest
    reading over every sample; each also keeps the readings sample by
    sample under ``samples``."""
    prog, ctrl = {"samples": []}, {"samples": []}

    def fold(acc, d):
        acc["samples"].append(d)
        for k, v in d.items():
            if k not in WHICH:
                acc[k] = max(acc.get(k, 0), v)

    for t, rec in sorted(capture.tracked.items()):
        img_kf = clip.frame(int(rec["kf_id"]))
        img = clip.frame(t)
        which = dict(t=t, jump=clip.is_keyframe(t))
        vr = ref.views(img, img_kf)
        out_r = ref.track(vr, rec)
        X = vr[0][0].reshape(-1, 3)
        fold(prog, dict(which, **_frame_numbers(
            rec["views"], rec, vr, out_r, X, rec["T0"], which["jump"],
            t == 1)))
        if control is not None:
            vc = control.views(img, img_kf)
            out_c = control.track(vc, rec)
            fold(ctrl, dict(which, **_frame_numbers(
                vc, dict(T=out_c.T_WC, metric=out_c.new_kf_metric,
                         new_kf=out_c.new_kf, lost=out_c.lost),
                vr, out_r, X, rec["T0"], which["jump"], t == 1)))
    if capture.ba is not None:
        b = dict(capture.ba, pin=ref.bcfg.pin)
        T_ref = ref.ba(b)
        fold(prog, _ba_numbers(b, T_ref))
        if control is not None:
            T_c = control.ba(b)
            n = len(b["T_WC"])
            fold(ctrl, _ba_numbers(dict(b, upd=np.arange(n), T_new=T_c),
                                   T_ref))
    return prog, ctrl
