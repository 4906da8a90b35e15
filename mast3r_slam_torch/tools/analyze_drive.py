"""Accuracy-bisect analysis of a ``--diag-out`` drive.

Compares the per-frame tracked poses and the final keyframe trajectory
against the clip's Sim(3) ground truth: per-frame translation error,
per-frame/per-keyframe SCALE error (the monocular-drift channel), frame
indices of keyframe creation, reloc events, and match_frac / gn_iters
traces: everything needed to localize where long-horizon drift enters.

The counterpart of ``scripts/analyze_drive.py``, with its arguments and its
report character for character.  That script imports the JAX package's
``lie_sim3`` but computes in numpy, and so does this one, on the same files:
``main_torch.py --diag-out``'s JSONL, the clip's ``oracle.npz`` and the
``--est`` trajectory.

    python -m mast3r_slam_torch.tools.analyze_drive DIAG_JSONL CLIP_DIR [--est EST_TXT]
"""

import argparse
import json
import pathlib
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("diag")
    p.add_argument("clip")
    p.add_argument("--est", default="")
    p.add_argument("--subsample", type=int, default=2,
                   help="dataset.subsample of the drive (eval configs: 2)")
    args = p.parse_args(argv)

    clip = pathlib.Path(args.clip)
    oracle = np.load(clip / "oracle.npz")
    T_gt = np.asarray(oracle["T_WC"])  # (N, 8) Sim3 embedding, all frames

    with open(args.diag) as f:
        rows = [json.loads(ln) for ln in f]
    print(f"{len(rows)} diag rows; GT {len(T_gt)} frames")

    # --- per-frame tracked-pose error (before BA corrections land) -------
    # gauge alignment: first frame pose is pinned to GT's first (identity)
    errs = []
    for r in rows:
        if "T_WC" not in r or r.get("mode") != "TRACKING":
            continue
        i = r["i"] * args.subsample
        Te = np.asarray(r["T_WC"], np.float32)
        Tg = np.asarray(T_gt[i], np.float32)
        qe = Te[3:7] / np.linalg.norm(Te[3:7])
        qg = Tg[3:7] / np.linalg.norm(Tg[3:7])
        rot = 2 * np.arccos(min(abs(float(qe @ qg)), 1.0))
        errs.append((r["i"], np.linalg.norm(Te[:3] - Tg[:3]),
                     float(Te[7] / Tg[7]),
                     rot,
                     r.get("match_frac", -1), r.get("gn_iters", -1),
                     r.get("new_kf_metric", -1),
                     int(r.get("new_kf", False))))
    errs = np.asarray(errs, np.float64)
    if len(errs):
        print("\nper-frame tracked pose vs GT (i, t_err, scale_ratio, "
              "rot_err, match_frac, gn_iters, kf_metric, new_kf):")
        worst = np.argsort(-errs[:, 1])[:12]
        for k in sorted(worst):
            print("  i=%3d t_err=%.4f s_ratio=%.3f rot=%.4f mf=%.3f "
                  "gn=%2d kfm=%.3f kf=%d" % tuple(errs[k]))
        kf_rows = errs[errs[:, 7] > 0]
        print("\nframes: %d  med t_err %.4f  max t_err %.4f (i=%d)" % (
            len(errs), np.median(errs[:, 1]), errs[:, 1].max(),
            errs[np.argmax(errs[:, 1]), 0]))
        print("scale ratio est/gt: min %.3f max %.3f (per-frame drift "
              "channel)" % (errs[:, 2].min(), errs[:, 2].max()))
        print("keyframe creations at i=%s" %
              [int(x) for x in kf_rows[:, 0]])

    # mode transitions
    for r in rows:
        if r.get("mode") not in ("TRACKING", None) or not r.get("ok", True):
            print("  event: i=%s mode=%s ok=%s mf=%s" % (
                r.get("i"), r.get("mode"), r.get("ok"),
                r.get("match_frac")))

    # --- final keyframe trajectory vs GT ---------------------------------
    if args.est:
        est = np.loadtxt(args.est)
        ts_gt = np.asarray(oracle["timestamps"])
        print("\nfinal keyframe poses vs GT (post-BA):")
        for row in est:
            t = row[0]
            i = int(np.argmin(np.abs(ts_gt - t)))
            Tg = T_gt[i]
            terr = np.linalg.norm(row[1:4] - Tg[:3])
            print("  t=%.2f i=%3d t_err=%.4f  (gt |t|=%.3f)" % (
                t, i, terr, np.linalg.norm(Tg[:3])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
