"""Render a synthetic clip (PNG folder + TUM ground truth + calibration) for
driving the CLI pipeline without external datasets.

The counterpart of ``scripts/make_synthetic_clip.py``, with its arguments
and files (``NNNNNN.png``, ``gt.txt``, ``oracle.npz``, ``calibration.txt``),
rendered by the port's ``testing.SyntheticSequence`` in numpy and written
through ``testing.write_clip`` (PIL):

    python -m mast3r_slam_torch.tools.make_synthetic_clip OUTDIR [n_frames]
        [h] [w] [--loop] [--scene smooth|cliff|occluder] [--traj-scale S]
        [--seed N] [--cycles C]

``--loop`` closes the trajectory (integer-cycle sinusoids return to the
start) so retrieval proposes genuine loop-closure edges.
"""

from __future__ import annotations

import argparse
import pathlib
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("out", nargs="?", default="/tmp/clip")
    p.add_argument("n_frames", nargs="?", type=int, default=30)
    p.add_argument("h", nargs="?", type=int, default=96)
    p.add_argument("w", nargs="?", type=int, default=128)
    p.add_argument("--loop", action="store_true",
                   help="closed trajectory (loop-closure clip)")
    p.add_argument("--scene", default="smooth",
                   choices=["smooth", "cliff", "occluder"])
    p.add_argument("--traj-scale", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cycles", type=int, default=1,
                   help="trajectory sweeps of the scene (bounded "
                        "amplitude for long clips; see make_trajectory)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from mast3r_slam_torch.testing import SyntheticSequence, write_clip

    seq = SyntheticSequence(n_frames=args.n_frames, h=args.h, w=args.w,
                            seed=args.seed, traj_scale=args.traj_scale,
                            loop=args.loop, scene=args.scene,
                            cycles=args.cycles)
    out = pathlib.Path(args.out)
    write_clip(seq, out)
    print(f"wrote {args.n_frames} frames to {out} "
          f"(gt.txt, calibration.txt, loop={args.loop}, "
          f"scene={args.scene})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
