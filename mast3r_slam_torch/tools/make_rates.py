"""Measure the protocol rates that ``bench_torch.py`` composes its headline
with: a dedicated loop-closure drive of the oracle pipeline with the oracle
retrieval database on, so the keyframe cadence, the retrieval-proposal
cadence and the accepted loop-closure edge rate are measured, not the
structural zeros of a clip without retrieval.

The counterpart of ``scripts/make_rates.py``, with its flags and defaults:
the clip is written with ``tools.make_synthetic_clip`` (a closed trajectory,
``--cycles`` sweeps of the scene), ``main_torch.py --oracle --oracle-desc
--oracle-retrieval --no-viz`` runs it at ``config/eval_no_calib.yaml`` from
the repository root and writes its ``--rates-out``, and the run's
trajectory is scored with ``evaluate.ate_rmse``.  A drive with an ATE
above 0.2 m lost tracking and measured a relocalization cadence, so
nothing is written.  The rates get ``ate_rmse`` and a ``provenance`` naming
this tool.  The drive runs on the card unless ``--cpu`` is given (passed on
to ``main_torch.py``); the oracle needs no network weights and the rates
are counts, not timings, so either device measures the same cadence.

    python -m mast3r_slam_torch.tools.make_rates [--frames 160] [--res H W]
        [--out bench_rates.json] [--clip $TMPDIR/rates_clip]
        [--traj-scale 0.35] [--cycles 0] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]
ATE_MAX = 0.2


def write_clip(clip, frames: int, h: int, w: int, traj_scale: float = 0.35,
               cycles: int = 0) -> int:
    """The rates drive's closed-loop clip, written with
    ``tools.make_synthetic_clip``; ``cycles`` 0 takes about one sweep of
    the scene per 40 frames.  Returns the sweeps."""
    from mast3r_slam_torch.tools import make_synthetic_clip

    cycles = cycles or max(1, round(frames / 40))
    make_synthetic_clip.main([str(clip), str(frames), str(h), str(w),
                              "--loop", "--traj-scale", str(traj_scale),
                              "--cycles", str(cycles)])
    return cycles


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=160)
    p.add_argument("--res", type=int, nargs=2, default=[384, 512],
                   metavar=("H", "W"))
    p.add_argument("--out", default="bench_rates.json")
    p.add_argument("--clip", default=str(pathlib.Path(tempfile.gettempdir())
                                         / "rates_clip"))
    p.add_argument("--traj-scale", type=float, default=0.35,
                   help="trajectory amplitude scale (larger scene -> "
                        "realistic keyframe cadence)")
    p.add_argument("--cycles", type=int, default=0,
                   help="scene sweeps (0 = auto ~ frames/40: bounded "
                        "amplitude + genuine revisits)")
    p.add_argument("--cpu", action="store_true",
                   help="run the drive on the CPU (default: the card)")
    args = p.parse_args(argv)
    h, w = args.res

    from mast3r_slam_torch.evaluate import ate_rmse

    clip = pathlib.Path(args.clip)
    cycles = write_clip(clip, args.frames, h, w, args.traj_scale,
                        args.cycles)
    rates_path = clip / "rates.json"
    subprocess.run(
        [sys.executable, str(ROOT / "main_torch.py"),
         "--dataset", str(clip),
         "--config", "config/eval_no_calib.yaml",
         "--no-viz", "--oracle", "--oracle-desc", "--oracle-retrieval",
         *(["--cpu"] if args.cpu else []),
         "--gt", str(clip / "gt.txt"), "--ate-max-diff", "0.05",
         "--rates-out", str(rates_path),
         "--save-as", "rates_run"],
        check=True, cwd=ROOT,
    )
    with open(rates_path) as f:
        rates = json.load(f)
    # a drive that lost tracking measures a relocalization cadence, not the
    # protocol's: refuse to write the rates file from it
    ate = ate_rmse(clip / "gt.txt",
                   ROOT / "logs" / "rates_run" / f"{clip.name}.txt",
                   max_diff=0.05)
    rates["ate_rmse"] = round(ate, 5)
    if ate > ATE_MAX:
        raise SystemExit(
            f"rates drive diverged (ATE {ate:.3f} m): not writing "
            f"{args.out}; adjust --traj-scale/--cycles")
    rates["provenance"] = (
        f"mast3r_slam_torch/tools/make_rates.py: {args.frames}-frame "
        f"closed-loop clip at {h}x{w} ({cycles} scene sweeps), oracle engine "
        f"+ oracle ASMK retrieval, config/eval_no_calib.yaml"
    )
    out = ROOT / args.out
    with open(out, "w") as f:
        json.dump(rates, f, indent=1)
    print(f"wrote {out}: {rates}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
