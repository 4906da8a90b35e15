"""Run a long drive as a chain of fresh ``main_torch.py`` processes with
SLAM-state checkpoints between segments.

The counterpart of ``scripts/segmented_drive.py``, with its flags.  A run
of many frames is checkpointed and resumed in bounded segments: each
process runs ``--segment`` protocol frames from ``--start-frame``, saves
the SLAM state with ``--state-out`` and the next one restores it with
``--resume-state`` (the retrieval index is replayed from the restored
arena, ``pipeline.SLAMSystem.load_state``), so a run can be stopped and
picked up again between segments, and no process holds more than one
segment's host state.  The JAX script's reason, XLA:CPU's code mappings
that grow for the life of a process, does not apply to the port.  Unlike
that script it does not add ``--cpu``: the processes run on the card unless
``--cpu`` is among the passed-through arguments.

    python -m mast3r_slam_torch.tools.segmented_drive --dataset D --config C
        [--segment 40] [main_torch.py passthrough args...]
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dataset", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--segment", type=int, default=40,
                   help="protocol frames per process")
    p.add_argument("--save-as", default="segmented")
    p.add_argument("--gt", default="")
    p.add_argument("--ate-max-diff", type=float, default=0.05)
    p.add_argument("--rates-out", default="")
    args, passthrough = p.parse_known_args(argv)

    from mast3r_slam_torch.utils.config import load_config

    # count protocol frames: dataset frames / config subsample
    cfg = load_config(args.config)
    sub = int(cfg["dataset"].get("subsample", 1))
    n_raw = len(list(pathlib.Path(args.dataset).glob("*.png")))
    n = -(-n_raw // sub)

    with tempfile.TemporaryDirectory() as tmp:
        state = pathlib.Path(tmp) / "seg_state.npz"
        seg_starts = list(range(0, n, args.segment))
        for k, s0 in enumerate(seg_starts):
            last = k == len(seg_starts) - 1
            cmd = [sys.executable, str(ROOT / "main_torch.py"),
                   "--dataset", args.dataset, "--config", args.config,
                   "--no-viz",
                   "--start-frame", str(s0),
                   "--max-frames", str(min(s0 + args.segment, n)),
                   "--save-as", args.save_as,
                   ] + passthrough
            if k > 0:
                cmd += ["--resume-state", str(state)]
            if not last:
                cmd += ["--state-out", str(state)]
            else:
                if args.gt:
                    cmd += ["--gt", args.gt,
                            "--ate-max-diff", str(args.ate_max_diff)]
                if args.rates_out:
                    cmd += ["--rates-out", args.rates_out]
            print(f"[segment {k + 1}/{len(seg_starts)}] frames "
                  f"{s0}..{min(s0 + args.segment, n) - 1}", flush=True)
            subprocess.run(cmd, check=True, cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.exit(main())
