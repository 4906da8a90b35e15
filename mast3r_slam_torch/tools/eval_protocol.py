"""Batch evaluation protocol runner of the port: run ``main_torch.py``
headless over each benchmark sequence, then score ATE RMSE with the
built-in Sim(3)-Umeyama evaluator (``mast3r_slam_torch/evaluate.py::
ate_rmse``, the ``evo_ape tum gt est -as`` equivalent) and print the
per-sequence table the accuracy north star is scored on.

The counterpart of ``scripts/eval_protocol.py`` (the Python mirror of the
reference's ``scripts/eval_{tum,euroc,7_scenes,eth3d}.sh``), with its flags,
suites, table and exit code.  Its JSON table goes to
``logs/ate_<suite>_<mode>_torch.json``, beside the JAX harness's
``logs/ate_<suite>_<mode>.json``, which it never overwrites.

Usage:
    python -m mast3r_slam_torch.tools.eval_protocol tum           # run + score
    python -m mast3r_slam_torch.tools.eval_protocol euroc --no-calib
    python -m mast3r_slam_torch.tools.eval_protocol 7-scenes --print  # score-only
    python -m mast3r_slam_torch.tools.eval_protocol tum --sequences rgbd_dataset_freiburg1_xyz
    python -m mast3r_slam_torch.tools.eval_protocol tum --main-args="--cpu --tiny-model"

Datasets are expected under datasets/<suite>/; EuRoC / 7-Scenes
groundtruths under groundtruths/<suite>/<seq>.txt
(``scripts/make_groundtruths.py`` derives them from the raw datasets).
``main_torch.py`` runs on the card unless ``--main-args`` holds ``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shlex
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
# where main_torch.py's runs and the JSON table go (main_torch.py writes
# under logs/ of its working directory, the repository root)
LOGS = REPO / "logs"

TUM_SEQUENCES = [
    "rgbd_dataset_freiburg1_360",
    "rgbd_dataset_freiburg1_desk",
    "rgbd_dataset_freiburg1_desk2",
    "rgbd_dataset_freiburg1_floor",
    "rgbd_dataset_freiburg1_plant",
    "rgbd_dataset_freiburg1_room",
    "rgbd_dataset_freiburg1_rpy",
    "rgbd_dataset_freiburg1_teddy",
    "rgbd_dataset_freiburg1_xyz",
]

EUROC_SEQUENCES = [
    "MH_01_easy", "MH_02_easy", "MH_03_medium", "MH_04_difficult",
    "MH_05_difficult", "V1_01_easy", "V1_02_medium", "V1_03_difficult",
    "V2_01_easy", "V2_02_medium", "V2_03_difficult",
]

SEVEN_SCENES_SEQUENCES = [
    "chess", "fire", "heads", "office", "pumpkin", "redkitchen", "stairs",
]

# eval_eth3d.sh:4-63 (commented-out dark sequences excluded there too)
ETH3D_SEQUENCES = [
    "plant_1", "plant_2", "plant_3", "plant_4", "plant_5",
    "cables_1", "cables_2", "cables_3",
    "camera_shake_1", "camera_shake_2", "camera_shake_3",
    "ceiling_1", "ceiling_2", "desk_3", "desk_changing_1",
    "einstein_1", "einstein_2", "einstein_flashlight",
    "einstein_global_light_changes_1", "einstein_global_light_changes_2",
    "einstein_global_light_changes_3",
    "kidnap_1", "large_loop_1",
    "mannequin_1", "mannequin_3", "mannequin_4", "mannequin_5",
    "mannequin_7", "mannequin_face_1", "mannequin_face_2",
    "mannequin_face_3", "mannequin_head", "motion_1",
    "planar_2", "planar_3",
    "plant_scene_1", "plant_scene_2", "plant_scene_3",
    "reflective_1", "repetitive", "sfm_bench", "sfm_garden",
    "sfm_house_loop", "sfm_lab_room_1", "sfm_lab_room_2",
    "sofa_1", "sofa_2", "sofa_3", "sofa_4", "sofa_shake",
    "table_3", "table_4", "table_7", "vicon_light_1", "vicon_light_2",
]


class Suite:
    """Per-benchmark protocol description (dataset root, config, GT source,
    timestamp-association window in the suite's native time units)."""

    def __init__(self, name, sequences, dataset_root, gt, max_diff,
                 calib_choice=True, config=None):
        self.name = name
        self.sequences = sequences
        self.dataset_root = pathlib.Path(dataset_root)
        self.gt = gt  # "dataset" -> <seq>/groundtruth.txt, else dir path
        self.max_diff = max_diff
        self.calib_choice = calib_choice  # supports --no-calib
        self.config = config  # fixed config overrides calib choice

    def gt_file(self, seq: str) -> pathlib.Path:
        if self.gt == "dataset":
            return self.dataset_root / seq / "groundtruth.txt"
        return pathlib.Path(self.gt) / f"{seq}.txt"


SUITES = {
    # TUM GT is inside each sequence dir; timestamps in seconds
    "tum": Suite("tum", TUM_SEQUENCES, "datasets/tum", "dataset", 0.05),
    # EuRoC timestamps are nanoseconds; GT at 200 Hz -> generous 0.1 s
    "euroc": Suite("euroc", EUROC_SEQUENCES, "datasets/euroc",
                   "groundtruths/euroc", 1e8),
    # 7-Scenes timestamps are frame indices
    "7-scenes": Suite("7-scenes", SEVEN_SCENES_SEQUENCES,
                      "datasets/7-scenes", "groundtruths/7-scenes", 0.5),
    # ETH3D: GT in-dataset, seconds; always-calibrated config (eth3d.yaml)
    "eth3d": Suite("eth3d", ETH3D_SEQUENCES, "datasets/eth3d/train",
                   "dataset", 0.05, calib_choice=False,
                   config="config/eth3d.yaml"),
}


def _save_as(save_root: str, seq: str) -> str:
    """``--save-as`` of a sequence's run: ``<save_root>/<seq>`` under
    ``logs/``, or the absolute directory when ``LOGS`` lies elsewhere."""
    d = LOGS / save_root / seq
    try:
        return str(d.relative_to(REPO / "logs"))
    except ValueError:
        return str(d)


def run_suite(suite: Suite, args) -> int:
    from mast3r_slam_torch.evaluate import ate_rmse

    sequences = args.sequences or suite.sequences
    if suite.config:
        config = suite.config
        mode = "default"
        save_root = suite.name
    else:
        mode = "no_calib" if args.no_calib else "calib"
        config = ("config/eval_no_calib.yaml" if args.no_calib
                  else "config/eval_calib.yaml")
        save_root = f"{suite.name}/{mode}"

    extra = shlex.split(args.main_args) if args.main_args else []

    if not args.print:
        for seq in sequences:
            ds = suite.dataset_root / seq
            if not ds.exists():
                print(f"[skip] dataset missing: {ds}", file=sys.stderr)
                continue
            cmd = [sys.executable, "main_torch.py",
                   "--dataset", str(ds),
                   "--no-viz",
                   "--save-as", _save_as(save_root, seq),
                   "--config", config] + extra
            print("+", " ".join(cmd), flush=True)
            t0 = time.time()
            ret = subprocess.run(cmd, cwd=REPO)
            print(f"  -> exit {ret.returncode} in {time.time() - t0:.0f}s",
                  flush=True)

    # scoring pass (eval_tum.sh:43-50)
    rows = []
    for seq in sequences:
        est = LOGS / save_root / seq / f"{seq}.txt"
        gt = REPO / suite.gt_file(seq)
        if not est.exists() or not gt.exists():
            rows.append((seq, None,
                         f"missing {'est' if not est.exists() else 'gt'}"))
            continue
        try:
            ate = ate_rmse(gt, est, max_diff=suite.max_diff)
            rows.append((seq, float(ate), ""))
        except Exception as e:  # scoring failure is a result, not a crash
            rows.append((seq, None, str(e)[:80]))

    print(f"\n== {suite.name} ({mode}) ATE RMSE [m], Sim3-aligned ==")
    vals = []
    for seq, ate, note in rows:
        if ate is None:
            print(f"  {seq:42s}  ------   {note}")
        else:
            print(f"  {seq:42s}  {ate:.4f}")
            vals.append(ate)
    if vals:
        print(f"  {'mean over ' + str(len(vals)) + ' seq':42s}  "
              f"{sum(vals) / len(vals):.4f}")

    out = LOGS / f"ate_{suite.name}_{mode}_torch.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump({
            "suite": suite.name, "mode": mode,
            "ate_rmse": {s: a for s, a, _ in rows},
            "mean": sum(vals) / len(vals) if vals else None,
            "n_scored": len(vals), "n_total": len(rows),
        }, f, indent=1)
    print(f"written: {out}")
    return 0 if vals else 1


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("suite", choices=sorted(SUITES))
    p.add_argument("--no-calib", action="store_true",
                   help="uncalibrated protocol (eval_no_calib.yaml)")
    p.add_argument("--print", action="store_true",
                   help="score existing logs only (eval_*.sh --print)")
    p.add_argument("--sequences", nargs="*", default=None,
                   help="subset of sequences")
    p.add_argument("--main-args", default="",
                   help="extra args passed to main_torch.py (e.g. '--cpu')")
    args = p.parse_args(argv)
    suite = SUITES[args.suite]
    if args.no_calib and not suite.calib_choice:
        p.error(f"{suite.name} protocol has no --no-calib variant")
    return run_suite(suite, args)


if __name__ == "__main__":
    sys.exit(main())
