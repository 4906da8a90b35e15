"""A/B sweep of the fast-path approximations, each toggled alone, the full
production bundle and the ``reference_exact`` bundle, across synthetic
scenes (smooth / cliff / occluder), scored by ATE on the oracle pipeline.

The counterpart of ``scripts/sweep_approximations.py``, with its flags,
variants and scenes, on the port's ``SLAMSystem`` with
``testing.OracleEngine`` (and ``make_oracle_retrieval`` under
``--loop-closure``) at ``config/eval_no_calib.yaml``.  Prints the markdown
table on stdout and one line per run on stderr.  Runs on the card unless
``--cpu`` is given; run from the repository root (the config's ``inherit``
is read relative to it).

    python -m mast3r_slam_torch.tools.sweep_approximations [--frames N]
        [--seed S] [--noise STD] [--res H W] [--variants a,b]
        [--scenes a,b] [--loop-closure] [--cpu]
"""

from __future__ import annotations

import argparse
import copy
import pathlib
import sys
import tempfile


def variants_for(loop_closure: bool) -> dict:
    """Variant name -> {(section, key): value}; None is the whole
    ``reference_exact`` bundle (sweep_approximations.py:62-82)."""
    if loop_closure:
        return {
            "production(desc_global)": {},
            "retrieval_edge_mode=sym": {
                ("local_opt", "retrieval_edge_mode"): "sym"},
            "reference_exact": None,
        }
    return {
        "production": {},
        "points_subsample=1": {("local_opt", "points_subsample"): 1},
        "reuse_track_matches=off": {
            ("local_opt", "reuse_track_matches"): False},
        "per-component huber": {("tracking", "joint_ray_huber"): False},
        "occlusion_subsample=2": {("matching", "occlusion_subsample"): 2},
        "reference_exact": None,
    }


def scenes_for(loop_closure: bool) -> dict:
    """Scene -> trajectory scale (sweep_approximations.py:106-111): the
    smooth surface tracks so well at 0.45 that no second keyframe is made,
    so it moves further; the loop clips are the rates tool's class."""
    if loop_closure:
        return {"smooth": 0.35, "cliff": 0.3, "occluder": 0.3}
    return {"smooth": 0.9, "cliff": 0.45, "occluder": 0.45}


def variant_config(base: dict, mods):
    from mast3r_slam_torch.utils.config import apply_reference_exact

    cfg = copy.deepcopy(base)
    if mods is None:
        return apply_reference_exact(cfg)
    for (a, b), v in mods.items():
        cfg[a][b] = v
    return cfg


def run_one(cfg, seq, noise: float, loop_closure: bool, device):
    """One oracle drive of ``seq`` under ``cfg``: (ATE, mean GN
    iterations)."""
    from mast3r_slam_torch import evaluate
    from mast3r_slam_torch.pipeline import SLAMSystem
    from mast3r_slam_torch.testing import OracleEngine, make_oracle_retrieval

    eng = OracleEngine(seq, noise_std=noise, export_desc=loop_closure,
                       device=device)
    retrieval = make_oracle_retrieval(seq, eng) if loop_closure else None
    s = SLAMSystem(cfg, eng, (seq.h, seq.w), buffer=32, retrieval=retrieval,
                   device=device)
    try:
        for i in range(len(seq)):
            s.process_frame(i, seq.images[i])
    finally:
        s.terminate()
    gn = s.tracker.gn_iters_total / max(s.tracker.gn_frames, 1)
    if loop_closure:
        print(f"    [desc batches {s.graph.n_desc_batches}"
              f" fallbacks {s.graph.n_desc_fallbacks}"
              f" retrieval edges {s.stats['retrieval_edges']}]",
              file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        evaluate.save_traj(d, "t.txt", seq.timestamps, s.arena)
        seq.write_gt(d / "gt.txt")
        return evaluate.ate_rmse(d / "gt.txt", d / "t.txt",
                                 max_diff=0.05), gn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=14)
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="pointmap noise std (OracleEngine)")
    ap.add_argument("--res", type=int, nargs=2, default=[48, 64],
                    metavar=("H", "W"),
                    help="scene resolution (384 512 runs the production "
                         "defaults at real match statistics)")
    ap.add_argument("--variants", default="",
                    help="comma-separated variant-name filter (default "
                         "all)")
    ap.add_argument("--scenes", default="",
                    help="comma-separated scene filter (default all)")
    ap.add_argument("--loop-closure", action="store_true",
                    help="closed-loop clip with oracle retrieval and "
                         "descriptor export: A/Bs the retrieval-edge "
                         "approximations (desc_global vs sym vs "
                         "reference_exact) through real loop-closure "
                         "edges instead of the frontend stack")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    from mast3r_slam_torch.testing import SyntheticSequence
    from mast3r_slam_torch.utils.config import load_config

    device = "cpu" if args.cpu else "cuda"
    H, W = args.res
    base = load_config("config/eval_no_calib.yaml")
    base["dataset"]["img_size"] = max(H, W)
    variants = variants_for(args.loop_closure)
    if args.variants:
        keep = {v.strip() for v in args.variants.split(",")}
        variants = {k: v for k, v in variants.items() if k in keep}
    scenes = scenes_for(args.loop_closure)
    if args.scenes:
        keep = {x.strip() for x in args.scenes.split(",")}
        scenes = {k: v for k, v in scenes.items() if k in keep}

    rows = []
    for scene, tscale in scenes.items():
        seq = SyntheticSequence(n_frames=args.frames, h=H, w=W,
                                seed=args.seed, traj_scale=tscale,
                                scene=scene, loop=args.loop_closure,
                                cycles=2 if args.loop_closure else 1)
        row = {}
        for name, mods in variants.items():
            row[name], gn = run_one(variant_config(base, mods), seq,
                                    args.noise, args.loop_closure, device)
            print(f"  {scene:9s} {name:24s} ATE {row[name]:.4f} "
                  f"gn_iters {gn:.1f}", file=sys.stderr, flush=True)
        rows.append((scene, row))

    print(f"\n| scene | " + " | ".join(variants) + " |")
    print("|---" * (len(variants) + 1) + "|")
    for scene, row in rows:
        print(f"| {scene} | " + " | ".join(
            f"{row[k]:.4f}" for k in variants) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
