"""One JAX reference run of ``tests/test_torch_bench_tools.py``'s sweep:
the JAX package's ``SLAMSystem`` with its ``OracleEngine`` over a sequence
the test wrote (the port's ``SyntheticSequence.save`` file and its images),
at ``config/eval_no_calib.yaml`` with the variant's changes, as
``scripts/sweep_approximations.py`` runs it; prints the ATE with every
digit on its last line.  Run from the repository root.

Usage: python _torch_sweep_jax_worker.py <dir> <variant> <img_size>
"""

import pathlib
import sys


def main():
    d, variant, img_size = (pathlib.Path(sys.argv[1]), sys.argv[2],
                            int(sys.argv[3]))
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from mast3r_slam_tpu import evaluate
    from mast3r_slam_tpu.pipeline import SLAMSystem
    from mast3r_slam_tpu.testing import OracleEngine, SyntheticSequence
    from mast3r_slam_tpu.utils.config import (apply_reference_exact,
                                              load_config)

    seq = SyntheticSequence.load(d / "seq.npz")
    seq.images = list(np.load(d / "images.npy"))
    cfg = load_config("config/eval_no_calib.yaml")
    cfg["dataset"]["img_size"] = img_size
    if variant == "reference_exact":
        cfg = apply_reference_exact(cfg)
    elif variant != "production":
        raise SystemExit(f"unknown variant {variant}")
    s = SLAMSystem(cfg, OracleEngine(seq), (seq.h, seq.w), buffer=32)
    for i in range(len(seq)):
        s.process_frame(i, seq.images[i])
    s.terminate()
    out = d / variant
    evaluate.save_traj(out, "t.txt", seq.timestamps, s.arena)
    seq.write_gt(out / "gt.txt")
    print(repr(evaluate.ate_rmse(out / "gt.txt", out / "t.txt",
                                 max_diff=0.05)))


if __name__ == "__main__":
    main()
