"""How the keyframe metric answers a camera's motion: the camera's first
frame as the keyframe, then frames cut from the strip at given offsets
(and with given photometric noise), each tracked against it from the
identity warm start; prints the keyframe metric and the match share.  The
traffic mixes' jump is chosen from this, so that held frames sit far
above ``match_frac_thresh`` and jump frames far below it and far above
``min_match_frac``.  With ``--held N``, also N frames of the first view
driven through ``process_frame`` at each noise level: per frame the
keyframe metric, the GN iterations, the keyframe decision and the host
time.

    python3 -m benchmark.tools.probe_keyframes --workload <cell> \
        --offsets 0:0,16:0,384:0 --noise 0,2 --seeds 1,2,3 [--held 40] \
        [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--offsets", required=True)
    ap.add_argument("--noise", default="0")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--held", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import harness
    from benchmark.clips import stream_rng, texture
    from benchmark.drive import make_system_factory

    harness.cache_dirs()
    cell = harness.load_cell(args.workload, need_limits=False)
    import torch

    from mast3r_slam_torch.frame import arena_get

    harness.device_info(torch, 1)
    from mast3r_slam_torch import _build
    _build.build(sorted(p.stem for p in _build.CSRC.glob("*.cu")))
    arch = harness.load_arch(cell.config, cell.config_file)
    sd = arch.make_state_dict(cell.config, "cuda")
    engine = arch.build_program(cell.config, sd, "cuda")
    make = make_system_factory(cell.config["slam"], engine,
                               cell.config["img_hw"])
    offsets = [tuple(int(v) for v in o.split(":"))
               for o in args.offsets.split(",")]
    noises = [float(n) for n in args.noise.split(",")]
    h, w = cell.config["img_hw"]
    M = max(abs(d) for o in offsets for d in o)
    tex = cell.traffic["texture"]
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        rng = stream_rng(seed, 0)
        strip = texture(rng, h + 2 * M, w + 2 * M, float(tex["share"]),
                        int(tex["grain_px"]))

        def cut(dx, dy, noise):
            img = strip[M + dy:M + dy + h, M + dx:M + dx + w]
            if noise:
                img = np.clip(img + rng.normal(0, noise, img.shape), 0,
                              255).astype(np.uint8)
            return np.ascontiguousarray(img)

        system = make()
        system.process_frame(0, cut(0, 0, 0))
        kf = arena_get(system.arena, 0)
        rows = []
        for noise in noises:
            for dx, dy in offsets:
                frame = system.create_frame(1, cut(dx, dy, noise))
                system.tracker.reset_idx_f2k()
                system.tracker.track(frame, kf)
                d = system.tracker.last_diag
                rows.append([dx, dy, noise, round(d["new_kf_metric"], 4),
                             round(d["match_frac"], 4)])
        system.terminate()
        held = []
        for noise in noises if args.held else []:
            system = make()
            system.process_frame(0, cut(0, 0, 0))
            per = []
            for t in range(1, args.held + 1):
                img = cut(0, 0, noise)
                t0 = time.perf_counter()
                info = system.process_frame(t, img)
                per.append([round(1e3 * (time.perf_counter() - t0), 1),
                            info.get("gn_iters"),
                            round(info.get("new_kf_metric") or 0.0, 4),
                            bool(info["new_kf"])])
            system.terminate()
            held.append(dict(noise=noise, frames=per))
        line = json.dumps(dict(seed=seed, rows=rows, held=held))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
    print("done", file=sys.stderr)


if __name__ == "__main__":
    main()
