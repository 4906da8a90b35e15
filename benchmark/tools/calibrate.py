"""The readings the limits of a cell are set from: runs of one cell on
several seeds in one process, each printing the program's compared numbers
and the control's (the reference one precision step down, in the program's
place) as one JSON line.

    python3 -m benchmark.tools.calibrate --workload <cell> \
        --seeds 11,12,13 --seconds 12 [--trace 1] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None):
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--no-control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from benchmark import harness

    harness.cache_dirs()
    cell = harness.load_cell(args.workload, need_limits=False)
    import torch

    harness.device_info(torch, int(cell.workload["chips"]))
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = harness.run_cell(
            cell, seed, args.seconds, bool(args.trace), "cuda", t_start,
            log=lambda m: print(m, file=sys.stderr, flush=True),
            control=not args.no_control)
        res.pop("checks", None)
        line = json.dumps(dict(workload=args.workload, seed=seed,
                               run_s=time.perf_counter() - t0, **res))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        t_start = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    main()
