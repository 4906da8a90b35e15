"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for.  Prints progress and the compared numbers (each beside its limit) on
standard error, and as the last line of standard output one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (with ``--trace 0`` the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``.  Exits
non-zero, printing no result, without the cards, or when a module of JAX
or of the JAX package is loaded at the end.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    harness.cache_dirs(ROOT)
    cell = harness.load_cell(args.workload, ROOT, need_limits=False)
    import torch

    dev_info = harness.device_info(torch, int(cell.workload["chips"]))
    if cell.limits is None:
        raise SystemExit(f"benchmark: no limits file for {args.workload}")
    log(f"{dev_info['kind']}, power limit {dev_info['power_limit_w']} W; "
        f"workload {args.workload}, seed {args.seed}, {args.seconds} s, "
        f"trace {args.trace}")
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START, log=log)
    out["device"] = {**dev_info, **out["device"],
                     "kind": dev_info["kind"]}
    bad = harness.imported_forbidden()
    if bad:
        log(f"benchmark: the process has loaded {bad} (JAX or the JAX "
            f"package); no result")
        return 3
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
