#!/usr/bin/env python3
"""The tracked-FPS benchmark of the PyTorch + CUDA port.

The counterpart of ``bench.py``: the frontend frame step and the keyframe
stages at 384x512 with the ViT-L network (bf16 heads, seeded random
weights), timed on the host clock with a synchronize at the end of every
call, composed into the protocol rate with the rates of
``bench_rates.json``.  Prints one JSON line with ``bench.py``'s keys (and
``breakdown_ms.drive_tracked_frame``) on stdout and logs to stderr.  The
stages and knobs are those of ``mast3r_slam_torch/tools/bench.py``.

    python3 bench_torch.py                          # on the card
    BENCH_SMALL=1 BENCH_CPU=1 python3 bench_torch.py  # tiny model, CPU

Run from the repository root.  Without a CUDA card and without
``BENCH_CPU=1`` it exits non-zero and prints no record.
"""

from __future__ import annotations

import sys

from mast3r_slam_torch.tools import bench

if __name__ == "__main__":
    sys.exit(bench.main())
