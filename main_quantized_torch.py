#!/usr/bin/env python3
"""The int8-encoder entry point of the PyTorch + CUDA port.

The counterpart of ``main_quantized.py``: ``main_torch.py`` with
``--int8-encoder`` appended when it is absent, so the encoder's Linears run
as per-channel int8 weights with per-token int8 activations on the card's
int8 product (``mast3r_slam_torch/models/quant.py``).  Same flags, same
outputs; there is no fallback to the bf16 encoder: a shape the int8
product does not take raises.

    python3 main_quantized_torch.py --dataset <clip> --config config/base.yaml --no-viz
"""

from __future__ import annotations

import sys

import main_torch


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--int8-encoder" not in argv:
        argv.append("--int8-encoder")
    return main_torch.main(argv)


if __name__ == "__main__":
    sys.exit(main())
