"""VGGT-1B (facebookresearch/vggt, arXiv:2503.11651): DINOv2-L/14, 24
alternating frame/global attention pairs, the point and track-feature DPT
heads; what the harness knows of this network.

A configuration names this file with ``"architecture": "vggt"``; its
``network`` keys are ``reference.vggt.VGGTNet``'s (and the port's
``VGGTConfig``'s), ``trunk_dtype`` and ``head_dtype`` say how the port
serves it, and ``int8_encoder`` is false (the int8 encoder is MASt3R's).
The seven names the harness reads:

* ``net_config(config)``: the reference's ``VGGTNet``;
* ``make_state_dict(config, device)``: the seeded, conditioned bf16
  weights of ``config["weight_seed"]`` (``vggt_weights.make_state_dict``);
* ``build_program(config, sd, device)``: the port's ``InferenceEngine``
  over ``models.vggt.VGGT`` with those weights;
* ``reference(config, sd, prec, device)``: ``reference/vggt.py`` in
  ``prec``, whose ``views(img_frame, img_kf)`` gives the 8 outputs;
* ``model_step(config)``: one tracked frame's operations
  (``vggt_flops.model_step``);
* ``ATTENTION_MODULES``: the port module that calls kernel A;
* ``tiny(config)``: the configuration cut to the CPU test size.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from benchmark import vggt_flops, vggt_weights
from benchmark.reference import vggt as ref_vggt

ATTENTION_MODULES = ("mast3r_slam_torch.models.vggt",)

# the CPU test size: width 64, 2 heads of 32, 2 encoder blocks, 4
# aggregator depths read at (0, 1, 2, 3), narrow heads, 56 x 70 frames
_TINY_NET = dict(embed_dim=64, num_heads=2, enc_depth=2, depth=4,
                 pos_grid=8, dpt_layers=[0, 1, 2, 3],
                 dpt_channels=[16, 24, 32, 48], point_features=32,
                 track_features=32, point_hidden=16)
_TINY_HW = [56, 70]
_TUPLES = ("dpt_layers", "dpt_channels")


def _fields(n: dict, cls) -> dict:
    return {f.name: (tuple(n[f.name]) if f.name in _TUPLES else n[f.name])
            for f in dataclasses.fields(cls) if f.name in n}


def net_config(config: dict) -> ref_vggt.VGGTNet:
    return ref_vggt.VGGTNet(**_fields(config["network"], ref_vggt.VGGTNet))


def make_state_dict(config: dict, device) -> dict:
    return vggt_weights.make_state_dict(net_config(config),
                                        config["weight_seed"], device)


def build_program(config: dict, sd: dict, device):
    """The port's network with the benchmark's weights, in the engine the
    system serves it from (the configuration's dtypes)."""
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.vggt import VGGT, VGGTConfig
    from mast3r_slam_torch.ops.matching import MatchingConfig

    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    vcfg = VGGTConfig(**_fields(config["network"], VGGTConfig),
                      dtype=dt[config["trunk_dtype"]],
                      head_dtype=dt[config["head_dtype"]])
    with torch.device("meta"):
        model = VGGT(vcfg)
    model = model.to_empty(device=device)
    model.load_state_dict(sd, strict=True)
    return InferenceEngine(
        model, tuple(config["img_hw"]),
        match_cfg=MatchingConfig.from_dict(config["slam"]["matching"]),
        device=device, int8_encoder=bool(config["int8_encoder"]))


def reference(config: dict, sd: dict, prec, device):
    return ref_vggt.build(net_config(config), sd, prec, device)


def model_step(config: dict) -> dict:
    return vggt_flops.model_step(config["network"], config["img_hw"])


def tiny(config: dict) -> dict:
    """A copy of ``config`` with the tiny network, 56 x 70 frames and the
    trunk and heads in float32."""
    cfg = copy.deepcopy(config)
    cfg["network"].update(copy.deepcopy(_TINY_NET))
    cfg["img_hw"] = list(_TINY_HW)
    cfg["trunk_dtype"] = cfg["head_dtype"] = "float32"
    return cfg
