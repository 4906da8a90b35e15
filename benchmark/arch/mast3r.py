"""MASt3R ViT-L/16 encoder, two ViT-B decoders, DPT and catMLP heads
(naver/mast3r, ``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric``): what
the harness knows of this network.

A configuration names this file with ``"architecture": "mast3r"``; its
``network`` keys are ``reference.network.NetConfig``'s (and the port's
``MASt3RConfig``'s), and ``trunk_dtype``, ``head_dtype`` and
``int8_encoder`` say how the port serves it.  The harness reads the names
below and nothing else of the network:

* ``net_config(config)``: the reference's ``NetConfig``;
* ``make_state_dict(config, device)``: the seeded, conditioned bf16 weights
  of ``config["weight_seed"]`` (``weights.make_state_dict``);
* ``build_program(config, sd, device)``: the port's ``InferenceEngine``
  over ``models.mast3r.MASt3R`` with those weights;
* ``reference(config, sd, prec, device)``: the plain network of
  ``reference/network.py`` in ``prec``, whose ``views(img_frame, img_kf)``
  takes two uint8 frames and returns the 8 outputs in ``correct.OUTPUTS``
  order for each view;
* ``model_step(config)``: one tracked frame's operations by precision
  (``flops.model_step``), which ``frame_mfu`` divides by;
* ``ATTENTION_MODULES``: the port modules whose ``flash_attention`` (kernel
  A) a traced run counts;
* ``tiny(config)``: the configuration cut to the CPU test size.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from benchmark import flops, weights
from benchmark.reference import network

ATTENTION_MODULES = ("mast3r_slam_torch.models.mast3r",)

# the CPU test size: heads of 32, two encoder and four decoder blocks
_TINY_NET = dict(enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
                 dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
                 feature_dim=32, last_dim=16, layer_dims=[16, 24, 32, 48])
_TINY_HW = [64, 96]


def net_config(config: dict) -> network.NetConfig:
    n = config["network"]
    return network.NetConfig(**{
        f.name: (tuple(n[f.name]) if f.name == "layer_dims" else n[f.name])
        for f in dataclasses.fields(network.NetConfig) if f.name in n})


def make_state_dict(config: dict, device) -> dict:
    return weights.make_state_dict(net_config(config), config["weight_seed"],
                                   device)


def build_program(config: dict, sd: dict, device):
    """The port's network with the benchmark's weights, in the engine the
    system serves it from (the configuration's dtypes and int8 encoder)."""
    from mast3r_slam_torch.inference import InferenceEngine
    from mast3r_slam_torch.models.mast3r import MASt3R, MASt3RConfig
    from mast3r_slam_torch.ops.matching import MatchingConfig

    n = config["network"]
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    mcfg = MASt3RConfig(
        **{k: (tuple(v) if k == "layer_dims" else v) for k, v in n.items()},
        dtype=dt[config["trunk_dtype"]], head_dtype=dt[config["head_dtype"]])
    with torch.device("meta"):
        model = MASt3R(mcfg)
    model = model.to_empty(device=device)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if ".scratch.layer_rn." not in k]
    if missing or unexpected:
        raise KeyError(f"program network: missing {missing}, unexpected "
                       f"{unexpected}")
    return InferenceEngine(
        model, tuple(config["img_hw"]),
        match_cfg=MatchingConfig.from_dict(config["slam"]["matching"]),
        device=device, int8_encoder=bool(config["int8_encoder"]))


def _normalised(img, device):
    """A (h, w, 3) uint8 frame as the network's input (1, h, w, 3) in
    [-1, 1]."""
    x = torch.from_numpy(img).to(device).float() * (1.0 / 127.5) - 1.0
    return x[None]


class _Reference:
    def __init__(self, net, img_hw, device):
        self.net = net
        self.img_hw = tuple(img_hw)
        self.device = device

    def views(self, img_frame, img_kf):
        f1, p1 = self.net.encode(_normalised(img_frame, self.device))
        f2, p2 = self.net.encode(_normalised(img_kf, self.device))
        return self.net.decode_pair(f1, p1, f2, p2, self.img_hw)


def reference(config: dict, sd: dict, prec: network.Precision, device):
    return _Reference(network.build(net_config(config), sd, prec, device),
                      config["img_hw"], device)


def model_step(config: dict) -> dict:
    return flops.model_step(config["network"], config["img_hw"],
                            bool(config["int8_encoder"]))


def tiny(config: dict) -> dict:
    """A copy of ``config`` with the tiny network, 64 x 96 frames and the
    trunk and heads in float32."""
    cfg = copy.deepcopy(config)
    cfg["network"].update(_TINY_NET)
    cfg["img_hw"] = list(_TINY_HW)
    cfg["trunk_dtype"] = cfg["head_dtype"] = "float32"
    return cfg
