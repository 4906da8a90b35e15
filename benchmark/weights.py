"""The benchmark's network weights: seeded, conditioned so that a clip
tracks, and stored in bf16, the type the configurations serve them in.

They stand in for a checkpoint.  One fixed seed per configuration
(``weight_seed`` in its file) makes them, on the device, with one
``torch.Generator`` call for all the tensors; ``--seed`` never reaches
them, so every seed of a cell runs the same network.  Both the program and
the reference get this state dict; each derives what it needs from it (the
program its bf16 and int8 copies, the reference its float32 copy).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .reference import network


def _shapes(c: network.NetConfig):
    """(name, shape, kind, fan_in) of every tensor of the network, kind
    "one" / "zero" for LayerNorm weights / biases, else "uniform"."""
    with torch.device("meta"):
        net = network.Network(c)
    out = []
    for mname, m in net.named_modules():
        if ".scratch.layer_rn" in f".{mname}":
            continue
        for pname, p in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if isinstance(m, nn.LayerNorm):
                out.append((key, p.shape, "one" if pname == "weight"
                            else "zero", 1))
                continue
            w = m.weight
            # PyTorch's default init: uniform within 1 / sqrt(fan_in), with
            # fan_in from dim 1 of the weight (a transposed conv's output
            # channels, as torch.nn.init computes it)
            fan_in = w.shape[1] * math.prod(w.shape[2:])
            out.append((key, p.shape, "uniform", fan_in))
    return out


def condition_for_tracking(sd: dict, patch_size: int = 16,
                           local_feat_dim: int = 24,
                           residual_scale: float = 0.02,
                           xyz_scale: float = 3.0,
                           desc_conf_bias: float = 2.0) -> dict:
    """Random weights reshaped so the frontend has something to track (a
    frozen copy of the port's ``testing.condition_for_tracking``): every
    transformer residual branch scaled down, the pointmap head biased to a
    surface in front of the camera whose shape follows the image, the
    descriptor confidence raised above the tracker's gate, and the second
    decoder branch and head tied to the first."""
    out = dict(sd)
    for k, v in sd.items():
        if k.startswith(("enc_blocks.", "dec_blocks.")) and \
                k.endswith(("attn.proj.weight", "mlp.fc2.weight")):
            out[k] = v * residual_scale
    w = out["downstream_head1.dpt.head.4.weight"].clone()
    b = out["downstream_head1.dpt.head.4.bias"].clone()
    w[:3] *= xyz_scale
    b[:3] = b.new_tensor([0.0, 0.0, 1.0])
    out["downstream_head1.dpt.head.4.weight"] = w
    out["downstream_head1.dpt.head.4.bias"] = b
    key = "downstream_head1.head_local_features.fc2.bias"
    b = out[key].clone()
    pp = patch_size * patch_size
    b[local_feat_dim * pp:(local_feat_dim + 1) * pp] += desc_conf_bias
    out[key] = b
    for k in list(out):
        if k.startswith("dec_blocks."):
            out["dec_blocks2." + k[len("dec_blocks."):]] = out[k]
        elif k.startswith("downstream_head1."):
            out["downstream_head2." + k[len("downstream_head1."):]] = out[k]
    return out


def make_state_dict(c: network.NetConfig, seed: int, device) -> dict:
    """The conditioned weights of ``seed`` as a bf16 state dict on
    ``device``, keyed as the published checkpoint (without the DPT's
    ``scratch.layer_rn`` aliases)."""
    shapes = _shapes(c)
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty((total,), device=device).uniform_(-1.0, 1.0,
                                                         generator=gen)
    sd, off = {}, 0
    for key, shape, kind, fan_in in shapes:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if kind == "one":
            v.fill_(1.0)
        elif kind == "zero":
            v.zero_()
        else:
            v.mul_(1.0 / math.sqrt(fan_in))
        sd[key] = v
    sd = condition_for_tracking(sd, c.patch_size, c.local_feat_dim)
    return {k: v.to(torch.bfloat16) for k, v in sd.items()}
