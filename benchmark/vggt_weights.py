"""VGGT-1B's benchmark weights: seeded, conditioned so that a clip tracks,
and stored in bf16.

They stand in for the published checkpoint, as ``weights.py``'s do for
MASt3R's: one fixed seed per configuration (``weight_seed``) makes every
tensor on the device from one ``torch.Generator`` call, and ``--seed``
never reaches them.  The program and the reference (``reference/vggt.py``)
both get this state dict, keyed as the published one.  The CPU tests of the
port make their weights here too.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .reference import vggt

# the published initialisation of what is not a product's weight: tokens
# and the position table (normal, std 0.02 or smaller, here uniform of that
# size), LayerScale (DINOv2 1.0, the aggregator 0.01); the conditioning
# then sets every LayerScale and the special tokens' size
TOKEN_SCALE = 0.02
LS_INIT = {"aggregator.patch_embed.": 1.0, "aggregator.": 0.01}


def _shapes(c: vggt.VGGTNet):
    """(name, shape, kind, scale) of every tensor: kind "one" / "zero" for
    LayerNorm weights / biases, "const" for a LayerScale (scale its value),
    else "uniform" within ``scale``."""
    with torch.device("meta"):
        net = vggt.Network(c)
    out = []
    for mname, m in net.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if isinstance(m, nn.LayerNorm):
                out.append((key, p.shape, "one" if pname == "weight"
                            else "zero", 1.0))
            elif isinstance(m, vggt.LayerScale):
                init = next(v for k, v in LS_INIT.items()
                            if key.startswith(k))
                out.append((key, p.shape, "const", init))
            elif pname.endswith(("_token", "_tokens", "pos_embed")):
                out.append((key, p.shape, "uniform", TOKEN_SCALE))
            else:
                # PyTorch's default init: uniform within 1 / sqrt(fan_in),
                # fan_in from dim 1 of the weight
                w = m.weight
                fan_in = w.shape[1] * math.prod(w.shape[2:])
                out.append((key, p.shape, "uniform", 1.0 / math.sqrt(fan_in)))
    return out


def _plant_sinks(out: dict, depth: int, num_heads: int, token_rms: float,
                 sink_bias: float) -> None:
    """The camera and register tokens made attention sinks, as trained
    ViTs' register tokens are ("Vision Transformers Need Registers",
    arXiv:2309.16588), in place in ``out``:

    * each token scaled to an RMS of ``token_rms``, so that it outweighs
      what the blocks add to it and every block's LayerNorm sees its own
      direction ``z``;
    * in every aggregator block, the key rows of ``qkv`` changed only
      along those directions (a rank-10 update), so that each special
      token's key, before the per-head LayerNorm, is the same vector
      ``e``: the lowest RoPE frequency of the y and x halves of each
      head, which the patch grid turns by at most half a radian;
    * ``q_norm``'s bias ``sink_bias * e``: every query leans towards
      those keys.

    A patch then puts a large share of its frame attention on its own
    view's special tokens, and in the global blocks on both views': the
    first frame's tokens and the later frames' differ, so view 1 of a pair
    differs from the frame alone and from view 2."""
    names = ("aggregator.camera_token", "aggregator.register_token")
    C = out[names[0]].shape[-1]
    Dh = C // num_heads
    rows = []
    for name in names:
        t = out[name].float()
        t = t * (token_rms / t.pow(2).mean(-1, keepdim=True).sqrt())
        out[name] = t
        rows.append(t.reshape(-1, C))
    Z = torch.cat(rows)
    Z = (Z - Z.mean(-1, keepdim=True)) / Z.std(-1, unbiased=False,
                                               keepdim=True)
    Zt = Z.T                                               # (C, 10)
    e = torch.zeros(Dh, device=Z.device)
    e[Dh // 4 - 1] = e[Dh // 2 + Dh // 4 - 1] = 1.0
    onto = torch.linalg.solve(Zt.T @ Zt, Zt.T)             # (10, C)
    for kind in ("frame_blocks", "global_blocks"):
        for i in range(depth):
            b = f"aggregator.{kind}.{i}.attn"
            W = out[f"{b}.qkv.weight"].float().clone()
            bk = out[f"{b}.qkv.bias"].float()[C:2 * C, None]
            Wk = W[C:2 * C]
            W[C:2 * C] = Wk + (e.repeat(num_heads)[:, None] - bk
                               - Wk @ Zt) @ onto
            out[f"{b}.qkv.weight"] = W
            out[f"{b}.q_norm.bias"] = sink_bias * e


def condition_for_tracking(sd: dict, depth: int, num_heads: int,
                           residual_scale: float = 0.02,
                           aggregator_scale: float = 0.5,
                           token_rms: float = 10.0, sink_bias: float = 5.0,
                           xyz_scale: float = 3.0,
                           conf_bias: float = 2.0) -> dict:
    """Random weights reshaped so the frame path has something to track,
    and so that what it compares hangs on the aggregator:

    * DINOv2's residual branches scaled down (its LayerScale at
      ``residual_scale`` in place of 1.0), so that its features stay close
      to the patch embedding of the image;
    * the aggregator's LayerScale at ``aggregator_scale`` in place of its
      published init 0.01 (the published value starts training; at 0.01
      the 48 blocks move the tokens by a few percent): the frame and
      global blocks then make most of what the heads read;
    * the camera and register tokens made attention sinks
      (``_plant_sinks``), so that a view's special tokens, and in the
      global blocks the other view's, shape its outputs;
    * in both heads, the biases zeroed and every filter of the fusion
      stages and of ``output_conv1`` centred (its taps summing to zero), so
      that a head passes the image's variation and not a constant: random
      biases, and the mean of the rectified maps the fusions read,
      otherwise give every pixel nearly the same descriptor, and the
      matcher's window argmax then ties between neighbours;
    * the point head's last convolution biased to a surface in front of
      the camera (z near ``expm1(1)``) whose shape follows the image (its
      xyz weights scaled up), and its confidence channel raised by
      ``conf_bias``, so that ``1 + exp`` clears the tracker's ``Q_conf``
      1.5."""
    out = dict(sd)
    for k, v in sd.items():
        if k.endswith(("ls1.gamma", "ls2.gamma")):
            enc = k.startswith("aggregator.patch_embed.blocks.")
            out[k] = torch.full_like(
                v, residual_scale if enc else aggregator_scale)
        elif k.startswith(("point_head.", "track_head.")):
            if k.endswith(".bias"):
                out[k] = torch.zeros_like(v)
            elif ("refinenet" in k or "output_conv1" in k) and v.dim() == 4:
                out[k] = v - v.mean(dim=(1, 2, 3), keepdim=True)
    _plant_sinks(out, depth, num_heads, token_rms, sink_bias)
    key = "point_head.scratch.output_conv2.2"
    w = out[f"{key}.weight"].clone()
    b = out[f"{key}.bias"].clone()
    w[:3] *= xyz_scale
    b[:3] = b.new_tensor([0.0, 0.0, 1.0])
    b[3] += conf_bias
    out[f"{key}.weight"], out[f"{key}.bias"] = w, b
    return out


def make_state_dict(c: vggt.VGGTNet, seed: int, device,
                    dtype=torch.bfloat16) -> dict:
    """The conditioned weights of ``seed`` on ``device``, keyed as the
    published state dict (without the heads the frame path does not read),
    in ``dtype``."""
    shapes = _shapes(c)
    total = sum(math.prod(s) for _, s, _, _ in shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty((total,), device=device).uniform_(-1.0, 1.0,
                                                         generator=gen)
    sd, off = {}, 0
    for key, shape, kind, scale in shapes:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        off += n
        if kind == "one":
            v.fill_(1.0)
        elif kind == "zero":
            v.zero_()
        elif kind == "const":
            v.fill_(scale)
        else:
            v.mul_(scale)
        sd[key] = v
    sd = condition_for_tracking(sd, c.depth, c.num_heads)
    return {k: v.to(dtype) for k, v in sd.items()}
