"""VGGT-1B's operations for one tracked frame, counted from shapes: what
``frame_mfu`` divides by in a VGGT cell (``flops.py`` holds the peaks and
MASt3R's count).

A tracked frame encodes the new frame with DINOv2 (the keyframe's features
are kept), runs the aggregator over the pair (frame, keyframe) and both
heads on both views.  At 392 x 518: 0.74 TFLOP in the encoder, 2.52 in the
aggregator's Linears and 0.64 in its attention, 0.63 in the heads.
"""

from __future__ import annotations

from .flops import attention


def _linear(n, i, o):
    return 2.0 * n * i * o


def _conv(h, w, k, i, o):
    return 2.0 * h * w * k * k * i * o


def _block(n, d, r):
    """One pre-norm block's Linears on n tokens: qkv, proj, fc1, fc2."""
    return _linear(n, d, 3 * d) + _linear(n, d, d) + 2 * _linear(n, d, r * d)


def encode(net: dict, img_hw) -> float:
    """DINOv2 on one frame: the patch conv and the blocks over [cls,
    registers, patches]."""
    p, d = net["patch_size"], net["embed_dim"]
    n_patch = (img_hw[0] // p) * (img_hw[1] // p)
    n = 1 + net["num_register_tokens"] + n_patch
    per = _block(n, d, net["mlp_ratio"]) + attention(1, 1, n, n, d)
    return net["enc_depth"] * per + _linear(n_patch, 3 * p * p, d)


def aggregate(net: dict, img_hw, views: int = 2) -> tuple:
    """(Linears, attention) of the aggregator over ``views`` views: per
    depth a frame block on each view's tokens and a global block on all of
    them."""
    p, d = net["patch_size"], net["embed_dim"]
    P = 1 + net["num_register_tokens"] + \
        (img_hw[0] // p) * (img_hw[1] // p)
    lin = 2 * _block(views * P, d, net["mlp_ratio"])
    att = attention(views, 1, P, P, d) + attention(1, 1, views * P,
                                                   views * P, d)
    return net["depth"] * lin, net["depth"] * att


def dpt_head(net: dict, img_hw, features: int, point: bool) -> float:
    """One DPT head on one view: the projections, the resizes, the 3x3
    ``layer{i}_rn``, the four fusions (two residual units of two 3x3 convs
    each, one in the deepest; a 1x1 ``out_conv`` after each resize),
    ``output_conv1``, and for the point head ``output_conv2``."""
    p, ch = net["patch_size"], net["dpt_channels"]
    H, W = img_hw
    nh, nw = H // p, W // p
    F = features
    lv = [(4 * nh, 4 * nw), (2 * nh, 2 * nw), (nh, nw),
          ((nh + 1) // 2, (nw + 1) // 2)]
    f = sum(_linear(nh * nw, 2 * net["embed_dim"], c) for c in ch)
    f += _conv(nh, nw, 4, ch[0], ch[0]) + _conv(nh, nw, 2, ch[1], ch[1])
    f += _conv(*lv[3], 3, ch[3], ch[3])
    f += sum(_conv(h, w, 3, c, F) for (h, w), c in zip(lv, ch))
    # refinenet4 at the deepest level up to refinenet1 at the finest; each
    # out_conv at the next level's size (refinenet1's at twice its own)
    outs = [lv[2], lv[1], lv[0], (2 * lv[0][0], 2 * lv[0][1])]
    for k, ((h, w), (oh, ow)) in enumerate(zip(lv[::-1], outs)):
        units = 1 if k == 0 else 2
        f += units * 2 * _conv(h, w, 3, F, F) + _conv(oh, ow, 1, F, F)
    h1, w1 = outs[-1]
    if not point:
        return f + _conv(h1, w1, 3, F, F)
    f += _conv(h1, w1, 3, F, F // 2)
    f += _conv(H, W, 3, F // 2, net["point_hidden"])
    f += _conv(H, W, 1, net["point_hidden"], 4)
    return f


def model_step(net: dict, img_hw) -> dict:
    """One tracked frame's network operations, all in bf16: the frame's
    encode, the aggregator over the pair, the point head and the
    track-feature head on both views."""
    lin, att = aggregate(net, img_hw)
    heads = 2 * (dpt_head(net, img_hw, net["point_features"], True)
                 + dpt_head(net, img_hw, net["track_features"], False))
    return {"bf16": encode(net, img_hw) + lin + att + heads}
