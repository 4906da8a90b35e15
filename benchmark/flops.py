"""Operations counted from shapes, and the card's published peaks: the
arithmetic the roofline and MFU metrics divide by.

NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit.
"""

from __future__ import annotations

PEAK = {"bf16": 989e12, "int8": 1979e12}


def attention(B, H, Nq, Nk, Dh) -> float:
    """Exact attention: Q K^T and P V, two operations a multiply-add."""
    return 4.0 * B * H * Nq * Nk * Dh


def _linear(n, i, o):
    return 2.0 * n * i * o


def _conv(h, w, k, i, o):
    return 2.0 * h * w * k * k * i * o


def dpt_head(net: dict, img_hw) -> float:
    """One DPT head on one view: the hooked tokens' projections, the four
    refinenets and the output convolutions."""
    p = net["patch_size"]
    nh, nw = img_hw[0] // p, img_hw[1] // p
    E, D = net["enc_embed_dim"], net["dec_embed_dim"]
    ld, F = net["layer_dims"], net["feature_dim"]
    n = nh * nw
    f = _linear(n, E, ld[0]) + _conv(4 * nh, 4 * nw, 1, ld[0], ld[0])
    f += _linear(n, D, ld[1]) + _conv(2 * nh, 2 * nw, 1, ld[1], ld[1])
    f += _linear(n, D, ld[2])
    f += _linear(n, D, ld[3]) + _conv(nh // 2, nw // 2, 3, ld[3], ld[3])
    # layer_rn 3x3 convs to F channels at 4x, 2x, 1x and 1/2 of the grid
    scales = [(4 * nh, 4 * nw), (2 * nh, 2 * nw), (nh, nw),
              (nh // 2, nw // 2)]
    for (h, w), c in zip(scales, ld):
        f += _conv(h, w, 3, c, F)
    # refinenet4: one unit; refinenets 3..1: two units; each unit two 3x3
    # convs; the 1x1 out_conv after each 2x upsample
    for k, (h, w) in enumerate(reversed(scales)):
        units = 1 if k == 0 else 2
        f += units * 2 * _conv(h, w, 3, F, F) + _conv(2 * h, 2 * w, 1, F, F)
    H2, W2 = 8 * nh, 8 * nw
    f += _conv(H2, W2, 3, F, F // 2)
    f += _conv(2 * H2, 2 * W2, 3, F // 2, net["last_dim"])
    f += _conv(2 * H2, 2 * W2, 1, net["last_dim"], 4)
    return f


def model_step(net: dict, img_hw, int8_encoder: bool) -> dict:
    """Operations of one tracked frame's network work: the frame's encode,
    the two-branch decode of (frame, keyframe) and both heads on both
    views, by precision ({"bf16": ..., "int8": ...})."""
    p = net["patch_size"]
    n = (img_hw[0] // p) * (img_hw[1] // p)
    E, D, r = net["enc_embed_dim"], net["dec_embed_dim"], net["mlp_ratio"]
    enc_lin = net["enc_depth"] * (_linear(n, E, 3 * E) + _linear(n, E, E)
                                  + 2 * _linear(n, E, r * E))
    enc_rest = net["enc_depth"] * attention(1, 1, n, n, E) + \
        _linear(n, 3 * p * p, E)
    dec = 2 * (_linear(n, E, D) + net["dec_depth"] * (
        _linear(n, D, 3 * D) + _linear(n, D, D) + 4 * _linear(n, D, D)
        + 2 * _linear(n, D, r * D) + 2 * attention(1, 1, n, n, D)))
    nch = net["local_feat_dim"] + 1
    local = _linear(n, E + D, 4 * (E + D)) + \
        _linear(n, 4 * (E + D), nch * p * p)
    heads = 2 * (dpt_head(net, img_hw) + local)
    out = {"bf16": enc_rest + dec + heads, "int8": 0.0}
    out["int8" if int8_encoder else "bf16"] += enc_lin
    return out


def step_seconds_at_peak(flops: dict) -> float:
    """The least time the card could take for ``flops``."""
    return sum(v / PEAK[k] for k, v in flops.items())
