"""2D rotary position embedding (mirrors ``mast3r_slam_tpu/models/rope.py``)."""

from __future__ import annotations

import torch


def rope_2d(tokens, positions, freq: float = 100.0):
    """Apply 2D RoPE (rope.py:18).

    tokens: (B, n_heads, N, D) with D % 4 == 0; positions: (B, N, 2) integer
    (y, x) patch coordinates.  The head dim splits into a y half and an x
    half, each rotated in the non-interleaved "rotate-half" layout.  sin/cos
    are computed in f32 and cast to the tokens' dtype, as in JAX.
    """
    B, H, N, D = tokens.shape
    half = D // 2
    quarter = half // 2
    pos = positions.to(torch.float32)
    inv_freq = 1.0 / (freq ** (torch.arange(
        0, quarter, dtype=torch.float32, device=tokens.device) * 2.0 / half))

    def rot_half(x, theta):
        cos = torch.cos(theta)
        sin = torch.sin(theta)
        cos = torch.cat([cos, cos], dim=-1)[:, None].to(x.dtype)
        sin = torch.cat([sin, sin], dim=-1)[:, None].to(x.dtype)
        x1, x2 = x[..., :quarter], x[..., quarter:]
        rotated = torch.cat([-x2, x1], dim=-1)
        return x * cos + rotated * sin

    theta_y = pos[..., 0:1] * inv_freq[None, None, :]
    theta_x = pos[..., 1:2] * inv_freq[None, None, :]
    return torch.cat([rot_half(tokens[..., :half], theta_y),
                      rot_half(tokens[..., half:], theta_x)], dim=-1)
