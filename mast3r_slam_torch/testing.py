"""Fixtures for driving the frontend without a checkpoint or a dataset.

The role of ``mast3r_slam_tpu/testing.py``: no published weights or clips
are in the repository, so the tests and ``chip_smoke.py`` drive the real
network with seeded random weights on frames made with numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from PIL import Image, ImageFilter

from .ops import gn
from .ops import lie_sim3 as sim3

# kernel B's sums against its plain version, entry by entry (gn_sums_check)
GN_RTOL, GN_FLOOR = 1e-4, 1e-5


def make_clip(seed: int, n: int, hw, shift: int = 1,
              texture: float = 0.0) -> list[np.ndarray]:
    """``n`` uint8 (h, w, 3) frames cut from one image, each ``shift``
    pixels right of the last: red ramps left to right, green top to bottom,
    plus a ``texture`` share of blurred seeded noise."""
    h, w = hw
    H, W = h + 16, w + shift * n + 16
    rng = np.random.default_rng(seed)
    noise = Image.fromarray((rng.random((H, W, 3)) * 255).astype(np.uint8))
    noise = np.asarray(noise.filter(ImageFilter.GaussianBlur(2)), np.float64)
    noise = (noise - noise.min()) / max(np.ptp(noise), 1e-9)
    ramp = np.zeros((H, W, 3))
    ramp[..., 0] = np.linspace(0, 1, W)[None, :]
    ramp[..., 1] = np.linspace(0, 1, H)[:, None]
    img = (255 * (texture * noise + (1 - texture) * ramp)).astype(np.uint8)
    return [np.ascontiguousarray(img[8:8 + h, 8 + shift * i:8 + shift * i + w])
            for i in range(n)]


def condition_for_tracking(sd: dict, patch_size: int = 16,
                           local_feat_dim: int = 24,
                           residual_scale: float = 0.02,
                           xyz_scale: float = 3.0,
                           desc_conf_bias: float = 2.0) -> dict:
    """A random-weight state dict reshaped so the frontend has something to
    track; returns a new dict.

    With raw random weights the pointmaps of two views share no geometry,
    no match passes the occlusion gate and the tracker drops to
    relocalization on its first frame.  Here the transformer's residual
    branches are scaled down (each block stays close to the identity), the
    second decoder branch and head are tied to the first (as the reference
    loader does for a checkpoint without ``dec_blocks2``), the pointmap head
    is biased to a surface in front of the camera whose shape follows the
    image (``xyz_scale``: a nearly flat, nearly constant pointmap leaves the
    7x7 Sim(3) system too ill-conditioned for its f32 solve), and the
    descriptor confidence is raised above the tracker's Q gate.
    """
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


def gn_problem(n: int, seed: int, device="cpu"):
    """One GN iteration's inputs at a pose far from the identity: keyframe
    points Xk, frame points Xf = T_true^-1 Xk with noise and 10% gross
    outliers, a 90% validity mask, and the pose T = exp(delta) o T_true
    (rotation ~0.2 rad, translation ~0.2, scale e^0.3) at which to evaluate.
    Returns (``gn.GNPointData``, T) on ``device``."""
    rng = np.random.default_rng(seed)
    Xk = rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    Xk[:, 2] += 3.0
    xi = (rng.standard_normal(7) * 0.2).astype(np.float32)
    xi[6] = 0.3
    T_true = sim3.exp(torch.from_numpy(xi))
    Xk = torch.from_numpy(Xk)
    Xf = sim3.act(sim3.inv(T_true), Xk) + torch.from_numpy(
        rng.standard_normal((n, 3)).astype(np.float32) * 0.01)
    bad = torch.from_numpy(rng.random(n) < 0.1)
    Xf[bad] += 1.0
    vq = torch.from_numpy(((rng.random(n) < 0.9) * np.sqrt(
        rng.uniform(1.0, 4.0, n))).astype(np.float32))
    dk = torch.sqrt(torch.clamp((Xk * Xk).sum(-1), min=1e-24))
    rd_k_t = torch.cat([Xk.T / dk[None], dk[None]])
    T = sim3.retr(T_true, torch.from_numpy(
        (rng.standard_normal(7) * 0.01).astype(np.float32)))
    pre = gn.GNPointData(*(t.to(device) for t in (Xf, rd_k_t, vq / 0.003,
                                                  vq / 10.0)))
    return pre, T.to(device)


def gn_sums_check(sums, terms, rtol: float = GN_RTOL,
                  floor: float = GN_FLOOR):
    """Kernel B's 27 sums against the plain per-point terms (27, n) they
    should add up to, entry by entry: entry j passes when
    |sums_j - sum_i terms_ji| <= rtol |sum_i terms_ji| + floor sum_i |terms_ji|.
    The floor covers f32 rounding over n terms of either sign, so each entry
    is held to its own scale (H_ss and H_tt differ by five orders of
    magnitude).  Returns (err, tol), each (27,) on the host."""
    plain = terms.sum(dim=1)
    tol = rtol * plain.abs() + floor * terms.abs().sum(dim=1)
    return (sums - plain).abs().cpu(), tol.cpu()
