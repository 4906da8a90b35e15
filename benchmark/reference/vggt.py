"""VGGT-1B's two-view forward in plain PyTorch, in float32: the benchmark's
reference for the port's ``models/vggt.py``.

Written from the published description ("VGGT: Visual Geometry Grounded
Transformer", arXiv:2503.11651; facebookresearch/vggt), independent of the
port: no kernel (attention is ``softmax(q k^T / sqrt(d)) v`` in float32, in
blocks of queries), every product and every head in float32, the
frame's normalisation its own.  The module names are the published state
dict's, so the benchmark's seeded state dict loads strictly.  What it
computes, for two uint8 frames (view 1 the tracked frame, view 2 the
keyframe):

* DINOv2 ViT-L/14 with 4 registers on each frame (ImageNet normalisation,
  the position table resized bicubically with antialias to the frame's
  grid, 24 blocks with LayerScale, the final LN; the patch tokens);
* the aggregator: [camera, registers, patches] per view (view 1 the
  first-frame tokens), positions the grid + 1 with the special tokens at
  0, 24 frame blocks alternating with 24 global blocks, each with
  per-head LN on q and k and 2D RoPE (frequency 100);
* the point head (DPT with the UV embedding; ``inv_log`` points, ``1 +
  exp`` confidence) and the track-feature head (DPT, 128 channels) read at
  depths (4, 11, 17, 23), each fusion resized to the next level's size,
  the last resize to the full frame;
* the 8 outputs, per view: points, confidence, the L2-normalised track
  features as descriptors and the point confidence as their confidence;
  and ``view``, one frame alone (S = 1): the keyframe's own pointmap.

The camera head, the depth head and the track head's tracker are not
built (the frame path reads none of them).  ``Precision`` (of
``network.py``) says how each product of the trunk and the heads is
rounded: "f32", or "fp8" (the control: both operands rounded to float8
e4m3 with one scale per tensor).  Matmuls and convolutions run with TF32
off (``network.reference_mode``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .network import Conv2d, ConvTranspose2d, Dense, Precision, rope_2d

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
# queries a block of the reference's attention takes at once
QUERY_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class VGGTNet:
    """VGGT-1B's published sizes; a benchmark configuration file gives
    each of them under ``network``."""
    patch_size: int = 14
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: int = 4
    enc_depth: int = 24
    depth: int = 24
    num_register_tokens: int = 4
    pos_grid: int = 37
    rope_freq: float = 100.0
    dpt_layers: Sequence[int] = (4, 11, 17, 23)
    dpt_channels: Sequence[int] = (256, 512, 1024, 1024)
    point_features: int = 256
    track_features: int = 128
    point_hidden: int = 32


class LN(nn.LayerNorm):
    """Two-pass LayerNorm in float32."""

    def forward(self, x):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight + \
            self.bias


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


def attention(q, k, v):
    """(B, H, N, Dh) exact attention in float32, in blocks of queries,
    merged to (B, N, H Dh)."""
    B, H, N, Dh = q.shape
    out = []
    for a in range(0, N, QUERY_BLOCK):
        s = torch.matmul(q[:, :, a:a + QUERY_BLOCK], k.transpose(-1, -2)) \
            / math.sqrt(Dh)
        out.append(torch.matmul(torch.softmax(s, dim=-1), v))
    return torch.cat(out, dim=2).transpose(1, 2).reshape(B, N, H * Dh)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, prec, qk_norm, rope_freq):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        self.qkv = Dense(dim, 3 * dim, prec)
        self.proj = Dense(dim, dim, prec)
        if qk_norm:
            self.q_norm = LN(dim // num_heads, eps=1e-5)
            self.k_norm = LN(dim // num_heads, eps=1e-5)
        self.qk_norm = qk_norm

    def forward(self, x, pos):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)
        if self.qk_norm:
            q = rope_2d(self.q_norm(q), pos, self.rope_freq)
            k = rope_2d(self.k_norm(k), pos, self.rope_freq)
        return self.proj(attention(q, k, v))


class Mlp(nn.Module):
    def __init__(self, dim, hidden, prec):
        super().__init__()
        self.fc1 = Dense(dim, hidden, prec)
        self.fc2 = Dense(hidden, dim, prec)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, c: VGGTNet, prec, eps, qk_norm):
        super().__init__()
        d = c.embed_dim
        self.norm1 = LN(d, eps=eps)
        self.attn = Attention(d, c.num_heads, prec, qk_norm, c.rope_freq)
        self.ls1 = LayerScale(d)
        self.norm2 = LN(d, eps=eps)
        self.mlp = Mlp(d, d * c.mlp_ratio, prec)
        self.ls2 = LayerScale(d)

    def forward(self, x, pos=None):
        x = x + self.ls1(self.attn(self.norm1(x), pos))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, c: VGGTNet, prec):
        super().__init__()
        self.proj = Conv2d(3, c.embed_dim, c.patch_size, stride=c.patch_size,
                           prec=prec)


class DinoViT(nn.Module):
    def __init__(self, c: VGGTNet, prec):
        super().__init__()
        d, R = c.embed_dim, c.num_register_tokens
        self.c = c
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + c.pos_grid ** 2, d))
        self.register_tokens = nn.Parameter(torch.zeros(1, R, d))
        self.mask_token = nn.Parameter(torch.zeros(1, d))
        self.patch_embed = PatchEmbed(c, prec)
        self.blocks = nn.ModuleList([Block(c, prec, 1e-6, False)
                                     for _ in range(c.enc_depth)])
        self.norm = LN(d, eps=1e-6)

    def forward(self, x):
        """x (B, 3, H, W) normalised -> patch tokens (B, nh nw, C)."""
        B, _, H, W = x.shape
        c = self.c
        nh, nw, M = H // c.patch_size, W // c.patch_size, c.pos_grid
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(B, -1, -1), t], dim=1)
        grid = self.pos_embed[:, 1:].reshape(1, M, M, -1).permute(0, 3, 1, 2)
        if (nh, nw) != (M, M):
            grid = F.interpolate(grid, size=(nh, nw), mode="bicubic",
                                 antialias=True)
        pe = torch.cat([self.pos_embed[:, :1],
                        grid.permute(0, 2, 3, 1).reshape(1, nh * nw, -1)],
                       dim=1)
        t = t + pe
        t = torch.cat([t[:, :1], self.register_tokens.expand(B, -1, -1),
                       t[:, 1:]], dim=1)
        for blk in self.blocks:
            t = blk(t)
        return self.norm(t)[:, 1 + c.num_register_tokens:]


class Aggregator(nn.Module):
    def __init__(self, c: VGGTNet, prec):
        super().__init__()
        d, R = c.embed_dim, c.num_register_tokens
        self.c = c
        self.patch_embed = DinoViT(c, prec)
        self.frame_blocks = nn.ModuleList([Block(c, prec, 1e-5, True)
                                           for _ in range(c.depth)])
        self.global_blocks = nn.ModuleList([Block(c, prec, 1e-5, True)
                                            for _ in range(c.depth)])
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, d))
        self.register_token = nn.Parameter(torch.zeros(1, 2, R, d))

    def forward(self, images):
        """images (S, 3, H, W) normalised, one pair -> the list over depths
        of (S, P, 2C)."""
        c = self.c
        S, _, H, W = images.shape
        patches = self.patch_embed(images)                 # (S, P', C)
        idx = torch.tensor([0] + [1] * (S - 1), device=images.device)
        tokens = torch.cat([self.camera_token[0, idx],
                            self.register_token[0, idx], patches], dim=1)
        nh, nw = H // c.patch_size, W // c.patch_size
        yy, xx = torch.meshgrid(torch.arange(nh), torch.arange(nw),
                                indexing="ij")
        grid = torch.stack([yy, xx], dim=-1).reshape(nh * nw, 2) + 1
        ns = 1 + c.num_register_tokens
        pos = torch.cat([torch.zeros(ns, 2, dtype=grid.dtype), grid])
        pos = pos.to(images.device)[None].expand(S, -1, -1)
        P, C = tokens.shape[1], tokens.shape[2]
        out = []
        x = tokens
        for fb, gb in zip(self.frame_blocks, self.global_blocks):
            x = fb(x, pos)
            fr = x
            x = gb(x.reshape(1, S * P, C), pos.reshape(1, S * P, 2)) \
                .reshape(S, P, C)
            out.append(torch.cat([fr, x], dim=-1))
        return out


def uv_embed(nh, nw, dim, aspect, device):
    """(dim, nh, nw): 0.1 x the sin/cos embedding (omega_0 100) of the UV
    grid, x in the first half of the channels, y in the second."""
    diag = (aspect * aspect + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    u = torch.linspace(-sx * (nw - 1) / nw, sx * (nw - 1) / nw, nw,
                       dtype=torch.float64)
    v = torch.linspace(-sy * (nh - 1) / nh, sy * (nh - 1) / nh, nh,
                       dtype=torch.float64)
    uu, vv = torch.meshgrid(u, v, indexing="xy")          # (nh, nw)
    half = dim // 2
    omega = torch.arange(half // 2, dtype=torch.float64) / (half / 2.0)
    omega = 1.0 / 100.0 ** omega

    def emb(p):
        a = p.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(a), torch.cos(a)], dim=1)
    e = torch.cat([emb(uu), emb(vv)], dim=1).reshape(nh, nw, dim)
    return (0.1 * e).float().permute(2, 0, 1).to(device)


class ResidualConvUnit(nn.Module):
    """The published unit, whose first ReLU is in place: the skip adds
    the rectified input."""

    def __init__(self, f, prec):
        super().__init__()
        self.conv1 = Conv2d(f, f, 3, padding=1, prec=prec)
        self.conv2 = Conv2d(f, f, 3, padding=1, prec=prec)

    def forward(self, x):
        x = F.relu(x)
        return self.conv2(F.relu(self.conv1(x))) + x


class FusionBlock(nn.Module):
    def __init__(self, f, prec, has_residual=True):
        super().__init__()
        if has_residual:
            self.resConfUnit1 = ResidualConvUnit(f, prec)
        self.resConfUnit2 = ResidualConvUnit(f, prec)
        self.out_conv = Conv2d(f, f, 1, prec=prec)

    def forward(self, x, skip=None, size=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        size = size or (2 * x.shape[2], 2 * x.shape[3])
        x = F.interpolate(x, size=tuple(size), mode="bilinear",
                          align_corners=True)
        return self.out_conv(x)


class DPTHead(nn.Module):
    def __init__(self, c: VGGTNet, prec, features, feature_only, pos_embed):
        super().__init__()
        ch = list(c.dpt_channels)
        self.c, self.feature_only, self.pos_embed = c, feature_only, pos_embed
        self.norm = LN(2 * c.embed_dim, eps=1e-5)
        self.projects = nn.ModuleList([Conv2d(2 * c.embed_dim, o, 1,
                                              prec=prec) for o in ch])
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(ch[0], ch[0], 4, prec),
            ConvTranspose2d(ch[1], ch[1], 2, prec), nn.Identity(),
            Conv2d(ch[3], ch[3], 3, stride=2, padding=1, prec=prec)])
        s = self.scratch = nn.Module()
        for i, o in enumerate(ch):
            setattr(s, f"layer{i + 1}_rn", Conv2d(o, features, 3, padding=1,
                                                  bias=False, prec=prec))
        for k in range(1, 5):
            setattr(s, f"refinenet{k}", FusionBlock(features, prec, k != 4))
        if feature_only:
            s.output_conv1 = Conv2d(features, features, 3, padding=1,
                                    prec=prec)
        else:
            s.output_conv1 = Conv2d(features, features // 2, 3, padding=1,
                                    prec=prec)
            s.output_conv2 = nn.Sequential(
                Conv2d(features // 2, c.point_hidden, 3, padding=1,
                       prec=prec), nn.ReLU(),
                Conv2d(c.point_hidden, 4, 1, prec=prec))

    def forward(self, tokens, H, W):
        """tokens: the four depths' (S, P', 2C) patch tokens ->
        (S, out, H, W)."""
        p = self.c.patch_size
        nh, nw = H // p, W // p
        feats = []
        for i, t in enumerate(tokens):
            x = self.norm(t).transpose(1, 2).reshape(t.shape[0], -1, nh, nw)
            x = self.projects[i](x)
            if self.pos_embed:
                x = x + uv_embed(nh, nw, x.shape[1], W / H, x.device)
            feats.append(self.resize_layers[i](x))
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(f)
                          for i, f in enumerate(feats))
        out = s.refinenet4(l4, size=l3.shape[2:])
        out = s.refinenet3(out, l3, size=l2.shape[2:])
        out = s.refinenet2(out, l2, size=l1.shape[2:])
        out = s.refinenet1(out, l1)
        out = F.interpolate(s.output_conv1(out), size=(H, W),
                            mode="bilinear", align_corners=True)
        if self.pos_embed:
            out = out + uv_embed(H, W, out.shape[1], W / H, out.device)
        if self.feature_only:
            return out
        return s.output_conv2(out)


class TrackHead(nn.Module):
    def __init__(self, c: VGGTNet, prec):
        super().__init__()
        self.feature_extractor = DPTHead(c, prec, c.track_features, True,
                                         False)


class Network(nn.Module):
    def __init__(self, c: VGGTNet, prec: Precision = Precision()):
        super().__init__()
        self.c, self.prec = c, prec
        self.aggregator = Aggregator(c, prec)
        self.point_head = DPTHead(c, prec, c.point_features, False, True)
        self.track_head = TrackHead(c, prec)

    def _tokens(self, frames):
        """(S, H, W, 3) uint8 -> (the heads' four depths of patch tokens,
        H, W)."""
        dev = self.point_head.norm.weight.device
        x = frames.to(dev).permute(0, 3, 1, 2).float() / 255.0
        mean = torch.tensor(MEAN, device=dev).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=dev).view(1, 3, 1, 1)
        x = (x - mean) / std
        inter = self.aggregator(x)
        ns = 1 + self.c.num_register_tokens
        return [inter[d][:, ns:] for d in self.c.dpt_layers], *x.shape[2:]

    def _points(self, tokens, H, W):
        raw = self.point_head(tokens, H, W).permute(0, 2, 3, 1)
        xyz = raw[..., :3]
        return (torch.sign(xyz) * torch.expm1(torch.abs(xyz)),
                1.0 + torch.exp(raw[..., 3]))

    def view(self, img):
        """One (H, W, 3) uint8 frame alone (S = 1) -> (pts, conf), each
        (1, H, W, ...): the keyframe's own pointmap."""
        return self._points(*self._tokens(torch.from_numpy(img)[None]))

    def views(self, img_frame, img_kf):
        """Two (H, W, 3) uint8 frames -> ((pts, conf, desc, dconf) of view
        1, of view 2), each (1, H, W, ...)."""
        tokens, H, W = self._tokens(torch.stack(
            [torch.from_numpy(img_frame), torch.from_numpy(img_kf)]))
        pts, conf = self._points(tokens, H, W)
        f = self.track_head.feature_extractor(tokens, H, W).permute(0, 2, 3, 1)
        desc = f / torch.clamp(torch.linalg.norm(f, dim=-1, keepdim=True),
                               min=1e-8)
        return tuple((pts[s:s + 1], conf[s:s + 1], desc[s:s + 1],
                      conf[s:s + 1]) for s in range(2))


def build(c: VGGTNet, state_dict: dict, prec: Precision, device):
    """The network on ``device`` with the benchmark's weights, every
    tensor as float32, loaded strictly."""
    with torch.device("meta"):
        net = Network(c, prec)
    net = net.to_empty(device=device)
    net.load_state_dict({k: v.float() for k, v in state_dict.items()},
                        strict=True)
    return net.eval()
