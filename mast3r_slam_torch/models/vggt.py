"""VGGT-1B as the frame path's two-view network, in PyTorch.

"VGGT: Visual Geometry Grounded Transformer" (Wang et al., 2025,
arXiv:2503.11651; facebookresearch/vggt, weights facebook/VGGT-1B).  Module
attributes carry the published state dict's names (``aggregator.*``,
``point_head.*``, ``track_head.feature_extractor.*``), so the published
file loads by a key map and nothing more.  The equations, as
``vggt/models/aggregator.py``, ``heads/dpt_head.py``, ``layers/block.py``,
``layers/rope.py`` and ``layers/vision_transformer.py`` give them:

* ``encode``: the frame in [-1, 1] mapped to [0, 1] and normalised with
  ImageNet's mean and std; DINOv2 ViT-L/14 with 4 registers
  (``dinov2_vitl14_reg``): a stride-14 patch conv, [cls, patches] plus the
  learned position table (its patch part interpolated from its square grid
  to the frame's by bicubic interpolation with antialias, cached per
  shape), the registers inserted after cls, 24 pre-norm blocks with
  LayerScale (LN eps 1e-6, no RoPE, GELU MLP), the final LN.  ``feat`` is
  the normalised patch tokens, ``pos`` their (y, x) grid;
* the aggregator over S views: each view's tokens are [camera, 4
  registers, patches], view 1 taking the first-frame camera and register
  tokens (index 0) and every later view index 1; positions are the patch
  grid + 1, the special tokens at (0, 0); 24 times a frame block (each
  view's tokens) then a global block (all views' tokens, each keeping its
  own grid positions).  A block is ``x += ls1 * proj(attn(q, k, v)); x +=
  ls2 * mlp(LN(x))`` with q, k, v from ``qkv(LN(x))``, LN eps 1e-5, and
  ``q = rope_2d(LN_q(q))``, ``k = rope_2d(LN_k(k))`` (LN over the head's
  channels, RoPE at frequency 100).  The output at depth i is
  ``cat(frame_i, global_i)``;
* the DPT heads (``DPTHead``) on the patch tokens of four depths: LN, a
  1x1 projection, the UV embedding (point head only), the resize (x4
  transposed, x2 transposed, none, a stride-2 conv), the 3x3
  ``layer{i}_rn``, RefineNet fusion resized to the next level's size
  (``FeatureFusionBlock`` with a target size; 37 columns are odd),
  ``output_conv1``, the bilinear resize to the frame's size, and for the
  point head the UV embedding again, ``output_conv2``, ``inv_log`` points
  and ``1 + exp`` confidence.

The frame path's 8 outputs per view pair: ``pts3d`` and ``conf`` from the
point head, both views' points in view 1's camera frame (MASt3R's
``decode_pair`` convention); ``desc`` the track-feature map
(``track_head.feature_extractor``, 128 channels), L2-normalised per pixel;
``desc_conf`` the point head's ``conf``.  ``decode_mono``, the keyframe's
own pointmap, runs the frame alone (S = 1, VGGT's one-view forward) where
MASt3R-SLAM pairs the frame with itself; a tracked frame's view 1 then
differs from it by what the global blocks take from the keyframe's view.

Departures from the published model, each because the frame path reads
nothing else:

* the camera head, the depth head and the track head's tracker are not
  built;
* the track-feature head interpolates once to the full frame (its
  ``down_ratio`` 1, published 2): the same layers, the matcher needs one
  descriptor a pixel;
* VGGT gives its features no confidence: ``desc_conf`` is the point
  head's;
* the aggregator keeps only the depths the heads read;
* precision: the trunk computes in ``cfg.dtype`` (bf16: every Linear and
  the patch conv, as the published demo's autocast runs them) with f32
  LayerNorm, LayerScale and residual stream (autocast's promotion); the
  heads in ``cfg.head_dtype`` (the published demo runs them in f32 with
  autocast off; the benchmark serves them in bf16, as it serves MASt3R's),
  the activations in f32.

The published ``_make_fusion_block`` builds its residual units with
``nn.ReLU(inplace=True)``, so each unit's skip adds the rectified input
(this module's ``ResidualConvUnit``).  RoPE's tables are made once a
forward (``rope_tables``) for all 48 blocks.  Every attention goes through
``ops.attention.flash_attention`` (kernel A, Dh 64), looked up by this
module's name at each call; ``VGGT.launches`` counts its launches by kind
(``encoder``, ``frame``, ``global``).
"""

from __future__ import annotations

import collections
import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import flash_attention
from ..utils.profiler import TRACER
from . import mast3r
from .mast3r import (Conv2d, ConvTranspose2d, Dense, _product,
                     bilinear_resize_align_corners)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    """VGGT-1B's published sizes (``VGGT()``'s defaults); ``dtype`` is the
    trunk's compute dtype, ``head_dtype`` that of the DPT heads."""
    patch_size: int = 14
    embed_dim: int = 1024
    num_heads: int = 16
    mlp_ratio: int = 4
    enc_depth: int = 24              # DINOv2 blocks
    depth: int = 24                  # aggregator frame/global pairs
    num_register_tokens: int = 4
    pos_grid: int = 37               # DINOv2's table: a 518 / 14 square
    rope_freq: float = 100.0
    dpt_layers: tuple = (4, 11, 17, 23)
    dpt_channels: tuple = (256, 512, 1024, 1024)
    point_features: int = 256
    track_features: int = 128
    point_hidden: int = 32           # output_conv2's hidden channels
    dtype: torch.dtype = torch.bfloat16
    head_dtype: torch.dtype = torch.float32

    @property
    def enc_embed_dim(self) -> int:
        """The width of ``encode``'s features, which the keyframe arena
        holds."""
        return self.embed_dim


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in f32."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        # a bf16 branch times the f32 scale: f32, as autocast promotes it
        return x * self.gamma


class Mlp(nn.Module):
    """fc1 -> GELU (erf) -> fc2 in the trunk dtype."""

    def __init__(self, dim, hidden, dtype):
        super().__init__()
        self.fc1 = Dense(dim, hidden, dtype)
        self.fc2 = Dense(hidden, dim, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def rope_tables(pos, head_dim: int, freq: float):
    """(cos, sin), each (B, 1, N, head_dim) f32, of 2D RoPE at the (y, x)
    positions ``pos`` (B, N, 2): ``rope.rope_2d``'s angles (a y half and
    an x half, each in the rotate-half layout), made once for every block
    that turns tokens at these positions."""
    quarter = head_dim // 4
    inv_freq = 1.0 / (freq ** (torch.arange(
        0, quarter, dtype=torch.float32, device=pos.device) * 2.0
        / (head_dim // 2)))
    theta = pos.to(torch.float32)[..., None] * inv_freq    # (B, N, 2, q)
    theta = torch.cat([theta, theta], dim=-1).flatten(-2)  # (B, N, D)
    return torch.cos(theta)[:, None], torch.sin(theta)[:, None]


def apply_rope(x, rope):
    """``rope.rope_2d`` of x (B, H, N, D) f32 with the tables of
    ``rope_tables``: the same products and sums, in one pass over both
    halves."""
    cos, sin = rope
    x4 = x.unflatten(-1, (2, 2, x.shape[-1] // 4))
    rotated = torch.stack([-x4[..., 1, :], x4[..., 0, :]], dim=-2)
    return x * cos + rotated.flatten(-3) * sin


class Attention(nn.Module):
    """Multi-head self-attention through kernel A; with ``qk_norm`` the
    per-head LayerNorm of q and k, then 2D RoPE with the tables ``rope``
    (``rope_tables``)."""

    def __init__(self, dim, num_heads, dtype, kind: str, launches,
                 qk_norm: bool = False):
        super().__init__()
        self.num_heads, self.dtype, self.kind = num_heads, dtype, kind
        self.launches = launches
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.qk_norm = qk_norm
        if qk_norm:
            self.q_norm = LayerNorm(dim // num_heads, eps=1e-5)
            self.k_norm = LayerNorm(dim // num_heads, eps=1e-5)

    def forward(self, x, rope=None):
        B, N, C = x.shape
        Dh = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, Dh)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        if self.qk_norm:
            q = apply_rope(self.q_norm(q), rope)
            k = apply_rope(self.k_norm(k), rope)
        dt = self.dtype
        out = flash_attention(q.to(dt), k.to(dt), v.to(dt))
        self.launches[self.kind] += 1
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class Block(nn.Module):
    """Pre-norm block with LayerScale (``layers/block.py``)."""

    def __init__(self, dim, num_heads, mlp_ratio, dtype, eps, kind,
                 launches, qk_norm=False):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads, dtype, kind, launches, qk_norm)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=eps)
        self.mlp = Mlp(dim, dim * mlp_ratio, dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x, rope=None):
        x = x + self.ls1(self.attn(self.norm1(x), rope))
        return x + self.ls2(self.mlp(self.norm2(x)))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, dim, dtype):
        super().__init__()
        self.proj = Conv2d(3, dim, patch_size, stride=patch_size,
                           compute_dtype=dtype)


class DinoVisionTransformer(nn.Module):
    """DINOv2 ViT with registers (``layers/vision_transformer.py``), the
    aggregator's ``patch_embed``."""

    def __init__(self, cfg: VGGTConfig, launches):
        super().__init__()
        C, R = cfg.embed_dim, cfg.num_register_tokens
        self.cfg = cfg
        self.cls_token = nn.Parameter(torch.zeros(1, 1, C))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + cfg.pos_grid ** 2,
                                                  C))
        self.register_tokens = nn.Parameter(torch.zeros(1, R, C))
        # unused in inference; kept so that the published state dict loads
        self.mask_token = nn.Parameter(torch.zeros(1, C))
        self.patch_embed = PatchEmbed(cfg.patch_size, C, cfg.dtype)
        self.blocks = nn.ModuleList([
            Block(C, cfg.num_heads, cfg.mlp_ratio, cfg.dtype, 1e-6,
                  "encoder", launches) for _ in range(cfg.enc_depth)])
        self.norm = LayerNorm(C, eps=1e-6)
        self._pos_cache: dict = {}

    def position_table(self, nh: int, nw: int):
        """(1, 1 + nh nw, C) f32: the cls row and the patch table resized
        from its square grid to (nh, nw), bicubic with antialias
        (``interpolate_pos_encoding``); cached per shape and weights."""
        pe = self.pos_embed
        key = (nh, nw, pe.device, pe.data_ptr(), pe._version)
        hit = self._pos_cache.get(key)
        if hit is None:
            M, C = self.cfg.pos_grid, pe.shape[-1]
            pe = pe.detach().float()
            if (nh, nw) == (M, M):
                hit = pe
            else:
                grid = pe[:, 1:].reshape(1, M, M, C).permute(0, 3, 1, 2)
                grid = F.interpolate(grid, size=(nh, nw), mode="bicubic",
                                     antialias=True)
                hit = torch.cat([pe[:, :1],
                                 grid.permute(0, 2, 3, 1).reshape(1, -1, C)],
                                dim=1)
            self._pos_cache = {key: hit}
        return hit

    def forward(self, x):
        """x (B, 3, H, W) normalised -> the normalised patch tokens
        (B, nh nw, C) f32."""
        B, _, H, W = x.shape
        p = self.cfg.patch_size
        nh, nw = H // p, W // p
        t = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        t = torch.cat([self.cls_token.expand(B, -1, -1), t], dim=1)
        t = t + self.position_table(nh, nw)
        R = self.cfg.num_register_tokens
        t = torch.cat([t[:, :1], self.register_tokens.expand(B, -1, -1),
                       t[:, 1:]], dim=1)
        for blk in self.blocks:
            t = blk(t)
        return self.norm(t)[:, 1 + R:]


class Aggregator(nn.Module):
    """DINOv2, then alternating frame and global attention
    (``models/aggregator.py``)."""

    def __init__(self, cfg: VGGTConfig, launches):
        super().__init__()
        C, R = cfg.embed_dim, cfg.num_register_tokens
        self.cfg = cfg
        self.patch_embed = DinoVisionTransformer(cfg, launches)

        def blocks(kind):
            return nn.ModuleList([
                Block(C, cfg.num_heads, cfg.mlp_ratio, cfg.dtype, 1e-5, kind,
                      launches, qk_norm=True)
                for _ in range(cfg.depth)])
        self.frame_blocks = blocks("frame")
        self.global_blocks = blocks("global")
        # index 0: the first frame's; index 1: every later frame's
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, C))
        self.register_token = nn.Parameter(torch.zeros(1, 2, R, C))

    def forward(self, feats, poss):
        """``feats``: the S views' encoder features, each (B, P', C);
        ``poss``: their (y, x) grids (B, P', 2).  Returns {depth: (B S, P,
        2C)} for the depths the heads read, rows in (batch, view) order."""
        cfg = self.cfg
        S, (B, Pp, C) = len(feats), feats[0].shape
        ns = 1 + cfg.num_register_tokens
        P = ns + Pp
        toks, pos = [], []
        for s, (f, q) in enumerate(zip(feats, poss)):
            i = min(s, 1)
            toks.append(torch.cat([
                self.camera_token[:, i].expand(B, -1, -1),
                self.register_token[:, i].expand(B, -1, -1), f.float()],
                dim=1))
            pos.append(F.pad(q + 1, (0, 0, ns, 0)))
        x = torch.stack(toks, dim=1).reshape(B * S, P, C)
        pos_f = torch.stack(pos, dim=1).reshape(B * S, P, 2)
        # the global blocks turn every view's tokens by its own grid: the
        # frame tables laid end to end
        rope_f = rope_tables(pos_f, C // cfg.num_heads, cfg.rope_freq)
        rope_g = tuple(t.reshape(B, 1, S * P, -1) for t in rope_f)
        out = {}
        for d in range(cfg.depth):
            x = self.frame_blocks[d](x, rope_f)
            fr = x
            x = self.global_blocks[d](x.reshape(B, S * P, C), rope_g) \
                .reshape(B * S, P, C)
            if d in cfg.dpt_layers:
                out[d] = torch.cat([fr, x], dim=-1)
        return out


@torch.no_grad()
def uv_embedding(nh: int, nw: int, dim: int, aspect: float, device):
    """(dim, nh, nw) f32: 0.1 x the sin/cos embedding (omega_0 100) of the
    UV grid spanning +-aspect / sqrt(aspect^2 + 1) across and
    +-1 / sqrt(aspect^2 + 1) down, each shrunk by (n - 1) / n
    (``heads/utils.py``: ``create_uv_grid``, ``position_grid_to_embed``)."""
    diag = math.sqrt(aspect * aspect + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (nw - 1) / nw, sx * (nw - 1) / nw, nw,
                        dtype=torch.float64, device=device)
    ys = torch.linspace(-sy * (nh - 1) / nh, sy * (nh - 1) / nh, nh,
                        dtype=torch.float64, device=device)
    omega = 1.0 / 100.0 ** (torch.arange(dim // 4, dtype=torch.float64,
                                         device=device) / (dim / 4.0))

    def sincos(c):                       # (n,) -> (n, dim / 2)
        a = c[:, None] * omega[None]
        return torch.cat([torch.sin(a), torch.cos(a)], dim=-1)
    ex, ey = sincos(xs), sincos(ys)
    emb = torch.cat([ex[None].expand(nh, -1, -1),
                     ey[:, None].expand(-1, nw, -1)], dim=-1)
    return (0.1 * emb).float().permute(2, 0, 1).contiguous()


class ResidualConvUnit(mast3r.ResidualConvUnit):
    """The published unit, built with ``nn.ReLU(inplace=True)``: its first
    ReLU rectifies the input that the skip then adds."""

    def forward(self, x):
        x = F.relu(x)
        return x + self.conv2(F.relu(self.conv1(x)))


class FeatureFusionBlock(mast3r.FeatureFusionBlock):
    """The DPT fusion block shared with MASt3R (resized to the next
    level's size) with the published units; ``refinenet4``, which gets no
    skip, has no ``resConfUnit1`` in the published state dict."""

    def __init__(self, features, dtype, has_residual: bool = True):
        super().__init__(features, dtype)
        self.resConfUnit1 = ResidualConvUnit(features, dtype) \
            if has_residual else None
        self.resConfUnit2 = ResidualConvUnit(features, dtype)


class DPTHead(nn.Module):
    """``heads/dpt_head.py::DPTHead`` in ``dtype``: the point head
    (``feature_only`` False, ``pos_embed`` on) or the track-feature
    extractor (``feature_only``, no ``pos_embed``)."""

    def __init__(self, cfg: VGGTConfig, features: int, feature_only: bool,
                 pos_embed: bool):
        super().__init__()
        dt = cfg.head_dtype
        ch = list(cfg.dpt_channels)
        self.cfg, self.dtype = cfg, dt
        self.feature_only, self.pos_embed = feature_only, pos_embed
        self.norm = LayerNorm(2 * cfg.embed_dim, eps=1e-5)
        self.projects = nn.ModuleList([
            Conv2d(2 * cfg.embed_dim, c, 1, compute_dtype=dt) for c in ch])
        self.resize_layers = nn.ModuleList([
            ConvTranspose2d(ch[0], ch[0], 4, dt),
            ConvTranspose2d(ch[1], ch[1], 2, dt),
            nn.Identity(),
            Conv2d(ch[3], ch[3], 3, stride=2, padding=1, compute_dtype=dt)])
        s = self.scratch = nn.Module()
        for i, c in enumerate(ch):
            setattr(s, f"layer{i + 1}_rn", Conv2d(c, features, 3, padding=1,
                                                  bias=False,
                                                  compute_dtype=dt))
        for k in range(1, 5):
            setattr(s, f"refinenet{k}", FeatureFusionBlock(features, dt,
                                                           k != 4))
        if feature_only:
            s.output_conv1 = Conv2d(features, features, 3, padding=1,
                                    compute_dtype=dt)
        else:
            s.output_conv1 = Conv2d(features, features // 2, 3, padding=1,
                                    compute_dtype=dt)
            s.output_conv2 = nn.Sequential(
                Conv2d(features // 2, cfg.point_hidden, 3, padding=1,
                       compute_dtype=dt),
                nn.ReLU(),
                Conv2d(cfg.point_hidden, 4, 1, compute_dtype=dt,
                       f32_out=True))
        self._uv: dict = {}

    def _uv_add(self, x, aspect):
        key = (x.shape[1], x.shape[2], x.shape[3], aspect, x.device, x.dtype)
        pe = self._uv.get(key)
        if pe is None:
            pe = uv_embedding(x.shape[2], x.shape[3], x.shape[1], aspect,
                              x.device).to(x.dtype)
            self._uv[key] = pe
        return x + pe

    def forward(self, tokens, img_hw):
        """``tokens``: the four depths' (N, P', 2C) patch tokens; returns
        (N, out, H, W) in the head dtype (the point head's raw 4 channels
        in f32)."""
        H, W = img_hw
        p = self.cfg.patch_size
        nh, nw = H // p, W // p
        aspect = W / H
        feats = []
        for i, t in enumerate(tokens):
            x = self.norm(t)
            # the 1x1 projection as a product on the token layout
            conv = self.projects[i]
            x = _product(F.linear, x, conv.weight.flatten(1), conv.bias,
                         self.dtype)
            x = x.transpose(1, 2).reshape(x.shape[0], -1, nh, nw)
            if self.pos_embed:
                x = self._uv_add(x, aspect)
            feats.append(self.resize_layers[i](x))
        s = self.scratch
        l1, l2, l3, l4 = (getattr(s, f"layer{i + 1}_rn")(f)
                          for i, f in enumerate(feats))
        out = s.refinenet4(l4, size=l3.shape[2:])
        out = s.refinenet3(out, l3, size=l2.shape[2:])
        out = s.refinenet2(out, l2, size=l1.shape[2:])
        out = s.refinenet1(out, l1)
        out = s.output_conv1(out)
        out = bilinear_resize_align_corners(out, H, W)
        if self.pos_embed:
            out = self._uv_add(out, aspect)
        if self.feature_only:
            return out
        return s.output_conv2(out)


class TrackHead(nn.Module):
    """``track_head``: its feature extractor only (the tracker is not
    built)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.feature_extractor = DPTHead(cfg, cfg.track_features,
                                         feature_only=True, pos_embed=False)


def activate_point(raw):
    """(N, 4, H, W) f32 -> (pts (N, H, W, 3), conf (N, H, W)): ``inv_log``
    points and ``expp1`` confidence (``heads/head_act.py``)."""
    y = raw.permute(0, 2, 3, 1).contiguous()
    xyz = y[..., :3]
    return torch.sign(xyz) * torch.expm1(torch.abs(xyz)), 1.0 + \
        torch.exp(y[..., 3])


def normalise_desc(feat):
    """(N, F, H, W) -> (N, H, W, F) f32 unit vectors."""
    d = feat.permute(0, 2, 3, 1).to(torch.float32,
                                    memory_format=torch.contiguous_format)
    return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True),
                           min=1e-8)


class VGGT(nn.Module):
    """The two-view network as the engine serves it: ``encode`` and
    ``decode_and_head`` with MASt3R's signatures.  Spans: ``vggt.aggregate``,
    ``vggt.point_head``, ``vggt.track_head`` (under ``inference.decode``)."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        # kernel A's launches by kind, counted as they are issued
        self.launches = collections.Counter()
        self.aggregator = Aggregator(cfg, self.launches)
        self.point_head = DPTHead(cfg, cfg.point_features, feature_only=False,
                                  pos_embed=True)
        self.track_head = TrackHead(cfg)
        self._in_affine: dict = {}

    def _normalise(self, img):
        """(B, H, W, 3) in [-1, 1] -> (B, 3, H, W) f32: mapped to [0, 1]
        and normalised with ImageNet's mean and std, as one affine map
        whose (scale, shift) are made once per device."""
        ab = self._in_affine.get(img.device)
        if ab is None:
            mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float64)
            std = torch.tensor(IMAGENET_STD, dtype=torch.float64)
            ab = tuple(t.float().view(1, 3, 1, 1).to(img.device)
                       for t in (0.5 / std, (0.5 - mean) / std))
            self._in_affine[img.device] = ab
        return img.permute(0, 3, 1, 2).float() * ab[0] + ab[1]

    def encode(self, img):
        """img (B, H, W, 3) in [-1, 1] -> (feat (B, N, C) f32, pos (B, N,
        2) integer (y, x))."""
        B, H, W, _ = img.shape
        p = self.cfg.patch_size
        nh, nw = H // p, W // p
        feat = self.aggregator.patch_embed(self._normalise(img))
        yy, xx = torch.meshgrid(torch.arange(nh, device=img.device),
                                torch.arange(nw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], dim=-1).reshape(1, nh * nw, 2)
        return feat, pos.expand(B, nh * nw, 2)

    def _aggregate(self, feats, poss):
        with TRACER.span("vggt.aggregate"):
            inter = self.aggregator(feats, poss)
            ns = 1 + self.cfg.num_register_tokens
            return [inter[d][:, ns:] for d in self.cfg.dpt_layers]

    def decode_mono(self, f, pos, img_hw):
        """The frame alone (S = 1, its own first-frame tokens; the global
        blocks see its tokens only), the point head: {``pts3d``, ``conf``},
        each (B, H, W, ...).  The keyframe's own pointmap: VGGT takes one
        view where MASt3R needs the frame paired with itself."""
        tokens = self._aggregate([f], [pos])
        with TRACER.span("vggt.point_head"):
            pts, conf = activate_point(self.point_head(tokens, img_hw))
        return {"pts3d": pts, "conf": conf}

    def decode_and_head(self, f1, pos1, f2, pos2, img_hw):
        """The aggregator over the pair (view 1 = ``f1``) and both heads on
        both views: two dicts (``pts3d``, ``conf``, ``desc``,
        ``desc_conf``), each (B, H, W, ...)."""
        B = f1.shape[0]
        tokens = self._aggregate([f1, f2], [pos1, pos2])
        with TRACER.span("vggt.point_head"):
            pts, conf = activate_point(self.point_head(tokens, img_hw))
        with TRACER.span("vggt.track_head"):
            desc = normalise_desc(
                self.track_head.feature_extractor(tokens, img_hw))

        def view(s):
            def pick(A):
                return A.reshape(B, 2, *A.shape[1:])[:, s]
            return {"pts3d": pick(pts), "conf": pick(conf),
                    "desc": pick(desc), "desc_conf": pick(conf)}
        return view(0), view(1)

    def cast_params_bf16(self, head_bf16: bool = False) -> "VGGT":
        """Store in bf16, in place, the weights of every product that
        computes in bf16 (the trunk's Linears and patch conv; with
        ``head_bf16`` the heads' convolutions): numerically identical, half
        the bytes.  LayerNorm, LayerScale, the tokens and the position
        table stay f32."""
        for name, m in self.named_modules():
            if name.startswith(("point_head", "track_head")) and \
                    not head_bf16:
                continue
            if isinstance(m, (Dense, Conv2d, ConvTranspose2d)) and \
                    m.compute_dtype == torch.bfloat16:
                m.to(torch.bfloat16)
        return self
