"""MASt3R two-view pointmap/descriptor network in PyTorch.

Mirrors ``mast3r_slam_tpu/models/mast3r.py`` (CroCo ViT encoder, dual
cross-attention decoder, DPT pts3d head, catMLP local-feature head).  Module
attributes carry the published checkpoint's key names
(``enc_blocks.{i}.attn.qkv``, ``downstream_head1.dpt.*``, ...), so a real
``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth`` loads with
``load_state_dict`` after ``convert.prepare_checkpoint``.

Precision follows the JAX package: the trunk computes in ``cfg.dtype``
(bf16) with f32 LayerNorm, the heads and postprocess in f32.  Public
layouts stay NHWC; the convolutions run NCHW inside.  Every attention goes
through ``ops.attention.flash_attention``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import flash_attention
from .rope import rope_2d


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
    """(mast3r.py:38) The heads always compute in f32, the JAX default."""
    patch_size: int = 16
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    mlp_ratio: int = 4
    rope_freq: float = 100.0
    local_feat_dim: int = 24
    two_confs: bool = True
    feature_dim: int = 256
    last_dim: int = 128
    layer_dims: Sequence[int] = (96, 192, 384, 768)
    conf_vmin: float = 1.0
    desc_conf_vmin: float = 0.0
    dtype: torch.dtype = torch.bfloat16  # trunk compute dtype

    @property
    def hooks(self):
        """DPT hooks into [enc_out, dec_1..dec_depth] (mast3r.py:68)."""
        d = self.dec_depth
        return (0, d * 2 // 4, d * 3 // 4, d)

    @classmethod
    def vit_large(cls, **kw):
        return cls(**kw)

    @classmethod
    def tiny(cls, **kw):
        """The JAX package's small test configuration (mast3r.py:79)."""
        defaults = dict(
            enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
            dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
            feature_dim=32, last_dim=16, layer_dims=(16, 24, 32, 48),
            dtype=torch.float32,
        )
        defaults.update(kw)
        return cls(**defaults)


# ---------------------------------------------------------------------------
# Transformer trunk
# ---------------------------------------------------------------------------

class Dense(nn.Linear):
    """Linear that computes in ``compute_dtype`` whatever its weights are
    stored in, like a Flax ``Dense(dtype=...)``."""

    def __init__(self, i, o, compute_dtype=torch.float32):
        super().__init__(i, o)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        cd = self.compute_dtype
        return F.linear(x.to(cd), self.weight.to(cd), self.bias.to(cd))


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in f32, eps 1e-6 (mast3r.py:192)."""

    def __init__(self, dim):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (mast3r.py:96)."""

    def __init__(self, i, hidden, out, dtype):
        super().__init__()
        self.fc1 = Dense(i, hidden, dtype)
        self.fc2 = Dense(hidden, out, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


def _attention(q, k, v, dtype):
    """(B, H, N, Dh) attention in the trunk dtype (mast3r.py:109), merged
    back to (B, N, H * Dh).  q, k and v go in as the strided views they are
    (the kernel wants only the last dimension contiguous), and the kernel's
    output already lies as (B, N, H, Dh), so the merge is a view on the
    card."""
    B, H, N, Dh = q.shape
    out = flash_attention(q.to(dtype), k.to(dtype), v.to(dtype))
    return out.transpose(1, 2).reshape(B, N, H * Dh)


class SelfAttention(nn.Module):
    """RoPE self-attention (mast3r.py:135)."""

    def __init__(self, dim, num_heads, rope_freq, dtype):
        super().__init__()
        self.num_heads, self.rope_freq, self.dtype = num_heads, rope_freq, dtype
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x, xpos):
        B, N, C = x.shape
        Dh = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, Dh)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        q = rope_2d(q, xpos, self.rope_freq)
        k = rope_2d(k, xpos, self.rope_freq)
        return self.proj(_attention(q, k, v, self.dtype))


class CrossAttention(nn.Module):
    """RoPE cross-attention (mast3r.py:156)."""

    def __init__(self, dim, num_heads, rope_freq, dtype):
        super().__init__()
        self.num_heads, self.rope_freq, self.dtype = num_heads, rope_freq, dtype
        self.projq = Dense(dim, dim, dtype)
        self.projk = Dense(dim, dim, dtype)
        self.projv = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, query, key, value, qpos, kpos):
        B, _, C = query.shape
        Dh = C // self.num_heads

        def heads(t, lin):
            return lin(t).reshape(B, -1, self.num_heads, Dh).transpose(1, 2)

        q = rope_2d(heads(query, self.projq), qpos, self.rope_freq)
        k = rope_2d(heads(key, self.projk), kpos, self.rope_freq)
        v = heads(value, self.projv)
        return self.proj(_attention(q, k, v, self.dtype))


class EncoderBlock(nn.Module):
    """Pre-norm ViT block (mast3r.py:182)."""

    def __init__(self, dim, num_heads, mlp_ratio, rope_freq, dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, rope_freq, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim, dtype)

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    """Self + cross + MLP block (mast3r.py:201)."""

    def __init__(self, dim, num_heads, mlp_ratio, rope_freq, dtype):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = SelfAttention(dim, num_heads, rope_freq, dtype)
        self.norm_y = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, rope_freq, dtype)
        self.norm3 = LayerNorm(dim)
        self.mlp = Mlp(dim, dim * mlp_ratio, dim, dtype)

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))


class PatchEmbed(nn.Module):
    """16x16 patchify as a stride-16 conv (mast3r.py:224); tokens in the
    trunk dtype, pos (B, N, 2) integer (y, x)."""

    def __init__(self, patch_size, embed_dim, dtype):
        super().__init__()
        self.patch_size, self.compute_dtype = patch_size, dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, img):
        B, H, W, _ = img.shape
        p = self.patch_size
        nh, nw = H // p, W // p
        cd = self.compute_dtype
        x = F.conv2d(img.permute(0, 3, 1, 2).to(cd), self.proj.weight.to(cd),
                     self.proj.bias.to(cd), stride=p)
        x = x.flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(nh, device=img.device),
                                torch.arange(nw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], dim=-1).reshape(1, nh * nw, 2)
        return x, pos.expand(B, nh * nw, 2)


# ---------------------------------------------------------------------------
# DPT pyramid head (f32, NCHW inside)
# ---------------------------------------------------------------------------

def bilinear_resize_align_corners(x, out_h, out_w):
    """Bilinear resize with align_corners=True on NCHW (mast3r.py:250)."""
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=True)


class Upsample2x(nn.Module):
    """2x align-corners bilinear upsample (a parameter-free slot of the
    checkpoint's ``dpt.head`` Sequential)."""

    def forward(self, x):
        return bilinear_resize_align_corners(x, 2 * x.shape[2], 2 * x.shape[3])


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv residual (mast3r.py:280)."""

    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """DPT refinenet (mast3r.py:296).  ``refinenet4`` never gets a skip
    input, so its ``resConfUnit1`` exists only to hold the checkpoint's
    (dead) weights."""

    def __init__(self, features):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = bilinear_resize_align_corners(x, 2 * x.shape[2], 2 * x.shape[3])
        return self.out_conv(x)


class Scratch(nn.Module):
    """``dpt.scratch``: the layer{i}_rn convs (also registered as the
    ``layer_rn`` list, as the checkpoint does) and the four refinenets."""

    def __init__(self, layer_dims, features):
        super().__init__()
        for i, ld in enumerate(layer_dims):
            setattr(self, f"layer{i + 1}_rn",
                    nn.Conv2d(ld, features, 3, padding=1, bias=False))
        self.layer_rn = nn.ModuleList(
            [getattr(self, f"layer{i + 1}_rn") for i in range(4)])
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", FeatureFusionBlock(features))


class DPTHead(nn.Module):
    """DPT regression head: (B, H, W, 4) xyz+conf from 4 hooked token layers
    (mast3r.py:343).  ``act_postprocess`` stages: 1x1 project, then a k=s
    transposed conv (x4, x2), nothing, or a 3x3 stride-2 conv."""

    def __init__(self, cfg: MASt3RConfig, num_channels: int = 4):
        super().__init__()
        self.cfg = cfg
        E, D = cfg.enc_embed_dim, cfg.dec_embed_dim
        ld = list(cfg.layer_dims)
        tok = [E if h == 0 else D for h in cfg.hooks]
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(tok[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(tok[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(tok[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(tok[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        Fd = cfg.feature_dim
        self.scratch = Scratch(ld, Fd)
        self.head = nn.Sequential(
            nn.Conv2d(Fd, Fd // 2, 3, padding=1),
            Upsample2x(),
            nn.Conv2d(Fd // 2, cfg.last_dim, 3, padding=1),
            nn.ReLU(),
            nn.Conv2d(cfg.last_dim, num_channels, 1),
        )

    def forward(self, hooked, img_hw):
        H, W = img_hw
        p = self.cfg.patch_size
        nh, nw = H // p, W // p
        feats = []
        for i, tok in enumerate(hooked):
            x = tok.float().reshape(tok.shape[0], nh, nw, tok.shape[-1])
            x = self.act_postprocess[i](x.permute(0, 3, 1, 2))
            feats.append(self.scratch.layer_rn[i](x))
        s = self.scratch
        path = s.refinenet4(feats[3])
        path = path[:, :, : feats[2].shape[2], : feats[2].shape[3]]
        path = s.refinenet3(path, feats[2])
        path = s.refinenet2(path, feats[1])
        path = s.refinenet1(path, feats[0])
        return self.head(path).permute(0, 2, 3, 1)


class DownstreamHead(nn.Module):
    """``downstream_headN``: the DPT head and the catMLP local-feature MLP
    (the checkpoint's ``head_local_features``)."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.cfg = cfg
        nch = cfg.local_feat_dim + int(cfg.two_confs)
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        p = cfg.patch_size
        self.dpt = DPTHead(cfg)
        self.head_local_features = Mlp(idim, 4 * idim, nch * p * p,
                                       torch.float32)

    def local_features(self, enc_tok, dec_tok, img_hw):
        """LocalFeaturesHead (mast3r.py:392): MLP on cat(enc, dec) tokens,
        then pixel shuffle to (B, H, W, nch)."""
        H, W = img_hw
        p = self.cfg.patch_size
        nh, nw = H // p, W // p
        nch = self.cfg.local_feat_dim + int(self.cfg.two_confs)
        x = self.head_local_features(
            torch.cat([enc_tok.float(), dec_tok.float()], dim=-1))
        B = x.shape[0]
        # torch pixel_shuffle channel layout: c * p^2 + a * p + b
        x = x.reshape(B, nh, nw, nch, p, p).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(B, H, W, nch)


def postprocess(dpt_out, local_out, cfg: MASt3RConfig):
    """exp-norm depth, 1+exp conf, L2-normalised descriptors, exp desc-conf
    (mast3r.py:415)."""
    xyz = dpt_out[..., 0:3]
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    pts3d = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
    conf = cfg.conf_vmin + torch.exp(dpt_out[..., 3])
    desc = local_out[..., : cfg.local_feat_dim]
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True),
                              min=1e-8)
    if cfg.two_confs:
        desc_conf = cfg.desc_conf_vmin + torch.exp(
            local_out[..., cfg.local_feat_dim])
    else:
        desc_conf = conf
    return {"pts3d": pts3d, "conf": conf, "desc": desc,
            "desc_conf": desc_conf}


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

class MASt3R(nn.Module):
    """Two-view network (mast3r.py:446): ``encode``, ``decode``, ``head``,
    ``decode_and_head``; ``forward`` is the full two-view pass."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embed = PatchEmbed(c.patch_size, c.enc_embed_dim, c.dtype)
        self.enc_blocks = nn.ModuleList([
            EncoderBlock(c.enc_embed_dim, c.enc_num_heads, c.mlp_ratio,
                         c.rope_freq, c.dtype) for _ in range(c.enc_depth)])
        self.enc_norm = LayerNorm(c.enc_embed_dim)
        self.decoder_embed = Dense(c.enc_embed_dim, c.dec_embed_dim, c.dtype)
        self.dec_blocks = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio,
                         c.rope_freq, c.dtype) for _ in range(c.dec_depth)])
        self.dec_blocks2 = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio,
                         c.rope_freq, c.dtype) for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm(c.dec_embed_dim)
        self.downstream_head1 = DownstreamHead(c)
        self.downstream_head2 = DownstreamHead(c)

    def encode(self, img):
        """img (B, H, W, 3) normalised -> (feat (B, N, C) f32, pos)
        (mast3r.py:484)."""
        x, pos = self.patch_embed(img)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos

    def decode(self, f1, pos1, f2, pos2):
        """Dual-branch decoder; per-layer token lists for both views, [0]
        the encoder output (mast3r.py:491)."""
        out1, out2 = [f1], [f2]
        x1 = self.decoder_embed(f1)
        x2 = self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = blk1(x1, x2, pos1, pos2), blk2(x2, x1, pos2, pos1)
            out1.append(x1)
            out2.append(x2)
        out1[-1] = self.dec_norm(out1[-1])
        out2[-1] = self.dec_norm(out2[-1])
        return out1, out2

    def head(self, head_num, tokens, img_hw):
        """f32 downstream head on the hooked token layers (mast3r.py:519)."""
        hd = self.downstream_head1 if head_num == 1 else self.downstream_head2
        dpt_out = hd.dpt([tokens[h] for h in self.cfg.hooks], img_hw)
        local_out = hd.local_features(tokens[0], tokens[-1], img_hw)
        return postprocess(dpt_out, local_out, self.cfg)

    def decode_and_head(self, f1, pos1, f2, pos2, img_hw):
        """Decoder + both heads (mast3r.py:530)."""
        d1, d2 = self.decode(f1, pos1, f2, pos2)
        return self.head(1, d1, img_hw), self.head(2, d2, img_hw)

    def forward(self, img1, img2):
        f1, pos1 = self.encode(img1)
        f2, pos2 = self.encode(img2)
        return self.decode_and_head(f1, pos1, f2, pos2,
                                    (img1.shape[1], img1.shape[2]))


def cast_trunk_params_bf16(model: MASt3R) -> MASt3R:
    """Store the trunk's weights in bf16, in place (mast3r.py:544).  Those
    modules compute in bf16 anyway, so this is numerically identical and
    halves the weight bytes; LayerNorm and head weights stay f32."""
    for m in model.modules():
        if isinstance(m, (Dense, PatchEmbed)) and \
                m.compute_dtype == torch.bfloat16:
            m.to(torch.bfloat16)
    return model
