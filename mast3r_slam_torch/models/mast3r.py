"""MASt3R two-view pointmap/descriptor network in PyTorch.

Mirrors ``mast3r_slam_tpu/models/mast3r.py`` (CroCo ViT encoder, dual
cross-attention decoder, DPT pts3d head, catMLP local-feature head).  Module
attributes carry the published checkpoint's key names
(``enc_blocks.{i}.attn.qkv``, ``downstream_head1.dpt.*``, ...), so a real
``MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth`` loads strictly
through ``convert.load_checkpoint``.

Precision follows the JAX package: the trunk computes in ``cfg.dtype``
(bf16) with f32 LayerNorm; the DPT and catMLP heads compute in
``cfg.head_dtype`` (f32 by default, the reference's autocast policy; bf16
where ``main_torch.py`` runs them, as ``main.py`` does) and hand f32 to
``postprocess``, which always runs in f32.  Below f32 every product, bias,
resize term and GELU rounds where the JAX program rounds (``_product``,
``bilinear_resize_align_corners``, ``gelu``), so on the same inputs the
bf16 heads give JAX's bits but for a few elements.  Public layouts stay
NHWC; the convolutions run NCHW inside.  Every attention goes through
``ops.attention.flash_attention``.

Tensor parallelism: after ``parallel.mesh.shard_params_tp`` the trunk's
attentions and MLPs hold a ``tp`` split over the mesh's ``model`` axis and
run as Megatron blocks (``_tp_sum``): each entry computes its heads (or its
slice of the hidden layer) on its device, its ``proj`` / ``fc2`` product a
partial sum; the partials are added in f32 in entry order on the input's
device, rounded to the compute dtype once and the bias added after, as
``_product`` adds it.  In f32 that is the unsplit function up to the order
of the sums; in bf16 each partial is rounded once more.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import flash_attention
from .rope import rope_2d


@dataclasses.dataclass(frozen=True)
class MASt3RConfig:
    """(mast3r.py:38) ``dtype`` is the trunk's compute dtype and
    ``head_dtype`` that of the DPT and catMLP heads: f32 by default, the JAX
    dataclass default (mast3r.py:65); bf16 is ``main.py``'s default and
    ``main_torch.py``'s."""
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
    head_dtype: torch.dtype = torch.float32  # DPT + catMLP compute dtype

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

def _product(op, x, weight, bias, cd, f32_out=False):
    """``op(x, weight, bias)`` (a linear map or convolution, bias on dim 1
    of a convolution's output) in ``cd`` as a Flax ``Dense`` or ``Conv``
    with ``dtype=cd`` computes it.  Below f32 the product is rounded to
    ``cd`` and the bias added in ``cd``: two roundings, as Flax writes it.
    With ``f32_out`` the bias is added in f32 and the output is f32, which
    is how XLA runs a product the program casts to f32 at once (it skips
    the second rounding).  In f32 the bias goes into the product."""
    x, w = x.to(cd), weight.to(cd)
    if bias is None or cd == torch.float32:
        return op(x, w, None if bias is None else bias.to(cd))
    y, b = op(x, w, None), bias.to(cd)
    if op is not F.linear:          # NCHW: a bias per channel
        b = b.view(-1, 1, 1)
    return y.float() + b.float() if f32_out else y + b


class Dense(nn.Linear):
    """Linear that computes in ``compute_dtype`` whatever its weights are
    stored in, like a Flax ``Dense(dtype=...)`` (``_product``)."""

    def __init__(self, i, o, compute_dtype=torch.float32, f32_out=False):
        super().__init__(i, o)
        self.compute_dtype, self.f32_out = compute_dtype, f32_out

    def forward(self, x):
        return _product(F.linear, x, self.weight, self.bias,
                        self.compute_dtype, self.f32_out)


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed and returned in f32, eps 1e-6 (mast3r.py:192)."""

    def __init__(self, dim):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(), self.eps)


@functools.lru_cache(maxsize=8)
def _sqrt_half(dtype):
    return torch.tensor(0.5 ** 0.5, dtype=dtype).item()


def gelu(x):
    """Exact GELU as ``jax.nn.gelu(approximate=False)`` computes it in
    ``x``'s dtype.  Below f32: ``0.5 * x * erfc(-x * sqrt_half)`` with
    ``sqrt_half`` rounded to that dtype, ``erfc`` taken in f32 on the
    unrounded product and rounded once, then the product rounded (XLA's
    fusion of it; in bf16 ``F.gelu`` differs in a quarter of the
    elements).  In f32 ``F.gelu`` computes the same function."""
    if x.dtype == torch.float32:
        return F.gelu(x)
    e = torch.erfc(x.float() * -_sqrt_half(x.dtype)).to(x.dtype)
    return (0.5 * x) * e


def _tp_sum(parts, dense: Dense, device):
    """The row-split product of ``dense``: the entries' partial products
    ``parts`` (each rounded to the compute dtype) summed in f32 in entry
    order on ``device``, then rounded and the bias added once, as
    ``_product`` finishes the whole product."""
    acc = parts[0].to(device, torch.float32)
    for p in parts[1:]:
        acc = acc + p.to(device, torch.float32)
    cd = dense.compute_dtype
    if cd == torch.float32:
        return acc + dense.bias.float()
    y, b = acc.to(cd), dense.bias.to(cd)
    return y.float() + b.float() if dense.f32_out else y + b


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (mast3r.py:96).  With ``tp`` set
    (``parallel.mesh.shard_params_tp``): ``fc1`` split by columns, ``fc2``
    by rows, one reduction."""

    def __init__(self, i, hidden, out, dtype, f32_out=False):
        super().__init__()
        self.fc1 = Dense(i, hidden, dtype)
        self.fc2 = Dense(hidden, out, dtype, f32_out)
        self.tp = None

    def forward(self, x):
        if self.tp is not None:
            return self._forward_tp(x)
        return self.fc2(gelu(self.fc1(x)))

    def _forward_tp(self, x):
        cd = self.fc1.compute_dtype
        parts = []
        for dev, p in zip(*self.tp):
            h = gelu(_product(F.linear, x.to(dev), p["fc1_w"], p["fc1_b"],
                              cd))
            parts.append(_product(F.linear, h, p["fc2_w"], None, cd))
        return _tp_sum(parts, self.fc2, x.device)


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
    """RoPE self-attention (mast3r.py:135).  With ``tp`` set: each entry
    computes the q, k and v of its heads from its columns of the fused
    ``qkv``, runs kernel A on them and multiplies by its rows of
    ``proj``."""

    def __init__(self, dim, num_heads, rope_freq, dtype):
        super().__init__()
        self.num_heads, self.rope_freq, self.dtype = num_heads, rope_freq, dtype
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.tp = None

    def _heads(self, qkv, xpos, B, N, Dh):
        qkv = qkv.reshape(B, N, 3, -1, Dh)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        q = rope_2d(q, xpos, self.rope_freq)
        k = rope_2d(k, xpos, self.rope_freq)
        return _attention(q, k, v, self.dtype)

    def forward(self, x, xpos):
        B, N, C = x.shape
        Dh = C // self.num_heads
        if self.tp is None:
            return self.proj(self._heads(self.qkv(x), xpos, B, N, Dh))
        parts = []
        for dev, p in zip(*self.tp):
            qkv = _product(F.linear, x.to(dev), p["qkv_w"], p["qkv_b"],
                           self.dtype)
            att = self._heads(qkv, xpos.to(dev), B, N, Dh)
            parts.append(_product(F.linear, att, p["proj_w"], None,
                                  self.dtype))
        return _tp_sum(parts, self.proj, x.device)


class CrossAttention(nn.Module):
    """RoPE cross-attention (mast3r.py:156).  With ``tp`` set: split by
    heads, each entry's columns of ``projq`` / ``projk`` / ``projv`` and
    rows of ``proj``."""

    def __init__(self, dim, num_heads, rope_freq, dtype):
        super().__init__()
        self.num_heads, self.rope_freq, self.dtype = num_heads, rope_freq, dtype
        self.projq = Dense(dim, dim, dtype)
        self.projk = Dense(dim, dim, dtype)
        self.projv = Dense(dim, dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.tp = None

    def forward(self, query, key, value, qpos, kpos):
        if self.tp is None:
            lins = [(m.weight, m.bias)
                    for m in (self.projq, self.projk, self.projv)]
            return self.proj(self._attend(query, key, value, qpos, kpos,
                                          lins))
        parts = []
        for dev, p in zip(*self.tp):
            lins = [(p[n + "_w"], p[n + "_b"])
                    for n in ("projq", "projk", "projv")]
            att = self._attend(*(t.to(dev) for t in (query, key, value, qpos,
                                                     kpos)), lins)
            parts.append(_product(F.linear, att, p["proj_w"], None,
                                  self.dtype))
        return _tp_sum(parts, self.proj, query.device)

    def _attend(self, query, key, value, qpos, kpos, lins):
        """Attention of the heads whose (weight, bias) of projq, projk and
        projv are ``lins``; (B, Nq, heads * Dh)."""
        Dh = query.shape[-1] // self.num_heads

        def heads(t, wb):
            return _product(F.linear, t, *wb, self.dtype).reshape(
                t.shape[0], t.shape[1], -1, Dh).transpose(1, 2)

        wq, wk, wv = lins
        q = rope_2d(heads(query, wq), qpos, self.rope_freq)
        k = rope_2d(heads(key, wk), kpos, self.rope_freq)
        return _attention(q, k, heads(value, wv), self.dtype)


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

    def forward(self, img, compute_dtype=None):
        """``compute_dtype`` overrides the trunk dtype: the int8 encoder
        embeds in bf16 whatever the trunk's (quant.py:108-109)."""
        B, H, W, _ = img.shape
        p = self.patch_size
        nh, nw = H // p, W // p
        cd = compute_dtype or self.compute_dtype
        # the bias as the JAX Dense adds it
        x = _product(lambda x, w, b: F.conv2d(x, w, b, stride=p),
                     img.permute(0, 3, 1, 2), self.proj.weight,
                     self.proj.bias, cd)
        x = x.flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(nh, device=img.device),
                                torch.arange(nw, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], dim=-1).reshape(1, nh * nw, 2)
        return x, pos.expand(B, nh * nw, 2)


# ---------------------------------------------------------------------------
# DPT pyramid head and catMLP (cfg.head_dtype, NCHW inside)
# ---------------------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """Conv2d that computes in ``compute_dtype`` whatever its weights are
    stored in, like a Flax ``Conv(dtype=...)``: input, weight and bias are
    cast and the output stays in that dtype (``_product``)."""

    def __init__(self, *args, compute_dtype=torch.float32, f32_out=False,
                 **kw):
        super().__init__(*args, **kw)
        self.compute_dtype, self.f32_out = compute_dtype, f32_out

    def forward(self, x):
        return _product(self._conv_forward, x, self.weight, self.bias,
                        self.compute_dtype, self.f32_out)


class ConvTranspose2d(nn.ConvTranspose2d):
    """The k = s transposed conv of ``act_postprocess`` (the JAX ``up``
    Dense, mast3r.py:334) in ``compute_dtype`` (``_product``)."""

    def __init__(self, i, o, s, compute_dtype=torch.float32):
        super().__init__(i, o, s, stride=s)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        return _product(
            lambda x, w, b: F.conv_transpose2d(x, w, b, stride=self.stride),
            x, self.weight, self.bias, self.compute_dtype)


@functools.lru_cache(maxsize=64)
def _resize_taps(n_in, n_out, dtype, device):
    """Source rows lo, hi and their weights 1 - frac, frac for each output
    row of an align-corners resize: JAX's coordinates in f32, frac cast to
    ``dtype`` and 1 - frac taken in it (mast3r.py:262-267, 277)."""
    coords = (np.arange(n_out) * (n_in - 1)).astype(np.float32) / \
        np.float32(n_out - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    frac = torch.from_numpy(coords - lo.astype(np.float32)).to(dtype)
    return tuple(t.to(device) for t in (torch.from_numpy(lo),
                                        torch.from_numpy(hi), 1 - frac, frac))


def bilinear_resize_align_corners(x, out_h, out_w):
    """Bilinear resize with align_corners=True on NCHW, as the JAX package
    writes it (mast3r.py:250).  Below f32: one axis after the other, rows
    then columns, ``a * (1 - frac) + b * frac`` with every term in ``x``'s
    dtype, rounding each term where ``F.interpolate`` rounds once.  In f32
    ``F.interpolate`` computes the same function."""
    if x.dtype == torch.float32:
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=True)
    for dim, n_out in ((2, out_h), (3, out_w)):
        n_in = x.shape[dim]
        if n_out == n_in:
            continue
        if n_in == 1:
            x = x.expand(*x.shape[:dim], n_out, *x.shape[dim + 1:])
            continue
        lo, hi, w_lo, w_hi = _resize_taps(n_in, n_out, x.dtype, x.device)
        if dim == 2:
            w_lo, w_hi = w_lo.view(n_out, 1), w_hi.view(n_out, 1)
        x = x.index_select(dim, lo) * w_lo + x.index_select(dim, hi) * w_hi
    return x


class Upsample2x(nn.Module):
    """2x align-corners bilinear upsample (a parameter-free slot of the
    checkpoint's ``dpt.head`` Sequential)."""

    def forward(self, x):
        return bilinear_resize_align_corners(x, 2 * x.shape[2], 2 * x.shape[3])


class ResidualConvUnit(nn.Module):
    """relu-conv-relu-conv residual (mast3r.py:280)."""

    def __init__(self, features, dtype):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1,
                            compute_dtype=dtype)
        self.conv2 = Conv2d(features, features, 3, padding=1,
                            compute_dtype=dtype)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    """DPT refinenet (mast3r.py:296).  ``refinenet4`` never gets a skip
    input, so its ``resConfUnit1`` exists only to hold the checkpoint's
    (dead) weights."""

    def __init__(self, features, dtype):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = Conv2d(features, features, 1, compute_dtype=dtype)

    def forward(self, x, skip=None, size=None):
        """The fused map resized to ``size`` (out_h, out_w), twice the
        input's by default, before ``out_conv``."""
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        out_h, out_w = size or (2 * x.shape[2], 2 * x.shape[3])
        x = bilinear_resize_align_corners(x, out_h, out_w)
        return self.out_conv(x)


class Scratch(nn.Module):
    """``dpt.scratch``: the layer{i}_rn convs (also registered as the
    ``layer_rn`` list, as the checkpoint does) and the four refinenets."""

    def __init__(self, layer_dims, features, dtype):
        super().__init__()
        for i, ld in enumerate(layer_dims):
            setattr(self, f"layer{i + 1}_rn",
                    Conv2d(ld, features, 3, padding=1, bias=False,
                           compute_dtype=dtype))
        self.layer_rn = nn.ModuleList(
            [getattr(self, f"layer{i + 1}_rn") for i in range(4)])
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", FeatureFusionBlock(features, dtype))


class DPTHead(nn.Module):
    """DPT regression head: (B, H, W, 4) xyz+conf from 4 hooked token layers
    (mast3r.py:343), computed in ``cfg.head_dtype`` and returned in f32
    (:389).  ``act_postprocess`` stages: 1x1 project, then a k=s transposed
    conv (x4, x2), nothing, or a 3x3 stride-2 conv."""

    def __init__(self, cfg: MASt3RConfig, num_channels: int = 4):
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dtype
        E, D = cfg.enc_embed_dim, cfg.dec_embed_dim
        ld = list(cfg.layer_dims)
        tok = [E if h == 0 else D for h in cfg.hooks]
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(Conv2d(tok[0], ld[0], 1, compute_dtype=hd),
                          ConvTranspose2d(ld[0], ld[0], 4, hd)),
            nn.Sequential(Conv2d(tok[1], ld[1], 1, compute_dtype=hd),
                          ConvTranspose2d(ld[1], ld[1], 2, hd)),
            nn.Sequential(Conv2d(tok[2], ld[2], 1, compute_dtype=hd)),
            nn.Sequential(Conv2d(tok[3], ld[3], 1, compute_dtype=hd),
                          Conv2d(ld[3], ld[3], 3, stride=2, padding=1,
                                 compute_dtype=hd)),
        ])
        Fd = cfg.feature_dim
        self.scratch = Scratch(ld, Fd, hd)
        self.head = nn.Sequential(
            Conv2d(Fd, Fd // 2, 3, padding=1, compute_dtype=hd),
            Upsample2x(),
            Conv2d(Fd // 2, cfg.last_dim, 3, padding=1, compute_dtype=hd),
            nn.ReLU(),
            Conv2d(cfg.last_dim, num_channels, 1, compute_dtype=hd,
                   f32_out=True),
        )

    def forward(self, hooked, img_hw):
        H, W = img_hw
        p = self.cfg.patch_size
        nh, nw = H // p, W // p
        feats = []
        for i, tok in enumerate(hooked):
            # JAX casts the hooked tokens to f32 and its convs cast them on
            # to the head dtype (mast3r.py:513); one cast gives the same bits
            x = tok.to(self.cfg.head_dtype)
            x = x.reshape(tok.shape[0], nh, nw, tok.shape[-1])
            x = self.act_postprocess[i](x.permute(0, 3, 1, 2))
            feats.append(self.scratch.layer_rn[i](x))
        s = self.scratch
        path = s.refinenet4(feats[3])
        path = path[:, :, : feats[2].shape[2], : feats[2].shape[3]]
        path = s.refinenet3(path, feats[2])
        path = s.refinenet2(path, feats[1])
        path = s.refinenet1(path, feats[0])
        return self.head(path).permute(0, 2, 3, 1).float()


class DownstreamHead(nn.Module):
    """``downstream_headN``: the DPT head and the catMLP local-feature MLP
    (the checkpoint's ``head_local_features``), both in
    ``cfg.head_dtype``."""

    def __init__(self, cfg: MASt3RConfig):
        super().__init__()
        self.cfg = cfg
        nch = cfg.local_feat_dim + int(cfg.two_confs)
        idim = cfg.enc_embed_dim + cfg.dec_embed_dim
        p = cfg.patch_size
        self.dpt = DPTHead(cfg)
        self.head_local_features = Mlp(idim, 4 * idim, nch * p * p,
                                       cfg.head_dtype, f32_out=True)

    def local_features(self, enc_tok, dec_tok, img_hw):
        """LocalFeaturesHead (mast3r.py:392): MLP on cat(enc, dec) tokens in
        the head dtype, then f32 (:407) and pixel shuffle to (B, H, W,
        nch)."""
        H, W = img_hw
        p = self.cfg.patch_size
        nh, nw = H // p, W // p
        nch = self.cfg.local_feat_dim + int(self.cfg.two_confs)
        hd = self.cfg.head_dtype
        # both tokens are f32 in JAX before the cast (mast3r.py:519); the
        # cast commutes with the concatenation
        x = self.head_local_features(
            torch.cat([enc_tok.to(hd), dec_tok.to(hd)], dim=-1)).float()
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
    """Two-view network (mast3r.py:446): ``encode``, ``decode``,
    ``head_dpt``, ``head``, ``decode_and_head``; ``forward`` is the full
    two-view pass."""

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

    def head_dpt(self, head_num, tokens, img_hw):
        """The DPT half of a downstream head (mast3r.py:509): the raw
        (B, H, W, 4) xyz + conf map from the hooked token layers, apart so
        that the int8 local-feature head (``quant.local_features_int8``)
        can pair with it."""
        hd = self.downstream_head1 if head_num == 1 else self.downstream_head2
        return hd.dpt([tokens[h] for h in self.cfg.hooks], img_hw)

    def head(self, head_num, tokens, img_hw):
        """Downstream head on the hooked token layers (mast3r.py:519), in
        ``cfg.head_dtype``; the postprocess in f32."""
        hd = self.downstream_head1 if head_num == 1 else self.downstream_head2
        dpt_out = self.head_dpt(head_num, tokens, img_hw)
        local_out = hd.local_features(tokens[0], tokens[-1], img_hw)
        return postprocess(dpt_out, local_out, self.cfg)

    def decode_and_head(self, f1, pos1, f2, pos2, img_hw):
        """Decoder + both heads (mast3r.py:530)."""
        d1, d2 = self.decode(f1, pos1, f2, pos2)
        return self.head(1, d1, img_hw), self.head(2, d2, img_hw)

    def decode_mono(self, f, pos, img_hw):
        """The frame's own pointmap: view 1 of the frame paired with itself
        (``mast3r_inference_mono``, inference.py:170)."""
        return self.decode_and_head(f, pos, f, pos, img_hw)[0]

    def cast_params_bf16(self, head_bf16: bool = False) -> "MASt3R":
        """``cast_trunk_params_bf16`` of this model."""
        return cast_trunk_params_bf16(self, head_bf16)

    def forward(self, img1, img2):
        f1, pos1 = self.encode(img1)
        f2, pos2 = self.encode(img2)
        return self.decode_and_head(f1, pos1, f2, pos2,
                                    (img1.shape[1], img1.shape[2]))


def cast_trunk_params_bf16(model: MASt3R, head_bf16: bool = False) -> MASt3R:
    """Store the trunk's weights in bf16, in place (mast3r.py:544).  Those
    modules compute in bf16 anyway, so this is numerically identical and
    halves the weight bytes; LayerNorm weights stay f32.  With
    ``head_bf16`` the DPT and catMLP weights are stored in bf16 as well,
    identical for a model whose heads compute in bf16; without it they stay
    as they are (mast3r.py:565-575)."""
    for name, m in model.named_modules():
        if name.startswith("downstream_head"):
            if head_bf16 and name in ("downstream_head1", "downstream_head2"):
                m.to(torch.bfloat16)
        elif isinstance(m, (Dense, PatchEmbed)) and \
                m.compute_dtype == torch.bfloat16:
            m.to(torch.bfloat16)
    return model
