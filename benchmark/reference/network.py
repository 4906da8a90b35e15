"""The MASt3R two-view network in plain PyTorch, in float32: the benchmark's
reference for the port's ``models/mast3r.py`` and ``models/quant.py``.

A frozen copy of the port's plain math, cut to what a reference needs: no
kernel (attention is ``softmax(q k^T / sqrt(d)) v`` in float32), no tensor
parallelism, every product and every head in float32.  The module names
are the published checkpoint's, so the state dict the benchmark makes
loads strictly.  ``Precision`` says how each product is rounded:

* ``products`` "f32" (the reference) or "fp8" (the control of a bf16
  configuration: both operands of every trunk and head product rounded to
  float8 e4m3 with one scale per tensor, then multiplied in float32);
* ``encoder_bits`` 0 (a float encoder), 8 (the encoder's Linears in int8, as
  ``--int8-encoder`` states: one symmetric scale per output channel, one
  per token, exact integer sums, rescaled in float32) or 4 (the control of
  the int8 configuration: the same with 4-bit codes).

Matmuls and convolutions run with TF32 off (``reference_mode``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


class Precision(NamedTuple):
    products: str = "f32"        # "f32" | "fp8"
    encoder_bits: int = 0        # 0: float encoder; 8: int8; 4: int4
    solves: str = "f32"          # "f32" | "tf32": the GN and BA products


@contextlib.contextmanager
def reference_mode():
    """TF32 off for matmuls and convolutions while the reference runs; the
    settings as they were afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def round_fp8(x):
    """x rounded to float8 e4m3 with one scale per tensor (amax to 448)."""
    s = torch.clamp(x.abs().amax(), min=1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def round_tf32(x):
    """x rounded to the 10 mantissa bits that TF32 keeps (to nearest)."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """The published ViT-L / base-decoder sizes; a benchmark configuration
    file gives each of them."""
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

    @property
    def hooks(self):
        d = self.dec_depth
        return (0, d * 2 // 4, d * 3 // 4, d)


def _rounded(x, w, prec: Precision):
    if prec.products == "fp8":
        return round_fp8(x.float()), round_fp8(w.float())
    return x.float(), w.float()


def _quant(x, bits, dim):
    """Symmetric codes of ``x`` along ``dim`` and their scale."""
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-12) / qmax
    return torch.clamp(torch.round(x / s), -qmax, qmax), s


def int_linear(x, weight, bias, bits):
    """Per-token activation codes times per-output-channel weight codes,
    summed exactly (float64 holds every integer sum) and rescaled in
    float32."""
    xc, xs = _quant(x.float(), bits, -1)
    wc, ws = _quant(weight.float(), bits, 1)
    acc = torch.matmul(xc.double(), wc.double().t()).float()
    return acc * xs * ws[:, 0] + bias.float()


class Dense(nn.Linear):
    def __init__(self, i, o, prec: Precision, int_bits: int = 0):
        super().__init__(i, o)
        self.prec, self.int_bits = prec, int_bits

    def forward(self, x):
        if self.int_bits:
            return int_linear(x, self.weight, self.bias, self.int_bits)
        xr, wr = _rounded(x, self.weight, self.prec)
        return F.linear(xr, wr, self.bias.float())


class Conv2d(nn.Conv2d):
    def __init__(self, *args, prec: Precision = Precision(), **kw):
        super().__init__(*args, **kw)
        self.prec = prec

    def forward(self, x):
        xr, wr = _rounded(x, self.weight, self.prec)
        return self._conv_forward(
            xr, wr, None if self.bias is None else self.bias.float())


class ConvTranspose2d(nn.ConvTranspose2d):
    def __init__(self, i, o, s, prec: Precision):
        super().__init__(i, o, s, stride=s)
        self.prec = prec

    def forward(self, x):
        xr, wr = _rounded(x, self.weight, self.prec)
        return F.conv_transpose2d(xr, wr, self.bias.float(),
                                  stride=self.stride)


def layer_norm(x, weight, bias):
    """Two-pass LayerNorm, eps 1e-6, in float32."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * weight.float() + bias.float()


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias)


def rope_2d(tokens, positions, freq: float = 100.0):
    """2D rotary embedding: the head dim splits into a y half and an x half,
    each rotated in the rotate-half layout."""
    D = tokens.shape[-1]
    half, quarter = D // 2, D // 4
    pos = positions.to(torch.float32)
    inv_freq = 1.0 / (freq ** (torch.arange(
        0, quarter, dtype=torch.float32, device=tokens.device) * 2.0 / half))

    def rot(x, theta):
        cos = torch.cat([torch.cos(theta)] * 2, dim=-1)[:, None]
        sin = torch.cat([torch.sin(theta)] * 2, dim=-1)[:, None]
        x1, x2 = x[..., :quarter], x[..., quarter:]
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    return torch.cat([rot(tokens[..., :half], pos[..., 0:1] * inv_freq),
                      rot(tokens[..., half:], pos[..., 1:2] * inv_freq)],
                     dim=-1)


def attention(q, k, v):
    """(B, H, N, Dh) exact attention in float32, merged to (B, N, H Dh)."""
    B, H, N, Dh = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / Dh ** 0.5
    out = torch.matmul(torch.softmax(s, dim=-1), v.float())
    return out.transpose(1, 2).reshape(B, N, H * Dh)


class Mlp(nn.Module):
    def __init__(self, i, hidden, out, prec, int_bits=0):
        super().__init__()
        self.fc1 = Dense(i, hidden, prec, int_bits)
        self.fc2 = Dense(hidden, out, prec, int_bits)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class SelfAttention(nn.Module):
    def __init__(self, dim, num_heads, rope_freq, prec, int_bits=0):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        self.qkv = Dense(dim, 3 * dim, prec, int_bits)
        self.proj = Dense(dim, dim, prec, int_bits)

    def forward(self, x, xpos):
        B, N, C = x.shape
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, C // self.num_heads)
        q, k, v = [qkv[:, :, i].transpose(1, 2) for i in range(3)]
        q = rope_2d(q, xpos, self.rope_freq)
        k = rope_2d(k, xpos, self.rope_freq)
        return self.proj(attention(q, k, v))


class CrossAttention(nn.Module):
    def __init__(self, dim, num_heads, rope_freq, prec):
        super().__init__()
        self.num_heads, self.rope_freq = num_heads, rope_freq
        self.projq = Dense(dim, dim, prec)
        self.projk = Dense(dim, dim, prec)
        self.projv = Dense(dim, dim, prec)
        self.proj = Dense(dim, dim, prec)

    def forward(self, query, key, value, qpos, kpos):
        Dh = query.shape[-1] // self.num_heads

        def heads(t, lin):
            return lin(t).reshape(t.shape[0], t.shape[1], -1, Dh) \
                .transpose(1, 2)

        q = rope_2d(heads(query, self.projq), qpos, self.rope_freq)
        k = rope_2d(heads(key, self.projk), kpos, self.rope_freq)
        return self.proj(attention(q, k, heads(value, self.projv)))


class EncoderBlock(nn.Module):
    def __init__(self, c: NetConfig, prec, int_bits):
        super().__init__()
        d = c.enc_embed_dim
        self.norm1 = LayerNorm(d)
        self.attn = SelfAttention(d, c.enc_num_heads, c.rope_freq, prec,
                                  int_bits)
        self.norm2 = LayerNorm(d)
        self.mlp = Mlp(d, d * c.mlp_ratio, d, prec, int_bits)

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    def __init__(self, c: NetConfig, prec):
        super().__init__()
        d = c.dec_embed_dim
        self.norm1 = LayerNorm(d)
        self.attn = SelfAttention(d, c.dec_num_heads, c.rope_freq, prec)
        self.norm_y = LayerNorm(d)
        self.norm2 = LayerNorm(d)
        self.cross_attn = CrossAttention(d, c.dec_num_heads, c.rope_freq, prec)
        self.norm3 = LayerNorm(d)
        self.mlp = Mlp(d, d * c.mlp_ratio, d, prec)

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size, embed_dim, prec):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size,
                           prec=prec)

    def forward(self, img):
        B, H, W, _ = img.shape
        p = self.patch_size
        x = self.proj(img.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
        yy, xx = torch.meshgrid(torch.arange(H // p, device=img.device),
                                torch.arange(W // p, device=img.device),
                                indexing="ij")
        pos = torch.stack([yy, xx], dim=-1).reshape(1, -1, 2)
        return x, pos.expand(B, -1, 2)


def upsample2x(x):
    return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]),
                         mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features, prec):
        super().__init__()
        self.conv1 = Conv2d(features, features, 3, padding=1, prec=prec)
        self.conv2 = Conv2d(features, features, 3, padding=1, prec=prec)

    def forward(self, x):
        return x + self.conv2(F.relu(self.conv1(F.relu(x))))


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, prec):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features, prec)
        self.resConfUnit2 = ResidualConvUnit(features, prec)
        self.out_conv = Conv2d(features, features, 1, prec=prec)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        return self.out_conv(upsample2x(self.resConfUnit2(x)))


class Scratch(nn.Module):
    def __init__(self, layer_dims, features, prec):
        super().__init__()
        for i, ld in enumerate(layer_dims):
            setattr(self, f"layer{i + 1}_rn",
                    Conv2d(ld, features, 3, padding=1, bias=False, prec=prec))
        self.layer_rn = nn.ModuleList(
            [getattr(self, f"layer{i + 1}_rn") for i in range(4)])
        for k in range(1, 5):
            setattr(self, f"refinenet{k}", FeatureFusionBlock(features, prec))


class Upsample2x(nn.Module):
    def forward(self, x):
        return upsample2x(x)


class DPTHead(nn.Module):
    def __init__(self, c: NetConfig, prec):
        super().__init__()
        self.c = c
        E, D = c.enc_embed_dim, c.dec_embed_dim
        ld = list(c.layer_dims)
        tok = [E if h == 0 else D for h in c.hooks]
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(Conv2d(tok[0], ld[0], 1, prec=prec),
                          ConvTranspose2d(ld[0], ld[0], 4, prec)),
            nn.Sequential(Conv2d(tok[1], ld[1], 1, prec=prec),
                          ConvTranspose2d(ld[1], ld[1], 2, prec)),
            nn.Sequential(Conv2d(tok[2], ld[2], 1, prec=prec)),
            nn.Sequential(Conv2d(tok[3], ld[3], 1, prec=prec),
                          Conv2d(ld[3], ld[3], 3, stride=2, padding=1,
                                 prec=prec)),
        ])
        Fd = c.feature_dim
        self.scratch = Scratch(ld, Fd, prec)
        self.head = nn.Sequential(
            Conv2d(Fd, Fd // 2, 3, padding=1, prec=prec), Upsample2x(),
            Conv2d(Fd // 2, c.last_dim, 3, padding=1, prec=prec), nn.ReLU(),
            Conv2d(c.last_dim, 4, 1, prec=prec))

    def forward(self, hooked, img_hw):
        p = self.c.patch_size
        nh, nw = img_hw[0] // p, img_hw[1] // p
        feats = []
        for i, tok in enumerate(hooked):
            x = tok.float().reshape(tok.shape[0], nh, nw, -1)
            x = self.act_postprocess[i](x.permute(0, 3, 1, 2))
            feats.append(self.scratch.layer_rn[i](x))
        s = self.scratch
        path = s.refinenet4(feats[3])
        path = path[:, :, :feats[2].shape[2], :feats[2].shape[3]]
        path = s.refinenet3(path, feats[2])
        path = s.refinenet2(path, feats[1])
        path = s.refinenet1(path, feats[0])
        return self.head(path).permute(0, 2, 3, 1)


class DownstreamHead(nn.Module):
    def __init__(self, c: NetConfig, prec):
        super().__init__()
        self.c = c
        nch = c.local_feat_dim + int(c.two_confs)
        idim = c.enc_embed_dim + c.dec_embed_dim
        self.dpt = DPTHead(c, prec)
        self.head_local_features = Mlp(idim, 4 * idim,
                                       nch * c.patch_size ** 2, prec)

    def local_features(self, enc_tok, dec_tok, img_hw):
        p = self.c.patch_size
        H, W = img_hw
        nch = self.c.local_feat_dim + int(self.c.two_confs)
        x = self.head_local_features(
            torch.cat([enc_tok.float(), dec_tok.float()], dim=-1))
        B = x.shape[0]
        x = x.reshape(B, H // p, W // p, nch, p, p).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(B, H, W, nch)


def postprocess(dpt_out, local_out, c: NetConfig):
    """exp-norm depth, 1 + exp conf, unit descriptors, exp desc-conf."""
    xyz = dpt_out[..., 0:3]
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    pts3d = xyz / torch.clamp(d, min=1e-8) * torch.expm1(d)
    conf = c.conf_vmin + torch.exp(dpt_out[..., 3])
    desc = local_out[..., :c.local_feat_dim]
    desc = desc / torch.clamp(torch.linalg.norm(desc, dim=-1, keepdim=True),
                              min=1e-8)
    desc_conf = c.desc_conf_vmin + torch.exp(local_out[..., c.local_feat_dim])
    return pts3d, conf, desc, desc_conf


class Network(nn.Module):
    """The two-view network; ``encode`` and ``decode_pair`` as the port's
    engine exposes them."""

    def __init__(self, c: NetConfig, prec: Precision = Precision()):
        super().__init__()
        self.c, self.prec = c, prec
        self.patch_embed = PatchEmbed(c.patch_size, c.enc_embed_dim, prec)
        ib = prec.encoder_bits
        self.enc_blocks = nn.ModuleList(
            [EncoderBlock(c, prec, ib) for _ in range(c.enc_depth)])
        self.enc_norm = LayerNorm(c.enc_embed_dim)
        self.decoder_embed = Dense(c.enc_embed_dim, c.dec_embed_dim, prec)
        self.dec_blocks = nn.ModuleList(
            [DecoderBlock(c, prec) for _ in range(c.dec_depth)])
        self.dec_blocks2 = nn.ModuleList(
            [DecoderBlock(c, prec) for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm(c.dec_embed_dim)
        self.downstream_head1 = DownstreamHead(c, prec)
        self.downstream_head2 = DownstreamHead(c, prec)

    def encode(self, img):
        """img (B, H, W, 3) normalised -> (feat (B, N, C), pos (B, N, 2))."""
        x, pos = self.patch_embed(img.float())
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos

    def decode_pair(self, f1, pos1, f2, pos2, img_hw):
        """Both views' (pts3d, conf, desc, desc_conf), each (B, H, W, ...)."""
        out1, out2 = [f1], [f2]
        x1, x2 = self.decoder_embed(f1), self.decoder_embed(f2)
        for blk1, blk2 in zip(self.dec_blocks, self.dec_blocks2):
            x1, x2 = blk1(x1, x2, pos1, pos2), blk2(x2, x1, pos2, pos1)
            out1.append(x1)
            out2.append(x2)
        out1[-1] = self.dec_norm(out1[-1])
        out2[-1] = self.dec_norm(out2[-1])
        res = []
        for n, toks in ((1, out1), (2, out2)):
            hd = getattr(self, f"downstream_head{n}")
            dpt = hd.dpt([toks[h] for h in self.c.hooks], img_hw)
            local = hd.local_features(toks[0], toks[-1], img_hw)
            res.append(postprocess(dpt, local, self.c))
        return tuple(res)


def build(c: NetConfig, state_dict: dict, prec: Precision, device):
    """The network on ``device`` with the benchmark's weights (every tensor
    as float32); ``scratch.layer_rn.*`` are aliases of ``layerN_rn``."""
    with torch.device("meta"):
        net = Network(c, prec)
    sd = {k: v for k, v in state_dict.items()
          if ".scratch.layer_rn." not in k}
    net = net.to_empty(device=device)
    missing, unexpected = net.load_state_dict(
        {k: v.float() for k, v in sd.items()}, strict=False)
    missing = [k for k in missing if ".scratch.layer_rn." not in k]
    if missing or unexpected:
        raise KeyError(f"reference network: missing {missing}, "
                       f"unexpected {unexpected}")
    return net.eval()
