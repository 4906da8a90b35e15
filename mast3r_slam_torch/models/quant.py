"""The int8 network path: the int8 encoder and the int8 catMLP local-feature
head.

Mirrors ``mast3r_slam_tpu/models/quant.py``: every encoder block's qkv,
proj, fc1 and fc2 (and, on request, the two catMLP MLPs) hold int8 weights
with one symmetric scale per output channel, quantised once from the
model's weights; at run time each token is quantised symmetrically on its
own (``_int8_matmul``), the int8 x int8 product accumulates in int32 and is
rescaled in f32.  LayerNorms (the two-pass formula of ``_layernorm``), RoPE
and the attention (kernel A, ``ops.attention.flash_attention``, in bf16)
stay in floating point.  The patch embed computes in bf16 whatever the
trunk dtype is, so the residual stream is bf16 through the whole encoder.

Tensor parallel (``InferenceEngine(mesh=, int8_encoder=True)``): the whole
weights are quantised, then their codes split as the float weights are
(``shard_qparams_tp``).  A column-split product quantises the whole token on
each entry, so its columns are the unsplit product's; a row-split product
takes the token's amax over all entries (a max, exact), quantises each
entry's slice with that scale, adds the entries' int32 accumulators (exact)
and rescales once (``_int8_matmul_rows``).  Codes and outputs are the
unsplit int8 encoder's, bit for bit.

The product is ``torch._int_mm``: JAX computes it with ``dot_general``
outside any Pallas kernel (quant.py:77-81), so it is a library call here as
the trunk's other products are.  On the card it runs cuBLASLt's int8 GEMM,
which needs more than 16 rows and K and N multiples of 8; a shape that
breaks a rule raises, and there is no other route.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .mast3r import MASt3R, MASt3RConfig, _attention, gelu
from .rope import rope_2d


class QuantDense(NamedTuple):
    """An int8 Linear (quant.py:35).  ``w_int8`` is (out, in) row-major,
    ``nn.Linear``'s layout, so the product takes ``w_int8.t()``: a
    column-major (in, out) operand, the "TN" layout in which cuBLASLt's
    int8 GEMM reads both operands along K.  ``weight = w_int8 * scale``
    row by row; ``scale`` and ``bias`` are (out,) f32."""
    w_int8: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor


def _quantize_dense(weight, bias) -> QuantDense:
    """Symmetric per-output-channel int8 (quant.py:41): amax over the input
    dimension, which is dim 1 of a (out, in) weight (dim 0 of a Flax
    kernel)."""
    weight = weight.detach().float()
    amax = weight.abs().amax(dim=1)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    w_int8 = torch.clamp(torch.round(weight / scale[:, None]), -127,
                         127).to(torch.int8)
    return QuantDense(w_int8.contiguous(), scale, bias.detach().float())


def _quantize_linear(lin) -> QuantDense:
    return _quantize_dense(lin.weight, lin.bias)


def quantize_encoder_params(model: MASt3R) -> dict:
    """Every encoder block's Linears as ``QuantDense``, keyed as JAX keys
    them (quant.py:49): {"enc_block_{i}": {"qkv", "proj", "fc1", "fc2"}}.
    Quantised from the weights as the model stores them: after
    ``cast_trunk_params_bf16`` those are the bf16-rounded weights and
    biases, as in the JAX engine (inference.py:55-68, 92)."""
    return {f"enc_block_{i}": {
        "qkv": _quantize_linear(blk.attn.qkv),
        "proj": _quantize_linear(blk.attn.proj),
        "fc1": _quantize_linear(blk.mlp.fc1),
        "fc2": _quantize_linear(blk.mlp.fc2),
    } for i, blk in enumerate(model.enc_blocks)}


def quantize_local_heads(model: MASt3R) -> dict:
    """The two catMLP local-feature MLPs as ``QuantDense`` (quant.py:152):
    {"local1", "local2": {"fc1", "fc2"}}."""
    out = {}
    for n in (1, 2):
        mlp = getattr(model, f"downstream_head{n}").head_local_features
        out[f"local{n}"] = {"fc1": _quantize_linear(mlp.fc1),
                            "fc2": _quantize_linear(mlp.fc2)}
    return out


def int_mm(x8, w8_t):
    """(M, K) int8 x (K, N) int8 -> (M, N) int32 through ``torch._int_mm``.
    On the card it raises for a shape cuBLASLt's int8 GEMM does not take
    (M <= 16, K or N not a multiple of 8) instead of going another way."""
    M, K = x8.shape
    N = w8_t.shape[1]
    if x8.device.type == "cuda" and (M <= 16 or K % 8 or N % 8):
        raise ValueError(
            f"the card's int8 product needs more than 16 rows and K, N "
            f"multiples of 8; got ({M} x {K}) . ({K} x {N})")
    return torch._int_mm(x8, w8_t)


def quantize_tokens(x):
    """Dynamic symmetric int8 per token (quant.py:72-75): (codes int8,
    scale (..., 1) f32) with ``x ~ codes * scale``.  ``torch.round`` rounds
    half to even, as ``jnp.round`` does.  The scale is amax times the f32
    reciprocal of 127: XLA compiles JAX's ``amax / 127.0`` inside the jitted
    encoder to that product, one ulp off the quotient for some tokens."""
    x32 = x.float()
    a_scale = torch.clamp(x32.abs().amax(dim=-1, keepdim=True),
                          min=1e-12) * (1.0 / 127.0)
    codes = torch.clamp(torch.round(x32 / a_scale), -127, 127)
    return codes.to(torch.int8), a_scale


def _int8_matmul(x, qd: QuantDense):
    """Per-token int8 activations, the int8 product, the f32 rescale in
    JAX's order ``acc * a_scale * scale + bias`` (quant.py:70)."""
    x8, a_scale = quantize_tokens(x)
    lead, K = x.shape[:-1], x.shape[-1]
    acc = int_mm(x8.reshape(-1, K), qd.w_int8.t())
    acc = acc.reshape(*lead, acc.shape[-1])
    return acc.float() * a_scale * qd.scale + qd.bias


def _int8_matmul_rows(parts, qds, device):
    """``_int8_matmul`` of the concatenation of ``parts`` (each entry's
    slice of the input's last dim, on its device) with the row-split
    weights ``qds`` (each entry's input columns; the whole scale and
    bias), on ``device``: the same codes, accumulators and rescale as the
    unsplit product."""
    amax = None
    for p in parts:
        a = p.float().abs().amax(dim=-1, keepdim=True).to(device)
        amax = a if amax is None else torch.maximum(amax, a)
    a_scale = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    acc = None
    for p, qd in zip(parts, qds):
        codes = torch.clamp(torch.round(p.float() / a_scale.to(p.device)),
                            -127, 127).to(torch.int8)
        part = int_mm(codes.reshape(-1, p.shape[-1]), qd.w_int8.t())
        acc = part.to(device) if acc is None else acc + part.to(device)
    acc = acc.reshape(*parts[0].shape[:-1], acc.shape[-1])
    return acc.float() * a_scale * qds[0].scale.to(device) + \
        qds[0].bias.to(device)


def shard_qparams_tp(qparams: dict, n_heads: int, head_dim: int,
                     devices) -> dict:
    """The encoder's ``QuantDense`` codes split over ``devices`` as
    ``parallel.mesh.shard_params_tp`` splits the float weights: per block,
    a list (one per entry) for each of qkv and fc1 (output rows, with
    their scales and biases) and proj and fc2 (input columns, the whole
    scale and bias)."""
    from ..parallel.mesh import _head_rows

    n = len(devices)

    def rows(qd, idx, dev):
        return QuantDense(qd.w_int8[idx].contiguous().to(dev),
                          qd.scale[idx].to(dev), qd.bias[idx].to(dev))

    def cols(qd, idx, dev):
        return QuantDense(qd.w_int8[:, idx].contiguous().to(dev),
                          qd.scale.to(dev), qd.bias.to(dev))

    out = {}
    for name, q8 in qparams.items():
        k = q8["fc1"].w_int8.shape[0] // n
        out[name] = {
            "qkv": [rows(q8["qkv"], _head_rows(n_heads, head_dim, n, e, 3), d)
                    for e, d in enumerate(devices)],
            "proj": [cols(q8["proj"], _head_rows(n_heads, head_dim, n, e), d)
                     for e, d in enumerate(devices)],
            "fc1": [rows(q8["fc1"], torch.arange(e * k, (e + 1) * k), d)
                    for e, d in enumerate(devices)],
            "fc2": [cols(q8["fc2"], torch.arange(e * k, (e + 1) * k), d)
                    for e, d in enumerate(devices)],
        }
    return out


def _layernorm(x, scale, bias):
    """quant.py:86: the two-pass variance, eps 1e-6, in f32 (not the
    model's ``F.layer_norm``)."""
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale.float() + bias.float()


@torch.no_grad()
def encode_int8(model: MASt3R, qparams: dict, img, tp=None):
    """The int8 encoder (quant.py:94): img (B, H, W, 3) -> (feat (B, N, C)
    f32, pos (B, N, 2)), ``model``'s encoder with its blocks' Linears
    replaced by ``qparams`` (``quantize_encoder_params``).  ``tp``:
    (devices, ``shard_qparams_tp``'s split) runs every block tensor
    parallel over those devices."""
    cfg: MASt3RConfig = model.cfg
    x, pos = model.patch_embed(img, torch.bfloat16)
    B, N, D = x.shape
    n_heads = cfg.enc_num_heads
    Dh = D // n_heads

    def heads(qkv, pos):
        qkv = qkv.reshape(B, N, 3, -1, Dh)
        q, k, v = [qkv[:, :, j].transpose(1, 2) for j in range(3)]
        q = rope_2d(q, pos, cfg.rope_freq)
        k = rope_2d(k, pos, cfg.rope_freq)
        return _attention(q, k, v, torch.bfloat16)

    for i, blk in enumerate(model.enc_blocks):
        q8 = qparams[f"enc_block_{i}"]
        h = _layernorm(x, blk.norm1.weight, blk.norm1.bias)
        if tp is None:
            att = heads(_int8_matmul(h, q8["qkv"]), pos)
            x = x + _int8_matmul(att, q8["proj"]).to(x.dtype)
            h = _layernorm(x, blk.norm2.weight, blk.norm2.bias)
            h = gelu(_int8_matmul(h, q8["fc1"]))
            x = x + _int8_matmul(h, q8["fc2"]).to(x.dtype)
            continue
        devs, s8 = tp[0], tp[1][f"enc_block_{i}"]
        att = [heads(_int8_matmul(h.to(d), s8["qkv"][e]), pos.to(d))
               for e, d in enumerate(devs)]
        x = x + _int8_matmul_rows(att, s8["proj"], x.device).to(x.dtype)
        h = _layernorm(x, blk.norm2.weight, blk.norm2.bias)
        hs = [gelu(_int8_matmul(h.to(d), s8["fc1"][e]))
              for e, d in enumerate(devs)]
        x = x + _int8_matmul_rows(hs, s8["fc2"], x.device).to(x.dtype)
    return _layernorm(x, model.enc_norm.weight, model.enc_norm.bias), pos


def local_features_int8(qlocal_head: dict, enc_tok, dec_tok, img_hw,
                        cfg: MASt3RConfig):
    """The int8 catMLP local-feature head (quant.py:167): the MLP on
    cat(enc, dec) tokens in int8, then the pixel shuffle to (B, H, W, nch)
    f32, as ``DownstreamHead.local_features`` lays it out."""
    H, W = img_hw
    p = cfg.patch_size
    nh, nw = H // p, W // p
    nch = cfg.local_feat_dim + int(cfg.two_confs)
    x = torch.cat([enc_tok.float(), dec_tok.float()], dim=-1)
    h = gelu(_int8_matmul(x, qlocal_head["fc1"]))
    x = _int8_matmul(h, qlocal_head["fc2"])
    B = x.shape[0]
    x = x.reshape(B, nh, nw, nch, p, p).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(B, H, W, nch)
