"""Weight conversion between the JAX model's Flax parameters and the port's
state dict.

``params_from_jax`` is the inverse of ``convert_state_dict``
(``mast3r_slam_tpu/models/convert.py:178``): it turns the Flax tree of the
JAX ``MASt3R`` into a state dict keyed like the published checkpoint, which
``MASt3R.load_state_dict`` takes strictly.  Layouts undone:

* Dense kernel (I, O) -> Linear weight (O, I)
* Conv kernel (kh, kw, I, O) -> Conv2d weight (O, I, kh, kw)
* space-to-depth patch kernel (p*p*C, O), index order (a, b, c) -> the
  stride-16 conv weight (O, C, p, p)
* Dense "up" (I, s*s*O), output order (a, b, o), bias tiled s*s times ->
  ConvTranspose2d weight (I, O, s, s) and its (O,) bias (convert.py:57-62)

``quant_params_from_jax`` does the same for the int8 weight trees of the
JAX ``models/quant.py``.

``load_checkpoint`` is the user's route from a published checkpoint file
(``load_torch_checkpoint`` then ``prepare_checkpoint``) into the port's
``MASt3R``, the file that JAX reads with its own ``load_torch_checkpoint``
and ``convert_state_dict``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# Checkpoint tensors the reference loads with strict=False and never uses
# (convert.py:175)
ALLOWED_UNUSED = ("mask_token", "enc_pos_embed", "dec_pos_embed")


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _linear(p):
    return {"weight": _np(p["kernel"]).T, "bias": _np(p["bias"])}


def _conv(p):
    out = {"weight": _np(p["kernel"]).transpose(3, 2, 0, 1)}
    if "bias" in p:
        out["bias"] = _np(p["bias"])
    return out


def _norm(p):
    return {"weight": _np(p["scale"]), "bias": _np(p["bias"])}


def _patch_conv(p, patch_size):
    k = _np(p["kernel"])
    O = k.shape[1]
    C = k.shape[0] // (patch_size * patch_size)
    w = k.reshape(patch_size, patch_size, C, O).transpose(3, 2, 0, 1)
    return {"weight": w, "bias": _np(p["bias"])}


def _dense_as_convtranspose(p, s):
    k = _np(p["kernel"])
    I = k.shape[0]
    O = k.shape[1] // (s * s)
    w = k.reshape(I, s, s, O).transpose(0, 3, 1, 2)
    b = _np(p["bias"]).reshape(s * s, O)[0]
    return {"weight": w, "bias": b}


def _mlp(p):
    return {"fc1": _linear(p["fc1"]), "fc2": _linear(p["fc2"])}


def _enc_block(p):
    return {
        "norm1": _norm(p["norm1"]), "norm2": _norm(p["norm2"]),
        "attn": {"qkv": _linear(p["attn"]["qkv"]),
                 "proj": _linear(p["attn"]["proj"])},
        "mlp": _mlp(p["mlp"]),
    }


def _dec_block(p):
    out = _enc_block(p)
    out["norm3"] = _norm(p["norm3"])
    out["norm_y"] = _norm(p["norm_y"])
    out["cross_attn"] = {n: _linear(p["cross_attn"][n])
                         for n in ("projq", "projk", "projv", "proj")}
    return out


def _rcu(p):
    return {"conv1": _conv(p["conv1"]), "conv2": _conv(p["conv2"])}


def _dpt(p):
    scratch = {}
    for i in range(4):
        scratch[f"layer{i + 1}_rn"] = _conv(p[f"layer{i + 1}_rn"])
    # the checkpoint registers the same convs again as scratch.layer_rn
    scratch["layer_rn"] = {str(i): scratch[f"layer{i + 1}_rn"]
                           for i in range(4)}
    for k in range(1, 5):
        rp = p[f"refinenet{k}"]
        rcu2 = _rcu(rp["resConfUnit2"])
        # refinenet4 has no skip input: its resConfUnit1 is dead in the
        # JAX model (no params) and in the reference; zeros fill the slot
        rcu1 = _rcu(rp["resConfUnit1"]) if "resConfUnit1" in rp else \
            {c: {kk: np.zeros_like(vv) for kk, vv in rcu2[c].items()}
             for c in rcu2}
        scratch[f"refinenet{k}"] = {"resConfUnit1": rcu1,
                                    "resConfUnit2": rcu2,
                                    "out_conv": _conv(rp["out_conv"])}
    return {
        "act_postprocess": {
            "0": {"0": _conv(p["act_0"]["project"]),
                  "1": _dense_as_convtranspose(p["act_0"]["up"], 4)},
            "1": {"0": _conv(p["act_1"]["project"]),
                  "1": _dense_as_convtranspose(p["act_1"]["up"], 2)},
            "2": {"0": _conv(p["act_2"]["project"])},
            "3": {"0": _conv(p["act_3"]["project"]),
                  "1": _conv(p["act_3"]["down"])},
        },
        "scratch": scratch,
        "head": {"0": _conv(p["head_conv1"]), "2": _conv(p["head_conv2"]),
                 "4": _conv(p["head_conv3"])},
    }


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = torch.from_numpy(np.array(v))  # a writable copy
    return out


def params_from_jax(flax_params, patch_size: int = 16) -> dict:
    """Flax params of the JAX ``MASt3R`` (numpy or JAX leaves, with or
    without the top-level ``params`` key) -> f32 state dict for the port's
    ``MASt3R``.  Leaves may be f32 or bf16 (the output of the JAX
    ``cast_trunk_params_bf16``, heads included): bf16 widens to f32
    exactly."""
    p = flax_params.get("params", flax_params)
    tree = {
        "patch_embed": {"proj": _patch_conv(p["patch_embed"]["proj"],
                                            patch_size)},
        "enc_norm": _norm(p["enc_norm"]),
        "decoder_embed": _linear(p["decoder_embed"]),
        "dec_norm": _norm(p["dec_norm"]),
        "enc_blocks": {}, "dec_blocks": {}, "dec_blocks2": {},
    }
    i = 0
    while f"enc_block_{i}" in p:
        tree["enc_blocks"][str(i)] = _enc_block(p[f"enc_block_{i}"])
        i += 1
    i = 0
    while f"dec_block_{i}" in p:
        tree["dec_blocks"][str(i)] = _dec_block(p[f"dec_block_{i}"])
        tree["dec_blocks2"][str(i)] = _dec_block(p[f"dec_block2_{i}"])
        i += 1
    for n in (1, 2):
        tree[f"downstream_head{n}"] = {
            "dpt": _dpt(p[f"dpt{n}"]),
            "head_local_features": _mlp(
                p[f"local{n}"]["head_local_features"]),
        }
    return _flatten(tree)


def quant_params_from_jax(qparams) -> dict:
    """The JAX ``QuantDense`` trees of ``quantize_encoder_params`` and
    ``quantize_local_heads`` (mast3r_slam_tpu/models/quant.py:49, 152;
    numpy or JAX leaves) -> the port's, with the same keys: each int8 Flax
    kernel (in, out) becomes the (out, in) weight of ``quant.QuantDense``;
    scale and bias stay (out,) f32."""
    from .quant import QuantDense

    def one(qd):
        w_int8, scale, bias = qd
        return QuantDense(
            torch.from_numpy(np.ascontiguousarray(
                np.asarray(w_int8, dtype=np.int8).T)),
            torch.from_numpy(np.array(scale, dtype=np.float32)),
            torch.from_numpy(np.array(bias, dtype=np.float32)))

    return {name: {layer: one(qd) for layer, qd in blk.items()}
            for name, blk in qparams.items()}


def load_torch_checkpoint(path):
    """A torch checkpoint file -> (state dict, the model's args string)
    (mast3r_slam_tpu/models/convert.py:272).  A published checkpoint is a
    dict with the state dict under ``"model"`` and the training run's
    ``argparse.Namespace`` under ``"args"``, whose ``model`` is the string
    the reference builds the network from (dust3r/model.py:27-43); a bare
    state dict is returned as it is, with an empty string.  The Namespace
    is an arbitrary pickled object, so the file is read with
    ``weights_only=False``: load only checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt["model"] if "model" in ckpt else ckpt
    args = getattr(ckpt.get("args", None), "model", "")
    return sd, args


_LAYER_RN = re.compile(r"^(.*\.scratch)\.layer([1-4])_rn\.weight$")


def prepare_checkpoint(sd: dict) -> dict:
    """A published checkpoint's state dict ready for ``load_state_dict``:
    the reference loader's ``dec_blocks2`` duplication rule when the
    checkpoint has none (convert.py:188-194), the DPT's
    ``scratch.layer_rn.{i}`` aliases of ``scratch.layer{i+1}_rn`` made when
    absent and required equal when present (convert.py:123-131;
    ``models/mast3r.py::Scratch`` registers the same convs under both
    names), and the unused tensors dropped.  A key left over still fails the strict load,
    as JAX's ``convert_state_dict(strict=True)`` fails."""
    out = {k: v for k, v in sd.items()
           if not any(k == a or k.startswith(a + ".") for a in ALLOWED_UNUSED)}
    if not any(k.startswith("dec_blocks2.") for k in out):
        for k in list(out):
            if k.startswith("dec_blocks."):
                out[k.replace("dec_blocks.", "dec_blocks2.", 1)] = out[k]
    for k in list(out):
        m = _LAYER_RN.match(k)
        if m is None:
            continue
        alias = f"{m[1]}.layer_rn.{int(m[2]) - 1}.weight"
        if alias not in out:
            out[alias] = out[k]
        elif not torch.equal(out[alias], out[k]):
            raise ValueError(f"{alias} is not an alias of layer{m[2]}_rn")
    return out


def load_checkpoint(model, path):
    """The checkpoint file ``path`` (published layout or a bare state dict)
    loaded strictly into the port's ``MASt3R`` ``model``:
    ``load_torch_checkpoint``, ``prepare_checkpoint``, then
    ``load_state_dict(strict=True)``.  Returns the model."""
    sd, _ = load_torch_checkpoint(path)
    model.load_state_dict(prepare_checkpoint(sd), strict=True)
    return model
