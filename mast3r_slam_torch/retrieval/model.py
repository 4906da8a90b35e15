"""Retrieval feature head: whitening, projector, attention top-k.

Mirrors ``mast3r_slam_tpu/retrieval/model.py``: the retrieval model minus
its frozen backbone (a prewhitening ``Whitener``, an MLP projector of
(Linear, LayerNorm, GELU) pairs ending in a Linear, with an optional
residual, the L2-norm attention, a postwhitening ``Whitener`` and the top-k
selection of local features) over the cached encoder features, and the
converter of the published checkpoint.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class RetrievalParams(NamedTuple):
    """Whitener and projector weights (model.py:20), as tensors.
    Whiteners: y = (x - m) @ P.  ``proj_weights``: ((W (d_in, d_out), b),
    ...) per Linear; ``proj_norms``: ((scale, bias), ...) per LayerNorm."""
    prewhiten_m: torch.Tensor          # (1, D_in)
    prewhiten_p: torch.Tensor          # (D_in, D_in)
    proj_weights: tuple
    proj_norms: tuple
    postwhiten_m: torch.Tensor         # (1, D_out)
    postwhiten_p: torch.Tensor         # (D_out, D_out)
    residual: bool = False

    @classmethod
    def random(cls, d_in=1024, hdims=(1024,), seed=0) -> "RetrievalParams":
        """Random weights drawn from ``np.random.default_rng(seed)`` in the
        order of model.py:34-53, so they equal the JAX package's bit for
        bit (its PRNG ``key`` argument draws nothing)."""
        rng = np.random.default_rng(seed)

        def f32(a):   # numpy may promote the division to f64, as in JAX
            return torch.from_numpy(np.asarray(a, np.float32))

        ws, ns = [], []
        d = d_in
        for h in hdims[:-1]:
            W = rng.standard_normal((d, h)).astype(np.float32) / np.sqrt(d)
            ws.append((f32(W), torch.zeros(h)))
            ns.append((torch.ones(h), torch.zeros(h)))
            d = h
        W = rng.standard_normal((d, hdims[-1])).astype(np.float32) / np.sqrt(d)
        ws.append((f32(W), torch.zeros(hdims[-1])))
        return cls(
            prewhiten_m=torch.zeros((1, d_in)),
            prewhiten_p=torch.eye(d_in),
            proj_weights=tuple(ws),
            proj_norms=tuple(ns),
            postwhiten_m=torch.zeros((1, hdims[-1])),
            postwhiten_p=torch.eye(hdims[-1]),
        )

    @classmethod
    def from_torch_checkpoint(cls, path) -> "RetrievalParams":
        """The published retrieval checkpoint
        (``*_retrieval_trainingfree.pth``; model.py:56): ``ckpt["model"]``
        holds ``projector.{i}.weight`` / ``.bias`` (a 2-D weight is a
        Linear, stored (out, in); a 1-D one a LayerNorm), ``prewhiten.m``,
        ``prewhiten.p`` and, when present, ``postwhiten.m`` / ``.p``;
        ``ckpt["args"].residual`` selects the residual projector."""
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
        sd = ckpt["model"]
        args = ckpt.get("args")

        def t(k):
            return sd[k].float().clone()

        ws, ns = [], []
        i = 0
        while f"projector.{i}.weight" in sd:
            W = t(f"projector.{i}.weight")
            if W.ndim == 2:
                ws.append((W.T.contiguous(), t(f"projector.{i}.bias")))
            else:   # LayerNorm
                ns.append((W, t(f"projector.{i}.bias")))
            i += 1
        d_out = ws[-1][0].shape[1]
        residual = bool(getattr(args, "residual", False)) if args else False
        return cls(
            prewhiten_m=t("prewhiten.m"),
            prewhiten_p=t("prewhiten.p"),
            proj_weights=tuple(ws),
            proj_norms=tuple(ns),
            postwhiten_m=t("postwhiten.m") if "postwhiten.m" in sd
            else torch.zeros((1, d_out)),
            postwhiten_p=t("postwhiten.p") if "postwhiten.p" in sd
            else torch.eye(d_out),
            residual=residual,
        )

    def to(self, device) -> "RetrievalParams":
        """The same weights on ``device``."""
        def mv(x):
            if isinstance(x, tuple):
                return tuple(mv(e) for e in x)
            return x.to(device)

        return RetrievalParams(*(mv(x) for x in self[:-1]), self.residual)


def _whiten(x, m, p):
    return (x - m) @ p


def _projector(params: RetrievalParams, x):
    """(model.py:99)  LayerNorm with eps 1e-5 as JAX writes it, exact GELU."""
    h = x
    n_pairs = len(params.proj_norms)
    for i, (W, b) in enumerate(params.proj_weights):
        h = h @ W + b
        if i < n_pairs:
            scale, bias = params.proj_norms[i]
            mu = h.mean(-1, keepdim=True)
            var = ((h - mu) ** 2).mean(-1, keepdim=True)
            h = (h - mu) / torch.sqrt(var + 1e-5) * scale + bias
            h = F.gelu(h)
    return h


def top_k_indices(x, k: int):
    """Indices of the k largest entries along the last axis, largest first,
    equal entries in index order: ``jax.lax.top_k``'s order (a stable
    descending sort; ``torch.topk`` leaves the order of ties open)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[
        ..., :k]


def prep_features(params: RetrievalParams, backbone_feat, nfeat: int = 300,
                  residual: bool = False):
    """Backbone tokens (B, N, D) f32 -> the top-k whitened local features
    (B, nfeat, D_out) (model.py:114): whitening, projector, L2 attention
    per token, postwhitening, and the ``nfeat`` tokens of largest attention,
    largest first."""
    x = _whiten(backbone_feat, params.prewhiten_m, params.prewhiten_p)
    proj = _projector(params, x)
    if residual:
        proj = proj + x
    attention = torch.sqrt((proj * proj).sum(-1))
    whitened = _whiten(proj, params.postwhiten_m, params.postwhiten_p)
    k = min(nfeat, attention.shape[1])
    idx = top_k_indices(attention, k)
    return torch.gather(whitened, 1,
                        idx[..., None].expand(-1, -1, whitened.shape[-1]))
