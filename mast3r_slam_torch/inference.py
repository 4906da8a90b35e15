"""Inference adapters around the two-view network: MASt3R, or VGGT-1B
(``models/vggt.py``) through the same entry points.

Mirrors ``mast3r_slam_tpu/inference.py``: encode (bf16, f32 or int8), the
asymmetric two-view decode with both heads (the local-feature MLPs in int8
on request), the mono (self-pair) decode, the asymmetric
decode + dense match of the tracker, the backend's symmetric decode + match
and decode-free pose-warped match of a factor-graph edge, and the
host-side image resize.  With a mesh the network runs tensor parallel over
its ``model`` axis (``parallel.mesh.shard_params_tp``); ``replica`` gives
the engine's copy on another device, which a backend device decodes with.
"""

from __future__ import annotations

import copy
from typing import Tuple

import numpy as np
import torch

from .device import resolve_device
from .models import quant
from .models.mast3r import MASt3R, postprocess
from .parallel.mesh import shard_params_tp
from .ops import lie_sim3 as sim3
from .ops import matching
from .utils.profiler import TRACER


class InferenceEngine:
    """Holds the model on ``device`` and exposes the inference entry points
    (inference.py:30).  ``img_hw`` is fixed per run."""

    def __init__(self, model: MASt3R, img_hw: Tuple[int, int],
                 downsample: int = 1,
                 match_cfg: matching.MatchingConfig | None = None,
                 device="cuda", int8_encoder: bool = False,
                 int8_local_head: bool = False, mesh=None):
        """``int8_encoder`` runs the encoder through ``quant.encode_int8``
        and ``int8_local_head`` the catMLP local-feature MLPs through
        ``quant.local_features_int8`` (inference.py:89-110), both with
        weights quantised here from the model as cast below.

        ``mesh`` (inference.py:42-67): a ``parallel.mesh.Mesh`` whose
        ``model`` axis is larger than 1 splits the trunk over that axis's
        entries (the first row of the mesh), each entry running kernel A on
        its ``H / n_model`` heads; the model's other weights stay on
        ``device``, where the partial sums are reduced.  With
        ``int8_encoder`` the whole weights are quantised and their codes
        split (``quant.shard_qparams_tp``).

        Another network (``models.vggt.VGGT``) is served through the same
        ``encode``, ``decode_pair`` and ``inference_mono``; the int8 paths
        and the tensor-parallel path are MASt3R's, and asking for them with
        another network raises."""
        if not isinstance(model, MASt3R) and (
                int8_encoder or int8_local_head or (
                    mesh is not None and mesh.shape["model"] > 1)):
            raise ValueError("InferenceEngine: the int8 encoder, the int8 "
                             "local head and tensor parallelism are "
                             "MASt3R's; this network runs without them")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 heads (``--fp32-head``, the reference's autocast policy):
            # PyTorch would run their cuDNN convolutions in TF32 by default,
            # which keeps ~3 decimal digits.  Keep both matmul and conv f32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if model.cfg.dtype == torch.bfloat16:
            # identical bits, half the weight bytes; the head weights too
            # when the heads compute in bf16 (inference.py:55-63)
            model.cast_params_bf16(
                head_bf16=model.cfg.head_dtype == torch.bfloat16)
        self.model = model.to(self.device).eval()
        # quantised from the cast weights, as JAX quantises after its cast
        self.qparams = quant.quantize_encoder_params(self.model) \
            if int8_encoder else None
        self.qlocal = quant.quantize_local_heads(self.model) \
            if int8_local_head else None
        self.mesh = mesh
        self.qparams_tp = None
        if mesh is not None and mesh.shape["model"] > 1:
            shard_params_tp(self.model, mesh)
            if self.qparams is not None:
                devs = mesh.axis_devices("model")
                cfg = model.cfg
                self.qparams_tp = (devs, quant.shard_qparams_tp(
                    self.qparams, cfg.enc_num_heads,
                    cfg.enc_embed_dim // cfg.enc_num_heads, devs))
        self.img_hw = tuple(img_hw)
        self.match_cfg = match_cfg or matching.MatchingConfig()
        p = model.cfg.patch_size
        self.n_patches = (img_hw[0] // p) * (img_hw[1] // p)
        self.feat_dim = model.cfg.enc_embed_dim
        # dataset.img_downsample: every head output strided by it
        # (inference.py:70-76)
        self.downsample = int(downsample)
        ds = self.downsample
        self.out_hw = (img_hw[0] // ds, img_hw[1] // ds)

    @torch.no_grad()
    def encode(self, img):
        """img (B, h, w, 3) -> (feat (B, N, C) f32, pos (B, N, 2))
        (inference.py:161).  Span ``inference.encode``."""
        with TRACER.span("inference.encode"):
            img = img.to(self.device)
            if self.qparams is not None:
                return quant.encode_int8(self.model, self.qparams, img,
                                         tp=self.qparams_tp)
            return self.model.encode(img)

    def replica(self, device) -> "InferenceEngine":
        """This engine's copy on ``device`` (JAX's params put on the
        backend chip, pipeline.py:133-137): the same weights, casts and
        quantised heads, unsharded; this engine itself on its own
        device."""
        device = resolve_device(device)
        if device == self.device:
            return self
        twin = copy.copy(self)
        twin.device = device
        # the split pieces stay behind: the copy runs whole
        memo = {id(m.tp): None for m in self.model.modules()
                if getattr(m, "tp", None) is not None}
        twin.model = copy.deepcopy(self.model, memo).to(device)
        twin.mesh = twin.qparams_tp = None
        twin.qparams = self.qparams and _tree_to(self.qparams, device)
        twin.qlocal = self.qlocal and _tree_to(self.qlocal, device)
        return twin

    @torch.no_grad()
    def decode_pair(self, feat1, pos1, feat2, pos2):
        """One asymmetric two-view decode with both heads, the one decode of
        the tracker, the backend's symmetric edges and relocalization
        (``_decode_head``, inference.py:119-145, 165).  With
        ``int8_local_head``: decode, the DPT, the int8 local-feature MLP on
        (encoder, last decoder) tokens, the postprocess.  Returns ((X, C,
        D, Q) for view 1, for view 2), each (B, h, w, ...), (h, w) the
        engine's ``out_hw``: every ``downsample``-th row and column of the
        heads' output (``_pack``, inference.py:146-157).  Span
        ``inference.decode``."""
        with TRACER.span("inference.decode"):
            return self._decode_pair(feat1, pos1, feat2, pos2)

    def _decode_pair(self, feat1, pos1, feat2, pos2):
        m = self.model
        if self.qlocal is None:
            res = m.decode_and_head(feat1, pos1, feat2, pos2, self.img_hw)
        else:
            res = []
            for n, toks in enumerate(m.decode(feat1, pos1, feat2, pos2), 1):
                local = quant.local_features_int8(
                    self.qlocal[f"local{n}"], toks[0], toks[-1],
                    self.img_hw, m.cfg)
                res.append(postprocess(m.head_dpt(n, toks, self.img_hw),
                                       local, m.cfg))
        return tuple(tuple(self._strided(r[k]) for k in
                           ("pts3d", "conf", "desc", "desc_conf"))
                     for r in res)

    def _strided(self, A):
        ds = self.downsample
        return A if ds == 1 else A[:, ::ds, ::ds].contiguous()

    @torch.no_grad()
    def inference_mono(self, feat, pos):
        """The frame's own pointmap (inference.py:170): the network's
        ``decode_mono`` (MASt3R's view 1 of the frame paired with itself,
        VGGT's frame alone).  Returns Xii (1, hw, 3), Cii (1, hw, 1).
        Span ``inference.decode``."""
        with TRACER.span("inference.decode"):
            r = self.model.decode_mono(feat, pos, self.img_hw)
        X, C = self._strided(r["pts3d"]), self._strided(r["conf"])
        b = X.shape[0]
        return X.reshape(b, -1, 3), C.reshape(b, -1, 1)

    @torch.no_grad()
    def match_asymmetric(self, frame_feat, frame_pos, kf_feat, kf_pos,
                         idx_i2j_init=None):
        """Asymmetric decode + dense match, exporting the q8 descriptor
        tables (inference.py:217, ``_match_asymmetric_desc_impl``).  Returns
        (idx_f2k (1, hw), valid_match (1, hw, 1), Xff, Cff, Qff, Xkf, Ckf,
        Qkf, desc8_frame, desc8_kf) with pointmaps flattened to
        (1, hw, ...).  The descriptors are quantised here, outside
        ``match``, which takes the int8 arrays as they are; the two
        (1, hw, f) int8 tables ride along for the backend's consecutive
        edge (None when the matcher does not run on int8 tables).  Without
        ``idx_i2j_init`` the matcher starts from the identity on the
        ``out_hw`` grid of the strided pointmaps (inference.py:186-190).
        The quantisation and the matcher are the span ``matching.match``."""
        (Xii, Cii, Dii, Qii), (Xji, Cji, Dji, Qji) = self.decode_pair(
            frame_feat, frame_pos, kf_feat, kf_pos)
        b = Xii.shape[0]
        desc8 = (None, None)
        with TRACER.span("matching.match"):
            if self.match_cfg.desc_bits == 8 and self.match_cfg.radius > 0:
                D8f, D8k = matching._q8_pair(
                    Dii, Dji.reshape(b, -1, Dji.shape[-1]),
                    self.match_cfg.desc_prenorm)
                desc8 = (D8f.reshape(b, -1, D8f.shape[-1]), D8k)
                Dii, Dji = D8f, D8k.reshape(Dji.shape)
            idx_i2j, valid_match_j = matching.match(
                Xii, Xji, Dii, Dji, idx_1_to_2_init=idx_i2j_init,
                cfg=self.match_cfg)

        def flat(A):
            return A.reshape(b, -1, A.shape[-1] if A.dim() == 4 else 1)

        return (idx_i2j, valid_match_j, flat(Xii), flat(Cii), flat(Qii),
                flat(Xji), flat(Cji), flat(Qji), *desc8)

    @torch.no_grad()
    def match_arrays_warp(self, X_arena, T_arena, i, j, D11_flat, D21_flat,
                          img_hw):
        """Decode-free pose-warped match of the consecutive edge (i, j)
        (inference.py:254): keyframe i's canonical pointmap against
        keyframe j's canonical points under the relative pose, with the
        tracker's int8 q8 tables (D11 keyframe i's, D21 keyframe j's, each
        (1, h*w, f)), on the edge query grid.  Returns (idx_i_to_j
        (1, n), valid (1, n, 1))."""
        h, w = img_hw
        f = D11_flat.shape[-1]
        X11 = X_arena[i].reshape(1, h, w, 3)
        T_ij = sim3.rel(T_arena[i], T_arena[j])
        X21 = sim3.act(T_ij, X_arena[j]).reshape(1, h, w, 3)
        return matching.match(
            X11, X21, D11_flat.reshape(1, h, w, f),
            D21_flat.reshape(1, h, w, f), cfg=self.match_cfg,
            query_subsample=self.match_cfg.edge_query_subsample)

    @torch.no_grad()
    def decode_symmetric_batch(self, feat_i, pos_i, feat_j, pos_j):
        """Both directions of E edges (inference.py:288), one B=2 two-view
        forward per edge as the JAX ``lax.map`` runs them.  feat_i/j
        (E, N, C).  Returns X, C, D, Q, each (4, E, h, w, ...), ordered
        [ii, ji, jj, ij]."""
        per_edge = []
        for e in range(feat_i.shape[0]):
            f1 = torch.stack([feat_i[e], feat_j[e]])
            p1 = torch.stack([pos_i[e], pos_j[e]])
            f2 = torch.stack([feat_j[e], feat_i[e]])
            p2 = torch.stack([pos_j[e], pos_i[e]])
            v1, v2 = self.decode_pair(f1, p1, f2, p2)
            # view 1 = [res11 of (i, j); res11 of (j, i)] = [ii; jj],
            # view 2 = [ji; ij]
            per_edge.append([torch.stack([A1[0], A2[0], A1[1], A2[1]])
                             for A1, A2 in zip(v1, v2)])
        return tuple(torch.stack([q[k] for q in per_edge], dim=1)
                     for k in range(4))

    @torch.no_grad()
    def match_symmetric(self, feat_i, pos_i, feat_j, pos_j):
        """Symmetric decode + two-directional match of E edges
        (inference.py:345), the matcher on the edge query grid.  Returns
        (idx_i2j, idx_j2i (E, n), valid_j, valid_i (E, n, 1), Qii, Qjj,
        Qji, Qij (E, h*w, 1))."""
        X, C, D, Q = self.decode_symmetric_batch(feat_i, pos_i, feat_j,
                                                 pos_j)
        E = X.shape[1]
        X11 = torch.cat([X[0], X[2]])
        X21 = torch.cat([X[1], X[3]])
        D11 = torch.cat([D[0], D[2]])
        D21 = torch.cat([D[1], D[3]])
        idx, valid = matching.match(
            X11, X21, D11, D21, cfg=self.match_cfg,
            query_subsample=self.match_cfg.edge_query_subsample)

        def flat1(A):
            return A.reshape(E, -1, 1)

        return (idx[:E], idx[E:], valid[:E], valid[E:],
                flat1(Q[0]), flat1(Q[2]), flat1(Q[1]), flat1(Q[3]))


def _tree_to(tree, device):
    """A dict of ``QuantDense`` (nested) with every tensor on ``device``."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return type(tree)(*(t.to(device) for t in tree))


# ---------------------------------------------------------------------------
# Image resize to network input shape (host side, numpy)
# ---------------------------------------------------------------------------

IMGNORM_MEAN = np.array([0.5, 0.5, 0.5], dtype=np.float32)
IMGNORM_STD = np.array([0.5, 0.5, 0.5], dtype=np.float32)


def resize_img(img: np.ndarray, size: int = 512,
               return_transformation: bool = False):
    """Resize the long side to ``size`` and centre-crop H, W to multiples of
    16 (inference.py:392; 224 square mode included).  img: (H, W, 3) uint8
    or float in [0, 1].  Returns dict(img (1, h, w, 3) normalised,
    true_shape (1, 2), unnormalized_img, unnormalized_img_u8), and with
    ``return_transformation`` also (scale_w, scale_h, half_crop_w,
    half_crop_h), which carry intrinsics to the network frame."""
    from PIL import Image

    if size not in (224, 512):
        raise ValueError(f"resize_img: size must be 224 or 512, got {size}")
    if img.dtype == np.uint8:
        pil = Image.fromarray(img)
    else:
        pil = Image.fromarray(np.uint8(np.clip(img, 0, 1) * 255))
    W1, H1 = pil.size

    def _resize_long(p, long_edge):
        S = max(p.size)
        interp = Image.LANCZOS if S > long_edge else Image.BICUBIC
        new_size = tuple(int(round(x * long_edge / S)) for x in p.size)
        return p.resize(new_size, interp)

    if size == 224:
        pil = _resize_long(pil, round(size * max(W1 / H1, H1 / W1)))
        W, H = pil.size
        cx, cy = W // 2, H // 2
        half = min(cx, cy)
        pil = pil.crop((cx - half, cy - half, cx + half, cy + half))
    else:
        pil = _resize_long(pil, size)
        W, H = pil.size
        cx, cy = W // 2, H // 2
        halfw, halfh = ((2 * cx) // 16) * 8, ((2 * cy) // 16) * 8
        if W == H:
            halfh = int(3 * halfw / 4)
        pil = pil.crop((cx - halfw, cy - halfh, cx + halfw, cy + halfh))

    arr8 = np.asarray(pil)
    res = {
        "img": (arr8.astype(np.float32) * (1.0 / 127.5) - 1.0)[None],
        "true_shape": np.int32([pil.size[::-1]]),
        "unnormalized_img": arr8.astype(np.float32) * (1.0 / 255.0),
        "unnormalized_img_u8": arr8,
    }
    if return_transformation:
        return res, (W1 / W, H1 / H, (W - pil.size[0]) / 2,
                     (H - pil.size[1]) / 2)
    return res
