"""Retrieval database: an incremental ASMK index over the keyframes, for
loop-closure and relocalization proposals.

Mirrors ``mast3r_slam_tpu/retrieval/database.py``: ``update(frame, ...)``
takes the top-k attention features of the frame's cached encoder tokens
(on the card), queries the inverted file (on the host) for the most
similar keyframes above a score threshold, and adds the frame to the index
after the query unless told not to (relocalization peeks first and adds
only on success).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .asmk import ASMKKernel, IVF, Codebook
from .model import RetrievalParams, prep_features


class RetrievalDatabase:
    """The pipeline's retrieval object (the interface of
    ``pipeline.NullRetrieval``).  The head's weights live on the codebook's
    device."""

    def __init__(self, params: RetrievalParams, codebook: Codebook,
                 nfeat: int = 300, alpha: float = 3.0,
                 similarity_threshold: float = 0.0,
                 query_ma: int = 5, build_ma: int = 1):
        self.device = codebook.device
        self.params = params.to(self.device)
        self.codebook = codebook
        self.kernel = ASMKKernel(codebook, binary=True)
        self.ivf = IVF(codebook.size)
        self.nfeat = nfeat
        self.alpha = alpha
        self.similarity_threshold = similarity_threshold
        self.query_ma = query_ma   # multiple assignment of a query
        self.build_ma = build_ma   # multiple assignment of an added image
        self.kf_counter = 0
        self.kf_ids: list[int] = []

    @classmethod
    def from_checkpoint(cls, retrieval_ckpt, codebook_pkl, device="cuda",
                        **kw) -> "RetrievalDatabase":
        """The published retrieval head and codebook (database.py:42)."""
        params = RetrievalParams.from_torch_checkpoint(retrieval_ckpt)
        codebook = Codebook.load(codebook_pkl, device=device)
        return cls(params, codebook, **kw)

    # ------------------------------------------------------------------

    def _features(self, frame):
        """The frame's top-k features: (on the device, one host copy)."""
        feat = frame.feat[None].to(self.device, torch.float32)
        top = prep_features(self.params, feat, self.nfeat,
                            residual=bool(self.params.residual))[0]
        return top, top.cpu().numpy()

    def update(self, frame, arena=None, add_after_query: bool = True,
               k: int = 3, min_thresh: float = 0.0):
        """Query, then insert unless ``add_after_query`` is False
        (database.py:65).  Returns the positions of the matching keyframes
        in the order they were added, best first."""
        feat_dev, feat = self._features(frame)

        topk_image_inds: list[int] = []
        query_words = None
        if self.kf_counter > 0:
            query_words = self.codebook.quantize(feat_dev, self.query_ma)
            ades, word_ids = self.kernel.aggregate_image(feat, query_words)
            ranks, ranked_scores = self.ivf.search_packed(
                ades, word_ids, self.codebook.dim, alpha=self.alpha,
                similarity_threshold=self.similarity_threshold, topk=None)
            scores = np.empty_like(ranked_scores)
            scores[ranks] = ranked_scores
            kk = min(k, self.ivf.n_images)
            order = np.argsort(-scores)[:kk]
            valid = scores[order] > min_thresh
            topk_image_inds = [int(i) for i in order[valid]]

        if add_after_query:
            self._add(feat_dev, feat, query_words)
        return topk_image_inds

    def _add(self, feat_dev, feat: np.ndarray,
             query_words: Optional[np.ndarray]):
        if query_words is not None:
            words = query_words[:, : self.build_ma]
        else:
            words = self.codebook.quantize(feat_dev, self.build_ma)
        ades, word_ids = self.kernel.aggregate_image(feat, words)
        imids = np.full(word_ids.shape[0], self.kf_counter, np.int64)
        self.ivf.add(ades, word_ids, imids)
        self.kf_ids.append(self.kf_counter)
        self.kf_counter += 1
